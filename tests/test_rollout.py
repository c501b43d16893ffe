"""make_rollout_fn: checkpointed trajectory adjoints match the plain
differentiable scan for every integrator, remat policy and force path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini_nbody_tpu import SimConfig
from mini_nbody_tpu.models import init
from mini_nbody_tpu.sim import init_carry, make_rollout_fn


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("remat", ["step", "sqrt"])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
def test_rollout_remat_equivalence(integrator, remat, backend):
    """Checkpointed rollouts recompute deterministically: gradients equal
    the plain scan's for every integrator and backend (ragged sqrt
    segments at steps=5)."""
    n, steps = 32, 5
    cfg = SimConfig(n=n, dt=1e-2, steps=steps, softening=1e-2,
                    integrator=integrator, backend=backend, interpret=True,
                    use_masses=True)
    s = init.plummer(jax.random.key(33), n)
    carry0 = init_carry(cfg, s)

    def grad(r):
        roll = make_rollout_fn(cfg, steps, remat=r)

        def loss(p):
            out, _ = roll((dataclasses.replace(carry0[0], pos=p), carry0[1]))
            return jnp.sum(out.vel ** 2)

        return np.asarray(jax.grad(loss)(s.pos))

    # The interpreted kernel runs eagerly here: XLA:CPU miscompiles the
    # interpreter's loop under jax.checkpoint inside a scan (yoshida4,
    # remat="step", 6+ steps: wrong gradients with jit, exact without it;
    # JAX 0.9.0). The compiled kernel is an opaque custom call on the GPU.
    import contextlib

    ctx = jax.disable_jit() if backend == "pallas" else contextlib.nullcontext()
    with ctx:
        ref = grad("none")
        got = grad(remat)
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())
