"""Every exchange (comm) against the single-device result on the 8-device
CPU mesh, for both force paths and both mass modes: the per-step force
(sharded_force) and the gradient of a differentiable sharded step."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini_nbody_tpu import SimConfig
from mini_nbody_tpu.models import init
from mini_nbody_tpu.ops.force import body_force
from mini_nbody_tpu.parallel import make_mesh, shard_state
from mini_nbody_tpu.parallel.sharded import (
    _state_specs, make_sharded_step_fn, sharded_force)
from mini_nbody_tpu.sim import make_step_fn

N = 200  # pads to every mesh below
MESHES = {"all_gather": (8,), "ring": (8,), "ring_sym": (8,),
          "grid": (2, 4)}


def _mesh(comm):
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (the virtual CPU mesh)")
    return make_mesh(MESHES[comm])


def _cfg(comm, backend, use_masses):
    return SimConfig(n=N, dt=1e-2, softening=1e-2, comm=comm,
                     mesh_shape=MESHES[comm], backend=backend,
                     interpret=True, use_masses=use_masses)


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("use_masses", [False, True])
@pytest.mark.parametrize("comm", ["all_gather", "ring", "ring_sym", "grid"])
def test_sharded_force_matches_single_device(comm, use_masses, backend):
    mesh = _mesh(comm)
    s = init.plummer(jax.random.key(5), N)
    cfg = _cfg(comm, backend, use_masses)
    st = shard_state(s, mesh, pad_far=not use_masses)
    got = np.asarray(sharded_force(cfg, mesh, st))[:N]
    ref = body_force(s.pos, s.pos, s.mass if use_masses else None,
                     softening=1e-2)
    assert _rel(got, ref) < 1e-5


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("use_masses", [False, True])
@pytest.mark.parametrize("comm", ["all_gather", "ring", "ring_sym", "grid"])
def test_sharded_gradient_matches_single_device(comm, use_masses, backend):
    """jax.grad through one differentiable sharded Euler step. The loss
    reads velocities, so the gradient is all force VJP (the collectives'
    backward and the pairwise VJP per hop / gather / pair block)."""
    mesh = _mesh(comm)
    n = 192  # divisible by every mesh: shard_state adds no padding
    s = init.plummer(jax.random.key(6), n)
    cfg = _cfg(comm, backend, use_masses).replace(n=n)
    single = make_step_fn(cfg.replace(mesh_shape=None), differentiable=True)
    sharded = make_sharded_step_fn(cfg, mesh, differentiable=True)
    specs = _state_specs(mesh)

    def loss(step, constrain, p):
        st = dataclasses.replace(s, pos=p)
        if constrain:
            st = jax.tree_util.tree_map(
                lambda x, sp: jax.lax.with_sharding_constraint(
                    x, jax.sharding.NamedSharding(mesh, sp)), st, specs)
        out, _ = step((st, jnp.zeros_like(p)))
        return jnp.sum(out.vel ** 2)

    ref = jax.grad(lambda p: loss(single, False, p))(s.pos)
    got = jax.jit(jax.grad(lambda p: loss(sharded, True, p)))(s.pos)
    assert _rel(got, ref) < 1e-4
