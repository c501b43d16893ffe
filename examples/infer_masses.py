"""Demo: infer per-body masses from an observed trajectory.

Generates a short "observed" trajectory with hidden true masses, then
recovers them by gradient descent on the trajectory mismatch — gradients
flow to the masses through every step via the analytic mass cotangent
(dF_j/dm_k = w d_jk; ops/autodiff.make_differentiable_force(mass_grad=True),
the Pallas backward kernel on a GPU). A capability the fixed-function
reference hardware cannot express at all.

Run: python examples/infer_masses.py [--n 64] [--steps 20] [--iters 200]
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import optax

from mini_nbody_tpu import SimConfig, init
from mini_nbody_tpu.models.state import BodyState
from mini_nbody_tpu.ops.autodiff import make_differentiable_force
from mini_nbody_tpu.ops.integrators import leapfrog_step


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (CI smoke runs)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    cfg = SimConfig(n=args.n, dt=2e-2, softening=1e-2,
                    integrator="leapfrog", use_masses=True)
    s0 = init.plummer(jax.random.key(0), args.n)
    true_mass = s0.mass * jax.random.uniform(
        jax.random.key(1), (args.n,), minval=0.5, maxval=2.0)

    force = make_differentiable_force(cfg, mass_grad=True)

    def rollout(mass):
        def f3(pos_i, pos_j, mass_j):
            return force(pos_i, mass_j)

        state = BodyState(pos=s0.pos, vel=s0.vel, mass=mass)
        acc = f3(s0.pos, s0.pos, mass)
        snaps = []
        for _ in range(args.steps):
            state, acc = leapfrog_step(state, acc, f3, cfg.dt)
            snaps.append(state.pos)
        # velocities carry most of the mass signal over short horizons
        return jnp.stack(snaps), state.vel

    observed = rollout(true_mass)

    obs_pos, obs_vel = observed

    @jax.jit
    def loss(log_mass):
        # optimize in log space: masses stay positive
        pos, vel = rollout(jnp.exp(log_mass))
        return (jnp.mean((pos - obs_pos) ** 2)
                + jnp.mean((vel - obs_vel) ** 2))

    params = jnp.log(jnp.full((args.n,), float(jnp.mean(true_mass))))
    opt = optax.adam(1e-1)
    opt_state = opt.init(params)
    grad_fn = jax.jit(jax.value_and_grad(loss))

    for it in range(args.iters):
        val, g = grad_fn(params)
        updates, opt_state = opt.update(g, opt_state)
        params = optax.apply_updates(params, updates)
        if it % 20 == 0 or it == args.iters - 1:
            err = jnp.abs(jnp.exp(params) - true_mass) / true_mass
            print(f"iter {it:4d}  loss {float(val):.3e}  "
                  f"median mass err {float(jnp.median(err)):.3e}")

    err = jnp.abs(jnp.exp(params) - true_mass) / true_mass
    print(f"final median relative mass error: {float(jnp.median(err)):.3e}")
    assert float(jnp.median(err)) < 0.05, "mass inference did not converge"
    print("OK")


if __name__ == "__main__":
    main()
