"""Demo: gradient-based initial-condition optimization through the simulator.

Optimizes the initial velocity of a probe body so that, after `steps` of
softened-gravity evolution inside a Plummer cluster, it arrives at a target
point — gradients flow through the whole trajectory via the analytic force
VJP (the Pallas backward kernel on a GPU), with the sqrt-checkpointed rollout
(sim.make_rollout_fn) so long trajectories don't store every step's
residuals.

Run: python examples/optimize_impact.py [--n 512] [--steps 40] [--iters 60]
                                        [--remat {sqrt,step,none}]
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import optax

from mini_nbody_tpu import SimConfig, init
from mini_nbody_tpu.models.state import BodyState
from mini_nbody_tpu.sim import init_carry, make_rollout_fn


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--remat", choices=["sqrt", "step", "none"],
                    default="sqrt")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (CI smoke runs)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    cfg = SimConfig(n=args.n, dt=5e-3, softening=1e-2,
                    integrator="leapfrog", use_masses=True)
    cluster = init.plummer(jax.random.key(0), args.n)
    target = jnp.asarray([1.2, 0.8, 0.0])
    rollout = make_rollout_fn(cfg, args.steps, remat=args.remat)

    def final_probe_pos(v0):
        # probe = body 0 with optimizable initial velocity
        state = BodyState(
            pos=cluster.pos.at[0].set(jnp.asarray([-1.5, -1.0, 0.0])),
            vel=cluster.vel.at[0].set(v0),
            mass=cluster.mass,
        )
        carry = rollout(init_carry(cfg, state))
        return carry[0].pos[0]

    @jax.jit
    def loss_fn(v0):
        return jnp.sum((final_probe_pos(v0) - target) ** 2)

    # straight-line initial guess; gravity bends the path, Adam corrects it
    total_t = args.steps * cfg.dt
    v0 = (target - jnp.asarray([-1.5, -1.0, 0.0])) / total_t
    opt = optax.adam(0.5)
    opt_state = opt.init(v0)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    for it in range(args.iters):
        loss, g = grad_fn(v0)
        updates, opt_state = opt.update(g, opt_state)
        v0 = optax.apply_updates(v0, updates)
        if it % 10 == 0 or it == args.iters - 1:
            print(json.dumps({"iter": it, "miss_distance": round(float(loss) ** 0.5, 5),
                              "v0": [round(float(x), 4) for x in v0]}))


if __name__ == "__main__":
    main()
