"""Demo: cold-sphere gravitational collapse with live diagnostics.

Run: python examples/cold_collapse.py [--n 8192] [--steps 400]

A uniform cold (zero-velocity) sphere collapses under self-gravity, bounces
at ~a free-fall time, and relaxes. Total energy is conserved by the leapfrog
integrator; the virial ratio -2T/U swings through the collapse. Prints one
JSON metrics row per interval (utils.tracing.StepMetrics).
"""

import argparse
import json
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax

from mini_nbody_tpu import SimConfig, init
from mini_nbody_tpu.ops import diagnostics as diag
from mini_nbody_tpu.sim import init_carry, make_step_fn
from mini_nbody_tpu.utils.tracing import StepMetrics


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--interval", type=int, default=50)
    ap.add_argument("--dt", type=float, default=2e-3)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (CI smoke runs)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    soft = 1e-3
    cfg = SimConfig(n=args.n, dt=args.dt, steps=args.steps, softening=soft,
                    integrator="leapfrog", use_masses=True)
    state = init.cold_sphere(jax.random.key(0), args.n)
    e0 = float(diag.total_energy(state, soft))
    print(json.dumps({"n": args.n, "e0": e0, "backend": cfg.resolve_backend()}))

    step = jax.jit(make_step_fn(cfg))
    carry = init_carry(cfg, state)
    metrics = StepMetrics(n=args.n).start()
    for _ in range(args.steps // args.interval):
        for _ in range(args.interval):
            carry = step(carry)
        st = carry[0]
        ke = float(diag.kinetic_energy(st.vel, st.mass))
        e = float(diag.total_energy(st, soft))
        row = metrics.tick(
            args.interval,
            energy=round(e, 6),
            drift=round(abs(e - e0) / abs(e0), 8),
            virial=round(-2 * ke / (e - ke), 3) if e != ke else None,
        )
        print(json.dumps(row))


if __name__ == "__main__":
    main()
