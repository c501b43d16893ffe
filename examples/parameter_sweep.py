"""Demo: batched parameter sweep — B perturbed systems in ONE program.

Run: python examples/parameter_sweep.py [--b 32] [--n 1024] [--steps 200]

The batched answer to "re-run the simulation across a knob": B copies
of a Plummer sphere, each with a different velocity-scale factor q (the
virial knob: q=1 is equilibrium, q<1 collapses, q>1 expands), integrated
together by sim.simulate_ensemble — the force is jax.vmap of the
single-system force (a batch grid axis on the Pallas kernel), so the device
sees one program instead of B launches (the reference FPGA could serve
exactly one RAM-load at a time: src/top_level.vhd:180-186). Per-system
energy drift and the half-mass radius trend are reported per system; total
wall time is the time of ONE batched trajectory.
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from mini_nbody_tpu import SimConfig, init
from mini_nbody_tpu.models.state import BodyState
from mini_nbody_tpu.ops import diagnostics as diag
from mini_nbody_tpu.sim import simulate_ensemble


def half_mass_radius(pos, mass):
    """Median-mass radius from the center of mass, per system (B, N, 3)."""
    com = jnp.sum(pos * mass[..., None], axis=1) / jnp.sum(
        mass, axis=1, keepdims=True).reshape(-1, 1)
    r = jnp.linalg.norm(pos - com[:, None, :], axis=-1)
    return jnp.median(r, axis=1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--b", type=int, default=32)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dt", type=float, default=2e-3)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (CI smoke runs)")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    soft = 1e-3
    cfg = SimConfig(n=args.n, dt=args.dt, steps=args.steps, softening=soft,
                    integrator="leapfrog", use_masses=True,
                    backend="auto")

    base = init.plummer(jax.random.key(0), args.n)
    q = jnp.linspace(0.2, 1.6, args.b)  # velocity-scale sweep
    st = BodyState(
        pos=jnp.broadcast_to(base.pos, (args.b,) + base.pos.shape),
        vel=base.vel[None, :, :] * q[:, None, None],
        mass=jnp.broadcast_to(base.mass, (args.b,) + base.mass.shape),
    )

    e0 = diag.total_energy_ensemble(st, soft)
    r0 = half_mass_radius(st.pos, st.mass)
    t0 = time.perf_counter()
    out = simulate_ensemble(cfg, st)
    jax.block_until_ready(out.pos)
    wall = time.perf_counter() - t0
    e1 = diag.total_energy_ensemble(out, soft)
    r1 = half_mass_radius(out.pos, out.mass)

    drift = np.abs((np.asarray(e1) - np.asarray(e0)) / np.asarray(e0))
    print(json.dumps({
        "B": args.b, "n": args.n, "steps": args.steps,
        "backend": cfg.resolve_backend(),
        "wall_s": round(wall, 3),
        "pairs_per_s": round(args.b * args.steps * args.n ** 2 / 2
                             / wall / 1e9, 2),
        "max_energy_drift": float(drift.max()),
    }))
    for i in range(args.b):
        print(json.dumps({
            "q": round(float(q[i]), 3),
            "energy_drift": float(drift[i]),
            "r_half": round(float(r1[i]), 4),
            "r_half_ratio": round(float(r1[i] / r0[i]), 3),
        }))

    # Sanity: collapsing (q<<1) systems shrink, hot (q>1.4) ones expand.
    rr = np.asarray(r1 / r0)
    qs = np.asarray(q)
    assert rr[qs < 0.5].mean() < 1.0, "cold systems should contract"
    assert rr[qs > 1.4].mean() > 1.0, "hot systems should expand"
    print(json.dumps({"sweep_trend": "ok"}))


if __name__ == "__main__":
    main()
