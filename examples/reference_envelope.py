"""Run the reference FPGA's OWN operating envelope, end to end.

The reference accelerator serves N <= 32,767 bodies (its RAM depth,
``vec_add.srcs/sources_1/new/top_level.vhd:45-46``) at a hypothetical peak
of 3.0 GInteractions/s (12 lanes @ 250 MHz) with ~97% efficiency at N=4096
(BASELINE.md). This demo sweeps exactly that envelope on one device:

  * config-1 scale (N=4096, dt=0.01, 10 Euler steps — BASELINE.json),
  * the envelope edge (N=32,767, the reference's hard cap),
  * a leapfrog drift check at the edge (the accuracy gate the reference
    host could run but never shipped),

and prints measured GInteractions/s next to the reference's 3.0 G/s
(wall time per simulate() call, dispatch included, amortized by running
1000 steps per call).

Run: python examples/reference_envelope.py [--quick] [--cpu]
(--quick shrinks sizes ~16x; --cpu forces the CPU backend by setting the
config var before any backend initializes.)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_GIPS = 3.0  # hypothetical FPGA peak (BASELINE.md)


def main(quick: bool = False, cpu: bool = False) -> int:
    import jax

    if cpu:
        jax.config.update("jax_platforms", "cpu")

    from mini_nbody_tpu import SimConfig, init, simulate
    from mini_nbody_tpu.ops import diagnostics as diag

    div = 16 if quick else 1
    steps = 10 if quick else 1000

    print(f"backend: {jax.default_backend()}  "
          f"(reference envelope: N <= 32,767 @ {REFERENCE_GIPS} G/s hyp.)")

    # 1. Reference config 1: N=4096, dt=0.01, Euler.
    for n in (4096 // div, 32767 // div):
        s = init.uniform_random(jax.random.key(0), n)
        cfg = SimConfig(n=n, dt=0.01, steps=steps)
        jax.block_until_ready(simulate(cfg, s).pos)  # compile first
        t0 = time.perf_counter()
        out = simulate(cfg, s)
        jax.block_until_ready(out.pos)
        sec = time.perf_counter() - t0
        gips = n * n * steps / sec / 1e9
        print(f"N={n:6d} euler  {steps} steps: {sec*1e3:8.1f} ms  "
              f"{gips:7.1f} GInter/s  ({gips / REFERENCE_GIPS:6.1f}x "
              f"the reference peak)")

    # 2. Drift gate at the envelope edge: leapfrog, mass mode.
    n = 32767 // div
    s = init.plummer(jax.random.key(1), n)
    cfg = SimConfig(n=n, dt=1e-3, steps=steps, softening=1e-2,
                    integrator="leapfrog", use_masses=True)
    e0 = float(diag.total_energy(s, cfg.softening))
    out = simulate(cfg, s)
    e1 = float(diag.total_energy(out, cfg.softening))
    drift = abs(e1 - e0) / abs(e0)
    print(f"N={n:6d} leapfrog drift over {steps} steps: {drift:.2e} "
          f"(gate at 1k steps: <= 1e-5)")
    assert drift < 1e-4, drift
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    sys.exit(main(a.quick, a.cpu))
