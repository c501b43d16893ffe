"""Benchmarks of the force path on a CUDA GPU.

    python bench.py             # headline: interactions/s at N=1M, one JSON line
    python bench.py --compare   # Pallas kernel vs XLA's plain version, end to end
    python bench.py --sweep N   # block-size sweep of the Pallas kernels at N

The headline line is {"metric", "value", "unit", "vs_baseline"}; vs_baseline
is against the reference design's only absolute rate, 3.0 GInteractions/s
(12 interactions/cycle at a 250 MHz fabric clock, BASELINE.md row
"Hypothetical absolute rate"). Every line names the card and its power
limit; a run that finds no GPU fails.
"""

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_GIPS = 3.0  # reference FPGA @250 MHz, 12 interactions/cycle


def _card():
    from chip_smoke import card_line

    dev = jax.devices()[0]
    return {"card": card_line(), "device_kind": dev.device_kind,
            "jax": jax.__version__}


def _timed(fn, *args, reps=3):
    """(first call seconds incl. compile, median warm seconds)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        warm.append(time.perf_counter() - t0)
    return first, float(np.median(warm))


def headline(n: int, steps: int) -> None:
    from mini_nbody_tpu import SimConfig, init, simulate
    from mini_nbody_tpu.utils.harness import Throughput

    cfg = SimConfig(n=n, dt=0.01, steps=steps)
    state = init.uniform_random(jax.random.key(0), n)
    first, sec = _timed(lambda s: simulate(cfg, s).pos, state, reps=2)
    t = Throughput(n=n, steps=steps, seconds=sec)
    print(json.dumps({**_card(), "backend": cfg.resolve_backend(),
                      "first_call_s": first, **t.report()}), file=sys.stderr)
    print(json.dumps({
        "metric": f"per-device interactions/s, N={n}, fp32 "
                  f"({cfg.resolve_backend()} backend)",
        "value": t.ginteractions_per_s_per_device,
        "unit": "GInteractions/s",
        "vs_baseline": t.ginteractions_per_s_per_device / BASELINE_GIPS,
    }))


def compare(sizes, steps_by_n, backends) -> None:
    """End-to-end simulate and rollout-gradient times, per backend."""
    import dataclasses

    from mini_nbody_tpu import SimConfig, init, simulate
    from mini_nbody_tpu.sim import init_carry, make_rollout_fn

    card = _card()
    for n in sizes:
        steps = steps_by_n[n]
        s = init.uniform_random(jax.random.key(0), n)
        for be in backends:
            cfg = SimConfig(n=n, dt=0.01, steps=steps, backend=be)
            first, sec = _timed(lambda st: simulate(cfg, st).pos, s, reps=2)
            print(json.dumps({**card, "what": "simulate", "n": n,
                              "steps": steps, "backend": be,
                              "first_call_s": first, "window_s": sec,
                              "step_s": sec / steps,
                              "ginteractions_per_s":
                                  float(n) * n * steps / sec / 1e9}),
                  flush=True)
        for be in backends:
            cfg = SimConfig(n=n, dt=1e-3, softening=1e-2, backend=be,
                            integrator="leapfrog")
            carry = init_carry(cfg, s)
            roll = make_rollout_fn(cfg, steps, remat="none")

            @jax.jit
            def grad(p):
                def loss(p):
                    out, _ = roll((dataclasses.replace(carry[0], pos=p),
                                   carry[1]))
                    return jnp.sum(out.pos ** 2)

                return jax.grad(loss)(p)

            first, sec = _timed(grad, s.pos, reps=2)
            print(json.dumps({**card, "what": "rollout_grad", "n": n,
                              "steps": steps, "backend": be,
                              "first_call_s": first, "window_s": sec,
                              "step_s": sec / steps}), flush=True)


def sweep(n: int) -> None:
    """Time the forward and VJP kernels over block sizes at N."""
    from mini_nbody_tpu import init
    from mini_nbody_tpu.ops.pallas_force import body_force_pallas, vjp_pallas

    card = _card()
    s = init.plummer(jax.random.key(0), n)
    g = jax.random.normal(jax.random.key(1), (n, 3), jnp.float32)
    for ti, tj, warps, stages in [
            (16, 64, 4, 1), (32, 32, 4, 1), (64, 16, 4, 1), (32, 64, 8, 1),
            (32, 64, 4, 1), (64, 32, 4, 1), (16, 64, 2, 1), (32, 32, 2, 1),
            (64, 64, 8, 1), (16, 128, 4, 1), (128, 16, 4, 1),
            (32, 32, 1, 1), (32, 64, 2, 1), (64, 32, 2, 1),
            (32, 64, 4, 2), (64, 32, 4, 2)]:
        kw = dict(tile_i=ti, tile_j=tj, num_warps=warps, num_stages=stages)
        row = {**card, "n": n, **kw}
        try:
            _, sec = _timed(lambda p: body_force_pallas(
                p, p, s.mass, softening=1e-2, **kw), s.pos)
            row["force_s"] = sec
            row["force_ginter_s"] = float(n) * n / sec / 1e9
            _, sec = _timed(lambda p: vjp_pallas(
                p, g, s.mass, p, g, s.mass, softening=1e-2, **kw), s.pos)
            row["vjp_s"] = sec
        except Exception as e:  # a block the compiler refuses is a result
            row["error"] = f"{type(e).__name__}: {str(e)[:200]}"
        print(json.dumps(row), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--sweep", type=int, default=0, metavar="N")
    ap.add_argument("--sizes", default="65536,1048576")
    ap.add_argument("--backends", default="pallas,jnp")
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        sys.exit(f"no GPU: JAX found {jax.devices()[0].platform!r}")
    from mini_nbody_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    if args.sweep:
        sweep(args.sweep)
    elif args.compare:
        sizes = [int(x) for x in args.sizes.split(",")]
        steps = {n: max(1, min(20, int(1e12 // (n * n)))) for n in sizes}
        compare(sizes, steps, args.backends.split(","))
    else:
        headline(args.n, args.steps)


if __name__ == "__main__":
    main()
