"""Command-line harness.

The replacement for the reference system's host driver (the
unmounted ARM PS software that wrote bodies into the shared RAM, set the
begin bit, polled for completion and read the kilocycle counter,
``src/top_level.vhd:184-186,255-263``; SURVEY.md §3.1):

  run    — integrate a system for S steps (optionally checkpointing)
  bench  — time the step loop, report GInteractions/s + roofline
  shmoo  — scaling sweep over N, CSV/JSONL out (upstream shmoo analog)
  check  — numerics gate: force error vs fp64 oracle, energy drift,
           momentum conservation (the value-checking the reference's
           testbenches never did, sim/tb_dxy.vhd:899-923)
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _add_common(p):
    p.add_argument("--n", type=int, default=4096, help="number of bodies")
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--softening", type=float, default=1e-9)
    p.add_argument("--integrator", choices=["euler", "leapfrog", "rk4", "yoshida4"], default="euler")
    p.add_argument("--backend", choices=["auto", "jnp", "pallas"],
                   default="auto",
                   help="force path: jnp (XLA), pallas (Pallas-Triton "
                        "kernel, CUDA GPU only), auto (pallas on a GPU, "
                        "jnp elsewhere)")
    p.add_argument("--tile-i", type=int, default=None,
                   help="receiver block of the pallas kernel (power of 2)")
    p.add_argument("--tile-j", type=int, default=None,
                   help="source tile of the pallas kernel (power of 2)")
    p.add_argument("--init", choices=["uniform", "plummer", "cold_sphere", "two_cluster"],
                   default="uniform")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--devices", default="0",
                   help="shard bodies over this many devices (0 = single); "
                        "'RxC' (e.g. 2x2) selects a 2-D mesh for --comm grid")
    p.add_argument("--comm", choices=["all_gather", "ring", "ring_sym", "grid"],
                   default="ring")


def _parse_mesh(devices):
    """--devices '8' -> (8,); '2x4' -> (2, 4); '0' -> None."""
    if "x" in str(devices):
        return tuple(int(v) for v in str(devices).split("x"))
    return (int(devices),) if int(devices) else None


def _build(args):
    from mini_nbody_tpu.utils.config import SimConfig

    return SimConfig(
        n=args.n, dt=args.dt, steps=args.steps, softening=args.softening,
        integrator=args.integrator, backend=args.backend,
        tile_i=args.tile_i, tile_j=args.tile_j,
        comm=args.comm,
        mesh_shape=_parse_mesh(args.devices),
        # uniform init has unit masses (reference semantics -> fast path);
        # plummer/cold_sphere carry per-body masses.
        use_masses=args.init != "uniform",
    )


def _state(args, cfg):
    import jax
    from mini_nbody_tpu.models import init as minit

    return minit.make(args.init, jax.random.key(args.seed), cfg.n)


def cmd_run(args):
    import jax
    from mini_nbody_tpu.sim import simulate
    from mini_nbody_tpu.ops import diagnostics as diag
    from mini_nbody_tpu.utils import checkpoint as ckpt

    cfg = _build(args)
    if getattr(args, "ensemble", 0):
        # BEFORE the single-system state build (no wasted N-body init) and
        # with explicit conflicts: an ensemble neither resumes a
        # single-system checkpoint nor writes one, so a --resume-loaded
        # state is refused rather than silently discarded.
        for flag in ("resume", "save"):
            if getattr(args, flag, None):
                raise SystemExit(
                    f"--ensemble does not support --{flag} (ensembles are "
                    "seed-initialized, single-run batches)")
        from mini_nbody_tpu.models.state import BodyState
        from mini_nbody_tpu.sim import simulate_ensemble

        b = args.ensemble
        import jax.numpy as jnp
        from mini_nbody_tpu.models import init as minit

        t0 = time.perf_counter()
        systems = [minit.make(args.init, jax.random.key(args.seed + i),
                              cfg.n) for i in range(b)]
        batched = BodyState(
            pos=jnp.stack([s.pos for s in systems]),
            vel=jnp.stack([s.vel for s in systems]),
            mass=jnp.stack([s.mass for s in systems]))
        if args.trajectory:
            from mini_nbody_tpu.sim import trajectory_ensemble

            every = args.save_every or 1
            out_b, hist = trajectory_ensemble(cfg, batched, save_every=every)
            # (S, B, N, 3) history, one .npz shared with the single-system
            # dump format (pos_history just gains the batch axis).
            np.savez(args.trajectory, pos_history=np.asarray(hist),
                     save_every=every, dt=cfg.dt)
        else:
            out_b = simulate_ensemble(cfg, batched)
        jax.block_until_ready(out_b.pos)
        wall = time.perf_counter() - t0
        print(json.dumps({
            "n": cfg.n, "steps": cfg.steps, "ensemble": b,
            "wall_s": round(wall, 3),
            "momentum_max_abs": float(
                np.abs(np.asarray(out_b.vel * out_b.mass[..., None])
                       .sum(axis=1)).max()),
        }))
        return
    if args.resume:
        state, start_step, cfg_dict = ckpt.load(args.resume)
        print(f"resumed from {args.resume} at step {start_step}", file=sys.stderr)
    else:
        state, start_step = _state(args, cfg), 0

    t0 = time.perf_counter()
    if args.trajectory:
        # Stacked position history every --save-every steps (the analog of
        # the reference host reading the force buffer back after each
        # pass) — single-chip or mesh-sharded.
        every = args.save_every or 1
        if cfg.mesh_shape:
            from mini_nbody_tpu.parallel import make_mesh, trajectory_sharded

            out, hist = trajectory_sharded(
                cfg, make_mesh(cfg.mesh_shape), state, save_every=every)
        else:
            from mini_nbody_tpu.sim import trajectory

            out, hist = trajectory(cfg, state, cfg.steps, save_every=every)
        np.savez(args.trajectory, pos_history=np.asarray(hist),
                 save_every=every, dt=cfg.dt)
    elif cfg.mesh_shape:
        from mini_nbody_tpu.parallel import make_mesh, simulate_sharded

        mesh = make_mesh(cfg.mesh_shape)
        out = simulate_sharded(cfg, mesh, state)
    elif args.save and args.save_every:
        # Periodic checkpointing: the analog of the reference's implicit
        # state persistence between force passes (src/top_level.vhd:180-186),
        # with crash recovery the reference never had.
        from mini_nbody_tpu.ops.diagnostics import assert_finite

        out = state
        done = 0
        while done < cfg.steps:
            k = min(args.save_every, cfg.steps - done)
            out = simulate(cfg, out, steps=k)
            done += k
            assert_finite(out, f"at step {start_step + done}")
            ckpt.save(args.save, out, step=start_step + done, cfg=cfg)
    else:
        out = simulate(cfg, state)
    jax.block_until_ready(out.pos)
    wall = time.perf_counter() - t0

    report = {
        "n": cfg.n, "steps": cfg.steps, "wall_s": round(wall, 3),
        "momentum": [float(x) for x in np.asarray(diag.momentum(out))],
    }
    if args.energy:
        report["energy"] = float(diag.total_energy(out, cfg.softening))
    if args.trajectory:
        report["trajectory"] = args.trajectory
    if args.save:
        written = ckpt.save(args.save, out, step=start_step + cfg.steps,
                            cfg=cfg)
        report["checkpoint"] = str(written)
    print(json.dumps(report))


def cmd_bench(args):
    import jax
    from mini_nbody_tpu.sim import init_carry, make_step_fn
    from mini_nbody_tpu.utils.harness import Throughput, time_step_fn

    cfg = _build(args)
    state = _state(args, cfg)
    if cfg.mesh_shape:
        from mini_nbody_tpu.parallel import make_mesh, shard_state
        from mini_nbody_tpu.parallel.sharded import (
            init_sharded_carry, make_sharded_step_fn)

        mesh = make_mesh(cfg.mesh_shape)
        # pad_far like simulate_sharded: unit-mass kernels ignore zero pad
        # masses, so origin pads would exert real forces
        state = shard_state(state, mesh, pad_far=not cfg.use_masses)
        step = make_sharded_step_fn(cfg, mesh)
        carry = init_sharded_carry(cfg, mesh, state)
        ndev = mesh.devices.size
    else:
        step = make_step_fn(cfg)
        carry = init_carry(cfg, state)
        ndev = 1
    sec = time_step_fn(step, carry, reps=args.reps)
    t = Throughput(n=cfg.n, steps=1, seconds=sec, n_devices=ndev)
    dev = jax.devices()[0]
    print(json.dumps({
        "platform": dev.platform,
        "device": dev.device_kind,
        "backend": cfg.resolve_backend(),
        **t.report(),
    }))


def cmd_shmoo(args):
    from mini_nbody_tpu.utils import shmoo

    cfg = _build(args)
    ns = [int(x) for x in args.sizes.split(",")]
    mesh = None
    if cfg.mesh_shape:
        from mini_nbody_tpu.parallel import make_mesh

        mesh = make_mesh(cfg.mesh_shape)
    rows = shmoo.sweep(cfg, ns, reps=args.reps, mesh=mesh)
    out = shmoo.to_csv(rows) if args.format == "csv" else shmoo.to_jsonl(rows)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out)
        print(f"wrote {args.out}", file=sys.stderr)
    else:
        print(out)


def cmd_check(args):
    from mini_nbody_tpu.ops.force import make_force_fn
    from mini_nbody_tpu.ops import diagnostics as diag
    from mini_nbody_tpu.sim import simulate

    cfg = _build(args)
    state = _state(args, cfg)

    # 1. Force error vs the fp64 oracle — the native C++/OpenMP one when it
    # builds (handles large N), the NumPy one otherwise (capped subset).
    from mini_nbody_tpu import native

    if native.available():
        n_chk = min(cfg.n, 131072)
        f64 = native.body_force_oracle(
            np.asarray(state.pos[:n_chk]), np.asarray(state.pos[:n_chk]),
            np.asarray(state.mass[:n_chk]), softening=cfg.softening,
        )
    else:
        n_chk = min(cfg.n, 8192)
        pos = np.asarray(state.pos[:n_chk], np.float64)
        mass = np.asarray(state.mass[:n_chk], np.float64)
        d = pos[None, :, :] - pos[:, None, :]
        r2 = (d * d).sum(-1) + cfg.softening
        f64 = (d * ((r2 ** -1.5) * mass[None, :])[:, :, None]).sum(1)
    force = make_force_fn(cfg)
    pos_chk = state.pos[:n_chk]
    f = np.asarray(force(pos_chk, pos_chk, state.mass[:n_chk]))
    scale = np.abs(f64).max()
    err = np.abs(f - f64)
    ferr = err.max() / scale
    fmed = float(np.median(err) / scale)

    # 2. Conservation over the run (chunked-jnp potential; bounded N).
    e0 = (float(diag.total_energy(state, cfg.softening))
          if cfg.n <= 1 << 21 else None)
    p0 = np.asarray(diag.momentum(state))
    out = simulate(cfg, state)
    p1 = np.asarray(diag.momentum(out))

    ok = ferr < args.force_tol
    report = {
        "backend": cfg.resolve_backend(),
        "force_max_rel_err": float(ferr),
        "force_median_rel_err": fmed,
        "momentum_drift": float(np.abs(p1 - p0).max()),
    }
    if e0 is not None:
        e1 = float(diag.total_energy(out, cfg.softening))
        report["energy_drift"] = abs(e1 - e0) / abs(e0)
    report["ok"] = bool(ok)
    print(json.dumps(report))
    sys.exit(0 if ok else 1)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="nbody-tpu", description="N-body engine (JAX/XLA/Pallas)"
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="integrate a system")
    _add_common(p)
    p.add_argument("--save", help="checkpoint path (npz)")
    p.add_argument("--save-every", type=int, default=0,
                   help="checkpoint every K steps (with --save), or "
                        "snapshot stride (with --trajectory)")
    p.add_argument("--ensemble", type=int, default=0, metavar="B",
                   help="integrate B INDEPENDENT n-body systems batched in "
                        "one program (sim.simulate_ensemble)")
    p.add_argument("--trajectory",
                   help="write stacked position snapshots every "
                        "--save-every steps to this npz (works sharded "
                        "and with --ensemble; steps must divide evenly)")
    p.add_argument("--resume", help="resume from checkpoint")
    p.add_argument("--energy", action="store_true", help="report total energy")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("bench", help="time the step loop")
    _add_common(p)
    p.add_argument("--reps", type=int, default=3)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("shmoo", help="scaling sweep over N")
    _add_common(p)
    # Default sweep runs through the N=1M headline size.
    p.add_argument("--sizes", default="1024,4096,16384,65536,262144,1048576")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--format", choices=["csv", "jsonl"], default="csv")
    p.add_argument("--out", help="output file (default stdout)")
    p.set_defaults(fn=cmd_shmoo)

    p = sub.add_parser("check", help="numerics gate vs fp64 oracle")
    _add_common(p)
    p.add_argument("--force-tol", type=float, default=1e-4)
    p.set_defaults(fn=cmd_check)

    args = ap.parse_args(argv)
    from mini_nbody_tpu.utils.cache import setup_compile_cache

    setup_compile_cache()
    args.fn(args)


if __name__ == "__main__":
    main()
