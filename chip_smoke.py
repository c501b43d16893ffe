"""Smoke test of the N-body engine on one CUDA GPU (or four, with --four).

Run from the repository root:

    python chip_smoke.py            # phases (a)-(f) on one card
    python chip_smoke.py --four     # the sharded path on four cards only

It drives the system the way a user does (``simulate``, ``trajectory``,
``simulate_ensemble``, ``make_rollout_fn``, the sharded step) at the widths
of BASELINE.json's configurations, with every kernel compiled for the card
(no interpreter), and checks each result against the repository's fp64
NumPy oracle or its plain jnp path:

  (a) forces at N=65,536 and N=1,048,576 (unit and Plummer masses) for
      every force path, against the fp64 oracle on a subset of receivers;
      memory_analysis() of the N=1M step and of the plain step at a ragged N
  (b) config 1: N=4096, 10 Euler steps, dt=0.01, against fp64 Euler, and
      trajectory()'s last snapshot against simulate()
  (c) config 3: N=262,144, 1,000 leapfrog steps, relative energy drift
  (d) configs 2/4: one timed simulate window at N=65,536 and N=1M
  (e) simulate_ensemble, B=64 x N=1024, against per-system simulate
  (f) make_rollout_fn(remat="sqrt") against remat="none" at N=4096, and the
      Pallas VJP against the plain VJP at N=65,536

It exits non-zero, printing no result, when JAX finds no GPU; any failed
phase makes the exit code non-zero. The last line of standard output is one
JSON object naming the device as JAX reports it.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback

import numpy as np

#: Relative force gate: max|dF| / max|F_fp64| (fp32 arithmetic, no matrix
#: product anywhere in the force, so no TF32).
FORCE_TOL = 1e-5
#: Relative energy drift gate of config 3 over 1,000 leapfrog steps
#: (BASELINE.json).
DRIFT_TOL = 1e-5


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _rel(got, ref) -> float:
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / max(np.abs(ref).max(), 1e-30))


def _system(kind: str, n: int, seed: int):
    import jax

    from mini_nbody_tpu.models import init

    make = init.plummer if kind == "plummer" else init.uniform_random
    return make(jax.random.key(seed), n)


def phase_force(n: int, rows: int, backends, interpret: bool = False,
                seed: int = 0) -> dict:
    """Forces of every backend against the fp64 oracle on ``rows``
    receivers, for unit masses (uniform cloud) and Plummer masses."""
    import jax

    from mini_nbody_tpu.native import numpy_body_force
    from mini_nbody_tpu.ops.force import body_force

    res = {"n": n, "rows": rows, "tol": FORCE_TOL}
    ok = True
    for kind in ("unit", "plummer"):
        s = _system(kind, n, seed)
        m = None if kind == "unit" else s.mass
        ref = numpy_body_force(np.asarray(s.pos[:rows]), np.asarray(s.pos),
                               None if m is None else np.asarray(m))
        for be in backends:
            f = body_force(s.pos, s.pos, m, backend=be, interpret=interpret)
            err = _rel(jax.device_get(f[:rows]), ref)
            res[f"{kind}_{be}"] = err
            ok &= err <= FORCE_TOL
    res["ok"] = bool(ok)
    return res


def _memory(cfg, n: int, seed: int = 0) -> dict:
    """memory_analysis() of the compiled one-step simulate program."""
    from mini_nbody_tpu import sim

    s = _system("unit", n, seed)
    compiled = sim._simulate_scan.lower(cfg, sim.init_carry(cfg, s),
                                        1).compile()
    ma = compiled.memory_analysis()
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes")
    return {k: int(getattr(ma, k)) for k in keys if hasattr(ma, k)}


def phase_memory(n: int, ragged_n: int, backend: str,
                 interpret: bool = False) -> dict:
    """Step memory at N (configured backend) and of the plain jnp step at a
    ragged N, whose pair block must stay chunked: temp bytes within a few
    row chunks (ops/reference.PAIR_BUDGET pairs each), not an (N, N) block."""
    from mini_nbody_tpu import SimConfig
    from mini_nbody_tpu.ops.reference import PAIR_BUDGET

    main = _memory(SimConfig(n=n, backend=backend, interpret=interpret), n)
    ragged = _memory(SimConfig(n=ragged_n, backend="jnp"), ragged_n)
    bound = 32 * PAIR_BUDGET
    return {"n": n, "step": main, "ragged_n": ragged_n,
            "ragged_jnp_step": ragged,
            "ragged_temp_bound": bound,
            "ok": ragged.get("temp_size_in_bytes", 0) < bound}


def phase_euler(n: int = 4096, steps: int = 10, backend: str = "auto",
                interpret: bool = False, seed: int = 0) -> dict:
    """BASELINE config 1 against a NumPy fp64 Euler run. At the reference
    softening (1e-9) close encounters amplify fp32-vs-fp64 force noise
    chaotically within a few steps (tests/test_native_oracle.py), so the gate
    is on the median position error, with the max reported. trajectory()
    runs the same steps and its last snapshot must match simulate()'s."""
    from mini_nbody_tpu import SimConfig, simulate
    from mini_nbody_tpu.native import numpy_euler_steps
    from mini_nbody_tpu.sim import trajectory

    s = _system("unit", n, seed)
    cfg = SimConfig(n=n, dt=0.01, steps=steps, backend=backend,
                    interpret=interpret)
    out = simulate(cfg, s)
    _, hist = trajectory(cfg, s, steps, save_every=1)
    traj_rel = _rel(hist[-1], out.pos)
    p64, _ = numpy_euler_steps(np.asarray(s.pos), np.asarray(s.vel),
                               dt=0.01, steps=steps)
    err = np.abs(np.asarray(out.pos, np.float64) - p64)
    scale = float(np.abs(p64).max())
    med, mx = float(np.median(err) / scale), float(err.max() / scale)
    tol = 1e-5
    finite = bool(np.isfinite(err).all())
    return {"n": n, "steps": steps, "median_rel": med, "max_rel": mx,
            "median_tol": tol, "finite": finite,
            "trajectory_rel": traj_rel, "trajectory_tol": FORCE_TOL,
            "ok": finite and med <= tol and traj_rel <= FORCE_TOL}


def phase_drift(n: int = 262144, steps: int = 1000, backend: str = "auto",
                interpret: bool = False, seed: int = 0) -> dict:
    """BASELINE config 3: Plummer, softening 1e-2, dt 1e-3, leapfrog."""
    import jax

    from mini_nbody_tpu import SimConfig, simulate
    from mini_nbody_tpu.ops import diagnostics as diag

    s = _system("plummer", n, seed)
    cfg = SimConfig(n=n, dt=1e-3, steps=steps, softening=1e-2,
                    integrator="leapfrog", use_masses=True, backend=backend,
                    interpret=interpret)
    e0 = float(diag.total_energy(s, cfg.softening))
    t0 = time.perf_counter()
    out = simulate(cfg, s)
    jax.block_until_ready(out.pos)
    wall = time.perf_counter() - t0
    e1 = float(diag.total_energy(out, cfg.softening))
    drift = abs(e1 - e0) / abs(e0)
    return {"n": n, "steps": steps, "drift": drift, "tol": DRIFT_TOL,
            "wall_s_incl_compile": wall, "ok": drift <= DRIFT_TOL}


def phase_timing(n: int, steps: int, backend: str = "auto",
                 interpret: bool = False, reps: int = 2) -> dict:
    """One timed simulate window: the first call (compile + run) apart from
    the median of `reps` warm calls."""
    import jax

    from mini_nbody_tpu import SimConfig, simulate

    s = _system("unit", n, 0)
    cfg = SimConfig(n=n, dt=0.01, steps=steps, backend=backend,
                    interpret=interpret)

    def run():
        t0 = time.perf_counter()
        out = simulate(cfg, s)
        jax.block_until_ready(out.pos)
        return time.perf_counter() - t0, out

    first, _ = run()
    warm = []
    for _ in range(reps):
        sec, out = run()
        warm.append(sec)
    sec = float(np.median(warm))
    ok = bool(np.isfinite(np.asarray(out.pos)).all())
    return {"n": n, "steps": steps, "backend": cfg.resolve_backend(),
            "first_call_s": first, "compile_s_est": first - sec,
            "window_s": sec, "step_s": sec / steps,
            "ginteractions_per_s": float(n) * n * steps / sec / 1e9,
            "ok": ok}


def phase_ensemble(b: int = 64, n: int = 1024, steps: int = 10,
                   backend: str = "auto", interpret: bool = False) -> dict:
    """simulate_ensemble against per-system simulate. 'auto' resolves on
    the bodies of one force call, so the batch and a single system may run
    different paths: agreement is to fp32 rounding."""
    import jax
    import jax.numpy as jnp

    from mini_nbody_tpu import SimConfig, simulate, simulate_ensemble
    from mini_nbody_tpu.models.state import BodyState

    cfg = SimConfig(n=n, dt=1e-3, steps=steps, softening=1e-2,
                    integrator="leapfrog", use_masses=True, backend=backend,
                    interpret=interpret)
    ss = [_system("plummer", n, 100 + i) for i in range(b)]
    st = BodyState(pos=jnp.stack([s.pos for s in ss]),
                   vel=jnp.stack([s.vel for s in ss]),
                   mass=jnp.stack([s.mass for s in ss]))
    out = jax.device_get(simulate_ensemble(cfg, st).pos)
    ref = np.stack([np.asarray(simulate(cfg, s).pos) for s in ss])
    err = _rel(out, ref)
    tol = 1e-5
    return {"b": b, "n": n, "steps": steps, "max_rel": err, "tol": tol,
            "ok": err <= tol}


def phase_gradient(n: int = 4096, steps: int = 100, vjp_n: int = 65536,
                   backend: str = "auto", interpret: bool = False) -> dict:
    """Checkpointed rollout gradients against the plain scan's, and the
    configured backend's VJP against the plain jnp VJP."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from mini_nbody_tpu import SimConfig
    from mini_nbody_tpu.ops.autodiff import vjp_jnp, vjp_terms
    from mini_nbody_tpu.sim import init_carry, make_rollout_fn

    cfg = SimConfig(n=n, dt=1e-3, steps=steps, softening=1e-2,
                    integrator="leapfrog", use_masses=True, backend=backend,
                    interpret=interpret)
    s = _system("plummer", n, 7)
    carry0 = init_carry(cfg, s)

    def grad(remat):
        roll = make_rollout_fn(cfg, steps, remat=remat)

        def loss(p):
            out, _ = roll((dataclasses.replace(carry0[0], pos=p), carry0[1]))
            return jnp.sum(out.vel ** 2)  # velocities carry the force VJP

        return np.asarray(jax.jit(jax.grad(loss))(s.pos))

    remat_err = _rel(grad("sqrt"), grad("none"))

    v = _system("plummer", vjp_n, 8)
    g = jax.random.normal(jax.random.key(9), (vjp_n, 3), jnp.float32)
    args = (v.pos, g, v.mass, v.pos, g, v.mass)
    ref = np.asarray(vjp_jnp(*args, softening=1e-2))
    got = np.asarray(vjp_terms(cfg.resolve_backend(), *args, softening=1e-2,
                               interpret=interpret))
    vjp_err = _rel(got, ref)
    remat_tol, vjp_tol = 1e-5, 1e-4
    return {"n": n, "steps": steps, "remat_rel": remat_err,
            "remat_tol": remat_tol, "vjp_n": vjp_n,
            "vjp_backend": cfg.resolve_backend(), "vjp_rel": vjp_err,
            "vjp_tol": vjp_tol,
            "ok": remat_err <= remat_tol and vjp_err <= vjp_tol}


def phase_sharded(n: int, rows: int, mesh_1d, mesh_2d, backend: str = "auto",
                  interpret: bool = False) -> dict:
    """Forces of every exchange (all_gather, ring, ring_sym, grid) and the
    gradient of one differentiable ring step, each against the single-device
    result on a subset of rows."""
    import dataclasses

    import jax
    import jax.numpy as jnp

    from mini_nbody_tpu import SimConfig
    from mini_nbody_tpu.ops.force import body_force
    from mini_nbody_tpu.parallel.sharded import (
        _state_specs, make_sharded_step_fn, shard_state, sharded_force)
    from mini_nbody_tpu.sim import make_step_fn

    s = _system("plummer", n, 11)
    base = SimConfig(n=n, dt=1e-3, softening=1e-2, use_masses=True,
                     backend=backend, interpret=interpret)
    be = base.resolve_backend()
    ref = np.asarray(body_force(s.pos[:rows], s.pos, s.mass,
                                softening=1e-2, backend=be,
                                interpret=interpret))
    res = {"n": n, "rows": rows, "backend": be, "tol": FORCE_TOL}
    ok = True
    for comm, mesh in (("all_gather", mesh_1d), ("ring", mesh_1d),
                       ("ring_sym", mesh_1d), ("grid", mesh_2d)):
        cfg = base.replace(comm=comm, mesh_shape=mesh.devices.shape)
        st = shard_state(s, mesh)
        f = jax.device_get(sharded_force(cfg, mesh, st)[:rows])
        err = _rel(f, ref)
        res[comm] = err
        ok &= err <= FORCE_TOL

    # one differentiable ring step vs the single-device differentiable step
    cfg = base.replace(comm="ring", mesh_shape=mesh_1d.devices.shape)
    zero = jnp.zeros_like(s.pos)
    step1 = make_step_fn(base, differentiable=True)
    stepp = make_sharded_step_fn(cfg, mesh_1d, differentiable=True)
    specs = _state_specs(mesh_1d)

    def loss(step, constrain, p):
        st = dataclasses.replace(s, pos=p)
        if constrain:
            st = jax.tree_util.tree_map(
                lambda x, sp: jax.lax.with_sharding_constraint(
                    x, jax.sharding.NamedSharding(mesh_1d, sp)), st, specs)
        out, _ = step((st, zero))
        # vel' = vel + dt F: the gradient is dt (dF/dp)^T 2 vel', all VJP
        return jnp.sum(out.vel ** 2)

    g1 = np.asarray(jax.jit(jax.grad(lambda p: loss(step1, False, p)))(s.pos))
    gp = np.asarray(jax.jit(jax.grad(lambda p: loss(stepp, True, p)))(s.pos))
    grad_err = _rel(gp, g1)
    res["ring_grad"] = grad_err
    res["grad_tol"] = 1e-4
    res["ok"] = bool(ok and grad_err <= 1e-4)
    return res


def _report(name: str, fn, results: dict) -> None:
    t0 = time.perf_counter()
    try:
        r = fn()
    except Exception:  # reported and counted as a failed phase
        traceback.print_exc()
        r = {"ok": False, "error": traceback.format_exc(limit=1)[-500:]}
    r["phase_s"] = time.perf_counter() - t0
    results[name] = r
    print(f"phase {name}: {'PASS' if r['ok'] else 'FAIL'} "
          + json.dumps(r, default=str), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU: JAX found {devices[0].platform!r} devices",
              file=sys.stderr)
        return 2
    want = 4 if args.four else 1
    if len(devices) < want:
        print(f"needs {want} GPUs, found {len(devices)}", file=sys.stderr)
        return 2

    from mini_nbody_tpu.utils.cache import setup_compile_cache

    cache = setup_compile_cache()
    card = card_line()
    kind = devices[0].device_kind
    print(f"card: {card}", flush=True)
    print(f"jax {jax.__version__}; device_kind {kind!r}; "
          f"{len(devices)} device(s); compile cache {cache}", flush=True)

    results: dict = {}
    if args.four:
        from mini_nbody_tpu.parallel import make_mesh

        _report("four_sharded", lambda: phase_sharded(
            1 << 20, 1024, make_mesh(4), make_mesh((2, 2))), results)
    else:
        _report("a_force_65536", lambda: phase_force(
            65536, 1024, ("jnp", "pallas")), results)
        _report("a_force_1m", lambda: phase_force(
            1 << 20, 256, ("jnp", "pallas")), results)
        _report("a_memory", lambda: phase_memory(
            1 << 20, (1 << 20) - 3, "auto"), results)
        _report("b_config1_euler", phase_euler, results)
        _report("c_config3_drift", phase_drift, results)
        for n, steps in ((65536, 20), (1 << 20, 2)):
            _report(f"d_timing_{n}", lambda n=n, steps=steps: {
                **phase_timing(n, steps), "card": card}, results)
        _report("e_ensemble", phase_ensemble, results)
        _report("f_gradient", phase_gradient, results)

    failed = [k for k, r in results.items() if not r["ok"]]
    if failed:
        print(f"FAILED phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
