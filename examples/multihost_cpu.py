"""Two-process jax.distributed run on localhost CPUs.

The reference is strictly single-chip (SURVEY.md §2 item 6); BASELINE
config 5's multi-host axis needs several hosts, so this demo exercises the
REAL multi-process runtime path — coordinator handshake, global device
list, cross-process collectives — with the CPU
backend and gloo collectives on localhost:

  * each worker process calls parallel.multihost.initialize() (the same
    wrapper a multi-host GPU run would use, the network replaced by
    localhost TCP),
  * builds the global 1-D body mesh spanning both processes' devices
    (parallel.multihost.global_mesh),
  * runs a sharded trajectory (parallel.sharded.make_sharded_step_fn with
    comm='ring_sym') whose every ppermute hop crosses the process boundary,
  * verifies the gathered result against a local single-device run.

Run: python examples/multihost_cpu.py            (spawns 2 workers)
     python examples/multihost_cpu.py --procs 4  (4 workers)
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = 96
STEPS = 3


def worker(process_id: int, num_processes: int, port: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    from mini_nbody_tpu.parallel import multihost

    active = multihost.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=num_processes,
        process_id=process_id,
    )
    assert active and jax.process_count() == num_processes

    import numpy as np

    from mini_nbody_tpu import SimConfig, init, simulate
    from mini_nbody_tpu.parallel.sharded import simulate_sharded

    mesh = multihost.global_mesh()
    assert mesh.devices.size >= num_processes

    cfg = SimConfig(n=N, dt=1e-3, steps=STEPS, softening=1e-2,
                    backend="jnp", comm="ring_sym", use_masses=True)
    state = init.plummer(jax.random.key(0), N)  # identical on every process

    final = simulate_sharded(cfg, mesh, state)

    # Gather the sharded result to every process and check against a local
    # single-device trajectory (the correctness anchor).
    from jax.experimental import multihost_utils

    pos = np.asarray(multihost_utils.process_allgather(final.pos, tiled=True))
    ref = simulate(cfg.replace(mesh_shape=None, comm="all_gather"), state)
    scale = np.abs(np.asarray(ref.pos)).max()
    err = np.abs(pos - np.asarray(ref.pos)).max() / scale
    assert err < 1e-5, f"process {process_id}: err {err}"
    if multihost.is_primary():
        print(f"multihost OK: {num_processes} processes, "
              f"{mesh.devices.size} devices, {STEPS} sharded steps, "
              f"max err {err:.2e}")


def main(num_processes: int = 2) -> int:
    with socket.socket() as s:  # free localhost port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(i), "--procs", str(num_processes),
             "--port", str(port)],
            env=env, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for i in range(num_processes)
    ]
    # Inner timeout strictly below the gating test's 280 s subprocess
    # timeout, and any hang/raise kills EVERY surviving worker — a single
    # stuck process must not orphan the rest.
    try:
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            if p.poll() is None:
                p.wait(timeout=10)
    if any(rcs):
        raise SystemExit(f"worker exit codes {rcs}")
    return 0


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    if args.worker is None:
        sys.exit(main(args.procs))
    worker(args.worker, args.procs, args.port)
