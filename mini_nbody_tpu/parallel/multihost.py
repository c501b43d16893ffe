"""Multi-host initialization (the network across hosts, NVLink within).

The reference is strictly single-chip; scale-out across hosts is new work
(SURVEY.md §2 item 6). JAX's runtime handles the transport: after
``jax.distributed.initialize`` every host sees the global device list, and
the same 1-D body mesh (parallel.mesh) spans all hosts — XLA hands the
collectives to NCCL, which uses NVLink within a host and the network between
hosts.

This module is a thin, testable wrapper. The full multi-PROCESS runtime
path (coordinator handshake, global device list, cross-process collectives)
is exercised for real by examples/multihost_cpu.py: two+ localhost processes
with gloo CPU collectives run a ring_sym trajectory whose every ppermute hop
crosses the process boundary (gated by
tests/test_parallel.py::test_two_process_distributed_cpu). Without a
distributed env configured, initialize() no-ops gracefully.
"""

from __future__ import annotations

import os
from typing import Optional

import jax


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """Initialize jax.distributed if a multi-process env is configured.

    Returns True when distributed mode is active. Arguments default to the
    standard env vars (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
    JAX_PROCESS_ID) or cloud auto-detection; with none of those present this
    is a no-op returning False (single-process mode).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])

    if coordinator_address is None and num_processes is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh():
    """1-D body mesh over every device across all hosts."""
    from mini_nbody_tpu.parallel.mesh import make_mesh

    return make_mesh(devices=jax.devices())


def is_primary() -> bool:
    return jax.process_index() == 0
