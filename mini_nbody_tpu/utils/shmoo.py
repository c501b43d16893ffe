"""Shmoo sweep: scaling study over N (BASELINE.json config 5).

The analog of the upstream mini-nbody shmoo harness (and of reading the
reference's kilocycle counter per pass, ``src/top_level.vhd:146,255-263``):
sweep N, time the jitted step, report GInteractions/s + peak share, emit
CSV/JSON rows.
"""

from __future__ import annotations

import csv
import io
import json
from typing import List, Optional

import jax
import jax.numpy as jnp

from mini_nbody_tpu.models import init as minit
from mini_nbody_tpu.sim import make_step_fn
from mini_nbody_tpu.utils.config import SimConfig
from mini_nbody_tpu.utils.harness import Throughput, time_step_fn

FIELDS = ["n", "backend", "seconds", "ginteractions_per_s", "per_device",
          "gflops_20c", "fp32_peak_frac"]


def sweep(cfg: SimConfig, ns: List[int], reps: int = 3,
          mesh: Optional[object] = None) -> List[dict]:
    """Time one integration step per N in ns; returns report rows."""
    rows = []
    n_devices = 1 if mesh is None else mesh.devices.size
    for n in ns:
        c = cfg.replace(n=n)
        state = minit.uniform_random(jax.random.key(0), n)
        if mesh is None:
            step = make_step_fn(c)
            carry = (state, jnp.zeros_like(state.pos))
        else:
            from mini_nbody_tpu.parallel.sharded import (
                init_sharded_carry, make_sharded_step_fn, shard_state)

            state = shard_state(state, mesh, pad_far=not c.use_masses)
            step = make_sharded_step_fn(c, mesh)
            carry = init_sharded_carry(c, mesh, state)
        sec = time_step_fn(step, carry, reps=reps)
        t = Throughput(n=n, steps=1, seconds=sec, n_devices=n_devices)
        row = {"backend": c.resolve_backend(), **t.report()}
        row.pop("steps", None)
        rows.append(row)
    return rows


def to_csv(rows: List[dict]) -> str:
    buf = io.StringIO()
    w = csv.DictWriter(buf, fieldnames=FIELDS)
    w.writeheader()
    for r in rows:
        w.writerow({k: r.get(k) for k in FIELDS})
    return buf.getvalue()


def to_jsonl(rows: List[dict]) -> str:
    return "\n".join(json.dumps(r) for r in rows)
