"""Physics diagnostics: energy, momentum, angular momentum.

The reference has no numerical-correctness checking at all — its testbenches
verify handshake protocol only ("Do not check the output payload values",
``sim/tb_dxy.vhd:899-923``). These diagnostics are the replacement: invariants
a correct force kernel + symplectic integrator must (approximately) conserve,
used by the test suite and the ``--check`` harness mode.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from mini_nbody_tpu.models.state import BodyState
from mini_nbody_tpu.utils.config import SOFTENING


@partial(jax.jit, static_argnames=("softening", "row_chunk"))
def potential_energy(pos, mass, softening: float = SOFTENING,
                     row_chunk: int | None = None):
    """U = -sum_{i<j} m_i m_j / sqrt(r_ij^2 + eps), matching the softened force
    law (the force here is exactly -grad of this potential). Processes i-rows
    in chunks so memory stays O(row_chunk * N) at any N."""
    n = pos.shape[0]
    if row_chunk is None:
        # Cap the (row_chunk, N) intermediate at ~64 MB.
        row_chunk = max(8, min(2048, (1 << 24) // max(n, 1)))
    soft = jnp.asarray(softening, pos.dtype)

    def row_block(args):
        pos_c, mass_c, idx_c = args
        dx, dy, dz = (pos[None, :, k] - pos_c[:, None, k] for k in range(3))
        r2 = dx * dx + dy * dy + dz * dz + soft  # (C, N)
        inv = jax.lax.rsqrt(r2)
        mm = mass_c[:, None] * mass[None, :]
        # exclude the diagonal (self term) by global index comparison
        cols = jnp.arange(n)[None, :]
        off_diag = (idx_c[:, None] != cols).astype(pos.dtype)
        # padded rows (idx >= n) contribute zero via mass_c = 0 padding
        return jnp.sum(mm * inv * off_diag)

    if n <= row_chunk:
        return -0.5 * row_block((pos, mass, jnp.arange(n)))

    n_pad = -(-n // row_chunk) * row_chunk
    pos_p = jnp.pad(pos, ((0, n_pad - n), (0, 0)))
    mass_p = jnp.pad(mass, (0, n_pad - n))  # zero-mass pad rows are inert
    idx = jnp.arange(n_pad)
    chunks = (
        pos_p.reshape(-1, row_chunk, 3),
        mass_p.reshape(-1, row_chunk),
        idx.reshape(-1, row_chunk),
    )
    partials = jax.lax.map(row_block, chunks)
    return -0.5 * jnp.sum(partials)


@jax.jit
def kinetic_energy(vel, mass):
    return 0.5 * jnp.sum(mass * jnp.sum(vel * vel, axis=-1))


def total_energy(state: BodyState, softening: float = SOFTENING):
    """Kinetic + potential (the chunked-jnp potential, O(N^2) pairs)."""
    ke = kinetic_energy(state.vel, state.mass)
    return ke + potential_energy(state.pos, state.mass, softening)


@jax.jit
def momentum(state: BodyState):
    return jnp.sum(state.mass[:, None] * state.vel, axis=0)


@jax.jit
def angular_momentum(state: BodyState):
    return jnp.sum(state.mass[:, None] * jnp.cross(state.pos, state.vel), axis=0)


def energy_drift(e0, e1):
    """Relative energy drift |E1 - E0| / |E0| (BASELINE gate: <= 1e-5 / 1k steps)."""
    return jnp.abs(e1 - e0) / jnp.abs(e0)


@jax.jit
def check_finite(state: BodyState):
    """NaN/overflow guard (the failure detection the reference lacks —
    SURVEY.md §5: its only flow control is busy flags with no error path).
    Returns a dict of booleans; cheap enough to run every K steps."""
    return {
        "pos_finite": jnp.isfinite(state.pos).all(),
        "vel_finite": jnp.isfinite(state.vel).all(),
        "pos_bounded": (jnp.abs(state.pos) < 1e30).all(),
    }


def assert_finite(state: BodyState, context: str = ""):
    """Host-side hard check; raises on NaN/Inf (fetches 3 scalars)."""
    flags = {k: bool(v) for k, v in check_finite(state).items()}
    if not all(flags.values()):
        raise FloatingPointError(f"non-finite body state {context}: {flags}")


def total_energy_ensemble(state: BodyState, softening: float = SOFTENING):
    """Per-system total energy (B,) for a batched ensemble state
    (pos/vel (B, N, 3), mass (B, N)) — the drift-gate diagnostic for
    sim.simulate_ensemble runs. lax.scan over systems keeps one system's
    chunked potential live at a time."""
    import jax as _jax
    import jax.numpy as _jnp

    def body(_, args):
        p, v, m = args
        e = total_energy(BodyState(pos=p, vel=v, mass=m), softening)
        return None, e

    _, es = _jax.lax.scan(body, None, (state.pos, state.vel, state.mass))
    return es


def momentum_ensemble(state: BodyState):
    """Per-system total momentum (B, 3) for a batched ensemble state."""
    import jax.numpy as _jnp

    return _jnp.sum(state.vel * state.mass[..., None], axis=1)
