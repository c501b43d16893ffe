"""Vectorized jnp force ops — the correctness anchor and the plain path XLA
compiles on every platform.

Physics is exactly the reference inner loop (``src/dxy.vhd:94-122``,
``src/dzsoft.vhd:186-202``, ``src/fxyz.vhd:101-127``):

    dx = x_j - x_i; ...
    distSqr = dx^2 + dy^2 + dz^2 + SOFTENING
    invDist3 = rsqrt(distSqr)^3
    F_i += m_j * d * invDist3        (m_j == 1 in the reference)

Self-interaction (j == i) is computed, not skipped: d = 0 so the contribution
is exactly zero and the softening keeps rsqrt finite (SURVEY.md §0).

The op is rectangular — forces on ``pos_i`` due to sources ``(pos_j, mass_j)``
— so the same function serves single-device (i == j) and sharded use (local
i-shard against gathered/ring-passed j-shards).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from mini_nbody_tpu.utils.config import SOFTENING

#: Pair-block budget of the chunked paths: rows per chunk are chosen so a
#: (rows, Nj) fp32 intermediate stays near 256 MB.
PAIR_BUDGET = 1 << 26


def auto_row_chunk(nj: int, budget: int = PAIR_BUDGET) -> int:
    """Receiver rows per chunk that keep a (rows, nj) block within budget."""
    return max(8, budget // max(nj, 1))


def map_row_chunks(fn, row_chunk: int, *rows):
    """Apply ``fn`` to chunks of ``row_chunk`` leading rows of every array in
    ``rows`` and stitch the results back together.

    A ragged last chunk is zero-padded (padding rows are sliced off again),
    so the (rows, Nj) intermediate stays bounded at any N."""
    n = rows[0].shape[0]
    if row_chunk >= n:
        return fn(*rows)
    n_pad = -(-n // row_chunk) * row_chunk
    padded = [jnp.pad(r, ((0, n_pad - n),) + ((0, 0),) * (r.ndim - 1))
              for r in rows]
    chunks = [r.reshape((-1, row_chunk) + r.shape[1:]) for r in padded]
    out = jax.lax.map(lambda c: fn(*c), chunks)
    return jax.tree_util.tree_map(
        lambda o: o.reshape((n_pad,) + o.shape[2:])[:n], out)


def _diffs(pos_i, pos_j):
    """Per-axis (Ni, Nj) displacements p_j - p_i. One 2-D array per axis
    keeps every reduction on the minor axis, the layout XLA's GPU reduction
    emitter handles well (a trailing axis of 3 compiled very slowly there)."""
    return [pos_j[None, :, k] - pos_i[:, None, k] for k in range(3)]


def _force_block(pos_i, pos_j, mass_j, softening):
    """(Ni,3) x (Nj,3) -> (Ni,3) forces, materializing the (Ni,Nj) pair block."""
    dx, dy, dz = _diffs(pos_i, pos_j)
    dist_sqr = dx * dx + dy * dy + dz * dz + jnp.asarray(softening, dx.dtype)
    inv = jax.lax.rsqrt(dist_sqr)
    w = inv * inv * inv * mass_j[None, :]
    return jnp.stack([jnp.sum(d * w, axis=1) for d in (dx, dy, dz)], axis=-1)


@partial(jax.jit, static_argnames=("softening", "row_chunk"))
def body_force_jnp(pos_i, pos_j, mass_j=None, softening: float = SOFTENING,
                   row_chunk: int | None = None):
    """All-pairs softened gravity, pure jnp (XLA fuses; no Pallas).

    Args:
      pos_i: (Ni, 3) positions receiving force.
      pos_j: (Nj, 3) source positions.
      mass_j: (Nj,) source masses; None = unit masses (reference semantics).
      softening: Plummer softening added to each pair distance^2.
      row_chunk: if set, process i-rows in chunks of this size via lax.map to
        bound the (Ni, Nj) intermediate's memory (O(row_chunk * Nj)); any Ni
        works, a ragged last chunk is padded.

    Returns:
      (Ni, 3) forces (accelerations for unit masses).
    """
    if mass_j is None:
        mass_j = jnp.ones((pos_j.shape[0],), pos_j.dtype)
    if row_chunk is None:
        return _force_block(pos_i, pos_j, mass_j, softening)
    return map_row_chunks(
        lambda c: _force_block(c, pos_j, mass_j, softening), row_chunk, pos_i)


@partial(jax.jit, static_argnames=("softening", "row_chunk"))
def body_force_pair_jnp(pos_a, pos_b, mass_a=None, mass_b=None,
                        softening: float = SOFTENING,
                        row_chunk: int | None = None):
    """Both directions of the a<->b interaction from ONE weight block.

    Returns (F_a, F_b): forces on a from (pos_b, mass_b) and on b from
    (pos_a, mass_a). Each unordered pair's weight rsqrt(r2)^3 is computed
    once and used for the row sum and, with the opposite sign, for the
    reaction — Newton's third law, the arithmetic half of the each-pair-once
    schedule that comm='ring_sym' runs across shards. Masses: both or
    neither (None = unit).
    Rows of a are chunked (row_chunk; default auto-sized) with the b-side
    reactions summed across chunks.
    """
    if (mass_a is None) != (mass_b is None):
        raise ValueError("pass both masses or neither (unit masses)")
    f32 = jnp.float32
    pos_a, pos_b = pos_a.astype(f32), pos_b.astype(f32)
    na, nb = pos_a.shape[0], pos_b.shape[0]
    ma = jnp.ones((na,), f32) if mass_a is None else mass_a.astype(f32)
    mb = jnp.ones((nb,), f32) if mass_b is None else mass_b.astype(f32)
    soft = jnp.asarray(softening, f32)
    chunk = row_chunk or auto_row_chunk(nb)

    def block(pa, m_a):
        d = _diffs(pa, pos_b)  # p_b - p_a, (C, Nb) per axis
        inv = jax.lax.rsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2] + soft)
        w = inv * inv * inv
        wa, wb = w * mb[None, :], w * m_a[:, None]
        fa = jnp.stack([jnp.sum(dk * wa, axis=1) for dk in d], axis=-1)
        fb = -jnp.stack([jnp.sum(dk * wb, axis=0) for dk in d], axis=-1)
        return fa, fb

    if chunk >= na:
        return block(pos_a, ma)
    n_pad = -(-na // chunk) * chunk
    # zero-mass pad rows exert no reaction; their own rows are sliced off
    pa = jnp.pad(pos_a, ((0, n_pad - na), (0, 0))).reshape(-1, chunk, 3)
    m_a = jnp.pad(ma, (0, n_pad - na)).reshape(-1, chunk)

    def step(fb, c):
        fa_c, fb_c = block(*c)
        return fb + fb_c, fa_c

    fb, fa = jax.lax.scan(step, jnp.zeros((nb, 3), f32), (pa, m_a))
    return fa.reshape(n_pad, 3)[:na], fb
