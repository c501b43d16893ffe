"""Pallas kernels (Triton route) for the softened all-pairs force and its VJP.

The design is the CUDA ``nbody-block`` kernel (GPU Gems 3 ch. 31; BASELINE.md
"The CUDA-nbody number") written for one Pallas-Triton program:

* one program per block of ``tile_i`` receivers, whose coordinates stay in
  registers for the whole call (the analog of the reference FPGA's 12
  i-registers, ``src/top_level.vhd:83,206-229``);
* a ``lax.fori_loop`` inside the program walks the sources in tiles of
  ``tile_j`` bodies (the reference's one-target-per-cycle j-stream,
  ``src/top_level.vhd:233-254``);
* sources are packed SoA, one row per field (x, y, z, m), like the CUDA
  ``float4``; receivers are ``(tile_i, 4)`` blocks;
* the fp32 partial sums are ``(tile_i, tile_j)`` register tiles updated by
  FMAs and reduced over j once, after the loop, so the loop body carries no
  cross-thread reduction (the reference's rotating partial sums + final
  adder tree, ``src/fxyz.vhd:80-87,130-184``; ``src/final_adder.vhd``);
* tails are padded: unit-mass sources at FAR, where w underflows to exactly
  0, mass-mode sources with zero mass (the ``WRITE_MASK`` analog,
  ``src/top_level.vhd:201-205``); padded receivers are sliced off.

Math per pair (``src/dxy.vhd:94-122``, ``src/dzsoft.vhd:186-202``,
``src/fxyz.vhd:101-127``): d = p_j - p_i; r2 = |d|^2 + softening;
w = rsqrt(r2)^3 * m_j; F_i += w d. There is no matrix product, so TF32 never
enters and the result is fp32-exact class.

The VJP kernel runs on the same skeleton (``vjp_pallas``; the pair algebra
is in ops/autodiff.py's docstring).

Every call names the Triton route and its ``CompilerParams``. Off the GPU the
kernels run only when the caller passes ``interpret=True``; a compiled call
anywhere else raises.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from mini_nbody_tpu.utils.config import FAR, SOFTENING, round_up

#: Block sizes of both kernels, chosen by a sweep on an H100 (PERF.md).
TILE_I = 32
TILE_J = 32
NUM_WARPS = 4
NUM_STAGES = 1

#: Smallest block the wrappers shrink to for tiny N.
_MIN_TILE = 16

#: With the default receiver block, small N leaves the card's 132 SMs with
#: few programs, each walking all N sources alone: the block halves (down
#: to _MIN_TILE) until the grid has this many programs (measured on an
#: H100: 22-24% faster steps at N=4096-8192, equal at N=32768; PERF.md).
MIN_PROGRAMS = 1024


def check_device(interpret: bool) -> None:
    """Refuse a compiled call where the Triton route cannot compile."""
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "backend 'pallas' compiles for a CUDA GPU only (default backend "
            f"is {jax.default_backend()!r}); pass interpret=True to run the "
            "kernel in the Pallas interpreter")


def _tile(n: int, tile: int) -> int:
    """A power-of-two block no larger than n needs (Triton blocks are
    powers of two)."""
    if tile <= 0 or tile & (tile - 1):
        raise ValueError(f"block size must be a power of two, got {tile}")
    return min(tile, max(_MIN_TILE, pl.next_power_of_2(n)))


def _receiver_tile(n: int, tile_i: int | None) -> int:
    """The caller's receiver block, or (None) the default shrunk for small
    N so the grid keeps MIN_PROGRAMS programs."""
    if tile_i is not None:
        return _tile(n, tile_i)
    tile = _tile(n, TILE_I)
    while tile > _MIN_TILE and -(-n // tile) < MIN_PROGRAMS:
        tile //= 2
    return tile


def _pallas(kernel, recv, src, tile_i, num_warps, num_stages, interpret,
            name):
    """One program per receiver block; the whole source pack is visible to
    every program (the in-kernel loop slices it)."""
    ni_p, width = recv.shape
    return pl.pallas_call(
        kernel,
        grid=(ni_p // tile_i,),
        in_specs=[
            pl.BlockSpec((tile_i, width), lambda i: (i, 0)),
            pl.BlockSpec(src.shape, lambda i: (0, 0)),
        ],
        out_specs=pl.BlockSpec((tile_i, 4), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((ni_p, 4), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        interpret=interpret,
        name=name,
    )(recv, src)


def _force_kernel(recv_ref, src_ref, out_ref, *, softening, tile_j,
                  n_tiles, unit_mass):
    xi = recv_ref[:, 0][:, None]
    yi = recv_ref[:, 1][:, None]
    zi = recv_ref[:, 2][:, None]

    def body(t, acc):
        ax, ay, az = acc
        sl = pl.ds(t * tile_j, tile_j)
        dx = src_ref[0, sl][None, :] - xi
        dy = src_ref[1, sl][None, :] - yi
        dz = src_ref[2, sl][None, :] - zi
        inv = lax.rsqrt(dx * dx + dy * dy + (dz * dz + softening))
        w = inv * inv * inv
        if not unit_mass:
            w = w * src_ref[3, sl][None, :]
        return ax + w * dx, ay + w * dy, az + w * dz

    zero = jnp.zeros((xi.shape[0], tile_j), jnp.float32)
    ax, ay, az = lax.fori_loop(0, n_tiles, body, (zero, zero, zero))
    out_ref[:, 0] = jnp.sum(ax, axis=1)
    out_ref[:, 1] = jnp.sum(ay, axis=1)
    out_ref[:, 2] = jnp.sum(az, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("softening", "tile_i", "tile_j", "num_warps",
                     "num_stages", "interpret"),
)
def body_force_pallas(
    pos_i,
    pos_j,
    mass_j=None,
    softening: float = SOFTENING,
    tile_i: int | None = None,
    tile_j: int | None = None,
    num_warps: int = NUM_WARPS,
    num_stages: int = NUM_STAGES,
    interpret: bool = False,
):
    """Forces on pos_i (Ni,3) due to sources pos_j (Nj,3) with masses mass_j
    (None = unit masses, the reference semantics). Rectangular, so the same
    kernel serves single-device (pos_i is pos_j) and sharded calls. fp32 in
    and out, whatever the callers' dtype. tile_i None = TILE_I, shrunk for
    small N (_receiver_tile); tile_j None = TILE_J."""
    check_device(interpret)
    ni, nj = pos_i.shape[0], pos_j.shape[0]
    unit_mass = mass_j is None
    tile_i = _receiver_tile(ni, tile_i)
    tile_j = _tile(nj, tile_j or TILE_J)
    ni_p, nj_p = round_up(ni, tile_i), round_up(nj, tile_j)

    f32 = jnp.float32
    recv = jnp.pad(pos_i.astype(f32), ((0, ni_p - ni), (0, 1)))
    m = (jnp.ones((nj,), f32) if unit_mass else mass_j.astype(f32))
    src = jnp.concatenate([pos_j.astype(f32), m[:, None]], axis=1)
    if nj_p != nj:
        pad = jnp.zeros((nj_p - nj, 4), f32)
        if unit_mass:
            pad = pad.at[:, :3].set(FAR)
        src = jnp.concatenate([src, pad], axis=0)

    kernel = functools.partial(
        _force_kernel, softening=float(softening), tile_j=tile_j,
        n_tiles=nj_p // tile_j, unit_mass=unit_mass)
    out = _pallas(kernel, recv, src.T, tile_i, num_warps, num_stages,
                  interpret, "nbody_force")
    return out[:ni, :3]


def _vjp_kernel(recv_ref, src_ref, out_ref, *, softening, tile_j, n_tiles,
                recv_terms, src_terms, mass_grad):
    """pos_bar (and mass_bar) of receivers k against one source pack.

    Fields of both packs: x, y, z, m, gx, gy, gz, 0. With d = p_s - p_k,
    w = s^-3/2, u = s^-5/2 (zeroed where |d|^2 == 0):

      pos_bar_k = -g_k S + m_k T + 3 C,   mass_bar_k = -M
      S = sum m_s w          (receiver terms)
      T = sum w g_s          (source terms)
      C = sum u (m_s (g_k.d) [receiver] - m_k (g_s.d) [source]) d
      M = sum w (g_s.d)
    """
    cols = [recv_ref[:, c] for c in range(7)]  # (tile_i,) each
    xi, yi, zi, mi, gxi, gyi, gzi = (c[:, None] for c in cols)
    shape = (xi.shape[0], tile_j)

    def body(t, acc):
        acc = list(acc)
        sl = pl.ds(t * tile_j, tile_j)
        dx = src_ref[0, sl][None, :] - xi
        dy = src_ref[1, sl][None, :] - yi
        dz = src_ref[2, sl][None, :] - zi
        d2 = dx * dx + dy * dy + dz * dz
        inv = lax.rsqrt(d2 + softening)
        inv2 = inv * inv
        w = jnp.where(d2 == 0.0, 0.0, inv2 * inv)
        u = w * inv2
        k = 0
        c = jnp.zeros(shape, jnp.float32)
        if recv_terms:
            ms = src_ref[3, sl][None, :]
            acc[0] = acc[0] + ms * w
            c = ms * (gxi * dx + gyi * dy + gzi * dz)
            k = 1
        if src_terms or mass_grad:
            gxs = src_ref[4, sl][None, :]
            gys = src_ref[5, sl][None, :]
            gzs = src_ref[6, sl][None, :]
            gsd = gxs * dx + gys * dy + gzs * dz
        if src_terms:
            acc[k] = acc[k] + w * gxs
            acc[k + 1] = acc[k + 1] + w * gys
            acc[k + 2] = acc[k + 2] + w * gzs
            c = c - mi * gsd
            k += 3
        c = u * c
        acc[k] = acc[k] + c * dx
        acc[k + 1] = acc[k + 1] + c * dy
        acc[k + 2] = acc[k + 2] + c * dz
        if mass_grad:
            acc[k + 3] = acc[k + 3] + w * gsd
        return tuple(acc)

    n_acc = 3 + (1 if recv_terms else 0) + (3 if src_terms else 0) + (
        1 if mass_grad else 0)
    zero = jnp.zeros(shape, jnp.float32)
    # reduce over j once, to (tile_i,) vectors; the epilogue stays 1-D
    acc = [jnp.sum(a, axis=1) for a in
           lax.fori_loop(0, n_tiles, body, (zero,) * n_acc)]
    _, _, _, m1, gx1, gy1, gz1 = cols
    bar = [3.0 * a for a in acc[n_acc - 3 - mass_grad:n_acc - mass_grad]]
    if recv_terms:
        bar = [b - g * acc[0] for b, g in zip(bar, (gx1, gy1, gz1))]
    if src_terms:
        k = 1 if recv_terms else 0
        bar = [b + m1 * acc[k + i] for i, b in enumerate(bar)]
    for i, b in enumerate(bar):
        out_ref[:, i] = b
    if mass_grad:
        out_ref[:, 3] = -acc[-1]


def _vjp_pack(pos, g, mass, n_pad, far):
    """(n_pad, 8) pack x, y, z, m, gx, gy, gz, 0; padding rows are inert:
    zero cotangent and zero mass, at FAR when the masses are unit."""
    f32 = jnp.float32
    n = pos.shape[0]
    m = jnp.ones((n,), f32) if mass is None else mass.astype(f32)
    g = jnp.zeros((n, 3), f32) if g is None else g.astype(f32)
    pack = jnp.concatenate(
        [pos.astype(f32), m[:, None], g, jnp.zeros((n, 1), f32)], axis=1)
    if n_pad != n:
        pad = jnp.zeros((n_pad - n, 8), f32)
        if far:
            pad = pad.at[:, :3].set(FAR)
        pack = jnp.concatenate([pack, pad], axis=0)
    return pack


@functools.partial(
    jax.jit,
    static_argnames=("softening", "recv_terms", "src_terms", "mass_grad",
                     "tile_i", "tile_j", "num_warps", "num_stages",
                     "interpret"),
)
def vjp_pallas(pos_r, g_r, mass_r, pos_s, g_s, mass_s, *,
               softening: float = SOFTENING, recv_terms: bool = True,
               src_terms: bool = True, mass_grad: bool = False,
               tile_i: int | None = None, tile_j: int | None = None,
               num_warps: int = NUM_WARPS, num_stages: int = NUM_STAGES,
               interpret: bool = False):
    """Pairwise force VJP of receivers pos_r against sources pos_s: the
    kernel twin of ops.autodiff.vjp_jnp (same arguments and terms).

    Returns pos_bar (Nr, 3), and mass_bar (Nr,) when mass_grad."""
    check_device(interpret)
    nr, ns = pos_r.shape[0], pos_s.shape[0]
    tile_i = _receiver_tile(nr, tile_i)
    tile_j = _tile(ns, tile_j or TILE_J)
    far = mass_s is None
    recv = _vjp_pack(pos_r, g_r, mass_r, round_up(nr, tile_i), far=False)
    src = _vjp_pack(pos_s, g_s, mass_s, round_up(ns, tile_j), far=far)
    kernel = functools.partial(
        _vjp_kernel, softening=float(softening), tile_j=tile_j,
        n_tiles=src.shape[0] // tile_j, recv_terms=recv_terms,
        src_terms=src_terms, mass_grad=mass_grad)
    out = _pallas(kernel, recv, src.T, tile_i, num_warps, num_stages,
                  interpret, "nbody_force_vjp")
    if mass_grad:
        return out[:nr, :3], out[:nr, 3]
    return out[:nr, :3]
