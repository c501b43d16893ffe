"""Differentiable force op: an analytic VJP over any force backend.

Neither the Pallas kernel nor a chunked forward has a useful automatic
derivative, but softened gravity has a clean analytic one. With
d = p_s - p_k, s = |d|^2 + eps, w = s^(-3/2), u = s^(-5/2) and L = sum g.F:

  receiver (k receives from s):  dL/dp_k += m_s [ -w g_k + 3 u (g_k . d) d ]
  source   (k acts on s):        dL/dp_k += m_k [  w g_s - 3 u (g_s . d) d ]
  mass     (F_s depends on m_k): dL/dm_k += -w (g_s . d)

The self term i = j = k cancels ANALYTICALLY between the first two
(+-w g_k), but NOT in floating point: at the default SOFTENING=1e-9 the self
weight w = eps^-1.5 ~ 3e13 swamps the fp32 accumulator and the cancellation
residue is O(ulp(w |g|)) — measured max relative gradient error ~1.0 without
a mask. So w and u are zeroed on exactly-coincident pairs (the pre-softening
|d|^2 == 0); the self pair's true gradient contribution is identically zero
since its force term w(|d|^2+eps) d vanishes as a function of p_k.

One pairwise reduction serves every layout: ``vjp_jnp`` (chunked jnp, what
XLA compiles) and its kernel twin ``ops.pallas_force.vjp_pallas`` take
receivers (pos_r, g_r, mass_r) and sources (pos_s, g_s, mass_s) and sum the
receiver terms, the source terms, or both:

* square self-force: both terms, receivers = sources;
* a shard against a visiting shard (ring / all_gather backward): both terms;
* the two sides of a pair block (grid backward): receiver terms for the
  rows, source terms for the columns.

The reference, being fixed-function hardware, has no notion of
differentiation — this is capability on top of parity (initial-condition
optimization and adjoint analyses through the simulator).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from mini_nbody_tpu.ops.reference import (_diffs, auto_row_chunk,
                                         map_row_chunks)

#: Rows per chunk are sized so the (rows, Ns, 3) broadcasts of the backward
#: stay near 192 MB.
_VJP_BUDGET = 1 << 24


@partial(jax.jit, static_argnames=("softening", "recv_terms", "src_terms",
                                   "mass_grad", "row_chunk"))
def vjp_jnp(pos_r, g_r, mass_r, pos_s, g_s, mass_s, *, softening: float,
            recv_terms: bool = True, src_terms: bool = True,
            mass_grad: bool = False, row_chunk: int | None = None):
    """Pairwise force VJP of receivers pos_r against sources pos_s
    (module docstring). g_r is needed for the receiver terms, g_s for the
    source terms and the mass gradient; None masses are unit.

    Returns pos_bar (Nr, 3), and mass_bar (Nr,) when mass_grad."""
    dt = pos_r.dtype  # fp32 from the simulator; fp64 in x64 checks
    nr, ns = pos_r.shape[0], pos_s.shape[0]
    pos_s = pos_s.astype(dt)
    m_r = jnp.ones((nr,), dt) if mass_r is None else mass_r.astype(dt)
    m_s = jnp.ones((ns,), dt) if mass_s is None else mass_s.astype(dt)
    g_r = jnp.zeros((nr, 3), dt) if g_r is None else g_r.astype(dt)
    g_s = jnp.zeros((ns, 3), dt) if g_s is None else g_s.astype(dt)
    soft = jnp.asarray(softening, dt)

    def block(p_k, g_k, m_k):
        d = _diffs(p_k, pos_s)  # p_s - p_k, (C, Ns) per axis
        d2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        inv = jax.lax.rsqrt(d2 + soft)
        inv2 = inv * inv
        w = jnp.where(d2 == 0.0, 0.0, inv2 * inv)
        u = w * inv2
        bar = jnp.zeros(p_k.shape, dt)
        c = jnp.zeros(d2.shape, dt)
        if recv_terms:
            bar = bar - jnp.sum(m_s[None, :] * w, axis=1,
                                keepdims=True) * g_k
            c = m_s[None, :] * sum(g_k[:, k, None] * d[k] for k in range(3))
        if src_terms or mass_grad:
            gsd = sum(g_s[None, :, k] * d[k] for k in range(3))
        if src_terms:
            # sum_s w g_s, an elementwise reduction (no matmul, no TF32)
            tw = jnp.stack([jnp.sum(w * g_s[None, :, k], axis=1)
                            for k in range(3)], axis=-1)
            bar = bar + m_k[:, None] * tw
            c = c - m_k[:, None] * gsd
        uc = u * c
        bar = bar + 3.0 * jnp.stack([jnp.sum(uc * d[k], axis=1)
                                     for k in range(3)], axis=-1)
        if mass_grad:
            return bar, -jnp.sum(w * gsd, axis=1)
        return bar

    chunk = row_chunk or auto_row_chunk(ns, _VJP_BUDGET)
    return map_row_chunks(block, chunk, pos_r, g_r, m_r)


def vjp_terms(backend: str, *args, interpret: bool = False,
              tile_i: int | None = None, tile_j: int | None = None, **kw):
    """vjp_jnp or its Pallas twin, by backend name."""
    if backend == "pallas":
        from mini_nbody_tpu.ops.pallas_force import vjp_pallas

        return vjp_pallas(*args, interpret=interpret, tile_i=tile_i,
                          tile_j=tile_j, **kw)
    return vjp_jnp(*args, **kw)


def make_body_force_diff(force_impl, softening: float, backward: str = "jnp",
                         interpret: bool = False, unit_mass: bool = False,
                         mass_grad: bool = False, tile_i: int | None = None,
                         tile_j: int | None = None):
    """Wrap ``force_impl(pos, mass) -> (N,3)`` (square self-force, any
    backend, non-differentiable) into a custom-VJP differentiable function.

    Forward runs force_impl; backward is the analytic pairwise VJP through
    vjp_terms(backward). Gradients flow to pos; with mass_grad=True also to
    the per-body masses, otherwise the mass cotangent is zero (mass treated
    as a static property)."""
    if mass_grad and unit_mass:
        raise ValueError("mass_grad=True requires a mass-mode force "
                         "(unit_mass=False)")

    @jax.custom_vjp
    def body_force_diff(pos, mass):
        return force_impl(pos, mass)

    def _fwd(pos, mass):
        return force_impl(pos, mass), (pos, mass)

    def _bwd(res, g):
        pos, mass = res
        m = None if unit_mass else mass
        out = vjp_terms(backward, pos, g, m, pos, g, m,
                        softening=softening, mass_grad=mass_grad,
                        interpret=interpret, tile_i=tile_i, tile_j=tile_j)
        if mass_grad:
            return out
        return out.astype(pos.dtype), jnp.zeros_like(mass)

    body_force_diff.defvjp(_fwd, _bwd)
    return body_force_diff


def make_differentiable_force(cfg, mass_grad: bool = False):
    """Differentiable ``force(pos, mass=None) -> (N,3)`` over the configured
    backend, suitable for jax.grad / jax.vjp; the backward runs on the same
    backend as the forward. mass_grad=True (requires cfg.use_masses) also
    yields gradients w.r.t. the per-body masses."""
    from mini_nbody_tpu.ops.force import make_force_fn

    inner = make_force_fn(cfg)

    def impl(pos, mass):
        return inner(pos, pos, mass)

    diff = make_body_force_diff(
        impl, float(cfg.softening), backward=cfg.resolve_backend(),
        interpret=cfg.interpret, unit_mass=not cfg.use_masses,
        mass_grad=mass_grad, tile_i=cfg.tile_i, tile_j=cfg.tile_j,
    )

    def force(pos, mass=None):
        if mass is None:
            mass = jnp.ones((pos.shape[0],), pos.dtype)
        return diff(pos, mass)

    return force


def make_differentiable_ensemble_force(cfg):
    """Differentiable ``force(pos, mass=None) -> (B, N, 3)`` for B
    independent systems: jax.vmap of make_differentiable_force (the
    ensemble VJP is block-diagonal, so the batched backward is exact per
    system). Gradients flow to pos only."""
    single = make_differentiable_force(cfg)

    def force(pos, mass=None):
        if mass is None:
            mass = jnp.ones(pos.shape[:2], pos.dtype)
        return jax.vmap(single)(pos, mass)

    return force
