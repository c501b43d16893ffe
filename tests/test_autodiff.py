"""Analytic force VJP vs jnp autodiff ground truth."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini_nbody_tpu import SimConfig
from mini_nbody_tpu.models import init
from mini_nbody_tpu.ops.autodiff import make_differentiable_force
from mini_nbody_tpu.ops.reference import body_force_jnp


def _loss_through(force, pos, mass=None):
    # arbitrary nonlinear scalar so the cotangent varies per element
    f = force(pos) if mass is None else force(pos, mass)
    return jnp.sum(jnp.sin(f) * jnp.cos(pos))


def test_grad_matches_jnp_autodiff():
    cfg = SimConfig(n=96, backend="pallas", softening=1e-2, tile_i=32,
                    tile_j=64, interpret=True)
    s = init.uniform_random(jax.random.key(0), 96)

    force = make_differentiable_force(cfg)
    grad_analytic = jax.grad(lambda p: _loss_through(force, p))(s.pos)

    def jnp_force(p):
        return body_force_jnp(p, p, softening=1e-2)

    grad_auto = jax.grad(lambda p: _loss_through(jnp_force, p))(s.pos)
    ga, gb = np.asarray(grad_analytic), np.asarray(grad_auto)
    scale = np.abs(gb).max()
    np.testing.assert_allclose(ga, gb, rtol=1e-3, atol=1e-4 * scale)


def test_grad_with_masses():
    cfg = SimConfig(n=64, backend="jnp", softening=1e-2, use_masses=True)
    s = init.plummer(jax.random.key(1), 64)
    force = make_differentiable_force(cfg)
    grad_analytic = jax.grad(
        lambda p: _loss_through(lambda q: force(q, s.mass), p)
    )(s.pos)

    def jnp_force(p):
        return body_force_jnp(p, p, s.mass, softening=1e-2)

    grad_auto = jax.grad(lambda p: _loss_through(jnp_force, p))(s.pos)
    ga, gb = np.asarray(grad_analytic), np.asarray(grad_auto)
    scale = max(np.abs(gb).max(), 1e-9)
    np.testing.assert_allclose(ga, gb, rtol=1e-3, atol=1e-4 * scale)


def _ref_vjp_f64(pos, g, mass, softening):
    """fp64 reference pos_bar with the self pair explicitly excluded.

    Masking the diagonal does not change the forward values (the self term is
    w * 0) but makes fp64 autodiff yield the exact gradient, free of the
    +-eps^-1.5 g_k cancellation residue."""
    if not jax.config.jax_enable_x64:
        pytest.skip("needs x64 (enabled only in forced-CPU test runs)")
    n = pos.shape[0]
    pos64 = jnp.asarray(np.asarray(pos), jnp.float64)
    g64 = jnp.asarray(np.asarray(g), jnp.float64)
    m64 = jnp.asarray(np.asarray(mass), jnp.float64)
    eye = jnp.eye(n, dtype=jnp.float64)

    def f(p):
        d = p[None, :, :] - p[:, None, :]
        r2 = jnp.sum(d * d, axis=-1) + softening
        w = r2 ** -1.5 * m64[None, :] * (1.0 - eye)
        return jnp.sum(d * w[:, :, None], axis=1)

    _, vjp = jax.vjp(f, pos64)
    return np.asarray(vjp(g64)[0])


@pytest.mark.parametrize("use_masses", [False, True])
def test_grad_at_default_softening(use_masses):
    """Self-pair cancellation fails catastrophically in fp32 at the default
    SOFTENING=1e-9 (w_self ~ 3e13) unless coincident pairs are masked; both
    backward paths must stay accurate there."""
    from mini_nbody_tpu.ops.autodiff import vjp_terms
    from mini_nbody_tpu.utils.config import SOFTENING

    n = 256
    s = init.plummer(jax.random.key(11), n) if use_masses else \
        init.uniform_random(jax.random.key(11), n)
    g = jax.random.normal(jax.random.key(12), (n, 3), jnp.float32)
    ref = _ref_vjp_f64(s.pos, g, s.mass, SOFTENING)
    scale = np.abs(ref).max()

    m = s.mass if use_masses else None
    for backend in ("jnp", "pallas"):
        got = np.asarray(vjp_terms(backend, s.pos, g, m, s.pos, g, m,
                                   softening=SOFTENING, interpret=True))
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4 * scale)


def test_vjp_chunked_matches_unchunked():
    from mini_nbody_tpu.ops.autodiff import vjp_jnp

    s = init.uniform_random(jax.random.key(2), 300)
    g = jax.random.normal(jax.random.key(3), (300, 3), jnp.float32)
    args = (s.pos, g, s.mass, s.pos, g, s.mass)
    full = vjp_jnp(*args, softening=1e-2, row_chunk=512)
    chunked = vjp_jnp(*args, softening=1e-2, row_chunk=64)  # ragged
    np.testing.assert_allclose(
        np.asarray(full), np.asarray(chunked), rtol=1e-4,
        atol=1e-5 * float(np.abs(np.asarray(full)).max()),
    )


def test_finite_difference():
    # Directional derivative via central differences in fp64 (CPU x64 on).
    if not jax.config.jax_enable_x64:
        pytest.skip("needs x64 (enabled only in forced-CPU test runs)")
    s = init.uniform_random(jax.random.key(4), 32)
    pos64 = jnp.asarray(np.asarray(s.pos), jnp.float64)
    v = jax.random.normal(jax.random.key(5), pos64.shape, jnp.float64)
    soft = 1e-2

    def loss(p):
        f = body_force_jnp(p, p, softening=soft)
        return jnp.sum(jnp.sin(f))

    # analytic via our VJP formula (through custom_vjp machinery)
    cfg = SimConfig(n=32, backend="jnp", softening=soft)
    force = make_differentiable_force(cfg)
    g = jax.grad(lambda p: jnp.sum(jnp.sin(force(p))))(pos64)
    eps = 1e-6
    fd = (loss(pos64 + eps * v) - loss(pos64 - eps * v)) / (2 * eps)
    np.testing.assert_allclose(float(jnp.vdot(g, v)), float(fd), rtol=1e-4)


def test_grad_through_trajectory():
    # End-to-end differentiable simulation: gradient of a final-state scalar
    # w.r.t. initial positions through several integration steps (scan
    # backprop uses the custom force VJP at every step).
    from mini_nbody_tpu.ops.integrators import leapfrog_step
    from mini_nbody_tpu.models.state import BodyState

    cfg = SimConfig(n=48, backend="jnp", softening=1e-2, dt=1e-3)
    force_diff = make_differentiable_force(cfg)
    s = init.plummer(jax.random.key(8), 48)

    def force3(pos_i, pos_j, mass_j):
        return force_diff(pos_i, mass_j)

    def rollout(pos0, steps=5):
        state = BodyState(pos=pos0, vel=s.vel, mass=s.mass)
        acc = force3(pos0, pos0, s.mass)
        for _ in range(steps):
            state, acc = leapfrog_step(state, acc, force3, cfg.dt)
        return jnp.sum(state.pos ** 2)

    def rollout_ref(pos0, steps=5):
        def f3(pos_i, pos_j, mass_j):
            return body_force_jnp(pos_i, pos_j, mass_j, softening=1e-2)

        state = BodyState(pos=pos0, vel=s.vel, mass=s.mass)
        acc = f3(pos0, pos0, s.mass)
        for _ in range(steps):
            state, acc = leapfrog_step(state, acc, f3, cfg.dt)
        return jnp.sum(state.pos ** 2)

    ga = np.asarray(jax.grad(rollout)(s.pos))
    gb = np.asarray(jax.grad(rollout_ref)(s.pos))
    scale = np.abs(gb).max()
    np.testing.assert_allclose(ga, gb, rtol=1e-3, atol=1e-3 * scale)


class TestPallasVJPKernel:
    """The Pallas VJP kernel (square self-force) vs jax.vjp of the plain
    force: unit and per-body masses, ragged N (FAR / zero-mass padding)."""

    def _check(self, n, mass):
        from mini_nbody_tpu.ops.pallas_force import vjp_pallas

        s = init.uniform_random(jax.random.key(n), n)
        g = jax.random.normal(jax.random.key(n + 1), (n, 3), jnp.float32)
        m = s.mass * 1.5 if mass else None
        pb = vjp_pallas(s.pos, g, m, s.pos, g, m, softening=1e-2,
                        tile_i=32, tile_j=64, interpret=True)

        def f(p):
            return body_force_jnp(p, p, m, softening=1e-2)

        _, vjp = jax.vjp(f, s.pos)
        ref = np.asarray(vjp(g)[0])
        scale = np.abs(ref).max()
        np.testing.assert_allclose(np.asarray(pb), ref,
                                   rtol=1e-3, atol=1e-4 * scale)

    def test_unit_mass(self):
        self._check(256, mass=False)

    def test_masses(self):
        self._check(256, mass=True)

    def test_ragged_far_padding(self):
        self._check(300, mass=False)

    def test_ragged_zero_padding_masses(self):
        self._check(300, mass=True)


def test_differentiable_step_api():
    from mini_nbody_tpu.sim import init_carry, make_step_fn

    cfg = SimConfig(n=64, backend="jnp", softening=1e-2, dt=1e-3)
    s = init.uniform_random(jax.random.key(9), 64)
    step = make_step_fn(cfg, differentiable=True)

    def loss(pos0):
        from mini_nbody_tpu.models.state import BodyState

        carry = init_carry(cfg, BodyState(pos=pos0, vel=s.vel, mass=s.mass))
        for _ in range(3):
            carry = step(carry)
        return jnp.sum(carry[0].pos ** 2)

    g = jax.grad(loss)(s.pos)
    assert np.isfinite(np.asarray(g)).all()
    assert float(jnp.abs(g).max()) > 0


class TestMassGradients:
    """Gradients w.r.t. per-body masses (dF_j/dm_k = w d_jk): new capability
    beyond the reference (fixed-function hardware has no derivative at all).
    """

    def _ref(self, pos, g, mass, softening):
        def f(args):
            p, m = args
            return body_force_jnp(p, p, m, softening=softening)

        _, vjp = jax.vjp(f, (pos, mass))
        return vjp(g)[0]

    @pytest.mark.parametrize("backend", ["jnp", "pallas"])
    def test_vjp_matches_autodiff(self, backend):
        n = 192
        s = init.plummer(jax.random.key(41), n)
        g = jax.random.normal(jax.random.key(42), (n, 3), jnp.float32)
        soft = 1e-2
        cfg = SimConfig(n=n, backend=backend, softening=soft,
                        use_masses=True, tile_i=32, tile_j=64,
                        interpret=True)
        force = make_differentiable_force(cfg, mass_grad=True)
        _, vjp = jax.vjp(lambda p, m: force(p, m), s.pos, s.mass)
        pos_bar, mass_bar = vjp(g)
        ref_pos, ref_mass = self._ref(s.pos, g, s.mass, soft)
        sp = float(np.abs(np.asarray(ref_pos)).max())
        sm = float(np.abs(np.asarray(ref_mass)).max())
        np.testing.assert_allclose(np.asarray(pos_bar), np.asarray(ref_pos),
                                   rtol=1e-3, atol=1e-4 * sp)
        np.testing.assert_allclose(np.asarray(mass_bar), np.asarray(ref_mass),
                                   rtol=1e-3, atol=1e-4 * sm)

    def test_kernel_direct(self):
        from mini_nbody_tpu.ops.pallas_force import vjp_pallas

        n = 300  # ragged
        s = init.plummer(jax.random.key(43), n)
        g = jax.random.normal(jax.random.key(44), (n, 3), jnp.float32)
        pos_bar, mass_bar = vjp_pallas(s.pos, g, s.mass, s.pos, g, s.mass,
                                       softening=1e-2, mass_grad=True,
                                       interpret=True)
        ref_pos, ref_mass = self._ref(s.pos, g, s.mass, 1e-2)
        sm = float(np.abs(np.asarray(ref_mass)).max())
        np.testing.assert_allclose(np.asarray(mass_bar),
                                   np.asarray(ref_mass),
                                   rtol=1e-3, atol=1e-4 * sm)
        sp = float(np.abs(np.asarray(ref_pos)).max())
        np.testing.assert_allclose(np.asarray(pos_bar), np.asarray(ref_pos),
                                   rtol=1e-3, atol=1e-4 * sp)

    def test_requires_masses(self):
        cfg = SimConfig(n=8, backend="jnp", use_masses=False)
        with pytest.raises(ValueError, match="mass"):
            make_differentiable_force(cfg, mass_grad=True)




def _vjp(backend, *args, **kw):
    from mini_nbody_tpu.ops.autodiff import vjp_terms

    return vjp_terms(backend, *args, softening=1e-2, interpret=True, **kw)


def _close(got, ref, rtol=1e-4):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() / scale < rtol


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("n", [7, 100, 300])
def test_vjp_square_matches_jax_vjp(n, masses, backend):
    """Square self-force VJP (receiver + source terms) vs jax.vjp of the
    plain force; ragged N exercises FAR / zero-mass source padding."""
    s = init.plummer(jax.random.key(n), n)
    m = s.mass if masses else None
    g = jax.random.normal(jax.random.key(n + 1), (n, 3), jnp.float32)
    ref = jax.vjp(lambda p: body_force_jnp(p, p, m, softening=1e-2),
                  s.pos)[1](g)[0]
    _close(_vjp(backend, s.pos, g, m, s.pos, g, m), ref)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("n", [7, 100, 300])
def test_vjp_rect_matches_jax_vjp(n, masses, backend):
    """A local shard against a visiting shard (the ring / all_gather
    backward): pos_bar of the local bodies gathers both their receiver
    terms against the visitors and their source terms in the visitors'
    forces — the derivative of the local rows of the square system."""
    s = init.plummer(jax.random.key(n + 2), n)
    k = max(1, n // 3)
    g = jax.random.normal(jax.random.key(n + 3), (n, 3), jnp.float32)
    m = s.mass if masses else None

    def cross(p_loc):
        pos = jnp.concatenate([p_loc, s.pos[k:]])
        return body_force_jnp(pos, pos, m, softening=1e-2)

    # the cross-shard part of d/dp_local: full system minus local-local
    full = jax.vjp(cross, s.pos[:k])[1](g)[0]
    self_part = jax.vjp(
        lambda p: body_force_jnp(p, p, None if m is None else m[:k],
                                 softening=1e-2), s.pos[:k])[1](g[:k])[0]
    m_loc = None if m is None else m[:k]
    m_vis = None if m is None else m[k:]
    got = _vjp(backend, s.pos[:k], g[:k], m_loc, s.pos[k:], g[k:], m_vis)
    _close(got, np.asarray(full) - np.asarray(self_part), rtol=1e-4)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("na,nb", [(16, 40), (75, 33)])
def test_vjp_pair_matches_jax_vjp(na, nb, masses, backend):
    """The two sides of one pair block (the grid backward): rows a receive
    from columns b; receiver terms give a_bar, source terms b_bar."""
    s = init.plummer(jax.random.key(na + nb), na + nb)
    a, b = s.pos[:na], s.pos[na:]
    mb = s.mass[na:] if masses else None
    ga = jax.random.normal(jax.random.key(na), (na, 3), jnp.float32)
    ra, rb = jax.vjp(lambda x, y: body_force_jnp(x, y, mb, softening=1e-2),
                     a, b)[1](ga)
    _close(_vjp(backend, a, ga, None, b, None, mb, src_terms=False), ra)
    _close(_vjp(backend, b, None, mb, a, ga, None, recv_terms=False), rb)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("n", [9, 130])
def test_vjp_mass_grad_matches_jax_vjp(n, backend):
    s = init.plummer(jax.random.key(n + 7), n)
    g = jax.random.normal(jax.random.key(n + 8), (n, 3), jnp.float32)
    rp, rm = jax.vjp(lambda p, m: body_force_jnp(p, p, m, softening=1e-2),
                     s.pos, s.mass)[1](g)
    pb, mb = _vjp(backend, s.pos, g, s.mass, s.pos, g, s.mass,
                  mass_grad=True)
    _close(pb, rp)
    _close(mb, rm)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_vjp_coincident_pairs_masked(backend):
    # Distinct bodies at one point plus the self pairs: the mask keeps the
    # gradient finite and equal to the fp64 gradient with those pairs out.
    s = init.uniform_random(jax.random.key(70), 64)
    pos = s.pos.at[40].set(s.pos[3])
    g = jax.random.normal(jax.random.key(71), (64, 3), jnp.float32)
    got = np.asarray(vjp_terms_default(backend, pos, g))
    assert np.isfinite(got).all()
    d = np.asarray(pos, np.float64)
    mask = np.ones((64, 64))
    mask[3, 40] = mask[40, 3] = 0.0
    ref = _ref_vjp_masked(d, np.asarray(g, np.float64), mask, 1e-9)
    _close(got, ref, rtol=1e-3)


def vjp_terms_default(backend, pos, g):
    from mini_nbody_tpu.ops.autodiff import vjp_terms

    return vjp_terms(backend, pos, g, None, pos, g, None, softening=1e-9,
                     interpret=True)


def _ref_vjp_masked(pos, g, mask, softening):
    """fp64 VJP with the self pairs and the listed coincident pairs out."""
    p = jnp.asarray(pos)
    keep = jnp.asarray(mask) * (1.0 - jnp.eye(pos.shape[0]))

    def f(p):
        d = p[None, :, :] - p[:, None, :]
        r2 = jnp.sum(d * d, axis=-1) + softening
        return jnp.sum(d * (r2 ** -1.5 * keep)[:, :, None], axis=1)

    return np.asarray(jax.vjp(f, p)[1](jnp.asarray(g))[0])


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("use_masses", [False, True])
def test_differentiable_force_routes_backend(backend, use_masses):
    """make_differentiable_force runs the backward on the forward's
    backend; both match jax.grad of the plain force."""
    s = init.plummer(jax.random.key(80), 96)
    cfg = SimConfig(n=96, backend=backend, softening=1e-2, interpret=True,
                    use_masses=use_masses)
    force = make_differentiable_force(cfg)
    m = s.mass if use_masses else None
    ga = jax.grad(lambda p: _loss_through(lambda q: force(q, s.mass), p))(
        s.pos)
    gb = jax.grad(lambda p: _loss_through(
        lambda q: body_force_jnp(q, q, m, softening=1e-2), p))(s.pos)
    _close(ga, gb, rtol=1e-4)


def test_differentiable_ensemble_force_is_per_system():
    from mini_nbody_tpu.ops.autodiff import make_differentiable_ensemble_force

    ss = [init.plummer(jax.random.key(90 + i), 40) for i in range(3)]
    pos = jnp.stack([s.pos for s in ss])
    mass = jnp.stack([s.mass for s in ss])
    cfg = SimConfig(n=40, backend="pallas", softening=1e-2, interpret=True,
                    use_masses=True)
    force = make_differentiable_ensemble_force(cfg)
    g = np.asarray(jax.grad(lambda p: jnp.sum(force(p, mass)[0] ** 2))(pos))
    assert np.abs(g[0]).max() > 0
    np.testing.assert_array_equal(g[1:], 0.0)  # no cross-system leakage
    ref = jax.grad(lambda p: jnp.sum(body_force_jnp(
        p, p, ss[0].mass, softening=1e-2) ** 2))(ss[0].pos)
    _close(g[0], ref, rtol=1e-4)
