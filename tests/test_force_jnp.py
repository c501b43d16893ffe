"""jnp force op vs the fp64 NumPy oracle (reference physics, SURVEY.md §0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini_nbody_tpu.ops.reference import body_force_jnp
from mini_nbody_tpu.models import init


def _tols(f64):
    scale = np.abs(f64).max()
    return dict(rtol=2e-4, atol=2e-5 * max(scale, 1.0))


@pytest.mark.parametrize("n", [1, 7, 64, 500])
def test_matches_oracle_uniform(n, oracle):
    state = init.uniform_random(jax.random.key(0), n)
    pos = np.asarray(state.pos)
    f = body_force_jnp(jnp.asarray(pos, jnp.float32), jnp.asarray(pos, jnp.float32))
    f64 = oracle(pos)
    np.testing.assert_allclose(np.asarray(f), f64, **_tols(f64))


def test_rectangular_and_masses(oracle_rect, rng):
    pos_i = rng.uniform(-1, 1, (33, 3)).astype(np.float32)
    pos_j = rng.uniform(-1, 1, (77, 3)).astype(np.float32)
    m_j = rng.uniform(0.1, 2.0, 77).astype(np.float32)
    f = body_force_jnp(jnp.asarray(pos_i), jnp.asarray(pos_j), jnp.asarray(m_j))
    f64 = oracle_rect(pos_i, pos_j, m_j)
    np.testing.assert_allclose(np.asarray(f), f64, **_tols(f64))


def test_self_interaction_is_zero():
    # A single body exerts no force on itself (d=0; softening keeps it finite,
    # matching the reference which computes rather than skips j==i).
    pos = jnp.asarray([[0.3, -0.2, 0.7]], jnp.float32)
    f = body_force_jnp(pos, pos)
    np.testing.assert_array_equal(np.asarray(f), np.zeros((1, 3), np.float32))


def test_zero_mass_sources_are_inert(rng):
    pos_i = jnp.asarray(rng.uniform(-1, 1, (16, 3)), jnp.float32)
    pos_j = jnp.asarray(rng.uniform(-1, 1, (32, 3)), jnp.float32)
    m = jnp.zeros((32,), jnp.float32)
    f = body_force_jnp(pos_i, pos_j, m)
    np.testing.assert_array_equal(np.asarray(f), np.zeros((16, 3), np.float32))


def test_row_chunking_matches_unchunked(rng):
    pos = jnp.asarray(rng.uniform(-1, 1, (128, 3)), jnp.float32)
    full = body_force_jnp(pos, pos)
    chunked = body_force_jnp(pos, pos, row_chunk=32)
    # fp32 reduction-order noise only.
    scale = np.abs(np.asarray(full)).max()
    np.testing.assert_allclose(
        np.asarray(full), np.asarray(chunked), rtol=1e-4, atol=1e-5 * scale
    )


def test_newton_third_law(rng):
    # Equal masses: total force sums to ~0 (pairwise antisymmetry).
    pos = jnp.asarray(rng.uniform(-1, 1, (200, 3)), jnp.float32)
    f = np.asarray(body_force_jnp(pos, pos))
    scale = np.abs(f).sum()
    assert np.abs(f.sum(0)).max() < 1e-5 * scale


@pytest.mark.parametrize("n,chunk", [(130, 64), (300, 128), (4099, 1024)])
def test_row_chunking_ragged(n, chunk, rng):
    # Ragged N: the last row chunk is padded, never the whole (N, N) block.
    pos = jnp.asarray(rng.uniform(-1, 1, (n, 3)), jnp.float32)
    m = jnp.asarray(rng.uniform(0.5, 2.0, n), jnp.float32)
    full = np.asarray(body_force_jnp(pos, pos, m))
    chunked = np.asarray(body_force_jnp(pos, pos, m, row_chunk=chunk))
    assert chunked.shape == (n, 3)
    scale = np.abs(full).max()
    np.testing.assert_allclose(chunked, full, rtol=1e-5, atol=1e-6 * scale)


@pytest.mark.parametrize("n", [8193, 9001, 12288])
def test_dispatch_chunks_large_ragged_n(n):
    # Above 2^24 pairs the dispatcher chunks rows at any N, ragged or not:
    # no (N, N) block may appear in the traced program.
    from mini_nbody_tpu.ops.force import body_force

    pos = jax.ShapeDtypeStruct((n, 3), jnp.float32)
    jaxpr = str(jax.make_jaxpr(lambda p: body_force(p, p))(pos))
    assert "while" in jaxpr or "scan" in jaxpr
    assert f"{n},{n}" not in jaxpr.replace(" ", "")


@pytest.mark.parametrize("row_chunk", [None, 16])
@pytest.mark.parametrize("masses", [False, True])
def test_pair_function_both_directions(masses, row_chunk, rng):
    # One weight block gives the rows and, negated, the reactions
    # (comm='ring_sym'): each side equals the plain rectangular force.
    from mini_nbody_tpu.ops.reference import body_force_pair_jnp

    pa = jnp.asarray(rng.uniform(-1, 1, (45, 3)), jnp.float32)
    pb = jnp.asarray(rng.uniform(-1, 1, (70, 3)), jnp.float32)
    ma = jnp.asarray(rng.uniform(0.5, 2, 45), jnp.float32) if masses else None
    mb = jnp.asarray(rng.uniform(0.5, 2, 70), jnp.float32) if masses else None
    fa, fb = body_force_pair_jnp(pa, pb, ma, mb, softening=1e-2,
                                 row_chunk=row_chunk)
    ra = body_force_jnp(pa, pb, mb, softening=1e-2)
    rb = body_force_jnp(pb, pa, ma, softening=1e-2)
    for got, ref in ((fa, ra), (fb, rb)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())
