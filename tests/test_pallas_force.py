"""Force paths vs the fp64 oracle: XLA's jnp path and the Pallas-Triton
kernel (interpret mode here; compiled on a CUDA card under the gpu marker).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini_nbody_tpu import SimConfig
from mini_nbody_tpu.models import init
from mini_nbody_tpu.ops import pallas_force
from mini_nbody_tpu.ops.force import body_force, make_force_fn
from mini_nbody_tpu.ops.pallas_force import body_force_pallas
from mini_nbody_tpu.ops.reference import body_force_jnp

from conftest import oracle_force_rect


def _force(backend, pos_i, pos_j, mass_j=None, **kw):
    if backend == "pallas":
        return body_force(pos_i, pos_j, mass_j, backend="pallas",
                          interpret=True, **kw)
    return body_force(pos_i, pos_j, mass_j, backend="jnp", **kw)


def _assert_oracle(f, pos_i, pos_j, mass_j=None, softening=1e-9):
    ref = oracle_force_rect(pos_i, pos_j, mass_j, softening)
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(np.asarray(f, np.float64) - ref).max() / scale
    assert err < 2e-6, err


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("layout", ["square", "rect"])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("n", [1, 7, 100, 300, 1000, 4097])
def test_matches_fp64_oracle(n, masses, layout, backend):
    """Every force path against the fp64 oracle: ragged N (tail padding),
    unit (FAR padding) and Plummer masses (zero-mass padding), square
    self-forces and rectangular receiver/source sets."""
    s = init.plummer(jax.random.key(n), n)
    m = s.mass if masses else None
    pos_i = s.pos if layout == "square" else s.pos[: max(1, n // 3)]
    # big N: larger blocks keep the interpreter quick and still loop
    # over many source tiles
    kw = dict(tile_i=128, tile_j=128) if n > 1000 else {}
    f = _force(backend, pos_i, s.pos, m, **kw)
    assert f.shape == pos_i.shape and f.dtype == jnp.float32
    _assert_oracle(f, pos_i, s.pos, m)


def _check(pos_i, pos_j, mass_j=None, **kw):
    f = body_force_pallas(pos_i, pos_j, mass_j, interpret=True, **kw)
    ref = body_force_jnp(pos_i, pos_j, mass_j)
    f, ref = np.asarray(f), np.asarray(ref)
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(f, ref, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("n", [8, 128, 256, 512])
def test_square_aligned(n):
    s = init.uniform_random(jax.random.key(n), n)
    _check(s.pos, s.pos, s.mass, tile_i=32, tile_j=64)


@pytest.mark.parametrize("n", [1, 7, 100, 300])
def test_tail_padding(n):
    # Non-tile-aligned N: zero-mass padding is the WRITE_MASK analog
    # (src/top_level.vhd:201-205) — results must match exactly-sized oracle.
    s = init.uniform_random(jax.random.key(n), n)
    _check(s.pos, s.pos, s.mass, tile_i=32, tile_j=64)


def test_rectangular_with_masses(rng):
    pos_i = jnp.asarray(rng.uniform(-1, 1, (96, 3)), jnp.float32)
    pos_j = jnp.asarray(rng.uniform(-1, 1, (200, 3)), jnp.float32)
    m_j = jnp.asarray(rng.uniform(0.1, 2.0, 200), jnp.float32)
    _check(pos_i, pos_j, m_j, tile_i=32, tile_j=64)


def test_multi_j_block_accumulation(rng):
    # Nj spanning many source tiles exercises the accumulate-across-loop
    # path (the analog of the rotating-partial-sum flush,
    # src/fxyz.vhd:130-184).
    pos_i = jnp.asarray(rng.uniform(-1, 1, (64, 3)), jnp.float32)
    pos_j = jnp.asarray(rng.uniform(-1, 1, (640, 3)), jnp.float32)
    _check(pos_i, pos_j, tile_i=32, tile_j=64)


def test_zero_mass_inert(rng):
    pos = jnp.asarray(rng.uniform(-1, 1, (64, 3)), jnp.float32)
    f = body_force_pallas(pos, pos, jnp.zeros((64,), jnp.float32),
                          interpret=True)
    np.testing.assert_array_equal(np.asarray(f), 0.0)


def test_coincident_bodies_finite():
    # All bodies at the same point: softening must keep everything finite and
    # the net force zero (reference semantics: softened self/coincident pairs).
    pos = jnp.zeros((32, 3), jnp.float32)
    f = body_force_pallas(pos, pos, interpret=True)
    assert np.isfinite(np.asarray(f)).all()
    np.testing.assert_array_equal(np.asarray(f), 0.0)


class TestBodyForcePairMasses:
    """The ring_sym pair function: rows and reactions from one block."""

    def test_cross_pair_masses(self):
        from mini_nbody_tpu.ops.reference import body_force_pair_jnp

        ka, kb = jax.random.split(jax.random.key(7))
        pa = jax.random.uniform(ka, (96, 3), jnp.float32, -1, 1)
        pb = jax.random.uniform(kb, (200, 3), jnp.float32, -1, 1) + 3.0
        ma = jax.random.uniform(ka, (96,), jnp.float32, 0.1, 2.0)
        mb = jax.random.uniform(kb, (200,), jnp.float32, 0.1, 2.0)
        fa, fb = body_force_pair_jnp(pa, pb, ma, mb, row_chunk=64)
        ref_a = body_force_jnp(pa, pb, mb)
        ref_b = body_force_jnp(pb, pa, ma)
        scale = max(float(np.abs(np.asarray(ref_a)).max()), 1.0)
        np.testing.assert_allclose(np.asarray(fa), np.asarray(ref_a),
                                   rtol=1e-4, atol=1e-5 * scale)
        np.testing.assert_allclose(np.asarray(fb), np.asarray(ref_b),
                                   rtol=1e-4, atol=1e-5 * scale)

    def test_mass_arg_pairing_enforced(self):
        from mini_nbody_tpu.ops.reference import body_force_pair_jnp

        pa = jnp.zeros((8, 3), jnp.float32)
        ma = jnp.ones((8,), jnp.float32)
        with pytest.raises(ValueError, match="both masses or neither"):
            body_force_pair_jnp(pa, pa + 1.0, ma, None)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_zero_mass_sources_inert(backend, rng):
    pos_i = jnp.asarray(rng.uniform(-1, 1, (40, 3)), jnp.float32)
    pos_j = jnp.asarray(rng.uniform(-1, 1, (72, 3)), jnp.float32)
    f = _force(backend, pos_i, pos_j, jnp.zeros((72,), jnp.float32))
    np.testing.assert_array_equal(np.asarray(f), 0.0)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("masses", [False, True])
def test_coincident_bodies_exactly_zero(backend, masses):
    # All bodies at one point: softening keeps everything finite and every
    # pair's d = 0 makes the force exactly zero (reference semantics:
    # softened self/coincident pairs).
    pos = jnp.zeros((40, 3), jnp.float32)
    m = jnp.full((40,), 0.5, jnp.float32) if masses else None
    f = np.asarray(_force(backend, pos, pos, m))
    assert np.isfinite(f).all()
    np.testing.assert_array_equal(f, 0.0)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_single_body_self_force_zero(backend):
    pos = jnp.asarray([[0.3, -0.2, 0.7]], jnp.float32)
    np.testing.assert_array_equal(np.asarray(_force(backend, pos, pos)), 0.0)


@pytest.mark.parametrize("n", [17, 33, 200])
def test_far_tail_padding_inert(n):
    # Unit-mass tails pad sources at FAR: w underflows to exactly 0, so the
    # result equals the same force with sources padded to a tile multiple
    # by hand (zero-mass, mass mode) — and both match the oracle.
    s = init.uniform_random(jax.random.key(n), n)
    unit = body_force_pallas(s.pos, s.pos, None, tile_i=16, tile_j=16,
                             interpret=True)
    ones = body_force_pallas(s.pos, s.pos, jnp.ones((n,), jnp.float32),
                             tile_i=16, tile_j=16, interpret=True)
    np.testing.assert_allclose(np.asarray(unit), np.asarray(ones),
                               rtol=1e-6, atol=1e-6)
    _assert_oracle(unit, s.pos, s.pos)


@pytest.mark.parametrize("tile_j", [16, 32, 64])
def test_multi_tile_accumulation(tile_j, rng):
    # Nj spans many source tiles of the in-kernel loop: the (tile_i,
    # tile_j) register accumulators carry across iterations.
    pos_i = jnp.asarray(rng.uniform(-1, 1, (48, 3)), jnp.float32)
    pos_j = jnp.asarray(rng.uniform(-1, 1, (640, 3)), jnp.float32)
    m = jnp.asarray(rng.uniform(0.1, 2.0, 640), jnp.float32)
    f = body_force_pallas(pos_i, pos_j, m, tile_i=16, tile_j=tile_j,
                          interpret=True)
    _assert_oracle(f, pos_i, pos_j, m)


@pytest.mark.parametrize("tiles", [(16, 16), (32, 64), (64, 32), (128, 16)])
def test_block_sizes_agree(tiles):
    s = init.plummer(jax.random.key(3), 300)
    ref = body_force_jnp(s.pos, s.pos, s.mass)
    f = body_force_pallas(s.pos, s.pos, s.mass, tile_i=tiles[0],
                          tile_j=tiles[1], interpret=True)
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(np.asarray(f), np.asarray(ref), rtol=1e-5,
                               atol=1e-6 * scale)


def test_wrapper_casts_to_fp32():
    # x64 is on in this session: float64 inputs still run the fp32 kernel.
    pos = jnp.asarray(np.random.default_rng(0).uniform(-1, 1, (20, 3)),
                      jnp.float64)
    f = body_force_pallas(pos, pos, jnp.ones((20,), jnp.float64),
                          interpret=True)
    assert f.dtype == jnp.float32 and f.shape == (20, 3)


def test_tile_shrinks_to_small_n():
    assert pallas_force._tile(1, 32) == 16
    assert pallas_force._tile(20, 32) == 32
    assert pallas_force._tile(5000, 32) == 32
    assert pallas_force._tile(100, 256) == 128


@pytest.mark.parametrize("bad", [0, 3, 48, 100])
def test_non_power_of_two_block_rejected(bad):
    with pytest.raises(ValueError, match="power of two"):
        pallas_force._tile(64, bad)


def test_compiled_call_off_gpu_raises():
    # No silent fallback to the interpreter: a compiled call on a CPU
    # session is an error that names the way out.
    pos = jnp.zeros((8, 3), jnp.float32)
    with pytest.raises(ValueError, match="interpret=True"):
        body_force_pallas(pos, pos)
    with pytest.raises(ValueError, match="CUDA GPU"):
        make_force_fn(SimConfig(n=8, backend="pallas"))(pos, pos)


def test_unknown_backend_rejected():
    pos = jnp.zeros((8, 3), jnp.float32)
    with pytest.raises(ValueError, match="unknown force backend"):
        body_force(pos, pos, backend="sym")


@pytest.mark.parametrize("use_masses", [False, True])
def test_make_force_fn_threads_config(use_masses):
    s = init.plummer(jax.random.key(9), 96)
    cfg = SimConfig(n=96, backend="pallas", interpret=True, tile_i=16,
                    tile_j=64, softening=1e-2, use_masses=use_masses)
    f = make_force_fn(cfg)(s.pos, s.pos, s.mass)
    _assert_oracle(f, s.pos, s.pos, s.mass if use_masses else None,
                   softening=1e-2)


def test_auto_resolves_to_jnp_on_cpu():
    assert SimConfig(n=8).resolve_backend() == "jnp"
    assert SimConfig(n=1 << 20).resolve_backend() == "jnp"
    assert SimConfig(n=8, backend="pallas").resolve_backend() == "pallas"


@pytest.mark.parametrize("n,bodies,want", [
    (2048, None, "jnp"), (4095, None, "jnp"), (4096, None, "pallas"),
    (1 << 20, None, "pallas"), (1024, 64 * 1024, "pallas"),
    (1024, 2 * 1024, "jnp")])
def test_auto_crossover_on_gpu(monkeypatch, n, bodies, want):
    # On a GPU 'auto' picks the measured winner by bodies per force call
    # (ensembles count all B*N bodies of the batched call).
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert SimConfig(n=n).resolve_backend(bodies=bodies) == want
    assert SimConfig(n=n, backend="jnp").resolve_backend(bodies) == "jnp"


@pytest.mark.parametrize("n,want", [(16, 16), (4096, 16), (16384, 16),
                                    (32768, 32), (1 << 20, 32)])
def test_default_receiver_block_keeps_the_grid_full(n, want):
    assert pallas_force._receiver_tile(n, None) == want
    assert pallas_force._receiver_tile(n, 64) == min(64, max(16, n))


def test_vmap_adds_batch_axis():
    # simulate_ensemble batches the kernel with jax.vmap (a grid axis).
    ss = [init.plummer(jax.random.key(i), 50) for i in range(3)]
    pos = jnp.stack([s.pos for s in ss])
    mass = jnp.stack([s.mass for s in ss])
    f = jax.vmap(lambda p, m: body_force_pallas(p, p, m, interpret=True))(
        pos, mass)
    for i in range(3):
        np.testing.assert_allclose(
            np.asarray(f[i]),
            np.asarray(body_force_pallas(ss[i].pos, ss[i].pos, ss[i].mass,
                                         interpret=True)),
            rtol=1e-6, atol=1e-7)


@pytest.mark.gpu
@pytest.mark.parametrize("masses", [False, True])
def test_compiled_kernel_on_gpu(gpu, masses):
    n = 65536
    s = init.plummer(jax.random.key(1), n)
    m = s.mass if masses else None
    f = body_force_pallas(s.pos, s.pos, m)
    _assert_oracle(np.asarray(f[:256]), s.pos[:256], s.pos, m)


@pytest.mark.gpu
def test_compiled_vjp_on_gpu(gpu):
    from mini_nbody_tpu.ops.autodiff import vjp_jnp
    from mini_nbody_tpu.ops.pallas_force import vjp_pallas

    n = 8192
    s = init.plummer(jax.random.key(2), n)
    g = jax.random.normal(jax.random.key(3), (n, 3), jnp.float32)
    args = (s.pos, g, s.mass, s.pos, g, s.mass)
    ref = np.asarray(vjp_jnp(*args, softening=1e-2))
    got = np.asarray(vjp_pallas(*args, softening=1e-2))
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-4
