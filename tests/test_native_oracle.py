"""C++/OpenMP fp64 oracle vs the NumPy fp64 oracle (bit-level agreement)."""

import numpy as np
import pytest

from mini_nbody_tpu import native


@pytest.fixture(scope="module", autouse=True)
def require_native():
    if not native.available():
        from mini_nbody_tpu.native.oracle import build_error

        pytest.skip(f"native oracle unavailable: {build_error()}")


def test_matches_numpy_oracle(rng, oracle_rect):
    pos_i = rng.uniform(-1, 1, (257, 3)).astype(np.float32)
    pos_j = rng.uniform(-1, 1, (511, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, 511).astype(np.float32)
    f = native.body_force_oracle(pos_i, pos_j, m, softening=1e-9)
    ref = oracle_rect(pos_i, pos_j, m, softening=1e-9)
    np.testing.assert_allclose(f, ref, rtol=1e-12)


def test_unit_mass_and_self(rng):
    pos = rng.uniform(-1, 1, (128, 3)).astype(np.float32)
    f = native.body_force_oracle(pos, pos)
    # Newton's third law in fp64.
    assert np.abs(f.sum(0)).max() < 1e-8 * np.abs(f).sum()


def test_potential_energy(rng):
    pos = rng.uniform(-1, 1, (100, 3)).astype(np.float32)
    m = rng.uniform(0.5, 2.0, 100).astype(np.float32)
    u = native.potential_energy_oracle(pos, m, softening=1e-2)
    p64 = pos.astype(np.float64)
    d = p64[None] - p64[:, None]
    r2 = (d ** 2).sum(-1) + 1e-2
    mm = np.outer(m, m).astype(np.float64)
    ref = -0.5 * (mm / np.sqrt(r2))[~np.eye(100, dtype=bool)].sum()
    np.testing.assert_allclose(u, ref, rtol=1e-9)  # OpenMP sum order


def test_large_n_speed():
    # The point of the native oracle: fp64 ground truth at sizes where the
    # NumPy O(N^2) oracle is impractical. ~0.5s budget for 16k bodies.
    import time

    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (16384, 3)).astype(np.float32)
    t0 = time.perf_counter()
    f = native.body_force_oracle(pos, pos)
    dt = time.perf_counter() - t0
    assert np.isfinite(f).all()
    assert dt < 30.0


def test_trajectory_vs_engine():
    # Config-1 fidelity: the engine's Euler trajectory must track the native
    # fp64-force oracle trajectory (identical v-then-x semantics).
    import jax
    from mini_nbody_tpu import SimConfig, init, simulate

    # softening 1e-4 bounds close-encounter forces; at the reference 1e-9 the
    # system is chaotic enough that fp32-vs-fp64 force noise visibly diverges
    # trajectories within 10 steps (intrinsic, not an engine defect).
    state = init.uniform_random(jax.random.key(3), 512)
    pos64, vel64 = native.euler_steps_oracle(
        np.asarray(state.pos), np.asarray(state.vel), dt=0.01, steps=10,
        softening=1e-4,
    )
    cfg = SimConfig(n=512, dt=0.01, steps=10, backend="jnp", softening=1e-4)
    out = simulate(cfg, state)
    pos = np.asarray(out.pos)
    scale = np.abs(pos64).max()
    err = np.abs(pos - pos64)
    # A v-then-x ordering bug would shift EVERY element by O(dt^2 * F); the
    # tail elements are close-encounter chaos amplification, so gate the
    # median tightly and the max loosely.
    assert np.median(err) < 1e-4 * scale  # ordering bug would be ~1e-2
    assert err.max() < 5e-3 * scale
