"""Ensemble simulation: B independent systems batched in one program
(sim.simulate_ensemble / trajectory_ensemble, jax.vmap of the
single-system force). Every system must match its own simulate() run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini_nbody_tpu import SimConfig, simulate, simulate_ensemble
from mini_nbody_tpu.models import init
from mini_nbody_tpu.models.state import BodyState
from mini_nbody_tpu.sim import trajectory, trajectory_ensemble

B, N = 3, 50


def _systems(masses=False, key0=0, b=B):
    make = init.plummer if masses else init.uniform_random
    ss = [make(jax.random.key(key0 + i), N) for i in range(b)]
    return ss, BodyState(pos=jnp.stack([s.pos for s in ss]),
                         vel=jnp.stack([s.vel for s in ss]),
                         mass=jnp.stack([s.mass for s in ss]))


def _cfg(backend, integrator="leapfrog", masses=True, steps=4):
    return SimConfig(n=N, dt=1e-3, steps=steps, softening=1e-2,
                     integrator=integrator, backend=backend, interpret=True,
                     use_masses=masses)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-6,
                               atol=1e-7 * max(np.abs(b).max(), 1.0))


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("masses", [False, True])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "rk4",
                                        "yoshida4"])
def test_matches_per_system_simulate(integrator, masses, backend):
    ss, st = _systems(masses, key0=10)
    cfg = _cfg(backend, integrator, masses)
    out = simulate_ensemble(cfg, st)
    assert out.pos.shape == (B, N, 3)
    for i in range(B):
        ref = simulate(cfg, ss[i])
        _close(out.pos[i], ref.pos)
        _close(out.vel[i], ref.vel)


@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "yoshida4"])
def test_trajectory_bitwise_vs_per_system(integrator):
    # The vmapped kernel runs each system's blocks exactly as a standalone
    # call does: every system's trajectory is bitwise its own simulate().
    ss, st = _systems(masses=True, key0=20)
    cfg = _cfg("pallas", integrator)
    out = simulate_ensemble(cfg, st)
    for i in range(B):
        ref = simulate(cfg, ss[i])
        np.testing.assert_array_equal(np.asarray(out.pos[i]),
                                      np.asarray(ref.pos))
        np.testing.assert_array_equal(np.asarray(out.vel[i]),
                                      np.asarray(ref.vel))


class TestTrajectoryEnsemble:
    """trajectory_ensemble = simulate_ensemble + snapshots: history rows
    must be bitwise equal to the per-system trajectory() dumps."""

    def test_bitwise_vs_per_system(self):
        ss, st = _systems(masses=True, key0=40)
        for backend in ("jnp", "pallas"):
            cfg = _cfg(backend, steps=6)
            out, hist = trajectory_ensemble(cfg, st, save_every=2)
            assert hist.shape == (3, B, N, 3)
            for i in range(B):
                ref, rhist = trajectory(cfg, ss[i], cfg.steps, save_every=2)
                np.testing.assert_array_equal(np.asarray(hist[:, i]),
                                              np.asarray(rhist))
                np.testing.assert_array_equal(np.asarray(out.pos[i]),
                                              np.asarray(ref.pos))
            # the final snapshot IS the final state
            np.testing.assert_array_equal(np.asarray(hist[-1]),
                                          np.asarray(out.pos))

    def test_divisibility_validation(self):
        _, st = _systems()
        with pytest.raises(ValueError, match="divisible"):
            trajectory_ensemble(_cfg("jnp", steps=5), st, save_every=2)

    def test_sharded_matches_unsharded(self):
        from mini_nbody_tpu.parallel import make_mesh

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 devices")
        _, st = _systems(masses=True, key0=60, b=8)
        cfg = _cfg("pallas", steps=4)
        _, ref = trajectory_ensemble(cfg, st, save_every=2)
        out, hist = trajectory_ensemble(cfg, st, save_every=2,
                                        mesh=make_mesh(8))
        np.testing.assert_array_equal(np.asarray(hist), np.asarray(ref))
        np.testing.assert_array_equal(np.asarray(hist[-1]),
                                      np.asarray(out.pos))


class TestDifferentiableEnsemble:
    def test_no_cross_system_leakage(self):
        from mini_nbody_tpu.ops.autodiff import (
            make_differentiable_ensemble_force)

        _, st = _systems(True, key0=50)
        cfg = _cfg("pallas")
        force = make_differentiable_ensemble_force(cfg)
        g = np.asarray(jax.grad(
            lambda p: jnp.sum(force(p, st.mass)[0] ** 2))(st.pos))
        assert np.abs(g[0]).max() > 0
        np.testing.assert_array_equal(g[1:], np.zeros_like(g[1:]))


def test_systems_do_not_interact():
    # Moving one system's bodies leaves every other system's trajectory
    # bitwise unchanged: no cross-system pairs.
    _, st = _systems(masses=True, key0=60)
    cfg = _cfg("jnp")
    ref = simulate_ensemble(cfg, st)
    moved = BodyState(pos=st.pos.at[0].add(0.5), vel=st.vel, mass=st.mass)
    out = simulate_ensemble(cfg, moved)
    np.testing.assert_array_equal(np.asarray(out.pos[1:]),
                                  np.asarray(ref.pos[1:]))
    assert not np.array_equal(np.asarray(out.pos[0]), np.asarray(ref.pos[0]))


def test_validation():
    ss, st = _systems()
    cfg = SimConfig(n=N, backend="jnp")
    with pytest.raises(ValueError, match="batched"):
        simulate_ensemble(cfg, ss[0])
    with pytest.raises(ValueError, match="cfg.n"):
        simulate_ensemble(cfg.replace(n=N + 1), st)


class TestShardedEnsemble:
    """mesh= shards the batch axis data-parallel with ZERO collectives;
    results must equal the unsharded run."""

    @pytest.mark.parametrize("masses", [False, True])
    def test_matches_unsharded_bitwise(self, masses):
        from mini_nbody_tpu.parallel import make_mesh

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 devices")
        _, st = _systems(masses, key0=80, b=8)
        for backend in ("jnp", "pallas"):
            cfg = _cfg(backend, masses=masses, steps=3)
            ref = simulate_ensemble(cfg, st)
            out = simulate_ensemble(cfg, st, mesh=make_mesh(8))
            np.testing.assert_array_equal(np.asarray(out.pos),
                                          np.asarray(ref.pos))
            np.testing.assert_array_equal(np.asarray(out.vel),
                                          np.asarray(ref.vel))

    def test_batch_must_divide_mesh(self):
        from mini_nbody_tpu.parallel import make_mesh

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 devices")
        _, st = _systems(b=3)
        with pytest.raises(ValueError, match="divide"):
            simulate_ensemble(_cfg("jnp"), st, mesh=make_mesh(8))


def test_ensemble_diagnostics():
    from mini_nbody_tpu.ops import diagnostics as diag

    ss, st = _systems(masses=True, key0=95)
    es = np.asarray(diag.total_energy_ensemble(st, 1e-2))
    ps = np.asarray(diag.momentum_ensemble(st))
    assert es.shape == (B,) and ps.shape == (B, 3)
    for i in range(B):
        np.testing.assert_allclose(
            es[i], float(diag.total_energy(ss[i], 1e-2)), rtol=1e-6)
        np.testing.assert_allclose(
            ps[i], np.asarray(diag.momentum(ss[i])), rtol=1e-6, atol=1e-7)
