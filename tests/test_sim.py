"""Integrators + scan loop: reference Euler semantics, conservation gates."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mini_nbody_tpu import SimConfig, simulate
from mini_nbody_tpu.models import init
from mini_nbody_tpu.models.state import BodyState
from mini_nbody_tpu.ops import diagnostics as diag
from mini_nbody_tpu.sim import init_carry, make_step_fn, trajectory


def _np_reference_sim(pos, vel, dt, steps, softening=1e-9):
    """fp64 NumPy reimplementation of upstream mini-nbody's loop:
    v += dt*F(x); x += dt*v (semi-implicit Euler, velocity first)."""
    pos = np.asarray(pos, np.float64).copy()
    vel = np.asarray(vel, np.float64).copy()
    for _ in range(steps):
        d = pos[None, :, :] - pos[:, None, :]
        r2 = (d * d).sum(-1) + softening
        f = (d * (r2 ** -1.5)[:, :, None]).sum(1)
        vel += dt * f
        pos += dt * vel
    return pos, vel


def test_euler_matches_numpy_reference():
    # Config 1 of BASELINE.json (scaled down): uniform cloud, dt=0.01, Euler.
    state = init.uniform_random(jax.random.key(7), 128)
    cfg = SimConfig(n=128, dt=0.01, steps=10, backend="jnp")
    out = simulate(cfg, state)
    pos64, vel64 = _np_reference_sim(state.pos, state.vel, 0.01, 10)
    np.testing.assert_allclose(np.asarray(out.pos), pos64, rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(np.asarray(out.vel), vel64, rtol=5e-3, atol=5e-4)


def test_momentum_conserved():
    state = init.plummer(jax.random.key(3), 256)
    cfg = SimConfig(n=256, dt=1e-3, steps=50, integrator="leapfrog",
                    softening=1e-2, backend="jnp", use_masses=True)
    p0 = np.asarray(diag.momentum(state))
    out = simulate(cfg, state)
    p1 = np.asarray(diag.momentum(out))
    # Pairwise-antisymmetric forces: total momentum is conserved to fp32 noise.
    assert np.abs(p1 - p0).max() < 1e-4


def test_leapfrog_energy_drift_beats_euler():
    state = init.plummer(jax.random.key(5), 128)
    soft = 1e-2
    e0 = float(diag.total_energy(state, soft))
    drifts = {}
    for integ in ("euler", "leapfrog"):
        cfg = SimConfig(n=128, dt=1e-3, steps=200, integrator=integ,
                        softening=soft, backend="jnp", use_masses=True)
        out = simulate(cfg, state)
        e1 = float(diag.total_energy(out, soft))
        drifts[integ] = abs(e1 - e0) / abs(e0)
    assert drifts["leapfrog"] < 1e-3
    assert drifts["leapfrog"] <= drifts["euler"] * 2.0  # usually far smaller


def test_leapfrog_time_reversible():
    # Integrate forward, flip velocities, integrate back: recover the start.
    state = init.plummer(jax.random.key(11), 64)
    cfg = SimConfig(n=64, dt=1e-3, steps=100, integrator="leapfrog",
                    softening=1e-2, backend="jnp", use_masses=True)
    fwd = simulate(cfg, state)
    flipped = BodyState(pos=fwd.pos, vel=-fwd.vel, mass=fwd.mass)
    back = simulate(cfg, flipped)
    np.testing.assert_allclose(
        np.asarray(back.pos), np.asarray(state.pos), atol=5e-4
    )


def test_trajectory_snapshots():
    state = init.uniform_random(jax.random.key(0), 32)
    cfg = SimConfig(n=32, steps=8, backend="jnp")
    final, hist = trajectory(cfg, state, steps=8, save_every=2)
    assert hist.shape == (4, 32, 3)
    np.testing.assert_allclose(np.asarray(hist[-1]), np.asarray(final.pos))


def test_step_fn_is_jittable_and_pure():
    state = init.uniform_random(jax.random.key(1), 64)
    cfg = SimConfig(n=64, backend="jnp")
    step = jax.jit(make_step_fn(cfg))
    carry = init_carry(cfg, state)
    s1, _ = step(carry)
    s2, _ = step(carry)
    np.testing.assert_array_equal(np.asarray(s1.pos), np.asarray(s2.pos))


def test_energy_drift_gate_leapfrog():
    # BASELINE.json gate: energy drift <= 1e-5 over 1k steps. CI-scaled
    # version (512 bodies, 200 steps); chip_smoke.py phase (c) runs the
    # full config-3 gate on the card.
    state = init.plummer(jax.random.key(21), 512)
    soft = 1e-2
    cfg = SimConfig(n=512, dt=1e-3, steps=200, integrator="leapfrog",
                    softening=soft, backend="jnp", use_masses=True)
    e0 = float(diag.total_energy(state, soft))
    out = simulate(cfg, state)
    e1 = float(diag.total_energy(out, soft))
    assert abs(e1 - e0) / abs(e0) < 1e-5


class TestRolloutRemat:
    """make_rollout_fn: checkpointed trajectory adjoints must match the
    plain differentiable scan exactly (recompute is deterministic)."""

    def _grad(self, remat, steps=10, integrator="leapfrog"):
        import dataclasses

        from mini_nbody_tpu.sim import init_carry, make_rollout_fn

        n = 64
        cfg = SimConfig(n=n, dt=1e-3, steps=steps, backend="jnp",
                        softening=1e-2, use_masses=True,
                        integrator=integrator)
        s = init.plummer(jax.random.key(21), n)
        carry0 = init_carry(cfg, s)
        roll = make_rollout_fn(cfg, steps, remat=remat)

        def loss(pos0):
            st = dataclasses.replace(carry0[0], pos=pos0)
            out, _ = roll((st, carry0[1]))
            return jnp.sum(out.pos ** 2)

        return np.asarray(jax.grad(loss)(s.pos)), np.asarray(
            jax.jit(loss)(s.pos))

    def test_sqrt_matches_none(self):
        g0, l0 = self._grad("none")
        g1, l1 = self._grad("sqrt")
        np.testing.assert_allclose(l1, l0, rtol=1e-6)
        np.testing.assert_allclose(g1, g0, rtol=1e-5, atol=1e-6)

    def test_step_matches_none(self):
        g0, _ = self._grad("none")
        g1, _ = self._grad("step")
        np.testing.assert_allclose(g1, g0, rtol=1e-5, atol=1e-6)

    def test_sqrt_ragged_segments(self):
        # steps=11 -> inner=3, full=3, rem=2: remainder path
        g0, _ = self._grad("none", steps=11)
        g1, _ = self._grad("sqrt", steps=11)
        np.testing.assert_allclose(g1, g0, rtol=1e-5, atol=1e-6)

    def test_bad_remat(self):
        from mini_nbody_tpu.sim import make_rollout_fn

        with pytest.raises(ValueError):
            make_rollout_fn(SimConfig(n=8), 4, remat="bogus")


class TestRK4:
    def test_matches_fp64_numpy_rk4(self):
        """One fp32 RK4 step vs an fp64 NumPy implementation of the same
        Butcher tableau over the exact softened-gravity force."""
        import numpy as np

        from mini_nbody_tpu.models import init
        from mini_nbody_tpu.ops.integrators import rk4_step

        n, dt, soft = 96, 1e-3, 1e-2
        s = init.plummer(jax.random.key(2), n)
        x0 = np.asarray(s.pos, np.float64)
        v0 = np.asarray(s.vel, np.float64)
        m = np.asarray(s.mass, np.float64)

        def a(x):
            d = x[None, :, :] - x[:, None, :]
            r2 = (d * d).sum(-1) + soft
            return (d * ((r2 ** -1.5) * m[None, :])[:, :, None]).sum(1)

        k1v, k1x = a(x0), v0
        k2v, k2x = a(x0 + 0.5 * dt * k1x), v0 + 0.5 * dt * k1v
        k3v, k3x = a(x0 + 0.5 * dt * k2x), v0 + 0.5 * dt * k2v
        k4v, k4x = a(x0 + dt * k3x), v0 + dt * k3v
        xr = x0 + dt / 6 * (k1x + 2 * k2x + 2 * k3x + k4x)
        vr = v0 + dt / 6 * (k1v + 2 * k2v + 2 * k3v + k4v)

        def force(pi, pj, mass):
            from mini_nbody_tpu.ops.reference import body_force_jnp

            return body_force_jnp(pi, pj, mass, softening=soft)

        out, acc = rk4_step(s, None, force, dt)
        scale = np.abs(xr).max()
        np.testing.assert_allclose(np.asarray(out.pos), xr, rtol=1e-5,
                                   atol=1e-6 * scale)
        np.testing.assert_allclose(np.asarray(out.vel), vr, rtol=1e-5,
                                   atol=1e-6 * np.abs(vr).max())

    def test_energy_conservation_beats_euler(self):
        from mini_nbody_tpu import SimConfig, simulate
        from mini_nbody_tpu.models import init
        from mini_nbody_tpu.ops import diagnostics as diag

        n = 128
        s = init.plummer(jax.random.key(5), n)
        e0 = float(diag.total_energy(s, 1e-2))

        def drift(integrator):
            cfg = SimConfig(n=n, dt=2e-3, steps=50, softening=1e-2,
                            backend="jnp", use_masses=True,
                            integrator=integrator)
            out = simulate(cfg, s)
            return abs(float(diag.total_energy(out, 1e-2)) - e0) / abs(e0)

        assert drift("rk4") < drift("euler") / 10

    def test_rk4_sharded_and_differentiable(self):
        import jax.numpy as jnp
        import numpy as np

        from mini_nbody_tpu import SimConfig, simulate
        from mini_nbody_tpu.models import init
        from mini_nbody_tpu.parallel import make_mesh
        from mini_nbody_tpu.parallel.sharded import simulate_sharded
        from mini_nbody_tpu.sim import make_step_fn

        if len(jax.devices()) < 8:
            import pytest

            pytest.skip("needs 8 devices")
        n = 160
        s = init.plummer(jax.random.key(6), n)
        cfg = SimConfig(n=n, dt=1e-3, steps=3, softening=1e-2,
                        backend="jnp", use_masses=True, integrator="rk4",
                        comm="ring", mesh_shape=(8,))
        ref = simulate(cfg.replace(mesh_shape=None, comm="all_gather"), s)
        out = simulate_sharded(cfg, make_mesh(8), s)
        scale = np.abs(np.asarray(ref.pos)).max()
        np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                                   rtol=1e-4, atol=1e-5 * scale)
        # differentiable: grad flows through four force evals per step
        step = make_step_fn(cfg.replace(mesh_shape=None), differentiable=True)

        def loss(p):
            import dataclasses

            st = dataclasses.replace(s, pos=p)
            (st2, _), = [step((st, jnp.zeros_like(p)))]
            return jnp.sum(st2.pos ** 2)

        g = jax.grad(loss)(s.pos)
        assert np.isfinite(np.asarray(g)).all()

class TestYoshida4:
    """4th-order symplectic Yoshida integrator (ops/integrators.py)."""

    def _drift(self, integrator, dt, steps, s, e0):
        from mini_nbody_tpu import SimConfig, simulate
        from mini_nbody_tpu.ops import diagnostics as diag

        cfg = SimConfig(n=s.pos.shape[0], dt=dt, steps=steps,
                        softening=1e-2, backend="jnp", use_masses=True,
                        integrator=integrator)
        out = simulate(cfg, s)
        return abs(float(diag.total_energy(out, 1e-2)) - e0) / abs(e0)

    def test_matches_fp64_numpy_yoshida(self):
        """One fp32 yoshida4 step vs an fp64 NumPy implementation of the
        same composition (three KDK substeps scaled by w1, w0, w1) —
        validates the coefficients exactly (the TestRK4 pattern)."""
        import numpy as np

        from mini_nbody_tpu.models import init
        from mini_nbody_tpu.ops.integrators import (
            _Y4_W0, _Y4_W1, yoshida4_step)

        n, dt, soft = 96, 1e-3, 1e-2
        s = init.plummer(jax.random.key(7), n)
        x = np.asarray(s.pos, np.float64)
        v = np.asarray(s.vel, np.float64)
        m = np.asarray(s.mass, np.float64)

        def a(x):
            d = x[None, :, :] - x[:, None, :]
            r2 = (d * d).sum(-1) + soft
            return (d * ((r2 ** -1.5) * m[None, :])[:, :, None]).sum(1)

        acc = a(x)
        for w in (_Y4_W1, _Y4_W0, _Y4_W1):
            h = w * dt
            vh = v + 0.5 * h * acc
            x = x + h * vh
            acc = a(x)
            v = vh + 0.5 * h * acc

        def force(pi, pj, mass):
            from mini_nbody_tpu.ops.reference import body_force_jnp

            return body_force_jnp(pi, pj, mass, softening=soft)

        out, _ = yoshida4_step(s, force(s.pos, s.pos, s.mass), force, dt)
        np.testing.assert_allclose(np.asarray(out.pos), x, rtol=1e-5,
                                   atol=1e-6 * np.abs(x).max())
        np.testing.assert_allclose(np.asarray(out.vel), v, rtol=1e-5,
                                   atol=1e-6 * np.abs(v).max())

    def test_energy_beats_leapfrog_at_same_dt(self):
        # dt chosen so truncation error dominates the fp32 noise floor
        # (measured: leapfrog 2.2e-5 vs yoshida4 4.7e-7 at dt=1e-2/50 steps)
        from mini_nbody_tpu.models import init
        from mini_nbody_tpu.ops import diagnostics as diag

        n = 128
        s = init.plummer(jax.random.key(8), n)
        e0 = float(diag.total_energy(s, 1e-2))
        d_y = self._drift("yoshida4", 1e-2, 50, s, e0)
        d_lf = self._drift("leapfrog", 1e-2, 50, s, e0)
        assert d_y < d_lf / 10, (d_y, d_lf)

    def test_sharded_matches_single(self):
        import numpy as np

        from mini_nbody_tpu import SimConfig, simulate
        from mini_nbody_tpu.models import init
        from mini_nbody_tpu.parallel import make_mesh
        from mini_nbody_tpu.parallel.sharded import simulate_sharded

        if len(jax.devices()) < 8:
            pytest.skip("needs 8 devices")
        n = 160
        s = init.plummer(jax.random.key(9), n)
        cfg = SimConfig(n=n, dt=1e-3, steps=3, softening=1e-2,
                        backend="jnp", use_masses=True,
                        integrator="yoshida4", comm="ring", mesh_shape=(8,))
        ref = simulate(cfg.replace(mesh_shape=None, comm="all_gather"), s)
        out = simulate_sharded(cfg, make_mesh(8), s)
        scale = np.abs(np.asarray(ref.pos)).max()
        np.testing.assert_allclose(np.asarray(out.pos),
                                   np.asarray(ref.pos),
                                   rtol=1e-4, atol=1e-5 * scale)


def _np_accel(x, m, soft):
    d = x[None, :, :] - x[:, None, :]
    r2 = (d * d).sum(-1) + soft
    return (d * ((r2 ** -1.5) * m[None, :])[:, :, None]).sum(1)


def _np_integrate(integrator, x, v, m, dt, steps, soft):
    """fp64 NumPy twins of the four integrators (ops/integrators.py)."""
    from mini_nbody_tpu.ops.integrators import _Y4_W0, _Y4_W1

    def kdk(x, v, a, h):
        vh = v + 0.5 * h * a
        x = x + h * vh
        a = _np_accel(x, m, soft)
        return x, vh + 0.5 * h * a, a

    a = _np_accel(x, m, soft)
    for _ in range(steps):
        if integrator == "euler":
            v = v + dt * _np_accel(x, m, soft)
            x = x + dt * v
        elif integrator == "leapfrog":
            x, v, a = kdk(x, v, a, dt)
        elif integrator == "yoshida4":
            for w in (_Y4_W1, _Y4_W0, _Y4_W1):
                x, v, a = kdk(x, v, a, w * dt)
        else:
            k1v, k1x = _np_accel(x, m, soft), v
            k2v = _np_accel(x + 0.5 * dt * k1x, m, soft)
            k2x = v + 0.5 * dt * k1v
            k3v = _np_accel(x + 0.5 * dt * k2x, m, soft)
            k3x = v + 0.5 * dt * k2v
            k4v = _np_accel(x + dt * k3x, m, soft)
            k4x = v + dt * k3v
            x = x + dt / 6 * (k1x + 2 * k2x + 2 * k3x + k4x)
            v = v + dt / 6 * (k1v + 2 * k2v + 2 * k3v + k4v)
    return x, v


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("use_masses", [False, True])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog", "rk4",
                                        "yoshida4"])
def test_simulate_matches_fp64_numpy(integrator, use_masses, backend):
    """simulate() against an fp64 NumPy run of the same integrator, for
    both force paths, unit and Plummer masses (ragged N=75)."""
    n, dt, steps, soft = 75, 1e-3, 6, 1e-2
    s = init.plummer(jax.random.key(31), n)
    m = np.asarray(s.mass, np.float64) if use_masses else np.ones(n)
    cfg = SimConfig(n=n, dt=dt, steps=steps, softening=soft,
                    integrator=integrator, backend=backend, interpret=True,
                    use_masses=use_masses)
    out = simulate(cfg, s)
    x, v = _np_integrate(integrator, np.asarray(s.pos, np.float64),
                         np.asarray(s.vel, np.float64), m, dt, steps, soft)
    np.testing.assert_allclose(np.asarray(out.pos), x, rtol=1e-5,
                               atol=1e-6 * np.abs(x).max())
    np.testing.assert_allclose(np.asarray(out.vel), v, rtol=1e-4,
                               atol=1e-5 * np.abs(v).max())


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("integrator", ["euler", "leapfrog"])
def test_trajectory_matches_simulate(integrator, backend):
    s = init.plummer(jax.random.key(32), 40)
    cfg = SimConfig(n=40, dt=1e-3, steps=6, softening=1e-2,
                    integrator=integrator, backend=backend, interpret=True,
                    use_masses=True)
    final, hist = trajectory(cfg, s, steps=6, save_every=3)
    assert hist.shape == (2, 40, 3)
    ref = simulate(cfg, s)
    np.testing.assert_array_equal(np.asarray(final.pos), np.asarray(ref.pos))
    np.testing.assert_array_equal(np.asarray(hist[-1]), np.asarray(ref.pos))
    mid = simulate(cfg, s, steps=3)
    np.testing.assert_allclose(np.asarray(hist[0]), np.asarray(mid.pos),
                               rtol=1e-6, atol=1e-7)


def test_trajectory_divisibility():
    s = init.uniform_random(jax.random.key(0), 16)
    with pytest.raises(ValueError, match="divisible"):
        trajectory(SimConfig(n=16, backend="jnp"), s, steps=5, save_every=2)
