"""Mesh-sharded step on the virtual 8-device CPU mesh (SURVEY.md §4 gate)."""

import jax
import numpy as np
import pytest

from mini_nbody_tpu import SimConfig, simulate
from mini_nbody_tpu.models import init
from mini_nbody_tpu.parallel import make_mesh, shard_state, simulate_sharded
from mini_nbody_tpu.parallel.sharded import init_sharded_carry, make_sharded_step_fn


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices (the virtual CPU mesh)")
    return make_mesh(8)


@pytest.mark.parametrize("comm", ["all_gather", "ring"])
def test_sharded_matches_single_chip(mesh, comm):
    n = 512
    state = init.uniform_random(jax.random.key(0), n)
    cfg = SimConfig(n=n, dt=0.01, steps=5, backend="jnp", comm=comm)
    ref = simulate(cfg, state)
    out = simulate_sharded(cfg, mesh, state)
    scale = np.abs(np.asarray(ref.pos)).max()
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=1e-3, atol=1e-4 * scale
    )
    np.testing.assert_allclose(
        np.asarray(out.vel), np.asarray(ref.vel), rtol=1e-3, atol=1e-4 * scale
    )


@pytest.mark.parametrize("comm", ["all_gather", "ring"])
def test_sharded_pallas_interpret(mesh, comm):
    # Pallas kernel inside shard_map (interpret mode on CPU).
    n = 256
    state = init.uniform_random(jax.random.key(1), n)
    cfg = SimConfig(n=n, steps=2, backend="pallas", comm=comm,
                    tile_i=32, tile_j=64, interpret=True)
    ref = simulate(cfg.replace(backend="jnp"), state)
    out = simulate_sharded(cfg, mesh, state)
    scale = np.abs(np.asarray(ref.pos)).max()
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=1e-3, atol=1e-4 * scale
    )


def test_non_divisible_n_pads(mesh):
    # N not divisible by the mesh: shard_state pads with zero-mass bodies.
    n = 100
    state = init.uniform_random(jax.random.key(2), n)
    cfg = SimConfig(n=n, steps=3, backend="jnp")
    ref = simulate(cfg, state)
    out = simulate_sharded(cfg, mesh, state)
    assert out.n == n
    scale = np.abs(np.asarray(ref.pos)).max()
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=1e-3, atol=1e-4 * scale
    )


def test_leapfrog_sharded(mesh):
    n = 256
    state = init.plummer(jax.random.key(3), n)
    cfg = SimConfig(n=n, dt=1e-3, steps=10, integrator="leapfrog",
                    softening=1e-2, backend="jnp", comm="ring", use_masses=True)
    ref = simulate(cfg, state)
    out = simulate_sharded(cfg, mesh, state)
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=1e-3, atol=1e-4
    )


def test_output_stays_sharded(mesh):
    n = 512
    state = init.uniform_random(jax.random.key(4), n)
    cfg = SimConfig(n=n, steps=1, backend="jnp")
    sharded = shard_state(state, mesh)
    step = make_sharded_step_fn(cfg, mesh)
    carry = init_sharded_carry(cfg, mesh, sharded)
    out, _ = jax.jit(step)(carry)
    # The step must not implicitly replicate the state.
    assert not out.pos.sharding.is_fully_replicated
    assert out.pos.sharding.spec == jax.sharding.PartitionSpec("i", None)


def test_ring_symmetric_self_hop(mesh):
    # Unit-mass ring on the Pallas kernel (self hop and cross hops); results
    # must match the plain path.
    n = 512
    state = init.uniform_random(jax.random.key(7), n)
    cfg = SimConfig(n=n, steps=3, backend="pallas", comm="ring",
                    tile_i=32, tile_j=64, interpret=True)
    ref = simulate(cfg.replace(backend="jnp"), state)
    out = simulate_sharded(cfg, mesh, state)
    scale = np.abs(np.asarray(ref.pos)).max()
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=1e-3, atol=1e-4 * scale
    )


@pytest.mark.parametrize("p", [8, 5])
def test_ring_sym_matches_single_chip(p):
    # Symmetric half-ring (Newton's 3rd law across shards): even mesh (8)
    # exercises the antipodal half-band masking; odd mesh (5) the clean case.
    if len(jax.devices()) < p:
        pytest.skip("needs devices")
    m = make_mesh(p)
    n = 520  # not divisible by 5 or 8: padding path too
    state = init.uniform_random(jax.random.key(11), n)
    cfg = SimConfig(n=n, dt=0.01, steps=4, backend="jnp", comm="ring_sym")
    ref = simulate(cfg.replace(comm="ring"), state)
    out = simulate_sharded(cfg, m, state)
    scale = np.abs(np.asarray(ref.pos)).max()
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=1e-3, atol=1e-4 * scale
    )


@pytest.mark.parametrize("p", [8, 5])
def test_ring_sym_mass_mode(p):
    # Mass-mode half-ring: masses ride with the traveling packet; rows use
    # the packet's m, reactions the resident shard's m.
    if len(jax.devices()) < p:
        pytest.skip("needs devices")
    m = make_mesh(p)
    n = 520
    state = init.plummer(jax.random.key(13), n)
    cfg = SimConfig(n=n, dt=1e-3, steps=4, backend="jnp", comm="ring_sym",
                    softening=1e-2, use_masses=True)
    ref = simulate(cfg.replace(comm="ring"), state)
    out = simulate_sharded(cfg, m, state)
    scale = np.abs(np.asarray(ref.pos)).max()
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=1e-3, atol=1e-4 * scale
    )


def test_ring_mass_symmetric_self_hop(mesh):
    # Mass configs on the ring with the Pallas kernel; results must match
    # the jnp path.
    n = 512
    state = init.plummer(jax.random.key(17), n)
    cfg = SimConfig(n=n, dt=1e-3, steps=3, backend="pallas", comm="ring",
                    softening=1e-2, use_masses=True, tile_i=32, tile_j=64,
                    interpret=True)
    ref = simulate(cfg.replace(backend="jnp"), state)
    out = simulate_sharded(cfg, mesh, state)
    scale = np.abs(np.asarray(ref.pos)).max()
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=1e-3, atol=1e-4 * scale
    )


@pytest.mark.parametrize("comm", ["all_gather", "ring", "ring_sym"])
@pytest.mark.parametrize("use_masses", [False, True])
def test_differentiable_sharded_step(mesh, comm, use_masses):
    # jax.grad through a 5-step mesh-sharded trajectory must match the
    # single-device differentiable step. Backward runs the pairwise VJP per
    # gather/ring-hop.
    import jax.numpy as jnp
    from mini_nbody_tpu.models.state import BodyState
    from mini_nbody_tpu.parallel.sharded import _state_specs
    from mini_nbody_tpu.sim import make_step_fn

    n = 256
    s = (init.plummer if use_masses else init.uniform_random)(
        jax.random.key(31), n)
    cfg = SimConfig(n=n, dt=1e-3, steps=5, backend="jnp", comm=comm,
                    softening=1e-2, use_masses=use_masses)

    step1 = make_step_fn(cfg, differentiable=True)

    def loss_single(pos0):
        carry = (BodyState(pos=pos0, vel=s.vel, mass=s.mass),
                 jnp.zeros_like(pos0))
        for _ in range(5):
            carry = step1(carry)
        return jnp.sum(carry[0].pos ** 2)

    ref = np.asarray(jax.grad(loss_single)(s.pos))

    stepP = make_sharded_step_fn(cfg, mesh, differentiable=True)
    specs = _state_specs(mesh)

    def loss_sharded(pos0):
        state = BodyState(pos=pos0, vel=s.vel, mass=s.mass)
        state = jax.tree_util.tree_map(
            lambda x, sp: jax.lax.with_sharding_constraint(
                x, jax.sharding.NamedSharding(mesh, sp)), state, specs)
        carry = (state, jnp.zeros_like(pos0))
        for _ in range(5):
            carry = stepP(carry)
        return jnp.sum(carry[0].pos ** 2)

    got = np.asarray(jax.jit(jax.grad(loss_sharded))(s.pos))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2), (8, 1), (1, 8)])
def test_grid_2d_matches_single_chip(shape):
    # 2-D pair-matrix decomposition: device (a,b) computes rows a x cols b;
    # per-device comm O(N/sqrt(P)) (SURVEY §2 item 6 "1-D or 2-D mesh").
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    m = make_mesh(shape)
    n = 512
    state = init.plummer(jax.random.key(51), n)
    cfg = SimConfig(n=n, dt=1e-3, steps=5, backend="jnp", comm="grid",
                    softening=1e-2, use_masses=True, mesh_shape=shape)
    ref = simulate(cfg.replace(mesh_shape=None, comm="all_gather"), state)
    out = simulate_sharded(cfg, m, state)
    scale = np.abs(np.asarray(ref.pos)).max()
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=1e-3, atol=1e-4 * scale
    )


def test_grid_2d_pallas_and_padding():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    m = make_mesh((2, 4))
    n = 300  # not divisible by 8: padding path
    state = init.uniform_random(jax.random.key(52), n)
    cfg = SimConfig(n=n, steps=3, backend="pallas", comm="grid",
                    mesh_shape=(2, 4), tile_i=32, tile_j=64, interpret=True)
    ref = simulate(cfg.replace(mesh_shape=None, comm="all_gather",
                               backend="jnp"), state)
    out = simulate_sharded(cfg, m, state)
    assert out.n == n
    scale = np.abs(np.asarray(ref.pos)).max()
    np.testing.assert_allclose(
        np.asarray(out.pos), np.asarray(ref.pos), rtol=1e-3, atol=1e-4 * scale
    )


def test_grid_2d_differentiable():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    import jax.numpy as jnp
    from mini_nbody_tpu.models.state import BodyState
    from mini_nbody_tpu.parallel.sharded import _state_specs
    from mini_nbody_tpu.sim import make_step_fn

    m = make_mesh((2, 4))
    n = 256
    s = init.plummer(jax.random.key(53), n)
    cfg = SimConfig(n=n, dt=1e-3, steps=3, backend="jnp", comm="grid",
                    softening=1e-2, use_masses=True, mesh_shape=(2, 4))

    step1 = make_step_fn(cfg.replace(mesh_shape=None, comm="all_gather"),
                         differentiable=True)

    def loss_single(pos0):
        carry = (BodyState(pos=pos0, vel=s.vel, mass=s.mass),
                 jnp.zeros_like(pos0))
        for _ in range(3):
            carry = step1(carry)
        return jnp.sum(carry[0].pos ** 2)

    ref = np.asarray(jax.grad(loss_single)(s.pos))

    stepP = make_sharded_step_fn(cfg, m, differentiable=True)
    specs = _state_specs(m)

    def loss_sharded(pos0):
        state = BodyState(pos=pos0, vel=s.vel, mass=s.mass)
        state = jax.tree_util.tree_map(
            lambda x, sp: jax.lax.with_sharding_constraint(
                x, jax.sharding.NamedSharding(m, sp)), state, specs)
        carry = (state, jnp.zeros_like(pos0))
        for _ in range(3):
            carry = stepP(carry)
        return jnp.sum(carry[0].pos ** 2)

    got = np.asarray(jax.jit(jax.grad(loss_sharded))(s.pos))
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


def test_two_process_distributed_cpu():
    """REAL multi-process jax.distributed on localhost (config 5's
    multi-host axis, as far as one host allows): coordinator
    handshake, gloo CPU collectives, a ring_sym trajectory whose every
    ppermute hop crosses the process boundary, gathered and checked against
    a single-device run inside each worker (examples/multihost_cpu.py)."""
    import subprocess
    import sys
    from pathlib import Path

    script = Path(__file__).resolve().parents[1] / "examples" / "multihost_cpu.py"
    res = subprocess.run(
        [sys.executable, str(script)], capture_output=True, text=True,
        timeout=280,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert "multihost OK: 2 processes" in res.stdout


@pytest.mark.parametrize("shape", [(2, 3), (3, 2)])
def test_grid_2d_non_pow2_mesh(shape):
    # 6 = 2x3 devices: neither mesh axis a power of two (gathers/scatters
    # must not assume one); forward AND the O(N/sqrt(P)) backward.
    if len(jax.devices()) < 6:
        pytest.skip("needs 6 devices")
    import jax.numpy as jnp
    from mini_nbody_tpu.models.state import BodyState
    from mini_nbody_tpu.parallel.sharded import _state_specs
    from mini_nbody_tpu.sim import make_step_fn

    m = make_mesh(shape)
    n = 288  # divisible by 6, not by any power of two past 32
    s = init.plummer(jax.random.key(54), n)
    cfg = SimConfig(n=n, dt=1e-3, steps=3, backend="jnp", comm="grid",
                    softening=1e-2, use_masses=True, mesh_shape=shape)
    ref = simulate(cfg.replace(mesh_shape=None, comm="all_gather"), s)
    out = simulate_sharded(cfg, m, s)
    scale = np.abs(np.asarray(ref.pos)).max()
    np.testing.assert_allclose(np.asarray(out.pos), np.asarray(ref.pos),
                               rtol=1e-4, atol=1e-5 * scale)

    step1 = make_step_fn(cfg.replace(mesh_shape=None, comm="all_gather"),
                         differentiable=True)
    stepP = make_sharded_step_fn(cfg, m, differentiable=True)
    specs = _state_specs(m)

    def loss(step, pos0, constrain):
        state = BodyState(pos=pos0, vel=s.vel, mass=s.mass)
        if constrain:
            state = jax.tree_util.tree_map(
                lambda x, sp: jax.lax.with_sharding_constraint(
                    x, jax.sharding.NamedSharding(m, sp)), state, specs)
        carry = (state, jnp.zeros_like(pos0))
        for _ in range(2):
            carry = step(carry)
        return jnp.sum(carry[0].pos ** 2)

    gref = np.asarray(jax.grad(lambda p: loss(step1, p, False))(s.pos))
    got = np.asarray(jax.jit(
        jax.grad(lambda p: loss(stepP, p, True)))(s.pos))
    scale = np.abs(gref).max()
    np.testing.assert_allclose(got, gref, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.parametrize("comm", ["all_gather", "ring_sym"])
def test_trajectory_sharded_matches_single_chip(comm):
    # Sharded snapshot collection: history and final state must match
    # sim.trajectory on one device.
    from mini_nbody_tpu.parallel.sharded import trajectory_sharded
    from mini_nbody_tpu.sim import trajectory

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    m = make_mesh(8)
    n = 200  # pads to 8 shards
    s = init.plummer(jax.random.key(60), n)
    cfg = SimConfig(n=n, dt=1e-3, steps=6, backend="jnp", comm=comm,
                    softening=1e-2, use_masses=True, mesh_shape=(8,))
    ref_final, ref_hist = trajectory(
        cfg.replace(mesh_shape=None, comm="all_gather"), s, steps=6,
        save_every=2)
    out_final, hist = trajectory_sharded(cfg, m, s, steps=6, save_every=2)
    assert hist.shape == (3, n, 3)
    scale = np.abs(np.asarray(ref_hist)).max()
    np.testing.assert_allclose(hist, np.asarray(ref_hist),
                               rtol=1e-4, atol=1e-5 * scale)
    np.testing.assert_allclose(np.asarray(out_final.pos),
                               np.asarray(ref_final.pos),
                               rtol=1e-4, atol=1e-5 * scale)
    with pytest.raises(ValueError, match="divisible"):
        trajectory_sharded(cfg, m, s, steps=5, save_every=2)
