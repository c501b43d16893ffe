"""Mesh-sharded N-body step: shard_map + XLA collectives.

Bodies are sharded along "i" (each device owns N/P bodies' full state). Per
step every device must see all N source positions; two exchange strategies:

* ``all_gather``: one ``lax.all_gather`` of (pos, mass), then the
  local force kernel runs i-shard x N. Simple; XLA overlaps the gather with
  whatever it can.
* ``ring``: P-1 ``lax.ppermute`` hops, computing i-shard x j-shard between
  hops — the distributed generalization of the reference's j-target stream
  (one hop per j-shard instead of one RAM word per cycle,
  ``src/top_level.vhd:233-254``). Peak memory O(N/P) instead of O(N), and the
  hop is dependence-free from the force compute on the resident shard so
  XLA's latency-hiding scheduler can overlap the transfer with the
  O((N/P)^2) compute.

The reference's host<->accelerator polling protocol (begin bit / busy flags,
``src/top_level.vhd:184-196``) has no analog: dispatch and data dependence
replace flow control entirely.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from mini_nbody_tpu.models.state import BodyState
from mini_nbody_tpu.ops.autodiff import vjp_terms
from mini_nbody_tpu.ops.force import body_force
from mini_nbody_tpu.ops.integrators import INTEGRATORS, initial_acc
from mini_nbody_tpu.ops.reference import body_force_pair_jnp
from mini_nbody_tpu.parallel.mesh import BODY_AXIS, COL_AXIS
from mini_nbody_tpu.utils.config import SimConfig, round_up


def _body_axes(mesh: Mesh):
    """Mesh axes the body dimension is sharded over: ("i",) on a 1-D mesh,
    ("i", "j") on the 2-D pair-matrix grid."""
    return tuple(mesh.axis_names)


def _state_specs(mesh: Mesh):
    axes = _body_axes(mesh)
    return BodyState(pos=P(axes, None), vel=P(axes, None), mass=P(axes))


def shard_state(state: BodyState, mesh: Mesh, pad_far: bool = False) -> BodyState:
    """Pad N to a multiple of the mesh and lay the state out shard-by-body.
    pad_far=True places pad bodies at FAR (required for unit-mass configs,
    whose kernels ignore the zero masses)."""
    p = mesh.devices.size
    state = state.pad_to(round_up(state.n, p), far=pad_far)
    specs = _state_specs(mesh)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), state, specs
    )


def _make_local_force(cfg: SimConfig, n_shards: int):
    """Per-device force closure: local i-shard vs all N sources via the
    configured exchange. Signature matches ops.integrators.ForceFn."""
    def kern(pos_i, pos_j, mass_j):
        # unit-mass configs ignore the state's masses (pad bodies sit at FAR)
        return body_force(
            pos_i, pos_j, mass_j if cfg.use_masses else None,
            softening=cfg.softening, backend=cfg.resolve_backend(),
            tile_i=cfg.tile_i, tile_j=cfg.tile_j,
            interpret=cfg.interpret)

    if cfg.comm == "all_gather":

        def force(pos_local, _pos_j, mass_local):
            pos_all = jax.lax.all_gather(pos_local, BODY_AXIS, tiled=True)
            mass_all = jax.lax.all_gather(mass_local, BODY_AXIS, tiled=True)
            return kern(pos_local, pos_all, mass_all)

        return force

    if cfg.comm == "grid":
        # 2-D pair-matrix decomposition on an ("i" x "j") mesh: device
        # (a, b) computes forces on ROW group a (its "i"-row of shards,
        # gathered along "j") from COLUMN group b (its "j"-column of shards,
        # gathered along "i"); the row partials then reduce-scatter back
        # along "j" so every device ends with exactly its own shard's
        # forces. Per-step comm is O(N/Pi + N/Pj) = O(N/sqrt(P)) per device
        # vs the 1-D schemes' O(N) — the standard scalable decomposition
        # (every ordered pair computed exactly once: the row group fixes a,
        # the column group fixes b).

        def force(pos_local, _pos_j, mass_local):
            rows_pos = jax.lax.all_gather(pos_local, COL_AXIS, tiled=True)
            cols_pos = jax.lax.all_gather(pos_local, BODY_AXIS, tiled=True)
            cols_mass = jax.lax.all_gather(mass_local, BODY_AXIS, tiled=True)
            part = kern(rows_pos, cols_pos, cols_mass)  # (N/Pi, 3)
            return jax.lax.psum_scatter(
                part, COL_AXIS, scatter_dimension=0, tiled=True)

        return force

    if cfg.comm == "ring_sym":
        # Symmetric half-ring: Newton's third law ACROSS shards. A traveling
        # packet (positions [+ masses] + accumulated reactions) makes
        # floor(P/2) hops; at each hop the resident shard computes every
        # cross pair ONCE (body_force_pair_jnp: one weight block gives the
        # rows and, negated, the reactions), adding rows locally and
        # reactions into the packet, which finally returns to its owner in a
        # single logical ppermute. Half the pair arithmetic of the plain
        # ring for roughly the same traffic (3 arrays per hop instead of 2,
        # but half the hops). The self hop is the configured square force.
        use_m = cfg.use_masses
        half = n_shards // 2  # hops
        fwd = [(k, (k + 1) % n_shards) for k in range(n_shards)]
        back = [(k, (k - half) % n_shards) for k in range(n_shards)]

        def force(pos_local, _pos_j, mass_local):
            m_local = mass_local if use_m else None
            own = kern(pos_local, pos_local, mass_local)
            if n_shards == 1:
                return own
            pkt_pos = pos_local
            pkt_mass = m_local
            pkt_f = jnp.zeros_like(pos_local)
            for k in range(1, half + 1):
                pkt_pos = jax.lax.ppermute(pkt_pos, BODY_AXIS, fwd)
                if use_m:
                    pkt_mass = jax.lax.ppermute(pkt_mass, BODY_AXIS, fwd)
                pkt_f = jax.lax.ppermute(pkt_f, BODY_AXIS, fwd)
                fa, fb = body_force_pair_jnp(
                    pos_local, pkt_pos, m_local, pkt_mass,
                    softening=cfg.softening)
                if n_shards % 2 == 0 and k == half:
                    # Antipodal hop pairs each shard couple twice; keep the
                    # visit on the lower-index half of the ring.
                    keep = (jax.lax.axis_index(BODY_AXIS) < half).astype(
                        fa.dtype)
                    fa = fa * keep
                    fb = fb * keep
                own = own + fa
                pkt_f = pkt_f + fb
            # Return each packet's reactions to its owner (one permutation).
            return own + jax.lax.ppermute(pkt_f, BODY_AXIS, back)

        return force

    # Ring: rotate (pos, mass) shards around the mesh, one hop per shard.
    perm = [(k, (k + 1) % n_shards) for k in range(n_shards)]

    def force(pos_local, _pos_j, mass_local):
        acc = kern(pos_local, pos_local, mass_local)
        cur_pos, cur_mass = pos_local, mass_local
        # Unrolled python loop: n_shards is a static mesh property. Each
        # permute is issued before the hop's force and carries no data
        # dependence on it, so the scheduler can overlap the transfer with
        # the O((N/P)^2) math.
        for _ in range(n_shards - 1):
            cur_pos = jax.lax.ppermute(cur_pos, BODY_AXIS, perm)
            cur_mass = jax.lax.ppermute(cur_mass, BODY_AXIS, perm)
            acc = acc + kern(pos_local, cur_pos, cur_mass)
        return acc

    return force


def _make_local_diff_force(cfg: SimConfig, n_shards: int):
    """Differentiable per-device force: forward is the configured exchange
    (_make_local_force); backward is the analytic pairwise VJP evaluated with
    its own collective — the backward of a ppermute ring is a ppermute ring
    (here traversed in the same direction: the gradient is a plain sum over
    shards, so hop order is free), and the backward of the all-gather is an
    all-gather of the cotangents. Each hop/gather runs the pairwise VJP
    (ops/autodiff.vjp_terms, on the configured backend): local receivers x
    visiting sources. Gradients flow to positions only (mass cotangent 0,
    matching ops/autodiff.make_body_force_diff)."""
    base = _make_local_force(cfg, n_shards)
    use_m = cfg.use_masses
    ring = cfg.comm in ("ring", "ring_sym")
    perm = [(k, (k + 1) % n_shards) for k in range(n_shards)]
    vjp = partial(vjp_terms, cfg.resolve_backend(),
                  softening=float(cfg.softening),
                  interpret=cfg.interpret,
                  tile_i=cfg.tile_i, tile_j=cfg.tile_j)

    @jax.custom_vjp
    def force(pos_local, mass_local):
        return base(pos_local, pos_local, mass_local)

    def _fwd(pos_local, mass_local):
        return base(pos_local, pos_local, mass_local), (pos_local, mass_local)

    def _bwd(res, g_local):
        pos_local, mass_local = res
        m_local = mass_local if use_m else None
        if cfg.comm == "grid":
            # Transpose-structured O(N/sqrt(P)) backward: the mesh tiles
            # ALL ordered pairs as (row group, gathered over "j") x
            # (col group, gathered over "i") — the same tiling as the
            # forward. Each device takes the receiver terms for its rows and
            # the source terms for its columns. The psum_scatter transpose
            # rule supplies the row cotangents (the forward scattered over
            # COL_AXIS, so the backward all-gathers g over COL_AXIS), and two
            # psum_scatters — receiver grads over "j", source grads over "i"
            # — return each shard exactly its own bodies' gradient.
            rows_pos = jax.lax.all_gather(pos_local, COL_AXIS, tiled=True)
            g_rows = jax.lax.all_gather(g_local, COL_AXIS, tiled=True)
            cols_pos = jax.lax.all_gather(pos_local, BODY_AXIS, tiled=True)
            cols_m = (jax.lax.all_gather(mass_local, BODY_AXIS, tiled=True)
                      if use_m else None)
            a_bar = vjp(rows_pos, g_rows, None, cols_pos, None, cols_m,
                        src_terms=False)
            b_bar = vjp(cols_pos, None, cols_m, rows_pos, g_rows, None,
                        recv_terms=False)
            pos_bar = (
                jax.lax.psum_scatter(a_bar, COL_AXIS,
                                     scatter_dimension=0, tiled=True)
                + jax.lax.psum_scatter(b_bar, BODY_AXIS,
                                       scatter_dimension=0, tiled=True))
            return pos_bar, jnp.zeros_like(mass_local)
        if ring and n_shards > 1:
            acc = jnp.zeros_like(pos_local)
            # masses only travel when the force law uses them (unit-mass
            # configs would ppermute a dead array every hop)
            cur = (pos_local, g_local) + ((mass_local,) if use_m else ())
            for k in range(n_shards):
                acc = acc + vjp(pos_local, g_local, m_local, cur[0], cur[1],
                                cur[2] if use_m else None)
                if k < n_shards - 1:
                    cur = tuple(
                        jax.lax.ppermute(x, BODY_AXIS, perm) for x in cur)
            pos_bar = acc
        else:
            pos_all = jax.lax.all_gather(pos_local, BODY_AXIS, tiled=True)
            g_all = jax.lax.all_gather(g_local, BODY_AXIS, tiled=True)
            mass_all = (jax.lax.all_gather(mass_local, BODY_AXIS,
                                           tiled=True)
                        if use_m else None)
            pos_bar = vjp(pos_local, g_local, m_local, pos_all, g_all,
                          mass_all)
        return pos_bar, jnp.zeros_like(mass_local)

    force.defvjp(_fwd, _bwd)

    def force3(pos_local, _pos_j, mass_local):
        return force(pos_local, mass_local)

    return force3


def make_sharded_step_fn(cfg: SimConfig, mesh: Mesh,
                         differentiable: bool = False):
    """Build ``step((state, acc)) -> (state, acc)`` over a sharded carry.

    differentiable=True attaches the analytic force VJP with cross-shard
    collectives in the backward (_make_local_diff_force), so jax.grad flows
    through mesh-sharded trajectories."""
    n_shards = mesh.shape[BODY_AXIS]
    force = (_make_local_diff_force(cfg, n_shards) if differentiable
             else _make_local_force(cfg, n_shards))
    integ = INTEGRATORS[cfg.integrator]

    def local_step(carry):
        state, acc = carry
        return integ(state, acc, force, cfg.dt)

    specs = (_state_specs(mesh), P(_body_axes(mesh), None))
    # check_vma=False: Pallas out_shapes don't carry varying-mesh-axis info.
    return shard_map(
        local_step, mesh=mesh, in_specs=(specs,), out_specs=specs, check_vma=False
    )


def sharded_force(cfg: SimConfig, mesh: Mesh, state: BodyState):
    """Forces (N_pad, 3) of one exchange over a state laid out by
    shard_state — the force every sharded step evaluates, for checking the
    exchanges against a single-device force."""
    force = _make_local_force(cfg, mesh.shape[BODY_AXIS])
    return shard_map(
        lambda s: force(s.pos, s.pos, s.mass), mesh=mesh,
        in_specs=(_state_specs(mesh),), out_specs=P(_body_axes(mesh), None),
        check_vma=False,
    )(state)


def init_sharded_carry(cfg: SimConfig, mesh: Mesh, state: BodyState):
    n_shards = mesh.shape[BODY_AXIS]
    force = _make_local_force(cfg, n_shards)

    def local_init(state):
        return initial_acc(state, force, cfg.integrator)

    acc = shard_map(
        local_init,
        mesh=mesh,
        in_specs=(_state_specs(mesh),),
        out_specs=P(_body_axes(mesh), None),
        check_vma=False,
    )(state)
    return state, acc


@partial(jax.jit, static_argnames=("cfg", "mesh", "steps", "save_every"))
def _sharded_scan(cfg: SimConfig, mesh: Mesh, carry, steps: int,
                  save_every: int):
    """steps sharded steps as one program; snapshots of positions after
    every save_every-th step when save_every is nonzero."""
    step = make_sharded_step_fn(cfg, mesh)

    def run(c, k):
        return jax.lax.scan(lambda c2, _: (step(c2), None), c, None,
                            length=k)[0]

    if not save_every:
        return run(carry, steps), None

    def outer(c, _):
        c = run(c, save_every)
        return c, c[0].pos

    return jax.lax.scan(outer, carry, None, length=steps // save_every)


def simulate_sharded(cfg: SimConfig, mesh: Mesh, state: BodyState, steps=None):
    """Multi-step sharded trajectory as one XLA program. Returns the final
    state with the original (unpadded) N."""
    n = state.n
    steps = cfg.steps if steps is None else steps
    state = shard_state(state, mesh, pad_far=not cfg.use_masses)
    carry = init_sharded_carry(cfg, mesh, state)
    (final, _), _ = _sharded_scan(cfg, mesh, carry, steps, 0)
    return final.unpad(n)


def trajectory_sharded(cfg: SimConfig, mesh: Mesh, state: BodyState,
                       steps=None, save_every: int = 1):
    """Mesh-sharded ``sim.trajectory``: runs the sharded step loop and
    collects position snapshots every `save_every` steps. Returns
    (final_state, pos_history[steps // save_every, N, 3]) with the original
    (unpadded) N; the history is gathered to the host."""
    import numpy as np

    n = state.n
    steps = cfg.steps if steps is None else steps
    if steps % save_every != 0:
        raise ValueError("steps must be divisible by save_every")
    state = shard_state(state, mesh, pad_far=not cfg.use_masses)
    carry = init_sharded_carry(cfg, mesh, state)
    (final, _), hist = _sharded_scan(cfg, mesh, carry, steps, save_every)
    return final.unpad(n), np.asarray(hist)[:, :n]
