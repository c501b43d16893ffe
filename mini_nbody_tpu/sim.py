"""The step loop: jit + lax.scan over integration steps.

Replacement for the reference's control plane (SURVEY.md §1 L5-L7): the
4-state FSM scheduler (``waiting -> block_setup -> compute -> complete``,
``src/top_level.vhd:50-51,176-272``) and the host's poll-the-control-word
protocol (``src/top_level.vhd:184-186,255-262``) collapse into a single XLA
program — ``simulate`` traces the whole multi-step trajectory once, so there
is no per-step host round-trip at all (the reference pays a PS<->PL handshake
per force pass).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import jax

from mini_nbody_tpu.models.state import BodyState
from mini_nbody_tpu.ops.force import make_force_fn
from mini_nbody_tpu.ops.integrators import INTEGRATORS, initial_acc
from mini_nbody_tpu.utils.config import SimConfig


def make_step_fn(cfg: SimConfig, differentiable: bool = False):
    """Build ``step((state, acc)) -> (state, acc)`` for one dt of config cfg.

    Single-device version; for mesh-sharded steps see parallel.sharded.
    differentiable=True attaches the analytic force VJP (ops/autodiff), so
    jax.grad flows through whole trajectories regardless of backend.
    """
    if differentiable:
        from mini_nbody_tpu.ops.autodiff import make_differentiable_force

        diff = make_differentiable_force(cfg)

        def force(pos_i, pos_j, mass_j=None):
            return diff(pos_i, mass_j)
    else:
        force = make_force_fn(cfg)
    integ = INTEGRATORS[cfg.integrator]

    def step(carry):
        state, acc = carry
        return integ(state, acc, force, cfg.dt)

    return step


def init_carry(cfg: SimConfig, state: BodyState):
    """(state, acc) carry; evaluates the initial acceleration for leapfrog."""
    force = make_force_fn(cfg)
    return state, initial_acc(state, force, cfg.integrator)


def _scan_steps(step, carry, steps: int):
    def body(c, _):
        return step(c), None

    return jax.lax.scan(body, carry, None, length=steps)[0]


@partial(jax.jit, static_argnames=("cfg", "steps"))
def _simulate_scan(cfg: SimConfig, carry, steps: int):
    return _scan_steps(make_step_fn(cfg), carry, steps)


def simulate(
    cfg: SimConfig,
    state: BodyState,
    steps: Optional[int] = None,
) -> BodyState:
    """Run `steps` (default cfg.steps) integration steps as ONE XLA program
    (no per-step host round-trip — the reference pays a PS<->PL handshake per
    force pass)."""
    steps = cfg.steps if steps is None else steps
    state, _ = _simulate_scan(cfg, init_carry(cfg, state), steps)
    return state


def make_rollout_fn(cfg: SimConfig, steps: int, remat: str = "sqrt"):
    """Differentiable multi-step rollout ``(state, acc) -> (state, acc)``
    with gradient-checkpointed memory — the memory-for-FLOPs trade that makes
    ``jax.grad`` through LONG trajectories fit on the device.

    A naive differentiable scan stores every step's VJP residuals
    (positions + masses per custom_vjp step: ~16 MB/step at N=1M, so a
    1000-step adjoint would want ~16 GB). remat policies:

      * "none": plain scan; residuals for every step live until the
        backward pass (fastest backward, O(steps) memory).
      * "step": each step wrapped in jax.checkpoint — only the per-step
        carries survive the forward; each step's force recomputes in the
        backward (O(steps) carries, no residuals).
      * "sqrt" (default): the scan is split into ~sqrt(steps) checkpointed
        segments of ~sqrt(steps) steps; the forward keeps one carry per
        SEGMENT and the backward recomputes one segment at a time —
        O(sqrt(steps)) live states, one extra forward of compute. The
        standard recursive-checkpoint sweet spot for trajectory adjoints.

    The rollout composes with jax.grad/jax.vjp like any pure function:
    ``jax.grad(lambda p: loss(rollout((replace(state, pos=p), acc))))``.
    """
    if remat not in ("none", "step", "sqrt"):
        raise ValueError(f"remat must be 'none', 'step' or 'sqrt', got {remat!r}")
    step = make_step_fn(cfg, differentiable=True)
    if remat == "step":
        step = jax.checkpoint(step)
    if remat != "sqrt" or steps <= 2:
        return partial(_scan_steps, step, steps=steps)

    inner = max(1, math.isqrt(steps))
    full, rem = divmod(steps, inner)
    segment = jax.checkpoint(partial(_scan_steps, step, steps=inner))

    def rollout(carry):
        carry = _scan_steps(segment, carry, full)
        if rem:
            carry = _scan_steps(step, carry, rem)
        return carry

    return rollout


def _snapshot_scan(step, carry, steps: int, save_every: int):
    """Scan `steps` steps, stacking positions after every save_every-th."""

    def outer(c, _):
        c = _scan_steps(step, c, save_every)
        return c, c[0].pos

    return jax.lax.scan(outer, carry, None, length=steps // save_every)


@partial(jax.jit, static_argnames=("cfg", "steps", "save_every"))
def _trajectory_scan(cfg: SimConfig, carry, steps: int, save_every: int):
    return _snapshot_scan(make_step_fn(cfg), carry, steps, save_every)


def trajectory(cfg: SimConfig, state: BodyState, steps: int, save_every: int = 1):
    """Like simulate, but also returns stacked position snapshots every
    `save_every` steps: (state_final, pos_history[steps//save_every, N, 3]).
    """
    if steps % save_every != 0:
        raise ValueError("steps must be divisible by save_every")
    carry, hist = _trajectory_scan(cfg, init_carry(cfg, state), steps,
                                   save_every)
    return carry[0], hist


def _ensemble_force(cfg: SimConfig, mesh, b: int):
    """(pos (B,N,3), mass (B,N)) -> (B,N,3): jax.vmap of the single-system
    force (a batch grid axis on the Pallas kernel, a batch dimension for
    XLA); 'auto' resolves on the B*N bodies of one batched call. No
    cross-system pairs exist, so under a mesh the batch shards
    data-parallel with zero collectives."""
    single = make_force_fn(cfg, cfg.resolve_backend(bodies=b * cfg.n))
    batched = jax.vmap(lambda p, m: single(p, p, m))
    if mesh is None:
        return batched
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    bspec = P(mesh.axis_names[0])
    return shard_map(batched, mesh=mesh, in_specs=(bspec, bspec),
                     out_specs=bspec, check_vma=False)


def _ensemble_step(cfg: SimConfig, mesh, b: int):
    force = _ensemble_force(cfg, mesh, b)
    integ = INTEGRATORS[cfg.integrator]

    def step(carry):
        s, a = carry
        return integ(s, a, lambda pi, pj, mj: force(pi, mj), cfg.dt)

    return step


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _ensemble_initial_acc(cfg: SimConfig, mesh, st):
    force = _ensemble_force(cfg, mesh, st.pos.shape[0])
    return initial_acc(st, lambda pi, pj, mj: force(pi, mj), cfg.integrator)


@partial(jax.jit, static_argnames=("cfg", "mesh", "steps"))
def _ensemble_scan(cfg: SimConfig, mesh, carry, steps: int):
    step = _ensemble_step(cfg, mesh, carry[0].pos.shape[0])
    return _scan_steps(step, carry, steps)


@partial(jax.jit, static_argnames=("cfg", "mesh", "steps", "save_every"))
def _ensemble_traj_scan(cfg: SimConfig, mesh, carry, steps: int,
                        save_every: int):
    step = _ensemble_step(cfg, mesh, carry[0].pos.shape[0])
    return _snapshot_scan(step, carry, steps, save_every)


def _ensemble_prepare(cfg: SimConfig, state: BodyState, mesh):
    """Validate a batched state, place it on the mesh, and build the
    initial (state, acc) carry."""
    if state.pos.ndim != 3:
        raise ValueError(
            f"ensemble entry points need batched state (B, N, 3); got pos "
            f"{state.pos.shape}")
    b, n = state.pos.shape[0], state.pos.shape[1]
    if n != cfg.n:
        raise ValueError(f"cfg.n={cfg.n} != per-system N={n}")
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        nd = mesh.devices.size
        if b % nd != 0:
            raise ValueError(
                f"ensemble batch B={b} must divide the mesh size {nd}")
        ax = mesh.axis_names[0]
        state = jax.tree_util.tree_map(
            lambda x: jax.device_put(
                x, NamedSharding(mesh, P(ax, *([None] * (x.ndim - 1))))),
            state)
    return state, _ensemble_initial_acc(cfg, mesh, state)


def simulate_ensemble(cfg: SimConfig, state: BodyState, steps: int = None,
                      mesh=None):
    """Integrate B INDEPENDENT N-body systems batched in one program.

    state fields carry a leading batch dim: pos/vel (B, N, 3), mass (B, N).
    The force is jax.vmap of the single-system force, so every backend and
    integrator works and each system's result equals its own simulate() up
    to the order of fp32 sums.

    mesh (optional jax.sharding.Mesh, first axis = the batch axis): shard
    the B systems data-parallel over devices — ZERO collectives (no
    cross-system pairs). Requires B % mesh.devices.size == 0.

    The answer to parameter sweeps / perturbation ensembles — a workload
    the reference could only serve one RAM-load at a time
    (``src/top_level.vhd:180-186``).
    """
    steps = cfg.steps if steps is None else steps
    state, acc = _ensemble_prepare(cfg, state, mesh)
    return _ensemble_scan(cfg, mesh, (state, acc), steps)[0]


def trajectory_ensemble(cfg: SimConfig, state: BodyState, steps: int = None,
                        save_every: int = 1, mesh=None):
    """simulate_ensemble + stacked per-system position snapshots: returns
    (state_final, pos_history[steps//save_every, B, N, 3]).

    Snapshot semantics match trajectory(): one snapshot AFTER every
    `save_every`-th step; under a mesh the history stays batch-sharded.
    """
    steps = cfg.steps if steps is None else steps
    if steps % save_every != 0:
        raise ValueError("steps must be divisible by save_every")
    state, acc = _ensemble_prepare(cfg, state, mesh)
    carry, hist = _ensemble_traj_scan(cfg, mesh, (state, acc), steps,
                                      save_every)
    return carry[0], hist
