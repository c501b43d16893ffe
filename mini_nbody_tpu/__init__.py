"""mini_nbody_tpu — an N-body simulation engine (JAX/XLA/Pallas).

A from-scratch re-design of the capabilities of the onur-v/mini-nbody reference
(an FPGA accelerator for the softened all-pairs ``bodyForce`` gravity kernel,
``vec_add.srcs/sources_1/new/``, plus its host-side step loop):

* the O(N^2) softened-gravity interaction loop as plain jnp that XLA
  compiles anywhere (``ops.reference``) and as a Pallas-Triton kernel for
  NVIDIA GPUs (``ops.pallas_force``),
* semi-implicit Euler (reference semantics), leapfrog/KDK, RK4 and Yoshida-4
  integrators,
* multi-step trajectories under ``jit`` + ``lax.scan`` (``sim``), batched
  ensembles and differentiable, checkpointed rollouts,
* mesh scale-out via ``shard_map`` with per-step position all-gather, a
  ``ppermute`` ring, a symmetric half-ring or a 2-D pair grid (``parallel``),
* a shmoo benchmark harness reporting GInteractions/s and the share of the
  device's fp32 peak (``utils.harness``, ``cli``).

Physics fidelity mirrors the reference: SOFTENING = 1e-9 (fp32, baked at
``src/dzsoft.vhd:177``), self-interaction computed-not-skipped (zero
contribution; see ``src/fxyz.vhd:120-127``), dt = 0.01 Euler semantics.
"""

from mini_nbody_tpu.utils.config import SimConfig
from mini_nbody_tpu.models.state import BodyState
from mini_nbody_tpu.models import init
from mini_nbody_tpu.ops.force import body_force, make_force_fn
from mini_nbody_tpu.sim import (make_rollout_fn, make_step_fn, simulate,
                                simulate_ensemble, trajectory,
                                trajectory_ensemble)

__version__ = "0.1.0"

__all__ = [
    "SimConfig",
    "BodyState",
    "init",
    "body_force",
    "make_force_fn",
    "make_rollout_fn",
    "make_step_fn",
    "simulate",
    "simulate_ensemble",
    "trajectory",
    "trajectory_ensemble",
]
