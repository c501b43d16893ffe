"""Body state: SoA arrays resident in device memory.

The reference keeps body state in a shared memory-mapped RAM as 128-bit
``x|y|z|pad`` words (AoS; ``src/top_level.vhd:100-117,206-208``), with
velocities living host-side.  This design flips that to SoA ``(N, 3)``
arrays in device memory — the layout XLA and Pallas tile well — and keeps the full
state (positions *and* velocities *and* masses) device-resident so the whole
multi-step trajectory runs as one XLA program with no host round-trips (the
reference needs a PS<->PL handshake per force pass, ``src/top_level.vhd:180-186``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp

from mini_nbody_tpu.utils.config import FAR


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class BodyState:
    """SoA N-body state pytree.

    pos:  (N, 3) positions.
    vel:  (N, 3) velocities.
    mass: (N,) masses. The reference hardware has implicit unit masses
          (``src/fxyz.vhd:120-127`` accumulates dx*invDist3 with no mass
          factor); mass doubles as the tail-padding write mask (mass == 0
          bodies exert no force), the analog of WRITE_MASK at
          ``src/top_level.vhd:201-205``.
    """

    pos: jax.Array
    vel: jax.Array
    mass: jax.Array

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dtype(self):
        return self.pos.dtype

    @staticmethod
    def create(pos, vel, mass=None, dtype=jnp.float32) -> "BodyState":
        pos = jnp.asarray(pos, dtype)
        vel = jnp.asarray(vel, dtype)
        if mass is None:
            mass = jnp.ones((pos.shape[0],), dtype)
        else:
            mass = jnp.asarray(mass, dtype)
        if pos.shape != vel.shape or pos.ndim != 2 or pos.shape[1] != 3:
            raise ValueError(f"bad shapes pos={pos.shape} vel={vel.shape}")
        if mass.shape != (pos.shape[0],):
            raise ValueError(f"bad mass shape {mass.shape} for N={pos.shape[0]}")
        return BodyState(pos=pos, vel=vel, mass=mass)

    def pad_to(self, n_pad: int, far: bool = False) -> "BodyState":
        """Pad to n_pad bodies. Padded bodies have mass 0 (inert under
        mass-weighted kernels); with far=True they also sit at FAR so the
        unit-mass kernel fast paths leave them inert (w underflows to 0)."""
        n = self.n
        if n_pad < n:
            raise ValueError(f"cannot pad {n} bodies down to {n_pad}")
        if n_pad == n:
            return self
        extra = n_pad - n
        pos_fill = FAR if far else 0.0
        return BodyState(
            pos=jnp.concatenate(
                [self.pos, jnp.full((extra, 3), pos_fill, self.pos.dtype)]),
            vel=jnp.concatenate([self.vel, jnp.zeros((extra, 3), self.vel.dtype)]),
            mass=jnp.concatenate([self.mass, jnp.zeros((extra,), self.mass.dtype)]),
        )

    def unpad(self, n: int) -> "BodyState":
        return BodyState(pos=self.pos[:n], vel=self.vel[:n], mass=self.mass[:n])


def zeros(n: int, dtype=jnp.float32) -> BodyState:
    return BodyState(
        pos=jnp.zeros((n, 3), dtype),
        vel=jnp.zeros((n, 3), dtype),
        mass=jnp.ones((n,), dtype),
    )
