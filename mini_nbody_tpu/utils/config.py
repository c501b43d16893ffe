"""Simulation configuration.

The reference centralizes all knobs as compile-time VHDL generics in
``src/top_level.vhd:35-47`` (fp32 width, IP latencies, ``num_blocks=12``,
``ram_depth``) with SOFTENING hard-baked at ``src/dzsoft.vhd:177`` and the only
runtime inputs being N and the begin bit of the control word
(``src/top_level.vhd:184-185``).  The equivalent here is a frozen
dataclass: everything here is a *static* (trace-time) constant, so each config
compiles to one specialized XLA program — the analog of elaborating the RTL
with a generic map.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: Reference softening constant: fp32(1.0e-9), baked into the FPGA datapath at
#: ``src/dzsoft.vhd:177-178`` (dz^2 + SOFTENING fused in one FMA).
SOFTENING = 1.0e-9

#: Reference step size (upstream mini-nbody default; host-side in the reference).
DT = 0.01

#: Far-padding coordinate for tail bodies in unit-mass mode: r2 ~ 3e36 stays
#: finite in fp32 while rsqrt(r2)^3 underflows to exactly 0, so padded bodies
#: are inert without a mass multiply (the WRITE_MASK analog,
#: ``src/top_level.vhd:201-205``).
FAR = 1.0e18

_BACKENDS = ("auto", "jnp", "pallas")

#: Crossover of backend='auto' on a GPU: below this many bodies per force
#: call XLA's plain version was faster than the Pallas kernel end to end
#: (H100: 21 vs 39 us/step at N=2048, 64 vs 62 at N=4096; PERF.md).
PALLAS_MIN_BODIES = 4096
_INTEGRATORS = ("euler", "leapfrog", "rk4", "yoshida4")
_COMMS = ("all_gather", "ring", "ring_sym", "grid")


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static configuration for an N-body simulation.

    Attributes:
      n: number of bodies (the reference caps this at 32,767 via its RAM depth,
        ``src/top_level.vhd:45-46``; we have no such cap).
      dt: integrator time step.
      steps: number of integration steps per `simulate` call.
      softening: Plummer softening epsilon**2 added to every pair distance^2.
      integrator: "euler" (reference semantics: v += dt*F; x += dt*v),
        "leapfrog" (KDK, symplectic — the drift-gate integrator),
        "rk4" (classic 4th-order Runge-Kutta: four force evaluations per
        step, O(dt^4) accuracy; not symplectic), or "yoshida4" (Yoshida
        composition of three leapfrog substeps: O(dt^4) AND symplectic —
        three force evaluations per step, the long-horizon high-accuracy
        choice; ops/integrators.py).
      backend: force implementation. "jnp" = the plain formula as XLA
        compiles it (ops/reference.py); "pallas" = the Pallas-Triton kernel
        (ops/pallas_force.py), which compiles only on a CUDA GPU unless
        interpret=True; "auto" = the measured winner: "pallas" on a GPU
        from PALLAS_MIN_BODIES bodies per force call, "jnp" below that and
        off the GPU. Every path is fp32 with no matrix
        product (the reference datapath is all fp32,
        ``src/top_level.vhd:35-36``).
      tile_i: receiver block of the Pallas kernel, a power of two (the
        analog of the 12 i-registers, ``src/top_level.vhd:83,206-229``);
        None = the kernel's measured default, shrunk for small N.
      tile_j: source tile its in-kernel loop streams (the analog of the
        1-per-cycle j-stream, ``src/top_level.vhd:233-254``); power of two,
        None = measured default.
      mesh_shape: devices along the body-sharding axis (1-tuple), or the
        (rows, cols) of the 2-D pair-matrix grid for comm='grid'; None =
        single device.
      comm: cross-device position exchange: "all_gather", "ring" (ppermute,
        one hop per shard, each ordered pair computed), "ring_sym"
        (symmetric half-ring: Newton's third law across shards — half the
        pair arithmetic, ~same traffic), or "grid" (2-D pair-matrix
        decomposition on an ("i","j") mesh: per-device comm O(N/sqrt(P))
        instead of O(N); mesh_shape must be 2-D).
      interpret: run the Pallas kernel in the Pallas interpreter (CPU
        tests). Never chosen by platform.
      use_masses: apply per-body masses from BodyState.mass in the force law.
        False = unit masses (reference semantics, ``src/fxyz.vhd:120-127``
        has no mass factor) — enables the kernels' mass-free fast path with
        far-padded tails.
    """

    n: int
    dt: float = DT
    steps: int = 10
    softening: float = SOFTENING
    integrator: str = "euler"
    backend: str = "auto"
    tile_i: Optional[int] = None
    tile_j: Optional[int] = None
    mesh_shape: Optional[Tuple[int, ...]] = None
    comm: str = "all_gather"
    interpret: bool = False
    use_masses: bool = False

    def __post_init__(self):
        if self.n <= 0:
            raise ValueError(f"n must be positive, got {self.n}")
        if self.backend not in _BACKENDS:
            raise ValueError(f"backend must be one of {_BACKENDS}, got {self.backend!r}")
        if self.integrator not in _INTEGRATORS:
            raise ValueError(
                f"integrator must be one of {_INTEGRATORS}, got {self.integrator!r}"
            )
        if self.comm not in _COMMS:
            raise ValueError(f"comm must be one of {_COMMS}, got {self.comm!r}")
        if self.mesh_shape is not None:
            want = 2 if self.comm == "grid" else 1
            if len(self.mesh_shape) != want:
                raise ValueError(
                    f"comm {self.comm!r} needs a {want}-D mesh_shape, got "
                    f"{self.mesh_shape}"
                )
        for name in ("tile_i", "tile_j"):
            t = getattr(self, name)
            if t is not None and (t <= 0 or t & (t - 1)):
                raise ValueError(f"{name} must be a power of two, got {t}")

    def resolve_backend(self, bodies: Optional[int] = None) -> str:
        """Resolve 'auto' to the measured winner: on a GPU the Pallas kernel
        once a force call covers PALLAS_MIN_BODIES bodies (``bodies``:
        B * N for a batch of B systems; default n), XLA's plain version
        below that (PERF.md); jnp everywhere else."""
        if self.backend != "auto":
            return self.backend
        import jax

        if jax.default_backend() != "gpu":
            return "jnp"
        return ("pallas" if (bodies or self.n) >= PALLAS_MIN_BODIES
                else "jnp")

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def ceil_log2(x: int) -> int:
    """Smallest k with 2**k >= x (reference utility ``subprograms_types.vhd:14-21``)."""
    if x <= 0:
        raise ValueError(f"ceil_log2 requires positive input, got {x}")
    return (x - 1).bit_length()


def round_up(x: int, m: int) -> int:
    """Round x up to a multiple of m (tile-shape math)."""
    return -(-x // m) * m
