"""Force-op dispatcher: one API over the plain jnp path and the Pallas kernel.

The reference has exactly one datapath elaborated at synthesis time; here the
backend is a static config choice (SimConfig.backend) resolved at trace time,
so each choice is its own specialized XLA program.
"""

from __future__ import annotations

from mini_nbody_tpu.ops.reference import auto_row_chunk, body_force_jnp
from mini_nbody_tpu.utils.config import SOFTENING, SimConfig


def body_force(
    pos_i,
    pos_j,
    mass_j=None,
    softening: float = SOFTENING,
    backend: str = "jnp",
    tile_i: int | None = None,
    tile_j: int | None = None,
    interpret: bool = False,
):
    """Forces on pos_i (Ni,3) from sources (pos_j, mass_j). Returns (Ni,3).

    backend "jnp": XLA's fusion of the plain formula, rows chunked so the
    (rows, Nj) pair block stays bounded at any N. backend "pallas": the
    Pallas-Triton kernel (ops/pallas_force.py) with tile_i/tile_j blocks
    (None = its measured defaults, tile_i shrunk for small N); it compiles
    only on a CUDA GPU unless interpret=True. Both handle self/coincident
    pairs exactly (zero contribution) by construction.
    """
    if backend == "jnp":
        chunk = None
        if pos_i.shape[0] * pos_j.shape[0] > 1 << 24:
            chunk = auto_row_chunk(pos_j.shape[0])
        return body_force_jnp(pos_i, pos_j, mass_j, softening=softening,
                              row_chunk=chunk)
    if backend == "pallas":
        from mini_nbody_tpu.ops.pallas_force import body_force_pallas

        return body_force_pallas(
            pos_i, pos_j, mass_j, softening=softening, tile_i=tile_i,
            tile_j=tile_j, interpret=interpret,
        )
    raise ValueError(f"unknown force backend {backend!r}")


def make_force_fn(cfg: SimConfig, backend: str | None = None):
    """Close a SimConfig over body_force: (pos_i, pos_j, mass_j) -> (Ni,3).
    backend overrides the config's resolved backend (ensembles resolve
    'auto' on their total body count)."""
    backend = backend or cfg.resolve_backend()

    def force(pos_i, pos_j, mass_j=None):
        if not cfg.use_masses:
            mass_j = None  # unit masses: kernels take the mass-free fast path
        return body_force(
            pos_i, pos_j, mass_j,
            softening=cfg.softening, backend=backend,
            tile_i=cfg.tile_i, tile_j=cfg.tile_j,
            interpret=cfg.interpret,
        )

    return force
