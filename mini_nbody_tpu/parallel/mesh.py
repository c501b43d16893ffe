"""Device mesh construction.

The reference is a single-chip design; nothing in its tree crosses a chip
boundary (SURVEY.md §2 item 6). Scale-out is new work here: a
``jax.sharding.Mesh`` over the body axis ("i"), optionally 2-D ("i" x "j"
— the pair-matrix grid decomposition whose per-step communication is
O(N/sqrt(P)) instead of the 1-D schemes' O(N)), with XLA collectives
between the devices. The mesh follows the algorithm: the cards of one host
reach each other all to all.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import jax
import numpy as np
from jax.sharding import Mesh

BODY_AXIS = "i"
COL_AXIS = "j"


def make_mesh(n_devices: Union[int, Tuple[int, ...], None] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh over the body-sharding axis (axes).

    1-D (int or 1-tuple): bodies are data-parallel along "i" (each device
    owns an i-shard and, per step, sees every j-body via all-gather or a
    ppermute ring — the distributed generalization of the reference's
    j-target stream, ``src/top_level.vhd:233-254``).

    2-D ((pi, pj) tuple): the pair matrix is tiled over an "i" x "j" grid;
    device (a, b) computes forces on row-group a from column-group b
    (comm="grid" in parallel.sharded).
    """
    shape = n_devices
    if isinstance(shape, int) or shape is None:
        shape = (shape,) if shape is not None else None
    total = None if shape is None else int(np.prod(shape))
    if devices is None:
        devices = jax.devices()
        if total is not None:
            devices = devices[:total]
    if shape is None:
        shape = (len(devices),)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    if len(shape) == 1:
        return Mesh(np.asarray(devices), (BODY_AXIS,))
    if len(shape) == 2:
        return Mesh(np.asarray(devices).reshape(shape),
                    (BODY_AXIS, COL_AXIS))
    raise ValueError(f"mesh must be 1-D or 2-D, got shape {shape}")
