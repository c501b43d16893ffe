"""Trajectory checkpoint / resume.

The reference's implicit checkpointing is body state persisting in the shared
PS<->PL RAM between force passes (the ``waiting`` FSM state,
``src/top_level.vhd:180-186``) — the host can read or rewrite state between
invocations. Here the step is a pure function of BodyState, so checkpointing
is just saving the SoA arrays: npz (portable, zero-dep) with the step count
and config fingerprint for resume validation.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Tuple

import jax
import numpy as np

from mini_nbody_tpu.models.state import BodyState
from mini_nbody_tpu.utils.config import SimConfig


def _normalize(path) -> Path:
    # np.savez appends '.npz' when missing; normalize up front so save()
    # reports the file that actually exists and load() finds it.
    path = Path(path)
    return path if path.suffix == ".npz" else path.with_suffix(
        path.suffix + ".npz")


def save(path, state: BodyState, step: int = 0,
         cfg: Optional[SimConfig] = None) -> Path:
    """Write a checkpoint; returns the actual path written (suffix
    normalized to .npz). Device arrays are fetched to host."""
    path = _normalize(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    meta = {"step": int(step)}
    if cfg is not None:
        meta["config"] = dataclasses.asdict(cfg)
    np.savez(
        path,
        pos=np.asarray(jax.device_get(state.pos)),
        vel=np.asarray(jax.device_get(state.vel)),
        mass=np.asarray(jax.device_get(state.mass)),
        meta=json.dumps(meta),
    )
    return path


def load(path) -> Tuple[BodyState, int, Optional[dict]]:
    """Read a checkpoint -> (state, step, config_dict_or_None)."""
    with np.load(_normalize(path), allow_pickle=False) as z:
        state = BodyState.create(z["pos"], z["vel"], z["mass"])
        meta = json.loads(str(z["meta"]))
    return state, meta.get("step", 0), meta.get("config")


def restore_config(cfg_dict: dict) -> SimConfig:
    """SimConfig from a saved dict; keys of options that no longer exist
    are dropped, so older checkpoints still resume."""
    known = {f.name for f in dataclasses.fields(SimConfig)}
    cfg_dict = {k: v for k, v in cfg_dict.items() if k in known}
    if cfg_dict.get("mesh_shape") is not None:
        cfg_dict = dict(cfg_dict, mesh_shape=tuple(cfg_dict["mesh_shape"]))
    return SimConfig(**cfg_dict)


def save_orbax(path, state: BodyState, step: int = 0,
               cfg: Optional[SimConfig] = None) -> Path:
    """Orbax checkpoint: sharding-aware (mesh-sharded states save without a
    host gather, unlike the npz path's device_get) and atomically written.
    Returns the checkpoint directory."""
    import orbax.checkpoint as ocp

    path = Path(path).resolve()
    meta = {"step": int(step), "n": int(state.n)}
    if cfg is not None:
        meta["config"] = dataclasses.asdict(cfg)
        if cfg.mesh_shape is not None:
            meta["config"]["mesh_shape"] = list(cfg.mesh_shape)
    with ocp.Checkpointer(ocp.CompositeCheckpointHandler()) as ckptr:
        ckptr.save(
            path,
            ocp.args.Composite(
                state=ocp.args.StandardSave(
                    {"pos": state.pos, "vel": state.vel, "mass": state.mass}),
                meta=ocp.args.JsonSave(meta),
            ),
            force=True,
        )
    return path


def load_orbax(path, sharding=None) -> Tuple[BodyState, int, Optional[dict]]:
    """Read an orbax checkpoint -> (state, step, config_dict_or_None).
    Pass a NamedSharding (or a pytree of them for pos/vel/mass) to restore
    directly onto a mesh."""
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    path = Path(path).resolve()
    with ocp.Checkpointer(ocp.CompositeCheckpointHandler()) as ckptr:
        if sharding is None:
            restored = ckptr.restore(
                path,
                ocp.args.Composite(state=ocp.args.StandardRestore(),
                                   meta=ocp.args.JsonRestore()),
            )
            meta = restored["meta"]
        else:
            # shapes come from the saved meta (n stored at save time), so
            # the arrays restore straight onto the mesh, shard by shard
            meta = ckptr.restore(
                path, ocp.args.Composite(meta=ocp.args.JsonRestore())
            )["meta"]
            n = meta["n"]

            def tgt(shape, s):
                return jax.ShapeDtypeStruct(shape, jnp.float32, sharding=s)

            tree = {
                k: tgt((n, 3) if k != "mass" else (n,),
                       sharding[k] if isinstance(sharding, dict) else sharding)
                for k in ("pos", "vel", "mass")
            }
            restored = ckptr.restore(
                path,
                ocp.args.Composite(state=ocp.args.StandardRestore(tree)),
            )
    st = restored["state"]
    state = BodyState.create(st["pos"], st["vel"], st["mass"])
    return state, meta.get("step", 0), meta.get("config")
