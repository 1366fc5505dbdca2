"""NavMesh (de)serialization (reference: navmesh_io.h binary serialize).

A copy of lighthouse2_tpu/pathfinding/io.py (numpy only).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from lighthouse2_tpu_torch.pathfinding.builder import NavMesh, NavMeshConfig

_CFG_FIELDS = ["cell_size", "cell_height", "agent_height", "agent_radius",
               "agent_max_climb", "agent_max_slope", "min_region_area"]


def save_navmesh(path, navmesh: NavMesh) -> None:
    cfg = {f: getattr(navmesh.config, f) for f in _CFG_FIELDS}
    np.savez_compressed(
        path, origin=navmesh.origin, walkable=navmesh.walkable,
        floor=navmesh.floor, region=navmesh.region,
        n_regions=np.int32(navmesh.n_regions),
        config=np.array([cfg[f] for f in _CFG_FIELDS], np.float64))


def load_navmesh(path) -> NavMesh:
    z = np.load(path, allow_pickle=False)
    vals = z["config"]
    cfg = NavMeshConfig(**{f: float(vals[i])
                           for i, f in enumerate(_CFG_FIELDS)})
    return NavMesh(
        config=cfg, origin=z["origin"], walkable=z["walkable"],
        floor=z["floor"], region=z["region"], n_regions=int(z["n_regions"]))
