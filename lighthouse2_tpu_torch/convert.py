"""Carry a scene across from the JAX package as plain numpy arrays.

`scene_from_numpy` takes a flat dict keyed "<group>.<field>", where group is
one of tris, materials, lights, sky, textures, bvh, cbvh (the fields of the
JAX package's DeviceScene, its DeviceBVH and its ClusterBVH) or view (a
ViewPyramid), and the
values are numpy arrays, or ints for the static counts (lights.s_tri,
materials.s_base_maps, bvh.max_leaf, ...) and sky.has_ibl (an int or a
bool). The sky's IBL tables (sky.pdf, sky.cdf_rows, sky.cdf_cond,
sky.nee_energy) come across when present. Unknown fields are ignored. The
caller flattens its objects with np.asarray; no JAX type reaches the port.
That lets both packages compute on the same BVH topology. The port-only BVH
fields (the BVH2 depth and the packed BVH4 of bvh/wide.py) are computed here
from the BVH2 arrays; the ClusterBVH's int table of triangle ids from its
PAY_PRIM row. Without cbvh.* keys the scene has no cluster tiles.
"""
from __future__ import annotations

import numpy as np

from lighthouse2_tpu_torch.bvh.builder import bvh_depth
from lighthouse2_tpu_torch.bvh.clusters import PAY_PRIM, ClusterBVH
from lighthouse2_tpu_torch.bvh.traverse import DeviceBVH
from lighthouse2_tpu_torch.bvh.wide import pack_wide
from lighthouse2_tpu_torch.core.types import ViewPyramid
from lighthouse2_tpu_torch.device import resolve_device
from lighthouse2_tpu_torch.scene.device_scene import (
    DeviceLights, DeviceMaterials, DeviceScene, DeviceSky, DeviceTextures,
    DeviceTriangles, to_device)

_GROUPS = dict(tris=DeviceTriangles, materials=DeviceMaterials,
               lights=DeviceLights, sky=DeviceSky, textures=DeviceTextures,
               bvh=DeviceBVH, view=ViewPyramid)


def scene_from_numpy(arrays: dict, device=None):
    """Returns (DeviceScene, ViewPyramid) on `device` (see
    device.resolve_device); the view is None when no view.* keys exist."""
    dev = resolve_device(device)
    parts = {g: {} for g in (*_GROUPS, "cbvh")}
    for key, value in arrays.items():
        group, _, field = key.partition(".")
        if group in parts:
            parts[group][field] = value
    b = parts["bvh"]
    b["depth"] = bvh_depth(b)
    b.update(pack_wide(b["nbox"], b["left"], b["right"], b["count"],
                       b["prim"], b["tri9"], b.get("max_leaf", 4)))
    objs = {g: to_device(cls, parts[g], dev) for g, cls in _GROUPS.items()
            if g != "view"}
    c = parts["cbvh"]
    if c:
        c.setdefault("prim", c["pgeo"][:, PAY_PRIM].astype(np.int32))
    objs["cbvh"] = to_device(ClusterBVH, c, dev) if c else None
    view = to_device(ViewPyramid, parts["view"], dev) if parts["view"] else None
    return DeviceScene(**objs), view
