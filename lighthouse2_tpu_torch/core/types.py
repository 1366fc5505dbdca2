"""Render configuration and the camera frustum.

Counterpart of lighthouse2_tpu/core/types.py (RenderConfig, ViewPyramid,
Rays, Hits, CoreStats). Differences: RenderConfig has no `dtype` field (the
port computes in float32 throughout), and ViewPyramid, Rays, Hits and
CoreStats are plain dataclasses of tensors instead of flax pytrees. Like
JAX's, the executors pass rays and hits as tensors and dicts, not as Rays
and Hits.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration (field meanings as in the JAX package).

    The port implements the classic and the path-regeneration executors
    (with remat), the filter's G-buffer stream (classic executor only),
    the Lambert and Disney BSDFs, sky IBL, the brute-force intersector
    (use_bvh=False or intersector="brute") and the cluster-tile kernels
    (intersector="cluster"); "auto" and "lockstep" take the BVH4 trace
    kernels ("auto" never resolves to "cluster", where JAX's does on an
    accelerator). render_pass rejects scene_sharded=True: that pass is
    parallel/scene_shard.py's."""
    width: int = 512
    height: int = 512
    spp_per_pass: int = 1
    max_path_length: int = 16
    max_diffuse_bounces: int = 1000
    russian_roulette: bool = True
    clamp_fireflies: bool = True
    consistent_normals: bool = True
    bsdf: str = "lambert"
    geometry_epsilon: float = 1e-4
    clamp_value: float = 10.0
    clamp_direct: float = 15.0
    clamp_indirect: float = 2.5
    filter_enabled: bool = False
    taa_enabled: bool = False
    max_is_lights: int = 8
    tri_chunk: int = 1024
    use_bvh: bool = True
    intersector: str = "auto"
    blue_noise: bool = True
    sky_ibl: bool = False
    kernel_interpret: bool = False
    tile_order: bool = True
    ray_sort: bool = True
    shadow_sort: bool = True
    scene_sharded: bool = False
    path_regen: bool = False
    remat: bool = False

    def tiled(self) -> bool:
        return (self.tile_order and self.width % 32 == 0
                and self.height % 32 == 0)

    @property
    def n_paths(self) -> int:
        return self.width * self.height * self.spp_per_pass


@dataclasses.dataclass
class ViewPyramid:
    """Camera frustum handed to the renderer (common_classes.h:362-385).

    p1/p2/p3 = top-left / top-right / bottom-left of the image plane at the
    focal distance. Vectors are [3] float32 tensors, scalars 0-d tensors,
    all on the render device."""
    pos: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor
    aperture: torch.Tensor
    spread_angle: torch.Tensor
    image_plane: torch.Tensor
    focal_distance: torch.Tensor
    distortion: torch.Tensor


@dataclasses.dataclass
class Rays:
    """A wavefront of rays, SoA (core_settings.h:78-86 path-state analog)."""
    origin: torch.Tensor   # [N,3]
    dir: torch.Tensor      # [N,3]


@dataclasses.dataclass
class Hits:
    """Intersection results (core_settings.h:91 hitData analog)."""
    t: torch.Tensor        # [N], BIG_T on a miss
    prim: torch.Tensor     # [N] int32 global triangle id, -1 on a miss
    inst: torch.Tensor     # [N] int32 instance id, -1 on a miss
    u: torch.Tensor        # [N] barycentric u
    v: torch.Tensor        # [N] barycentric v


@dataclasses.dataclass
class CoreStats:
    """Per-frame device-side statistics (core_api_base.h:30-61 analog): ray
    counts as int32 device scalars."""
    primary_rays: torch.Tensor
    bounce1_rays: torch.Tensor
    deep_rays: torch.Tensor
    shadow_rays: torch.Tensor

    @staticmethod
    def zero(device=None) -> "CoreStats":
        from lighthouse2_tpu_torch.device import resolve_device
        z = torch.zeros((), dtype=torch.int32, device=resolve_device(device))
        return CoreStats(z, z, z, z)
