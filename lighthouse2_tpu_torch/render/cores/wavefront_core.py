"""The built-in render cores.

Counterpart of lighthouse2_tpu/render/cores/wavefront_core.py:
  - "wavefront": the progressive path tracer (rendercore_optix7 analog);
  - "primeref": the validation core, the same algorithm with path length
    64, no diffuse-bounce cap, no Russian roulette, no firefly clamp
    (RenderCore_PrimeRef);
  - "minimal": plots every vertex as a white dot (RenderCore_Minimal);
  - "wavefront_filter": the 1-spp real-time core, one classic pass a frame
    split into direct and indirect, filtered with SVGF and TAA
    (RenderCore_Optix7Filter);
  - "preview": primary rays only, albedo x (headlight N.L + ambient), the
    sky on a miss (the RenderCore_SoftRasterizer-class core);
  - "bdpt": the bidirectional path tracer of render/bdpt.py
    (RenderCore_OptixPrime_BDPT), without Russian roulette or firefly
    clamp.
Differences: the cores run eagerly on the device the scene is on and wait
with torch.cuda.synchronize where the JAX package calls
jax.block_until_ready; MinimalCore's .at[idx].max is scatter_reduce "amax";
PreviewCore traces through the port's _trace (the closest-hit kernel on a
card, one launch a render), _refine and get_shading_data;
FilteredWavefrontCore's stats add "pass_time" (render_pass) and
"filter_time" (SVGF + TAA + unsharpen), each closed by a synchronize, and
the per-bounce ray counts as WavefrontCore's do; FilteredWavefrontCore has
no `state` attribute (JAX's is never set), so its on_target_changed drops
the filter, TAA, previous-view and frame-index state; BDPTCore's stats are
WavefrontCore's keys, the per-bounce counts included (the totals in slot
0, as render_pass_bdpt returns them).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from lighthouse2_tpu_torch.core.geometry import cross, dot
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.render.cores.base import RenderCore, register_core
from lighthouse2_tpu_torch.render.wavefront import (
    AccumState, finalize, render_pass)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@register_core("wavefront")
class WavefrontCore(RenderCore):
    def __init__(self, config: RenderConfig):
        super().__init__(config)
        self.state = None

    def on_target_changed(self):
        self.state = None

    def _pass(self, device_scene, view):
        return render_pass(device_scene, view, self.state, self.config)

    def render(self, device_scene, view, converge: bool = True) -> dict:
        if self.state is None or not converge:
            # Convergence::Restart
            self.state = AccumState.make(self.config, device_scene.device)
        t0 = time.perf_counter()
        self.state, stats = self._pass(device_scene, view)
        _sync(device_scene.device)
        wall = time.perf_counter() - t0
        ext = int(stats["total_extension"])
        shad = int(stats["total_shadow"])
        if self.state.pixel_count is not None:
            # regen executor: the spp statistic is the per-pixel count of
            # completed samples (mean and min); "primary_rays" = samples
            # completed this pass
            pc = self.state.pixel_count
            spp_stat = {"spp": pc.mean().item(), "spp_min": pc.min().item()}
        else:
            spp_stat = {"spp": int(self.state.sample_count)}
        self.stats = {
            "render_time": wall,
            "primary_rays": int(stats["primary_rays"]),
            "extension_rays": ext,
            "shadow_rays": shad,
            "total_rays": ext + shad,
            "mrays_per_s": (ext + shad) / max(wall, 1e-9) / 1e6,
            **spp_stat,
            "extension_per_bounce": stats["extension_rays"].cpu().numpy(),
            "shadow_per_bounce": stats["shadow_rays"].cpu().numpy(),
        }
        return self.stats

    def get_image(self) -> np.ndarray:
        img = finalize(self.state)
        return img.cpu().numpy().reshape(self.config.height,
                                         self.config.width, 3)


@register_core("wavefront_filter")
class FilteredWavefrontCore(RenderCore):
    """1-spp real-time core with SVGF + TAA (RenderCore_Optix7Filter).

    Each render() traces one pass, splits direct / indirect and filters
    with temporal history; converge=False (camera moved) keeps the history,
    which is reprojected through the previous frame's view."""

    def __init__(self, config: RenderConfig):
        config = dataclasses.replace(config, filter_enabled=True)
        super().__init__(config)
        self.filter_state = None
        self.taa_state = None
        self.image = None
        self.prev_view = None     # the previous frame's (jittered) view
        self.frame_idx = 0

    def on_target_changed(self):
        self.filter_state = self.taa_state = None
        self.prev_view = None
        self.frame_idx = 0

    def render(self, device_scene, view, converge: bool = True) -> dict:
        from lighthouse2_tpu_torch.render.filter import (
            FilterState, TAAState, jittered_view, svgf_filter, taa,
            unsharpen)
        dev = device_scene.device
        h, w = self.config.height, self.config.width
        if self.filter_state is None:
            self.filter_state = FilterState.make(h, w, dev)
            self.taa_state = TAAState.make(h, w, dev)
        if self.config.taa_enabled:
            # 4-phase Halton subpixel jitter (rendercore.cpp:734-743)
            view, _ = jittered_view(view, self.frame_idx, w, h)
        t0 = time.perf_counter()
        state = AccumState.make(self.config, dev)   # fresh every frame
        state, stats = render_pass(device_scene, view, state, self.config)
        _sync(dev)
        t1 = time.perf_counter()
        aux = stats["filter_aux"]
        img = lambda x: x.reshape(h, w, *x.shape[1:])
        spp = max(1, self.config.spp_per_pass)
        direct = img(state.accumulator[:, :3]) / spp
        indirect = img(aux["indirect"]) / spp
        world_pos = img(aux["world_pos"])
        color, self.filter_state = svgf_filter(
            direct, indirect, img(aux["albedo"]), img(aux["normal"]),
            img(aux["depth"]), world_pos, self.filter_state,
            direct_clamp=self.config.clamp_direct,
            indirect_clamp=self.config.clamp_indirect,
            prev_view=self.prev_view)
        if self.config.taa_enabled:
            color, self.taa_state = taa(color, self.taa_state,
                                        world_pos=world_pos,
                                        prev_view=self.prev_view)
            color = unsharpen(color)
        self.prev_view = view
        self.frame_idx += 1
        self.image = color.cpu().numpy()
        t2 = time.perf_counter()
        ext = int(stats["total_extension"])
        shad = int(stats["total_shadow"])
        wall = t2 - t0
        self.stats = {
            "render_time": wall, "pass_time": t1 - t0, "filter_time": t2 - t1,
            "primary_rays": int(stats["primary_rays"]),
            "extension_rays": ext, "shadow_rays": shad,
            "total_rays": ext + shad,
            "mrays_per_s": (ext + shad) / max(wall, 1e-9) / 1e6,
            "spp": spp,
            "extension_per_bounce": stats["extension_rays"].cpu().numpy(),
            "shadow_per_bounce": stats["shadow_rays"].cpu().numpy(),
        }
        return self.stats

    def get_image(self) -> np.ndarray:
        return self.image


@register_core("bdpt")
class BDPTCore(WavefrontCore):
    """The bidirectional path tracer (RenderCore_OptixPrime_BDPT,
    render/bdpt.py) with validation-grade settings: no Russian roulette and
    no firefly clamp, as the reference's conservative BDPT core."""

    def __init__(self, config: RenderConfig):
        config = dataclasses.replace(config, russian_roulette=False,
                                     clamp_fireflies=False)
        super().__init__(config)

    def _pass(self, device_scene, view):
        from lighthouse2_tpu_torch.render.bdpt import render_pass_bdpt
        return render_pass_bdpt(device_scene, view, self.state, self.config)


@register_core("primeref")
class PrimeRefCore(WavefrontCore):
    def __init__(self, config: RenderConfig):
        config = dataclasses.replace(
            config,
            max_path_length=64,            # RenderCore_PrimeRef/core_settings.h:25
            max_diffuse_bounces=1 << 30,
            russian_roulette=False,
            clamp_fireflies=False,
        )
        super().__init__(config)


@register_core("minimal")
class MinimalCore(RenderCore):
    """The smallest valid backend (RenderCore_Minimal/rendercore.cpp:46-78):
    projects every vertex and plots it as a white dot."""

    def __init__(self, config: RenderConfig):
        super().__init__(config)
        self.image = None

    @staticmethod
    def _pass(device_scene, v, cfg):
        t = device_scene.tris
        verts = torch.cat([t.v0, t.v0 + t.e1, t.v0 + t.e2], 0)   # [3T, 3]
        right = v.p2 - v.p1
        up = v.p3 - v.p1
        n = cross(right, up)
        d = verts - v.pos[None]
        denom = dot(d, n[None])
        k = dot(v.p1[None] - v.pos[None], n[None]) / torch.where(
            torch.abs(denom) > 1e-12, denom, 1e-12)
        q = v.pos[None] + k[:, None] * d - v.p1[None]
        s = dot(q, right[None]) / torch.clamp(dot(right, right), min=1e-12)
        tt = dot(q, up[None]) / torch.clamp(dot(up, up), min=1e-12)
        ok = (k > 0) & (s >= 0) & (s < 1) & (tt >= 0) & (tt < 1)
        px = torch.clamp((s * cfg.width).to(torch.int64), 0, cfg.width - 1)
        py = torch.clamp((tt * cfg.height).to(torch.int64), 0, cfg.height - 1)
        idx = torch.where(ok, py * cfg.width + px, 0)
        img = torch.zeros(cfg.width * cfg.height, device=verts.device)
        img = img.scatter_reduce(0, idx, ok.to(torch.float32), "amax")
        return img[:, None].expand(-1, 3)

    def render(self, device_scene, view, converge: bool = True) -> dict:
        t0 = time.perf_counter()
        img = self._pass(device_scene, view, self.config)
        _sync(device_scene.device)
        wall = time.perf_counter() - t0
        h, w = self.config.height, self.config.width
        self.image = img.cpu().numpy().reshape(h, w, 3)
        self.stats = {"render_time": wall, "primary_rays": 0,
                      "extension_rays": 0, "shadow_rays": 0, "total_rays": 0,
                      "mrays_per_s": 0.0, "spp": 1}
        return self.stats

    def get_image(self) -> np.ndarray:
        return self.image


@register_core("preview")
class PreviewCore(RenderCore):
    """Primary rays only: albedo x (headlight N.L + ambient), emitters at
    their colour, the sky on a miss; the depth image in self.depth."""

    def __init__(self, config: RenderConfig):
        config = dataclasses.replace(config, max_path_length=1)
        super().__init__(config)
        self.image = None
        self.depth = None

    @staticmethod
    def _pass(device_scene, v, cfg):
        from lighthouse2_tpu_torch.render.shading import get_shading_data
        from lighthouse2_tpu_torch.render.sky import sample_skydome
        from lighthouse2_tpu_torch.render.wavefront import (
            _refine, _trace, generate_eye_rays, untile_image)
        paths = generate_eye_rays(v, cfg, 0)
        o, d = paths["origin"], paths["dir"]
        t, prim, u, uv_v = _refine(device_scene, o, d,
                                   *_trace(device_scene, o, d,
                                           paths["alive"], cfg))
        hit = prim >= 0
        ts = torch.where(hit, t, 1.0)
        sd = get_shading_data(device_scene, d, ts, prim, u, uv_v,
                              v.spread_angle,
                              consistent_normals=cfg.consistent_normals)
        ndl = torch.abs(dot(sd.n_shading, -d))
        lit = sd.color * (0.25 + 0.75 * ndl)[:, None]
        emis = torch.where(sd.emissive[:, None], sd.color, lit)
        col = torch.where(hit[:, None], emis,
                          sample_skydome(device_scene.sky, d))
        depth = torch.where(hit, t, torch.inf)
        wh = cfg.width * cfg.height
        spp = cfg.spp_per_pass
        col = untile_image(col.reshape(spp, wh, 3), cfg).mean(0)
        depth = untile_image(depth.reshape(spp, wh, 1), cfg).amin(0)[:, 0]
        return col, depth

    def render(self, device_scene, view, converge: bool = True) -> dict:
        t0 = time.perf_counter()
        col, depth = self._pass(device_scene, view, self.config)
        _sync(device_scene.device)
        wall = time.perf_counter() - t0
        h, w = self.config.height, self.config.width
        self.image = col.cpu().numpy().reshape(h, w, 3)
        self.depth = depth.cpu().numpy().reshape(h, w)
        n = self.config.n_paths
        self.stats = {
            "render_time": wall,
            "primary_rays": n,
            "extension_rays": n, "shadow_rays": 0, "total_rays": n,
            "mrays_per_s": n / max(wall, 1e-9) / 1e6,
            "spp": self.config.spp_per_pass,
        }
        return self.stats

    def get_image(self) -> np.ndarray:
        return self.image
