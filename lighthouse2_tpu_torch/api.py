"""RenderAPI: the thin app-facing facade (render_api.h:28-69).

Counterpart of lighthouse2_tpu/api.py. Owns a HostScene, a Camera and a
render core, and drives the per-frame dirty sync -> view -> core render
loop (rendersystem.cpp:214-301):

    api = RenderAPI.create("wavefront", width=512, height=512)   # the card
    api.scene, api.camera = cornell_box(512, 512)
    api.render()                 # a progressive pass (converges)
    img = api.get_ldr_image()    # tonemapped [H,W,3] in [0,1]

Differences: create takes a `device` (default: the card, raising without
one; "cpu" runs the plain versions on the host; see device.resolve_device)
and the scene is synced to it with scene.sync(device, rebuild_bvh=
config.use_bvh), with the cluster tiles when config.intersector is
"cluster"; probe traces through the closest-hit kernel on a card
(render/probe.py).
"""
from __future__ import annotations

import numpy as np
import torch

from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.device import resolve_device
from lighthouse2_tpu_torch.render.cores.base import create_core
from lighthouse2_tpu_torch.render.tonemap import tonemap
from lighthouse2_tpu_torch.scene.camera import Camera
from lighthouse2_tpu_torch.scene.host_scene import HostScene


class RenderAPI:
    def __init__(self, core, config: RenderConfig, device):
        self.scene = HostScene()
        self.config = config
        self.device = device
        self.camera = Camera(pixel_count=(config.width, config.height))
        self.core = core
        self._camera_snapshot = None

    @staticmethod
    def create(core_name: str = "wavefront",
               config: RenderConfig | None = None, device=None,
               **config_kw) -> "RenderAPI":
        dev = resolve_device(device)
        config = config or RenderConfig(**config_kw)
        return RenderAPI(create_core(core_name, config), config, dev)

    def _camera_changed(self) -> bool:
        snap = (tuple(self.camera.position), tuple(self.camera.direction),
                self.camera.fov, self.camera.aperture,
                self.camera.focal_distance, self.camera.distortion)
        changed = snap != self._camera_snapshot
        self._camera_snapshot = snap
        return changed

    def render(self, converge: bool | None = None) -> dict:
        """SynchronizeSceneData + the core's Render
        (rendersystem.cpp:214-237). converge=None restarts the
        accumulation when the camera or the scene changed."""
        scene_dirty = self.scene.dirty
        device_scene = self.device_scene()
        cam_moved = self._camera_changed()
        if converge is None:
            converge = not (scene_dirty or cam_moved)
        self.camera.pixel_count = (self.config.width, self.config.height)
        self.camera.aspect_ratio = self.config.width / self.config.height
        view = self.camera.get_view(self.device)
        return self.core.render(device_scene, view, converge=converge)

    def get_image(self) -> np.ndarray:
        """Linear HDR [H,W,3] float32."""
        return self.core.get_image()

    def get_ldr_image(self) -> np.ndarray:
        """Tonemapped [H,W,3] in [0,1], with the camera's tonemap
        parameters."""
        img = torch.from_numpy(np.ascontiguousarray(self.get_image()))
        return tonemap(img.to(self.device), method=self.camera.tonemapper,
                       gamma=self.camera.gamma, contrast=self.camera.contrast,
                       brightness=self.camera.brightness).cpu().numpy()

    def device_scene(self):
        """The synced DeviceScene (for instrumentation)."""
        return self.scene.sync(
            self.device, rebuild_bvh=self.config.use_bvh,
            clusters=self.config.intersector == "cluster")

    def probe(self, x: int, y: int) -> dict:
        """Pixel probe (core_api_base.h:57-60, rendersystem.cpp:249-256):
        prim / material / distance / u / v at pixel (x, y)."""
        from lighthouse2_tpu_torch.render.probe import probe_pixel
        return probe_pixel(self.device_scene(),
                           self.camera.get_view(self.device), self.config,
                           x, y)

    def serialize_camera(self, path):
        self.camera.serialize(path)

    def deserialize_camera(self, path):
        try:
            self.camera = Camera.deserialize(path)
        except FileNotFoundError:
            pass

    def serialize_materials(self, path):
        """RenderAPI::SerializeMaterials (render_api.h / main.cpp:273)."""
        self.scene.serialize_materials(path)

    def deserialize_materials(self, path):
        """RenderAPI::DeserializeMaterials (main.cpp:67): the number of
        materials matched by name; 0 when the file does not exist."""
        try:
            return self.scene.deserialize_materials(path)
        except FileNotFoundError:
            return 0

    def set_setting(self, name: str, value):
        self.core.setting(name, value)

    def shutdown(self):
        self.core.shutdown()
