"""Camera (reference: lib/RenderSystem/camera.cpp).

Counterpart of lighthouse2_tpu/scene/camera.py (Camera with its tonemap
fields, look_at, matrix, get_view, and JSON serialize / deserialize, the
analog of camera.cpp:154-212). get_view places the ViewPyramid's tensors on
a device resolved by device.resolve_device.
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import torch

from lighthouse2_tpu_torch.core.types import ViewPyramid
from lighthouse2_tpu_torch.device import resolve_device


@dataclasses.dataclass
class Camera:
    position: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3, np.float32))
    direction: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0, 0, -1], np.float32))
    focal_distance: float = 5.0
    aperture: float = 0.0
    distortion: float = 0.0
    fov: float = 40.0            # degrees (camera.h:34)
    aspect_ratio: float = 1.0
    pixel_count: tuple = (512, 512)   # (w, h)
    # tonemap parameters (camera.h:40-47), read by render.tonemap
    brightness: float = 0.0
    contrast: float = 0.0
    gamma: float = 2.2
    tonemapper: int = 4          # reinhard-jodie
    clamp_value: float = 10.0

    def __post_init__(self):
        self.position = np.asarray(self.position, np.float32)
        d = np.asarray(self.direction, np.float32)
        self.direction = d / np.linalg.norm(d)
        self.aspect_ratio = self.pixel_count[0] / self.pixel_count[1]

    def look_at(self, origin, target):
        """camera.cpp:64-69."""
        self.position = np.asarray(origin, np.float32)
        d = np.asarray(target, np.float32) - self.position
        self.direction = (d / np.linalg.norm(d)).astype(np.float32)

    def matrix(self):
        """(right, up, forward) per CalculateMatrix (camera.cpp:40-57)."""
        z = self.direction
        y = (np.array([1, 0, 0], np.float32) if abs(z[1]) > 0.99
             else np.array([0, 1, 0], np.float32))
        x = np.cross(z, y)
        x = x / np.linalg.norm(x)
        y = np.cross(x, z)
        return x, y, z

    def get_view(self, device=None) -> ViewPyramid:
        dev = resolve_device(device)
        right, up, forward = self.matrix()
        spread = (self.fov * math.pi / 180.0) / self.pixel_count[1]
        screen_size = math.tan(self.fov / 2 / (180 / math.pi))
        c = self.position + self.focal_distance * forward
        sx = screen_size * self.focal_distance * self.aspect_ratio
        sy = screen_size * self.focal_distance
        p1 = c - sx * right + sy * up
        p2 = c + sx * right + sy * up
        p3 = c - sx * right - sy * up
        u1 = c - screen_size * right * self.aspect_ratio + screen_size * up
        u2 = c + screen_size * right * self.aspect_ratio + screen_size * up
        u3 = c - screen_size * right * self.aspect_ratio - screen_size * up
        image_plane = float(np.linalg.norm(u1 - u2) * np.linalg.norm(u1 - u3))
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev)
        return ViewPyramid(
            pos=t(self.position), p1=t(p1), p2=t(p2), p3=t(p3),
            aperture=t(self.aperture), spread_angle=t(spread),
            image_plane=t(image_plane), focal_distance=t(self.focal_distance),
            distortion=t(self.distortion))

    def serialize(self, path):
        d = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
             for k, v in dataclasses.asdict(self).items()}
        with open(path, "w") as fh:
            json.dump(d, fh, indent=2)

    @staticmethod
    def deserialize(path) -> "Camera":
        with open(path) as fh:
            d = json.load(fh)
        d["position"] = np.asarray(d["position"], np.float32)
        d["direction"] = np.asarray(d["direction"], np.float32)
        d["pixel_count"] = tuple(d["pixel_count"])
        return Camera(**d)
