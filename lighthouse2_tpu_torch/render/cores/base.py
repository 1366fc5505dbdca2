"""The render-core contract (CoreAPI_Base, core_api_base.h:78-114).

Counterpart of lighthouse2_tpu/render/cores/base.py: register_core,
create_core, RenderCore (set_target, on_target_changed, setting) and
StageTimer. A core is a Python class registered by name; create_core(name)
is the analog of loading a core DLL by name (core_api_base.cpp:119-132).
StageTimer times on the host clock, as JAX's does; on a card a stage ends
where the caller synchronizes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np

from lighthouse2_tpu_torch.core.types import RenderConfig

_REGISTRY: dict[str, type] = {}


def register_core(name):
    def deco(cls):
        _REGISTRY[name] = cls
        cls.core_name = name
        return cls
    return deco


def create_core(name: str, config: RenderConfig | None = None) -> "RenderCore":
    """CreateCoreAPI analog (core_api_base.cpp:119-132)."""
    # late import so every built-in core registers itself
    from lighthouse2_tpu_torch.render.cores import wavefront_core  # noqa: F401
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown render core '{name}' (available: {sorted(_REGISTRY)})")
    return _REGISTRY[name](config or RenderConfig())


class RenderCore:
    """Base class of the core contract (CoreAPI_Base analog)."""

    core_name = "base"

    def __init__(self, config: RenderConfig):
        self.config = config
        self.stats: dict = {}

    def set_target(self, width: int, height: int, spp: int = 1):
        """SetTarget (core_api_base.h:83): resize the render target and
        drop whatever state depends on it."""
        self.config = dataclasses.replace(
            self.config, width=width, height=height, spp_per_pass=spp)
        self.on_target_changed()

    def on_target_changed(self):
        pass

    def setting(self, name: str, value):
        """String-keyed runtime settings (rendercore.cpp:597-615 accepts
        the ones it knows and ignores the rest)."""
        known = {"epsilon": "geometry_epsilon", "clampValue": "clamp_value",
                 "clampDirect": "clamp_direct",
                 "clampIndirect": "clamp_indirect"}
        if name in known:
            self.config = dataclasses.replace(self.config,
                                              **{known[name]: value})

    def render(self, device_scene, view, converge: bool = True) -> dict:
        raise NotImplementedError

    def get_image(self) -> np.ndarray:
        raise NotImplementedError

    def shutdown(self):
        pass


class StageTimer:
    """Host-side stage timing (the cudaEvent / CoreStats analog): the
    seconds spent in each named stage, summed over its entries."""

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0)
