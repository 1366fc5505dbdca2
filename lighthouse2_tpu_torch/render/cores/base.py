"""The render-core contract (CoreAPI_Base, core_api_base.h:78-114).

Counterpart of lighthouse2_tpu/render/cores/base.py: register_core,
create_core and RenderCore (setting). A core is a Python class registered
by name; create_core(name) is the analog of loading a core DLL by name
(core_api_base.cpp:119-132). Differences: the bidirectional ("bdpt") core
is not ported yet, and create_core raises ValueError for it as for any
unknown name; RenderCore.set_target and StageTimer are not ported (no
caller in either package needs them).
"""
from __future__ import annotations

import dataclasses

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

