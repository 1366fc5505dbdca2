"""The golden frame: one fixed-seed bathroom render that pins the renderer
(the PrimeRef validation methodology, apps/imguiapp/main.cpp:170).

Counterpart of lighthouse2_tpu/utils/golden.py: SIZE, PATHS, ANCHOR_MEAN,
ANCHOR_STD (values copied), golden_config, golden_scene (its sky as
golden_sky) and render_golden.
The anchor was made by the JAX package's CPU lockstep render; the port's
render is held to its mean and population standard deviation within 1e-3.
Differences: golden_config has no intersector or kernel_interpret argument
(the port's "auto" takes the trace kernels on a card and their plain
version on the CPU); render_golden takes a device; there is no
ANCHOR_SHA256, which pins XLA's CPU reduction order, and no main() that
regenerates the anchor (the JAX package owns it).
"""
from __future__ import annotations

import numpy as np

SIZE = 64
PATHS = 3

ANCHOR_MEAN = 0.3503158390522003
ANCHOR_STD = 0.4814316928386688


def golden_config():
    from lighthouse2_tpu_torch.core.types import RenderConfig
    # blue noise off: the anchor pins the white-noise sequence
    return RenderConfig(width=SIZE, height=SIZE, spp_per_pass=1,
                        max_path_length=PATHS, use_bvh=True, bsdf="disney",
                        sky_ibl=True, blue_noise=False)


def golden_sky():
    """The golden scene's 16x32 gradient sky [16,32,3]."""
    h, w = 16, 32
    sky = np.zeros((h, w, 3), np.float32)
    sky[:, :, 2] = np.linspace(1.2, 0.1, h)[:, None]
    sky[:, :, 0] = 0.3
    return sky


def golden_scene():
    """The golden scene: the low-detail bathroom and the gradient sky
    (Disney BSDF, textures and IBL)."""
    from lighthouse2_tpu_torch.scene.bench_scene import bathroom
    scene, cam = bathroom(SIZE, SIZE, detail=0)
    scene.set_sky(golden_sky())
    return scene, cam


def render_golden(device=None):
    """One fixed-seed classic pass on `device` (default: the card) -> the
    f32 accumulator [SIZE*SIZE, 3] as a tensor on that device."""
    from lighthouse2_tpu_torch.render.wavefront import AccumState, render_pass
    scene, cam = golden_scene()
    ds = scene.sync(device)
    cfg = golden_config()
    st, _ = render_pass(ds, cam.get_view(ds.device),
                        AccumState.make(cfg, ds.device), cfg)
    return st.accumulator[:, :3]
