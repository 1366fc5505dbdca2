"""The golden frame: one fixed-seed bathroom render that pins the renderer
(the PrimeRef validation methodology, apps/imguiapp/main.cpp:170).

Counterpart of lighthouse2_tpu/utils/golden.py: SIZE, PATHS, ANCHOR_MEAN,
ANCHOR_STD (values copied), golden_config, golden_scene (its sky as
golden_sky), render_golden and main.
The anchor was made by the JAX package's CPU lockstep render; the port's
render is held to its mean and population standard deviation within 1e-3.
Differences: the intersector defaults to "auto" (the port's "auto" takes
the trace kernels on a card and their plain version on the CPU) and
kernel_interpret, JAX's Pallas interpret mode, changes nothing in the
port; render_golden takes a keyword-only device (default: the card) and
returns the accumulator there; there is no ANCHOR_SHA256, which pins XLA's
CPU reduction order; main() prints the port's own mean, population std
and SHA-256 of the frame, for comparison with the anchor that the JAX
package owns and regenerates.

    python -m lighthouse2_tpu_torch.utils.golden [--device cpu]
"""
from __future__ import annotations

import numpy as np

SIZE = 64
PATHS = 3

ANCHOR_MEAN = 0.3503158390522003
ANCHOR_STD = 0.4814316928386688


def golden_config(intersector: str = "auto", interpret: bool = False):
    from lighthouse2_tpu_torch.core.types import RenderConfig
    # blue noise off: the anchor pins the white-noise sequence
    return RenderConfig(width=SIZE, height=SIZE, spp_per_pass=1,
                        max_path_length=PATHS, use_bvh=True, bsdf="disney",
                        sky_ibl=True, intersector=intersector,
                        kernel_interpret=interpret, blue_noise=False)


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


def render_golden(intersector: str = "auto", interpret: bool = False, *,
                  device=None):
    """One fixed-seed classic pass (render_pass_jit, as JAX) on `device`
    (default: the card) -> the f32 accumulator [SIZE*SIZE, 3] as a tensor
    on that device."""
    from lighthouse2_tpu_torch.render.wavefront import (
        AccumState, render_pass_jit)
    scene, cam = golden_scene()
    ds = scene.sync(device, clusters=intersector == "cluster")
    cfg = golden_config(intersector, interpret)
    st, _ = render_pass_jit(ds, cam.get_view(ds.device),
                            AccumState.make(cfg, ds.device), cfg)
    return st.accumulator[:, :3]


def main(argv=None):
    """Print the frame's mean, population std and SHA-256 (float32 bytes)
    beside the anchor, rendered on the card or with --device cpu."""
    import argparse
    import hashlib
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--device", default=None)
    ap.add_argument("--intersector", default="auto")
    args = ap.parse_args(argv)
    a = render_golden(args.intersector, device=args.device).cpu().numpy()
    print("MEAN =", repr(float(a.mean())), " ANCHOR_MEAN =", ANCHOR_MEAN)
    print("STD =", repr(float(a.std())), " ANCHOR_STD =", ANCHOR_STD)
    print('SHA256 = "%s"' % hashlib.sha256(
        np.ascontiguousarray(a, np.float32).tobytes()).hexdigest())


if __name__ == "__main__":
    main()
