"""Offline render CLI (the tinyapp / imguiapp analog for headless use).

    python -m lighthouse2_tpu_torch.apps.render_cli scene.gltf --spp 64 -o out.png
    python -m lighthouse2_tpu_torch.apps.render_cli cornell --size 512 --bsdf disney
    python -m lighthouse2_tpu_torch.apps.render_cli scene.obj --device cpu

Counterpart of lighthouse2_tpu/apps/render_cli.py, with its flags, plus
`--device` (default: the card, raising without one; "cpu" runs the plain
versions on the host). Prints per-pass stats (rays, Mrays/s) like the
reference's ImGui panel (apps/imguiapp/main.cpp:222-233) and returns 0.
`--no-bvh` syncs the scene without a BVH and traces by brute force
(core/geometry.py), as in JAX; `--core bdpt` renders with the
bidirectional path tracer. Difference: the default framing reads the world
triangles on the host instead of syncing the scene.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="lighthouse2_tpu_torch offline renderer")
    ap.add_argument("scene", help="'cornell', 'triangle', or a .obj/.gltf/.glb path")
    ap.add_argument("-o", "--output", default="out.png")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--spp", type=int, default=16, help="total samples/pixel")
    ap.add_argument("--spp-per-pass", type=int, default=4)
    ap.add_argument("--max-path", type=int, default=8)
    ap.add_argument("--bsdf", choices=["lambert", "disney"], default="lambert")
    ap.add_argument("--core", default="wavefront",
                    help="render core name (wavefront|primeref|minimal|"
                         "preview|wavefront_filter|bdpt)")
    ap.add_argument("--no-bvh", action="store_true")
    ap.add_argument("--camera", default=None, help="camera JSON to load")
    ap.add_argument("--save-camera", default=None)
    ap.add_argument("--sky", default=None,
                    help="HDR skydome path or 'r,g,b' constant")
    ap.add_argument("--hdr-output", default=None, help="also write linear .hdr")
    ap.add_argument("--tonemapper", type=int, default=4)
    ap.add_argument("--anim-time", type=float, default=None,
                    help="pose all animations at this time (seconds)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the host)")
    args = ap.parse_args(argv)

    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.utils.image import read_hdr, write_hdr, write_png

    w = args.width or args.size
    h = args.height or args.size
    cfg = RenderConfig(width=w, height=h, spp_per_pass=args.spp_per_pass,
                       max_path_length=args.max_path, bsdf=args.bsdf,
                       use_bvh=not args.no_bvh)
    api = RenderAPI.create(args.core, cfg, device=args.device)

    if args.scene == "cornell":
        from lighthouse2_tpu_torch.scene.presets import cornell_box
        api.scene, api.camera = cornell_box(w, h)
    elif args.scene == "triangle":
        from lighthouse2_tpu_torch.scene.presets import single_triangle
        api.scene, api.camera = single_triangle(w, h)
    elif args.scene.lower().endswith((".gltf", ".glb")):
        api.scene.load_gltf(args.scene)
        _default_frame(api)
    elif args.scene.lower().endswith(".obj"):
        mid = api.scene.load_obj(args.scene)
        api.scene.add_instance(mid)
        _default_frame(api)
    else:
        ap.error(f"unknown scene '{args.scene}'")

    if args.sky:
        if "," in args.sky:
            api.scene.set_sky(tuple(float(x) for x in args.sky.split(",")))
        else:
            api.scene.set_sky(read_hdr(args.sky))
    if args.camera:
        api.deserialize_camera(args.camera)
    api.camera.pixel_count = (w, h)
    api.camera.tonemapper = args.tonemapper
    if args.anim_time is not None:
        for anim in api.scene.animations:
            anim.apply(api.scene, args.anim_time)

    passes = max(1, args.spp // args.spp_per_pass)
    for i in range(passes):
        stats = api.render(converge=i > 0)
        # the pass's device time by stage (the stage marks), where the
        # core reports it
        stages = (f" (trace {stats['trace_time'] * 1e3:.1f}, shadow trace "
                  f"{stats['shadow_trace_time'] * 1e3:.1f}, shade "
                  f"{stats['shade_time'] * 1e3:.1f} ms)"
                  if "trace_time" in stats else "")
        print(f"pass {i + 1}/{passes}: {stats['total_rays']} rays, "
              f"{stats['render_time'] * 1e3:.1f} ms{stages}, "
              f"{stats['mrays_per_s']:.2f} Mrays/s, spp={stats['spp']}",
              file=sys.stderr)

    write_png(args.output, api.get_ldr_image())
    print(f"wrote {args.output} ({w}x{h}, {api.core.stats['spp']} spp)")
    if args.hdr_output:
        write_hdr(args.hdr_output, api.get_image())
        print(f"wrote {args.hdr_output}")
    if args.save_camera:
        api.serialize_camera(args.save_camera)
    return 0


def _default_frame(api):
    """Aim the camera at the loaded geometry (its world bounding box)."""
    v0 = api.scene.world_arrays(rebuild_bvh=False)["world"]["v0"]
    lo = v0.min(0)
    hi = v0.max(0)
    c = 0.5 * (lo + hi)
    ext = float(np.linalg.norm(hi - lo))
    api.camera.look_at(c + np.array([0.0, 0.35 * ext, 1.2 * ext + 1e-3]), c)
    api.camera.focal_distance = max(1.2 * ext, 1e-3)


if __name__ == "__main__":
    sys.exit(main())
