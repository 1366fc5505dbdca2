"""Scripted interactive viewer: the imguiapp main-loop analog, headless.

The reference's interactive loop (apps/imguiapp/main.cpp:185-271) does:
WASD/mouse camera input -> Restart on motion, shift-click probe -> focal
distance + material pick (main.cpp:123-134), live material edits -> restart
(HandleMaterialChange, main.cpp:143-153), progressive Converge otherwise,
and presents every frame. This CLI replays the same loop from a SESSION
SCRIPT (one command per line) and writes a numbered frame sequence —
interactivity made testable/headless.

Script commands (\"#\" comments allowed):
    move <dx> <dy> <dz>       translate camera in view space (WASD analog)
    turn <yaw_deg> <pitch_deg>  rotate the view direction (mouse analog)
    probe <x> <y>             shift-click analog: print hit identity, set
                              camera focal distance to the hit, select the
                              hit material for subsequent `mat` edits
    mat <field> <v> [v2 v3]   live-edit the selected material (restart)
    fov <deg> | aperture <v>  lens controls
    frames <n>                render n progressive passes, write a frame
                              after each (converge unless state changed)
    snap                      render one pass and write a frame
    camera save <path> / camera load <path>
    materials save <path>
    debug bvh|gbuffer [path]  write the BVH heatmap / the G-buffer mosaic
    debug tree                print the BVH shapes

Usage:
    python -m lighthouse2_tpu_torch.apps.viewer_cli cornell \\
        --script session.txt --out-dir frames/ --size 256 [--device cpu]

Counterpart of lighthouse2_tpu/apps/viewer_cli.py (_rotate, FrameServer,
ViewerSession, main), with its flags and script commands, plus `--device`
(default: the card, raising without one; "cpu" runs the plain versions on
the host) and `--serve-host`. Differences: FrameServer binds 127.0.0.1
unless it is given another host (the JAX server binds 0.0.0.0, every
interface), so the live view is private to the machine unless asked for;
the debug views come from the port's render/probe.py (its heatmap counts
BVH4 node visits, its tree print adds the BVH4); an OBJ scene is placed in
the scene (add_instance), where the JAX CLI adds its mesh but no instance
of it and so renders nothing.
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def _rotate(direction, yaw_deg, pitch_deg):
    d = np.asarray(direction, np.float64)
    yaw = np.radians(yaw_deg)
    pitch = np.radians(pitch_deg)
    # yaw about world up, pitch about camera right
    cy, sy = np.cos(yaw), np.sin(yaw)
    d = np.array([cy * d[0] + sy * d[2], d[1], -sy * d[0] + cy * d[2]])
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(d, up)
    rn = np.linalg.norm(right)
    if rn > 1e-8:
        right /= rn
        cp, sp = np.cos(pitch), np.sin(pitch)
        d = cp * d + sp * np.cross(right, d)
    return (d / np.linalg.norm(d)).astype(np.float32)


class FrameServer:
    """Live frame streaming — the 'present every frame' half of the
    reference's interactive loop (glfwSwapBuffers, main.cpp:270) for a
    headless box: a tiny HTTP server on a daemon thread holds the latest
    frame; a browser at / polls /frame.png so a human can watch the render
    converge live, and /stats holds the last frame's numbers. It listens on
    `host` (default 127.0.0.1, this machine only)."""

    _PAGE = (b"<!doctype html><title>lighthouse2_tpu_torch</title>"
             b"<body style='background:#111;margin:0;display:flex;"
             b"align-items:center;justify-content:center;height:100vh'>"
             b"<img id=f style='image-rendering:pixelated;"
             b"max-width:96vw;max-height:96vh'><script>"
             b"const i=document.getElementById('f');"
             b"setInterval(()=>{i.src='/frame.png?t='+Date.now();},300);"
             b"</script></body>")

    def __init__(self, port: int = 8642, host: str = "127.0.0.1"):
        import http.server
        import threading
        srv_self = self
        self.latest = b""
        self.stats = b"{}"

        class H(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.startswith("/frame.png") and srv_self.latest:
                    body, ctype = srv_self.latest, "image/png"
                elif self.path.startswith("/stats"):
                    body, ctype = srv_self.stats, "application/json"
                else:
                    body, ctype = srv_self._PAGE, "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Cache-Control", "no-store")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = http.server.ThreadingHTTPServer((host, port), H)
        self.port = self.httpd.server_address[1]
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()

    def push(self, png_bytes: bytes, stats: dict | None = None):
        import json
        self.latest = png_bytes
        if stats is not None:
            self.stats = json.dumps(
                {k: v for k, v in stats.items()
                 if isinstance(v, (int, float, str))}).encode()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


class ViewerSession:
    """Drives a RenderAPI from parsed script commands; keeps the selected
    material + frame counter (the imguiapp loop state)."""

    def __init__(self, api, out_dir: str, server: FrameServer | None = None):
        self.api = api
        self.out_dir = out_dir
        self.frame = 0
        self.selected_mat = -1
        self.log: list[str] = []
        self.server = server
        os.makedirs(out_dir, exist_ok=True)

    def _emit_frame(self):
        from lighthouse2_tpu_torch.utils.image import write_png
        path = os.path.join(self.out_dir, f"frame_{self.frame:04d}.png")
        write_png(path, self.api.get_ldr_image())
        if self.server is not None:
            with open(path, "rb") as f:
                self.server.push(f.read(), getattr(self.api.core, "stats",
                                                   None))
        self.frame += 1
        return path

    def _say(self, msg):
        self.log.append(msg)
        print(msg)

    def run_line(self, line: str):
        line = line.split("#", 1)[0].strip()
        if not line:
            return
        tok = line.split()
        cmd, args = tok[0], tok[1:]
        cam = self.api.camera
        if cmd == "move":
            dx, dy, dz = (float(a) for a in args)
            fwd = cam.direction
            up = np.array([0, 1, 0], np.float32)
            right = np.cross(fwd, up)
            right /= max(np.linalg.norm(right), 1e-8)
            cam.position = (cam.position + dx * right + dy * up
                            + dz * fwd).astype(np.float32)
        elif cmd == "turn":
            cam.direction = _rotate(cam.direction, float(args[0]),
                                    float(args[1]))
        elif cmd == "fov":
            cam.fov = float(args[0])
        elif cmd == "aperture":
            cam.aperture = float(args[0])
        elif cmd == "probe":
            # shift-click: identity + focal distance + material select
            # (apps/imguiapp/main.cpp:123-134)
            r = self.api.probe(int(args[0]), int(args[1]))
            if r["prim"] >= 0 and np.isfinite(r["distance"]):
                cam.focal_distance = float(r["distance"])
                self.selected_mat = r["material"]
            self._say(f"probe ({args[0]},{args[1]}): prim={r['prim']} "
                      f"mat={r['material']} dist={r['distance']:.4f}")
        elif cmd == "mat":
            # live material edit -> scene dirty -> restart
            # (HandleMaterialChange, main.cpp:143-153)
            if self.selected_mat < 0:
                self._say("mat: no material selected (probe first)")
                return
            field = args[0]
            vals = [float(a) for a in args[1:]]
            m = self.api.scene.materials[self.selected_mat]
            val = tuple(vals) if len(vals) > 1 else vals[0]
            self.api.scene.materials[self.selected_mat] = m.replace(
                **{field: val})
            self.api.scene.dirty = True
            self._say(f"mat {self.selected_mat}.{field} = {val}")
        elif cmd == "frames":
            for _ in range(int(args[0])):
                stats = self.api.render()
                p = self._emit_frame()
                self._say(f"{p}: spp={stats.get('spp')} "
                          f"mrays/s={stats.get('mrays_per_s', 0):.2f}")
        elif cmd == "snap":
            self.api.render()
            self._say(self._emit_frame())
        elif cmd == "camera":
            if args[0] == "save":
                self.api.serialize_camera(args[1])
            else:
                self.api.deserialize_camera(args[1])
        elif cmd == "materials":
            self.api.serialize_materials(args[1])
        elif cmd == "debug":
            # debug visualizations (F4-style, finalize_shared.h:491-541 +
            # ColorDebugBVH raytracer.cpp:102-120 + BVH::Print bvh.cpp:304)
            from lighthouse2_tpu_torch.render import probe as probe_mod
            from lighthouse2_tpu_torch.utils.image import write_png
            ds = self.api.device_scene()
            view = self.api.camera.get_view(self.api.device)
            cfg = self.api.core.config
            kind = args[0]
            if kind == "bvh":
                img = probe_mod.bvh_heatmap(ds, view, cfg)
            elif kind == "gbuffer":
                img = probe_mod.gbuffer_views(ds, view, cfg)
            elif kind == "tree":
                self._say(probe_mod.bvh_print(ds))
                return
            else:
                raise ValueError(f"unknown debug view: {kind!r}")
            path = (args[1] if len(args) > 1 else os.path.join(
                self.out_dir, f"debug_{kind}_{self.frame:04d}.png"))
            write_png(path, img)
            self._say(f"debug {kind}: {path}")
        else:
            raise ValueError(f"unknown viewer command: {line!r}")

    def run_script(self, text: str):
        for line in text.splitlines():
            self.run_line(line)


def main(argv=None):
    ap = argparse.ArgumentParser(description="scripted interactive viewer")
    ap.add_argument("scene", help="'cornell', 'triangle', or an asset path")
    ap.add_argument("--script", required=True, help="session script file")
    ap.add_argument("--out-dir", default="frames")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp-per-pass", type=int, default=2)
    ap.add_argument("--max-path", type=int, default=6)
    ap.add_argument("--core", default="wavefront")
    ap.add_argument("--serve", type=int, default=0, metavar="PORT",
                    help="serve the latest frame at http://host:PORT/ "
                         "(live convergence view)")
    ap.add_argument("--serve-host", default="127.0.0.1", metavar="HOST",
                    help="interface --serve listens on (default 127.0.0.1; "
                         "0.0.0.0 for every interface)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' for the host)")
    ap.add_argument("--watch", type=int, default=0, metavar="N",
                    help="after the script, keep converging N more passes "
                         "(0 = script only), pushing each to --serve")
    args = ap.parse_args(argv)

    from lighthouse2_tpu_torch.api import RenderAPI
    from lighthouse2_tpu_torch.core.types import RenderConfig

    cfg = RenderConfig(width=args.size, height=args.size,
                       spp_per_pass=args.spp_per_pass,
                       max_path_length=args.max_path)
    api = RenderAPI.create(args.core, cfg, device=args.device)
    if args.scene == "cornell":
        from lighthouse2_tpu_torch.scene.presets import cornell_box
        api.scene, api.camera = cornell_box(args.size, args.size)
    elif args.scene == "triangle":
        from lighthouse2_tpu_torch.scene.presets import single_triangle
        api.scene, api.camera = single_triangle(args.size, args.size)
    elif args.scene.lower().endswith((".gltf", ".glb")):
        api.scene.load_gltf(args.scene)
    else:
        api.scene.add_instance(api.scene.load_obj(args.scene))

    server = (FrameServer(args.serve, args.serve_host) if args.serve
              else None)
    if server is not None:
        print(f"live view: http://{args.serve_host}:{server.port}/")
    try:
        session = ViewerSession(api, args.out_dir, server=server)
        with open(args.script) as f:
            session.run_script(f.read())
        for _ in range(args.watch):
            session.run_line("snap")
    finally:
        if server is not None:
            server.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
