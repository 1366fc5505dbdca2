"""The benchmark's harness: one run of one cell of BENCHMARK.json.

Everything that belongs to a configuration, a scene, a traffic mix, a
driver, a per-layer metric or a cell's correctness limits is a file that
the harness finds by the name it is given:

  benchmark/configs/<config>.json    scene, resolution, render settings
                                     (the file BENCHMARK.json names)
  benchmark/scenes/<scene>.py        build(conf) -> the scene's raw arrays
  benchmark/traffic/<mix>.json       the mix: its driver ("kind") and the
                                     driver's parameters
  benchmark/drivers/<kind>.py        inputs(ctx, seed), drive(ctx) and
                                     check(ctx, out, dtype=None): the
                                     entry point the window drives and the
                                     comparison with its plain reference
  benchmark/metrics/<metric>.py      read(record) -> number or None
  benchmark/checks/<cell>.json       the limit of each number compared

So a cell, a configuration, a scene, a mix, a driver or a metric is added
by adding files, and this file is never edited for one.

A run builds the configuration's scene from the benchmark's own arrays,
hands it to the program through its public API, lets the driver draw its
inputs from the seed, warm up its entry point, measure for --seconds and
trace a few more calls with torch.profiler, then reads the peak memory,
frees the program's state and lets the driver hold what the timed path
produced against its plain reference.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "lighthouse2_tpu")
M32 = 0xFFFFFFFF


def forbidden_modules(names) -> list:
    """The module names whose top-level package (the part before the first
    dot, compared whole) is JAX's or the JAX package's."""
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root=ROOT):
    """Every compile cache of the run at a fixed path inside the checkout:
    the program builds its kernels into build/lighthouse2_tpu_torch/ by
    itself; Triton, torch extensions and the driver's PTX cache go beside
    it."""
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def _json(path):
    with open(path) as fh:
        return json.load(fh)


def load(folder: str, name: str, root=ROOT):
    """benchmark/<folder>/<name>.py as a module."""
    path = os.path.join(root, "benchmark", folder, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root=ROOT):
    """benchmark/metrics/<name>.py, with read(record)."""
    return load("metrics", name, root)


def cell_spec(workload: str, root=ROOT) -> dict:
    """The cell named `workload` with its configuration, traffic, limits
    and the metrics it reports, each read from its own file."""
    man = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {c["name"]: c for c in man["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    files = {c["name"]: c["file"] for c in man["configs"]}

    def reports(m):
        return "workloads" not in m or workload in m["workloads"]
    return dict(
        cell=cell, config=_json(os.path.join(root, files[cell["config"]])),
        traffic=_json(os.path.join(root, "benchmark", "traffic",
                                   cell["traffic"] + ".json")),
        checks=_json(os.path.join(root, "benchmark", "checks",
                                  workload + ".json")),
        end_to_end=[m for m in man["end_to_end"] if reports(m)],
        per_layer=[m for m in man["per_layer"] if reports(m)])


def mix32(seed: int) -> int:
    """A 32-bit value from a seed of any size (splitmix64's finaliser)."""
    z = (int(seed) + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) & M32


def triangle_count(raw: dict) -> int:
    return sum(raw["meshes"][m]["indices"].shape[0]
               for m, _ in raw["instances"])


# ------------------------------------------------------------ the program
def build_program_scene(raw: dict, conf: dict, dev):
    """The raw arrays handed to the program through HostMesh, HostScene and
    Camera, synced to `dev`. Returns (scene, view, seconds of the sync)."""
    from lighthouse2_tpu_torch.scene.camera import Camera
    from lighthouse2_tpu_torch.scene.host_mesh import HostMesh
    from lighthouse2_tpu_torch.scene.host_scene import HostScene
    from lighthouse2_tpu_torch.scene.host_texture import HostTexture

    host = HostScene()
    for img in raw["textures"]:
        host.add_texture(HostTexture(img, srgb=False))
    for m in raw["materials"]:
        host.add_material(**m)
    ids = [host.add_mesh(HostMesh.from_indexed_data(
        m["vertices"], m["indices"], uvs=m["uvs"], material=m["material"],
        flat=m["flat"], name=m["name"])) for m in raw["meshes"]]
    for mi, tr in raw["instances"]:
        host.add_instance(ids[mi], tr)
    for s in raw["spot_lights"]:
        host.add_spot_light(s["position"], s["radiance"], s["direction"],
                            s["inner_deg"], s["outer_deg"])
    for p in raw["point_lights"]:
        host.add_point_light(p["position"], p["radiance"])
    t0 = time.perf_counter()
    scene = host.sync(dev, clusters=conf["intersector"] == "cluster")
    sync_s = time.perf_counter() - t0
    c = raw["camera"]
    cam = Camera(pixel_count=(conf["width"], conf["height"]), fov=c["fov"])
    cam.look_at(c["origin"], c["target"])
    cam.focal_distance = c["focal_distance"]
    return scene, cam.get_view(dev), sync_s


def render_config(conf: dict):
    """The program's RenderConfig from every key of the configuration that
    names one of its fields."""
    from lighthouse2_tpu_torch.core.types import RenderConfig
    fields = {f.name for f in dataclasses.fields(RenderConfig)}
    return RenderConfig(**{k: v for k, v in conf.items() if k in fields})


def sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ------------------------------------------------------------ one run
def prepare(spec: dict, seed: int, seconds: float, trace: bool, device,
            t_start: float) -> dict:
    """Set-up shared by every driver: the raw scene, the program's scene
    and view, and the driver's inputs drawn from the seed."""
    conf = spec["config"]
    raw = load("scenes", conf["scene"]).build(conf)
    scene, view, sync_s = build_program_scene(raw, conf, device)
    ctx = dict(config=conf, traffic=spec["traffic"], device=device, raw=raw,
               scene=scene, view=view, seconds=seconds, trace=trace,
               t_start=t_start, n_tris=triangle_count(raw),
               spans=dict(sync_s=sync_s),
               driver=load("drivers", spec["traffic"]["kind"]))
    ctx["driver"].inputs(ctx, seed)
    return ctx


def measure(spec, seed, seconds, trace, device, t_start) -> tuple:
    """(ctx, driver output) of one run; the program's scene is dropped from
    ctx before it returns, so that only the checked values stay."""
    ctx = prepare(spec, seed, seconds, trace, device, t_start)
    out = ctx["driver"].drive(ctx)
    for k in ("scene", "view"):
        ctx.pop(k)
    return ctx, out


def record_of(ctx, out) -> dict:
    """What the metric readers read."""
    return dict(kind=out["kind"], config=ctx["config"], traffic=ctx["traffic"],
                spans=ctx["spans"], window=out["window"], trace=out["trace"],
                peak_bytes=out["peak_bytes"], n_tris=ctx["n_tris"])


def result(spec, ctx, out, checks, device) -> dict:
    """The run's result line (without the forbidden-module check)."""
    import torch
    from benchmark import profiling
    rec = record_of(ctx, out)
    wanted = spec["per_layer"] if ctx["trace"] else spec["end_to_end"]
    metrics = {}
    for m in wanted:
        v = metric_reader(m["name"]).read(rec)
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    limits = spec["checks"]
    correct = all(checks[k] <= limits[k] for k in limits)
    dev_info = dict(platform="gpu" if device.type == "cuda" else device.type,
                    kind=(torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
                    count=spec["cell"]["chips"],
                    memory_peak_bytes=int(out["peak_bytes"]))
    res = dict(correct=bool(correct), attempted=int(out["attempted"]),
               failed=0 if correct else int(out["attempted"]),
               metrics=metrics, device=dev_info)
    tr = out["trace"]
    if tr is not None:
        span = tr["span"]
        dev_info["busy_s"] = profiling.busy_seconds(tr["dev"], span)
        dev_info["window_s"] = (span[1] - span[0]) * 1e-6
        res["breakdown"] = dict(
            device_ops=[[n[:120], s] for n, s in profiling.top_ops(tr["dev"])],
            idle_gaps=[[n[:120], s] for n, s in
                       profiling.idle_gaps(tr["dev"], tr["host"], span)])
    res["checks"] = {k: dict(value=checks[k], limit=limits[k]) for k in limits}
    return res
