"""The port's own measurement (utils/telemetry.py), checked on the CPU.

  - the stage marks each executor requests, recorded by a launcher that
    stands in for the kernel launch: generate, trace, refine, shade,
    occlude, apply a bounce, then finish and end, for the regen, unrolled
    and classic passes (and one leading trace mark before the cluster
    path's payload pack); with config.remat the recompute in the backward
    requests none;
  - under torch.profiler (CPU activity) the staged executor's _stage_*
    ranges, the captured call's capture and instantiate spans (filling
    its capture_seconds and instantiate_seconds) and HostScene.sync's
    sync.<step> spans, with sync_seconds filled for every step;
  - the stage readout and the cores' stats on a device that marks nothing;
    build_library builds a source once.
32x32, path 3 (1 under the profiler); no JAX and no card.
"""
import json
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.diff.render import regen_value_and_grad
from lighthouse2_tpu_torch.render import graphs
from lighthouse2_tpu_torch.render import wavefront as wf
from lighthouse2_tpu_torch.render.kernels import trace as tk
from lighthouse2_tpu_torch.scene import presets
from lighthouse2_tpu_torch.scene.host_scene import SYNC_STEPS
from lighthouse2_tpu_torch.utils import telemetry

torch.set_num_threads(1)

SIZE = 32
PATH = 3
BOUNCE = ["generate", "trace", "refine", "shade", "occlude", "apply"]
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def scenes():
    host, cam = presets.cornell_box(SIZE, SIZE)
    view = cam.get_view(CPU)
    return dict(auto=(host.sync(CPU, native=False), view),
                cluster=(host.sync(CPU, native=False, clusters=True), view))


@pytest.fixture
def marks(monkeypatch):
    """The stages the code asks to mark, in order, on any device."""
    got = []
    monkeypatch.setattr(telemetry, "launcher",
                        lambda stage, device: got.append(stage))
    return got


def _config(**kw):
    return RenderConfig(**dict(dict(width=SIZE, height=SIZE, spp_per_pass=1,
                                    max_path_length=PATH), **kw))


EXECUTORS = dict(
    regen=(dict(path_regen=True), wf.render_pass_regen),
    unrolled=({}, wf.render_pass_unrolled),
    classic=({}, wf.render_pass),
    regen_cluster=(dict(path_regen=True, intersector="cluster"),
                   wf.render_pass_regen))


@pytest.mark.parametrize("executor", list(EXECUTORS))
def test_a_pass_marks_each_stage_of_each_bounce(executor, scenes, marks):
    kw, run = EXECUTORS[executor]
    ds, view = scenes["cluster" if "cluster" in executor else "auto"]
    cfg = _config(**kw)
    state, stats = run(ds, view, wf.AccumState.make(cfg, CPU), cfg)
    assert (stats["extension_rays"] > 0).all()      # no bounce skipped
    lead = ["trace"] if "cluster" in executor else []
    assert marks == lead + BOUNCE * PATH + ["finish", "end"]


def test_the_remat_recompute_marks_nothing(scenes, marks):
    ds, view = scenes["auto"]
    cfg = _config(path_regen=True, remat=True)
    params = dict(color=ds.materials.color)
    state = wf.ensure_regen_state(view, wf.AccumState.make(cfg, CPU), cfg)
    loss, grads, _ = regen_value_and_grad(ds, view, state, cfg,
                                          torch.zeros((SIZE * SIZE, 3)),
                                          params)
    assert grads["color"].abs().sum() > 0           # the backward ran
    assert marks == BOUNCE * PATH + ["finish", "end"]


def _host_names(prof, tmp_path):
    """The names of the events of a profiler's trace, read from its Chrome
    trace (quicker than building the profiler's event tree)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return {e.get("name")
            for e in json.loads(path.read_text())["traceEvents"]}


def test_host_spans_reach_the_profiler(scenes, tmp_path):
    ds, view = scenes["auto"]
    cfg = _config(path_regen=True, max_path_length=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        wf.render_pass_staged(ds, view, wf.AccumState.make(cfg, CPU), cfg)
    names = _host_names(prof, tmp_path)
    stages = ("_stage_generate", "_stage_prepare", "_stage_trace",
              "_stage_shade", "_stage_occlude", "_stage_apply",
              "_stage_finish")
    assert set(stages) <= names, set(stages) - names


def test_captured_call_spans(tmp_path, monkeypatch):
    """The capture and its instantiation under their spans, which fill the
    entry's capture_seconds and instantiate_seconds; a call that fails
    inside the capture ends the capture with its error and forgets the
    entry. A stub stands in for the CUDA graph (the CPU cannot capture),
    and a clock that moves only when told stands in for the host's."""
    ended, now = [], [0.0]
    monkeypatch.setattr(telemetry, "perf_counter", lambda: now[0])

    class StubCapture:
        def __init__(self, graph, stream=None):
            pass

        def __enter__(self):
            return self

        def __exit__(self, kind, exc, tb):
            now[0] += 2.0                   # the graph's instantiation
            ended.append(kind)
            return False

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: "graph")
    monkeypatch.setattr(torch.cuda, "graph", StubCapture)

    def fn(x):
        now[0] += 1.0                       # the recorded call
        return (x * 2.0,)

    cc = graphs.CapturedCall("stub_entry", fn)
    cc._side_stream = lambda dev: None
    x = torch.arange(4.0)
    cc.entry = graphs._Entry(graphs.cache_key("stub_entry", x))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cc._capture((x,), [x], CPU)
    assert ended == [None] and cc.entry.graph == "graph"
    assert torch.equal(cc.entry.out[0], x * 2.0)
    assert (cc.entry.capture_seconds, cc.entry.instantiate_seconds) == (
        1.0, 2.0)
    names = _host_names(prof, tmp_path)
    assert {"stub_entry.capture", "stub_entry.instantiate"} <= names, names

    def broken(x):
        raise ValueError("no capture")

    cc = graphs.CapturedCall("stub_entry", broken)
    cc._side_stream = lambda dev: None
    cc.entry = graphs._Entry(graphs.cache_key("stub_entry", x))
    with pytest.raises(ValueError, match="no capture"):
        cc._capture((x,), [x], CPU)
    assert ended == [None, ValueError] and cc.entry is None


def test_sync_spans_fill_every_step(tmp_path):
    host, _ = presets.cornell_box(SIZE, SIZE)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        host.sync(CPU, native=False, clusters=True)
    assert set(host.sync_seconds) == set(SYNC_STEPS)
    assert all(v > 0 for v in host.sync_seconds.values()), host.sync_seconds
    names = _host_names(prof, tmp_path)
    assert {f"sync.{s}" for s in SYNC_STEPS} <= names, names


def test_span_times_and_adds_into_a_dict():
    into = {"a": 1.0}
    with telemetry.span("x", into, "a") as s:
        pass
    assert s.seconds >= 0.0 and into["a"] == 1.0 + s.seconds
    with telemetry.span("y", into) as t:
        pass
    assert into["y"] == t.seconds


def test_readout_and_core_stats_on_a_device_without_marks(scenes):
    from lighthouse2_tpu_torch.render.cores.base import create_core
    zero = telemetry.stage_seconds(CPU)
    assert zero == dict(dict.fromkeys(telemetry.STAGES, 0.0), passes=0)
    ds, view = scenes["auto"]
    core = create_core("wavefront", _config(path_regen=True))
    stats = core.render(ds, view)
    assert stats["trace_time"] == stats["shadow_trace_time"] == 0.0
    assert stats["shade_time"] == 0.0
    assert set(stats["stage_ms"]) == set(telemetry.STAGES)
    # the split of a readout: the traces apart, every other stage shading
    after = dict(zero, generate=1.0, trace=2.0, refine=3.0, shade=4.0,
                 occlude=5.0, apply=6.0, finish=7.0)
    got = telemetry.stage_stats(zero, after)
    assert (got["trace_time"], got["shadow_trace_time"],
            got["shade_time"]) == (2.0, 5.0, 21.0)
    assert got["stage_ms"]["finish"] == 7000.0


def test_build_library_builds_a_source_once(tmp_path, monkeypatch):
    src = tmp_path / "probe_lib.cu"
    src.write_text("// nothing\n")
    runs = tmp_path / "runs"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f'#!/bin/sh\necho run >> "{runs}"\n'
                    'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(tk, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tk, "_nvcc", lambda: str(nvcc))
    so, _ = tk.build_library(str(src))
    assert tk.build_library(str(src))[0] == so and os.path.exists(so)
    assert runs.read_text().split() == ["run"]
    src.write_text("// changed\n")                 # a new source: built again
    assert tk.build_library(str(src))[0] != so
    assert runs.read_text().split() == ["run", "run"]
