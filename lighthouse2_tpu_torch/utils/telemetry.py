"""The port's own measurement: host spans on the profiler's clock, and
device stage marks that a CUDA graph captures with the pass.

Host spans. span(name) is a torch.profiler.record_function range, so it
lands on the same timeline as the device operations of a torch.profiler
trace (and is an NVTX range under torch.autograd.profiler.emit_nvtx); it
also times its body on the host clock (`.seconds`) and, given a dict,
adds those seconds to it. named_stage(fn) runs fn under a span of its
name. The spans of the port, each with what reads it:

  <entry>.capture / .instantiate   render/graphs.py CapturedCall, <entry>
                                   its name (_render_pass_regen_jit, ...):
                                   the entry's capture_seconds and
                                   instantiate_seconds
  _stage_generate ... _stage_finish  render_pass_staged's stages (a
                                   profile of that executor)
  sync.<step>                      HostScene.sync's steps (SYNC_STEPS):
                                   HostScene.sync_seconds

Device stage marks. A host range never reaches the kernels of a graph
replay. mark(stage, device) launches lh2_mark_<stage> (csrc/trace.cu), one
thread, on the current stream: inside a capture it becomes a node of the
graph. The kernel reads %globaltimer and adds the nanoseconds since the
previous mark to the stage that mark opened, in an int64 buffer that each
device allocates once, outside any capture (a graph bakes in its
address), and never frees. The passes place the marks as STAGES says;
"end" closes a pass, and the time from there to the next pass's first mark
(the replay's copies) goes to no stage. The launch is render/kernels/
trace.py's launch_mark, which that module installs as `launcher` (the
kernels live in its library); on the CPU a mark launches nothing. The
marks are always on; stage_seconds(device) reads the buffer on demand (one
copy from the device) and never inside a pass.
"""
from __future__ import annotations

import functools
from time import perf_counter

import torch

# the stages of a pass, in their order in a bounce (csrc/trace.cu
# lh2_mark_stages, which the library's loader holds to this): generate (regeneration / eye rays), trace (the closest-hit
# trace, with the cluster path's ray sort and payload pack), refine, shade
# (shading data, BSDF, NEE), occlude (the any-hit trace), apply (the
# shadow's contribution, the bounce's counters), finish (untile,
# accumulate, stats)
STAGES = ("generate", "trace", "refine", "shade", "occlude", "apply",
          "finish")
MARKS = STAGES + ("end",)
# the mark buffer (csrc/trace.cu stage_mark): the open stage (-1: none), the
# last mark's time, the passes closed, then the stages' nanoseconds
_OPEN, _LAST, _PASSES, _NS = 0, 1, 2, 3


class span:
    """A host span named `name`: a torch.profiler.record_function range
    around the body, whose host seconds are kept in `.seconds` and, with
    `into`, added to into[key] (key defaults to the name)."""

    def __init__(self, name: str, into: dict | None = None,
                 key: str | None = None):
        self.name = name
        self.into = into
        self.key = name if key is None else key
        self.seconds = 0.0
        self._range = torch.profiler.record_function(name)

    def __enter__(self):
        self._range.__enter__()
        self._t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = perf_counter() - self._t0
        if self.into is not None:
            self.into[self.key] = self.into.get(self.key, 0.0) + self.seconds
        return self._range.__exit__(*exc)


def named_stage(fn):
    """Run fn under a span of its name (render_pass_staged's stages)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with span(fn.__name__):
            return fn(*args, **kwargs)
    return run


# ------------------------------------------------------------ stage marks
_buffers: dict = {}     # torch.device -> int64 [_NS + STAGES] there


def _resolve(device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def stage_buffer(device) -> torch.Tensor:
    """The device's mark buffer, allocated at the first call (never inside
    a stream capture: a graph must find it in place)."""
    device = _resolve(device)
    buf = _buffers.get(device)
    if buf is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the stage-mark buffer of a device is "
                               "allocated outside any CUDA-graph capture")
        buf = torch.zeros(_NS + len(STAGES), dtype=torch.int64,
                          device=device)
        buf[_OPEN] = -1                   # no stage open
        _buffers[device] = buf
    return buf


def _no_launcher(stage: str, device):
    if torch.device(device).type == "cuda":
        raise RuntimeError("no stage-mark launcher: importing "
                           "lighthouse2_tpu_torch.render.kernels.trace "
                           "installs it")


launcher = _no_launcher     # render/kernels/trace.py installs launch_mark


def mark(stage: str, device):
    """Open `stage` (one of MARKS) on `device` through `launcher`."""
    launcher(stage, device)


def stage_seconds(device) -> dict:
    """{stage: seconds} the device's marks have summed since the buffer was
    allocated, and "passes": the passes closed; zeros where the device has
    marked nothing (the CPU). One copy from the device, on the current
    stream."""
    buf = _buffers.get(_resolve(device))
    if buf is None:
        return dict(dict.fromkeys(STAGES, 0.0), passes=0)
    v = buf.cpu().tolist()
    return dict({s: v[_NS + i] * 1e-9 for i, s in enumerate(STAGES)},
                passes=int(v[_PASSES]))


def stage_stats(before: dict, after: dict) -> dict:
    """A core's stats between two stage_seconds readouts, named after the
    reference's CoreStats: trace_time (the closest-hit traces),
    shadow_trace_time (the any-hit traces), shade_time (every other stage)
    in seconds, and stage_ms {stage: ms}."""
    d = {s: after[s] - before[s] for s in STAGES}
    return dict(trace_time=d["trace"], shadow_trace_time=d["occlude"],
                shade_time=sum(d[s] for s in STAGES
                               if s not in ("trace", "occlude")),
                stage_ms={s: 1e3 * v for s, v in d.items()})
