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
address), and never frees. The passes place the marks as STAGES says; the
composed shade code (render/wavefront.py _shade_composed) also opens the
two parts of its stage that SHADE_PARTS names, which a shade kernel's
single launch does not; "end" closes a pass, and the time from there to
the next pass's first mark (the replay's copies) goes to no stage. The
launch is render/kernels/trace.py's launch_mark, which that module
installs as `launcher` (the kernels live in its library); on the CPU a
mark launches nothing. The marks are always on; stage_seconds(device)
reads the buffer on demand (one copy from the device) and never inside a
pass.

Device counters. count_lobes adds a Disney bounce's lobe picks (LOBES) to
a second int64 buffer of the device with four small ops (the composed
shade code calls it on the marked bounces of the Disney BSDF only); the
Disney shade kernel adds its picks to the same buffer (lobe_counts) on
those bounces; lobe_picks(device) reads it on demand, the cores turn two readouts into a
pass's picks ("lobe_picks"), and the render CLI prints their shares on its
pass line.
"""
from __future__ import annotations

import functools
from time import perf_counter

import torch

# the stages of a pass, in their order in a bounce: generate (regeneration
# / eye rays), trace (the closest-hit trace, with the cluster path's ray
# sort and payload pack), refine, shade (shading data, BSDF, NEE),
# occlude (the any-hit trace), apply (the shadow's contribution, the
# bounce's counters), finish (untile, accumulate, stats)
STAGES = ("generate", "trace", "refine", "shade", "occlude", "apply",
          "finish")
# the parts of the composed shade stage that open with marks of their own,
# numbered after STAGES: nee (the light sample, the BSDF evaluation toward
# it, the shadow ray's set-up) and sample (the BSDF sample, roulette, the
# next ray); there "shade" keeps the shading data, the sky and the
# implicit-light MIS and the bounce's prep. The shade kernels mark neither,
# so a pass that takes one holds no such stage
SHADE_PARTS = ("nee", "sample")
# every stage a mark opens, in the order csrc/trace.cu numbers them
# (lh2_mark_stages, which the library's loader holds to this)
MARKED = STAGES + SHADE_PARTS
MARKS = MARKED + ("end",)
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
_buffers: dict = {}     # torch.device -> int64 [_NS + MARKED] there


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
        buf = torch.zeros(_NS + len(MARKED), dtype=torch.int64,
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
        return dict(dict.fromkeys(MARKED, 0.0), passes=0)
    v = buf.cpu().tolist()
    return dict({s: v[_NS + i] * 1e-9 for i, s in enumerate(MARKED)},
                passes=int(v[_PASSES]))


def stage_stats(before: dict, after: dict) -> dict:
    """A core's stats between two stage_seconds readouts, named after the
    reference's CoreStats: trace_time (the closest-hit traces),
    shadow_trace_time (the any-hit traces), shade_time (every other stage,
    the shade stage's parts included) in seconds, and stage_ms {stage:
    ms}."""
    d = {s: after[s] - before[s] for s in MARKED}
    return dict(trace_time=d["trace"], shadow_trace_time=d["occlude"],
                shade_time=sum(d[s] for s in MARKED
                               if s not in ("trace", "occlude")),
                stage_ms={s: 1e3 * v for s, v in d.items()})


# ------------------------------------------------------------ lobe picks
# the Disney BSDF's lobes in the order of bsdf_disney.sample's "lobe"
LOBES = ("diffuse", "sheen", "specular", "clearcoat", "transmission")
_lobe_buffers: dict = {}   # torch.device -> (int64 [LOBES], [LOBES, 1])


def _lobe_buffer(device):
    """The device's lobe counts and the lobes' indices as a column,
    allocated at the first call, outside any CUDA-graph capture."""
    device = _resolve(device)
    bufs = _lobe_buffers.get(device)
    if bufs is None:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("the lobe counts of a device are allocated "
                               "outside any CUDA-graph capture")
        bufs = (torch.zeros(len(LOBES), dtype=torch.int64, device=device),
                torch.arange(len(LOBES), device=device)[:, None])
        _lobe_buffers[device] = bufs
    return bufs


def count_lobes(lobe, mask):
    """Add one to the count of lobe[i] (an index into LOBES) for each lane
    i of `mask`: a where, a compare against every lobe, a sum and an add on
    the lanes' device (a scatter-add into the few counts would serialise
    its atomics)."""
    buf, lobes = _lobe_buffer(lobe.device)
    picked = torch.where(mask, lobe, -1)[None] == lobes
    buf += picked.sum(1)


def lobe_counts(device):
    """The device's int64 [LOBES] lobe counts, for a kernel to add its
    picks to (render/kernels/shade.py); allocated as count_lobes's."""
    return _lobe_buffer(device)[0]


def lobe_picks(device) -> dict:
    """{lobe: picks} counted on `device` since its counts were allocated
    (zeros where nothing was counted). One copy from the device."""
    bufs = _lobe_buffers.get(_resolve(device))
    if bufs is None:
        return dict.fromkeys(LOBES, 0)
    return dict(zip(LOBES, bufs[0].cpu().tolist()))
