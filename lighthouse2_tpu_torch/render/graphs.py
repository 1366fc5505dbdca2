"""CUDA-graph capture of the compiled executors: the port's counterpart of
jax.jit where the JAX package compiles a whole pass or step.

The JAX package jits render_pass_unrolled (lighthouse2_tpu/render/
wavefront.py:889), _render_pass_regen_jit (:1008) and the headline's fwd+bwd
step (bench.py:82-112 fb_pass): each is traced once per static config and
input shapes, and from then on runs as one program a call. A CapturedCall
does the same with a CUDA graph (torch.cuda.graphs) for arguments on a card:

  - the cache key (cache_key) is the entry point's name and the structure
    of its arguments (dataclasses, dicts, tuples and lists are walked): the
    shape, dtype and device of every tensor in them, and the value of every
    other leaf, which the pass bakes in as a constant: the config's fields
    and the ints, bools and strings of the scene (counts, tree depths,
    flags);
  - the first call with a key runs eagerly, on the capture's side stream:
    the warm-up, which builds and loads the kernels' libraries, runs their
    one-time attribute calls and the lazy inits (the blue-noise mask);
  - the second call with the key copies the arguments into static tensors
    the graph owns, captures the call on the side stream into the graph's
    private memory pool, instantiates the graph and replays it;
  - each later call copies its arguments into the static tensors and
    replays. A tensor that is the one copied there last (the same data_ptr
    and strides, its version counter unchanged since) is not copied again,
    so a scene passed call after call is read in place;
  - results are copied out of the graph's pool, so the caller owns them and
    no later replay overwrites a state the caller still holds (the JAX
    functions donate the state; these do not);
  - one graph is kept for each entry point: a new key frees the old graph
    and its pool. Calls whose shapes change every time (an animated scene
    re-synced each frame) therefore run eagerly at the eager cost and never
    pay for a capture;
  - the kernel wrappers' launch counters (trace_closest.launches and the
    three others) move only where a wrapper launches its kernel: in the
    eager call and in the capture, which records the launches into the
    graph. A replay runs the graph's kernels without the wrappers and
    moves no counter; the profiler counts its kernels by name;
  - the capture runs under two host spans (utils/telemetry.py) named after
    the entry point, <name>.capture (recording the call) and
    <name>.instantiate (ending the capture), which fill the entry's
    capture_seconds and instantiate_seconds.

Arguments on the CPU run eagerly, every call, as every entry point did
before. A call in which grad mode is on and an argument requires grad also
runs eagerly: a replay's results are not part of the caller's autograd
graph. There is no fallback: a capture that fails raises with its cause and
its entry is dropped, and nothing selects eager or graph from outside.
"""
from __future__ import annotations

import copy
import dataclasses

import torch

from lighthouse2_tpu_torch.utils import telemetry


class _Entry:
    """One key and, after its capture, its graph: static inputs, static
    outputs and the capture's timings."""

    def __init__(self, key):
        self.key = key
        self.graph = None
        self.static = None         # tensors the graph reads, in walk order
        self.sources = None        # (tensor, version) last copied into each
        self.out = None            # the captured call's result, in the pool
        self.capture_seconds = None       # the span <name>.capture
        self.instantiate_seconds = None   # the span <name>.instantiate

    def free(self):
        self.out = self.static = self.sources = None
        if self.graph is not None:
            self.graph.reset()
        self.graph = None


def _walk(x, tensors: list):
    """The hashable structure of x; its tensors appended to `tensors` in
    walk order."""
    if isinstance(x, torch.Tensor):
        tensors.append(x)
        return (torch.Tensor, tuple(x.shape), x.dtype, x.device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x), tuple((f.name, _walk(getattr(x, f.name), tensors))
                               for f in dataclasses.fields(x)))
    if isinstance(x, dict):
        return (dict, tuple((k, _walk(v, tensors)) for k, v in x.items()))
    if isinstance(x, (tuple, list)):
        return (type(x), tuple(_walk(v, tensors) for v in x))
    if x is None or isinstance(x, (bool, int, float, str)):
        return (type(x), x)
    raise TypeError(f"a captured call cannot take a {type(x).__name__}")


def _rebuild(x, it):
    """x with its tensors replaced, in walk order, by those of `it`."""
    if isinstance(x, torch.Tensor):
        return next(it)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        y = copy.copy(x)
        for f in dataclasses.fields(x):
            object.__setattr__(y, f.name, _rebuild(getattr(x, f.name), it))
        return y
    if isinstance(x, dict):
        return {k: _rebuild(v, it) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_rebuild(v, it) for v in x)
    return x


def cache_key(name: str, *args):
    """The key of a call of entry point `name` on `args` (the config among
    them, a frozen dataclass whose fields the key holds by value)."""
    return (name, _walk(args, []))


class CapturedCall:
    """fn(*args) compiled as the module docstring says, under the entry
    point name `name`. fn must be functional: it reads its arguments and
    never writes them, and draws no torch random numbers. `entry` is the
    cached key and, once captured, its graph (capture_seconds,
    instantiate_seconds), or None; `replays` counts the graph replays of
    all its keys."""

    def __init__(self, name: str, fn):
        self.name = name
        self.fn = fn
        self.entry = None
        self.replays = 0
        self._streams = {}      # device -> side stream of warm-ups, captures

    def clear(self):
        """Free the graph and forget the key."""
        if self.entry is not None:
            self.entry.free()
        self.entry = None

    def __call__(self, *args):
        tensors = []
        key = (self.name, _walk(args, tensors))
        devices = {t.device for t in tensors}
        if all(d.type == "cpu" for d in devices) or (
                torch.is_grad_enabled()
                and any(t.requires_grad for t in tensors)):
            return self.fn(*args)
        if len(devices) != 1:
            raise ValueError(f"{self.name}: the arguments lie on "
                             f"{sorted(map(str, devices))}; a captured call "
                             "takes them all on one card")
        dev = devices.pop()
        if self.entry is None or self.entry.key != key:
            self.clear()
            self.entry = _Entry(key)
            return self._warm_up(args, dev)
        if self.entry.graph is None:
            self._capture(args, tensors, dev)
        else:
            self._load(tensors)
        return self._replay()

    def _side_stream(self, dev: torch.device):
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(dev)
        return self._streams[dev]

    def _warm_up(self, args, dev):
        """The eager call, on the side stream; its results are handed to
        the caller's stream."""
        cur = torch.cuda.current_stream(dev)
        side = self._side_stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = self.fn(*args)
        cur.wait_stream(side)
        produced = []
        _walk(out, produced)
        for t in produced:
            t.record_stream(cur)
        return out

    def _stage(self, args, tensors):
        """The entry's static inputs: a clone of each of the call's tensors,
        each clone's source remembered. Returns the arguments rebuilt on
        the clones."""
        e = self.entry
        with torch.no_grad():
            e.static = [t.detach().clone() for t in tensors]
        e.sources = [(t, t._version) for t in tensors]
        return _rebuild(args, iter(e.static))

    def _capture(self, args, tensors, dev):
        e = self.entry
        static_args = self._stage(args, tensors)
        g = torch.cuda.CUDAGraph()
        # the mark buffer is in place before the graph bakes in its address
        telemetry.stage_buffer(dev)
        capture = torch.cuda.graph(g, stream=self._side_stream(dev))
        try:
            capture.__enter__()
            try:
                with telemetry.span(f"{self.name}.capture") as rec:
                    out = self.fn(*static_args)
            except BaseException as exc:
                capture.__exit__(type(exc), exc, exc.__traceback__)
                raise
            with telemetry.span(f"{self.name}.instantiate") as inst:
                capture.__exit__(None, None, None)
        except BaseException:
            self.clear()
            raise
        e.capture_seconds, e.instantiate_seconds = rec.seconds, inst.seconds
        e.graph, e.out = g, out

    def _load(self, tensors):
        """Copy the call's tensors into the static ones, but for a tensor
        that is the one copied there last and unchanged since."""
        e = self.entry
        with torch.no_grad():
            for i, (t, (src, ver)) in enumerate(zip(tensors, e.sources)):
                if (t.data_ptr() == src.data_ptr()
                        and t.stride() == src.stride()
                        and t._version == ver):
                    continue
                e.static[i].copy_(t)
                e.sources[i] = (t, t._version)

    def _replay(self):
        e = self.entry
        e.graph.replay()
        self.replays += 1
        produced, clones = [], {}
        _walk(e.out, produced)
        with torch.no_grad():
            for t in produced:
                if id(t) not in clones:
                    clones[id(t)] = t.clone()
        return _rebuild(e.out, iter(clones[id(t)] for t in produced))
