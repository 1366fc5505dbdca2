"""What a CUDA graph of each compiled executor replays, checked on the CPU.

render/graphs.py captures render_pass_unrolled, _render_pass_regen_jit and
regen_value_and_grad once and replays the capture at every later call with
the same key. That is right only if consecutive calls run the same
operations with the same non-tensor arguments (nothing of one call is
baked into the capture: a Python seed would replay the first pass's
samples in every later pass) and nothing reads the device back (a capture
cannot hold a readback). Each item records the aten ops, with their
non-tensor arguments and their tensors' shapes and dtypes, of the second
and third call of one entry point (TorchDispatchMode), at 16x16, path 3,
and requires the two sequences to be identical and to hold no
_local_scalar_dense, nonzero, is_nonzero or equal. The four trace-kernel
wrappers run outside the recording, each recorded as one entry: on a card
their CUDA branch is a single launch, their CPU branch a plain walk.

Cases: the regen pass on "auto" with Lambert, and with Disney and sky IBL
through RenderAPI (the chip_smoke [disney] path); the unrolled pass; the
regen pass on the cluster intersector; the fwd+bwd step with remat. No JAX.
"""
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

from lighthouse2_tpu_torch.api import RenderAPI
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.diff.render import regen_value_and_grad
from lighthouse2_tpu_torch.render import wavefront as wf
from lighthouse2_tpu_torch.render.kernels import cluster
from lighthouse2_tpu_torch.scene import presets

torch.set_num_threads(1)

SIZE = 16
PATH = 3
READBACKS = ("aten._local_scalar_dense", "aten.nonzero", "aten.is_nonzero",
             "aten.equal")


def _describe(x):
    if isinstance(x, torch.Tensor):
        return ("tensor", tuple(x.shape), x.dtype)
    if isinstance(x, (bool, int, float, str, type(None), torch.dtype,
                      torch.device, torch.layout, torch.memory_format)):
        return x
    return type(x).__name__


class _Recorder(TorchDispatchMode):
    """Every aten op of the calls made while it is on, as (name, described
    args, described kwargs); a kernel wrapper's call as one entry."""

    def __init__(self):
        super().__init__()
        self.ops = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            self.ops.append((str(func), tree_map(_describe, args),
                             tree_map(_describe, kwargs)))
        return func(*args, **kwargs)


_ACTIVE = []


def _outside(fn, name):
    def wrapped(*args, **kwargs):
        rec = _ACTIVE[-1] if _ACTIVE else None
        if rec is None:
            return fn(*args, **kwargs)
        rec.ops.append(("kernel " + name, tree_map(_describe, args)))
        rec.paused += 1
        try:
            return fn(*args, **kwargs)
        finally:
            rec.paused -= 1
    return wrapped


@pytest.fixture
def record(monkeypatch):
    """record(call) -> (call's result, its ops); the kernel wrappers are
    wrapped, and _render_pass_regen_jit's calls are recorded into
    `regen_calls`."""
    monkeypatch.setattr(wf, "trace_closest",
                        _outside(wf.trace_closest, "trace_closest"))
    monkeypatch.setattr(wf, "trace_occluded",
                        _outside(wf.trace_occluded, "trace_occluded"))
    monkeypatch.setattr(cluster, "cluster_closest",
                        _outside(cluster.cluster_closest, "cluster_closest"))
    monkeypatch.setattr(cluster, "cluster_occluded",
                        _outside(cluster.cluster_occluded,
                                 "cluster_occluded"))

    def call(fn):
        rec = _Recorder()
        _ACTIVE.append(rec)
        try:
            with rec:
                out = fn()
        finally:
            _ACTIVE.pop()
        return out, rec.ops

    regen_calls = []
    inner = wf._render_pass_regen_jit

    def regen_jit(*args, **kwargs):
        out, ops = call(lambda: inner(*args, **kwargs))
        regen_calls.append(ops)
        return out
    monkeypatch.setattr(wf, "_render_pass_regen_jit", regen_jit)
    call.regen_calls = regen_calls
    return call


def _scene(clusters=False):
    scene, cam = presets.cornell_box(SIZE, SIZE)
    cpu = torch.device("cpu")
    return scene.sync(cpu, clusters=clusters), cam.get_view(cpu)


def _config(**kw):
    return RenderConfig(width=SIZE, height=SIZE, spp_per_pass=1,
                        max_path_length=PATH, **kw)


def _regen_auto(record):
    ds, view = _scene()
    cfg = _config(path_regen=True)
    state = wf.AccumState.make(cfg, "cpu")
    for _ in range(3):
        state, _ = wf.render_pass_regen(ds, view, state, cfg)
    return record.regen_calls


def _regen_disney_ibl(record):
    api = RenderAPI.create("wavefront", width=SIZE, height=SIZE,
                           max_path_length=PATH, path_regen=True,
                           bsdf="disney", sky_ibl=True, device="cpu")
    api.scene, api.camera = presets.cornell_box(SIZE, SIZE)
    presets.test_sky(api.scene)
    for _ in range(3):
        api.render()
    return record.regen_calls


def _unrolled(record):
    ds, view = _scene()
    cfg = _config()
    state = wf.AccumState.make(cfg, "cpu")
    calls = []
    for _ in range(3):
        (state, _), ops = record(
            lambda: wf.render_pass_unrolled(ds, view, state, cfg))
        calls.append(ops)
    return calls


def _regen_cluster(record):
    ds, view = _scene(clusters=True)
    assert ds.cbvh is not None
    cfg = _config(path_regen=True, intersector="cluster")
    state = wf.AccumState.make(cfg, "cpu")
    for _ in range(3):
        state, _ = wf.render_pass_regen(ds, view, state, cfg)
    return record.regen_calls


def _step_remat(record):
    ds, view = _scene()
    cfg = _config(path_regen=True, remat=True)
    params = dict(color=ds.materials.color, light=ds.lights.tri_radiance,
                  offset=torch.zeros((ds.tris.count, 3, 3)))
    target = torch.zeros((SIZE * SIZE, 3))
    state = wf.ensure_regen_state(view, wf.AccumState.make(cfg, "cpu"), cfg)
    calls = []
    for _ in range(3):
        (_, _, state), ops = record(lambda: regen_value_and_grad(
            ds, view, state, cfg, target, params))
        calls.append(ops)
    return calls


CASES = dict(regen_auto_lambert=_regen_auto,
             regen_auto_disney_ibl=_regen_disney_ibl,
             unrolled_auto=_unrolled,
             regen_cluster=_regen_cluster,
             step_remat=_step_remat)


@pytest.mark.parametrize("case", list(CASES))
def test_consecutive_calls_replay_the_same_ops(case, record):
    calls = CASES[case](record)
    assert len(calls) == 3
    second, third = calls[1], calls[2]
    kernels = [op[0] for op in second if op[0].startswith("kernel ")]
    assert len(kernels) == 2 * PATH, kernels
    differ = [(i, a, b) for i, (a, b) in enumerate(zip(second, third))
              if a != b]
    assert len(second) == len(third) and not differ, (
        f"{len(second)} / {len(third)} ops, {len(differ)} differ: "
        f"{differ[:6]}")
    readbacks = sorted({op[0] for op in second
                        if op[0].rsplit(".", 1)[0] in READBACKS})
    assert not readbacks, readbacks
