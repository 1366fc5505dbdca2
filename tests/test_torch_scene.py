"""The port's host scene and upload against the JAX package's sync().

HostScene.sync(two_level=False, native=False) in lighthouse2_tpu_torch
builds the single-level numpy BVH, which is the JAX package's
sync(two_level=False) with the native builder off (LH2_NO_NATIVE=1). Every
uploaded array must be equal. (The default two-level sync over native
BLASes is held to the JAX default in test_torch_tlas.py.) The carry-across
(convert.scene_from_numpy) must reproduce the JAX scene exactly too.

`jax_scene_arrays` is the flattening the other test_torch_* files use to
hand a JAX scene and view to the port as numpy arrays.
"""
import dataclasses

import jax  # noqa: F401  (both frameworks share the process, as in every test_torch_* file)
import numpy as np
import pytest
import torch

from lighthouse2_tpu.scene import bench_scene as jbench
from lighthouse2_tpu.scene import presets as jpresets
from lighthouse2_tpu_torch.convert import scene_from_numpy
from lighthouse2_tpu_torch.scene import bench_scene as tbench
from lighthouse2_tpu_torch.scene import presets as tpresets

torch.set_num_threads(1)

GROUPS = ("tris", "materials", "lights", "sky", "textures", "bvh")
# port-only BVH fields: the measured depths and the packed BVH4 (bvh/wide.py)
PORT_ONLY = {"depth", "depth4", "node4", "tri4"}


def jax_scene_arrays(ds, view=None) -> dict:
    """Flatten a JAX DeviceScene (and ViewPyramid) into "<group>.<field>"
    numpy arrays; static int fields stay ints."""
    out = {}
    objs = [(g, getattr(ds, g)) for g in GROUPS]
    if view is not None:
        objs.append(("view", view))
    for g, obj in objs:
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if v is None:
                continue
            out[f"{g}.{f.name}"] = v if isinstance(v, int) else np.asarray(v)
    return out


def jax_sync(build, monkeypatch, *args, **kw):
    monkeypatch.setenv("LH2_NO_NATIVE", "1")
    host, cam = build(*args, **kw)
    return host.sync(two_level=False), cam.get_view()


def assert_scene_equal(port_scene, arrays):
    """Every field of the port's scene equals the flattened JAX array."""
    n = 0
    for g in GROUPS:
        obj = getattr(port_scene, g)
        for f in dataclasses.fields(obj):
            key = f"{g}.{f.name}"
            if key not in arrays:
                # absent on both sides (a sky without IBL tables) or port-only
                assert f.name in PORT_ONLY or getattr(obj, f.name) is None, key
                continue
            got, want = getattr(obj, f.name), arrays[key]
            if isinstance(got, torch.Tensor):
                got = got.cpu().numpy()
                assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
                np.testing.assert_array_equal(got, want, err_msg=key)
            else:
                assert got == want, key
            n += 1
    return n


@pytest.mark.parametrize("scene", ["cornell", "bathroom0"])
def test_sync_matches_jax_single_level(scene, monkeypatch):
    if scene == "cornell":
        jds, _ = jax_sync(jpresets.cornell_box, monkeypatch, 32, 32)
        host, _ = tpresets.cornell_box(32, 32)
    else:
        jds, _ = jax_sync(jbench.bathroom, monkeypatch, 64, 64, detail=0)
        host, _ = tbench.bathroom(64, 64, detail=0)
    ds = host.sync(device="cpu", two_level=False, native=False)
    n = assert_scene_equal(ds, jax_scene_arrays(jds))
    assert n >= 70
    assert ds.bvh.depth + 2 <= 64


def test_scene_from_numpy_round_trip(monkeypatch):
    jds, jview = jax_sync(jpresets.cornell_box, monkeypatch, 32, 32)
    arrays = jax_scene_arrays(jds, jview)
    ds, view = scene_from_numpy(arrays, "cpu")
    assert_scene_equal(ds, arrays)
    for f in dataclasses.fields(view):
        np.testing.assert_array_equal(getattr(view, f.name).numpy(),
                                      arrays[f"view.{f.name}"])
    host, cam = tpresets.cornell_box(32, 32)
    ref = host.sync(device="cpu", two_level=False, native=False)
    assert ds.bvh.depth == ref.bvh.depth
    pview = cam.get_view("cpu")
    for f in dataclasses.fields(view):
        np.testing.assert_allclose(getattr(pview, f.name).numpy(),
                                   getattr(view, f.name).numpy(), rtol=1e-6)


def test_entry_points_need_a_card_or_cpu():
    """Without a card, asking for CUDA (explicitly or by default) raises;
    nothing carries on on the CPU unless the caller asked for it."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    host, cam = tpresets.cornell_box(32, 32)
    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError):
            host.sync(device=dev)
        with pytest.raises(RuntimeError):
            cam.get_view(dev)
    with pytest.raises(RuntimeError):
        scene_from_numpy({}, "cuda")


def test_host_texture_width_height_match_jax():
    """HostTexture.width / .height (JAX host_texture.py:47-53) on a
    non-square uint8 texture, the JAX class's against the port's."""
    from lighthouse2_tpu.scene.host_texture import HostTexture as JTexture
    from lighthouse2_tpu_torch.scene.host_texture import HostTexture as TTexture
    pix = np.random.default_rng(0).integers(0, 256, (5, 7, 3), dtype=np.uint8)
    j, t = JTexture(pix), TTexture(pix)
    assert (t.width, t.height) == (j.width, j.height) == (7, 5)
