"""Central finite differences on the port (diff/fd.py), and the classic
executor's gradients.

  - the classic executor's gradients (colour, light, offsets) are equal
    with remat on and off;
  - central FD at the JAX package's threshold of 0.03 (tests/test_grad.py):
    colour and light on the Cornell box at 12x12, path 3, along the
    directions the JAX test draws (numpy RandomState(0) in its
    check_grad); vertices on the wall scene with the BVH on. The directions
    matter: colour and light steer discrete choices (Russian roulette reads
    the BSDF, the light pick reads the radiance), and a direction along
    which the directional derivative is small sees the jumps of the few
    lanes that flip (the JAX check itself fails with seeds 1 to 5). The
    port computes the JAX package's function and gradients
    (test_torch_grad.py), so on the same directions its FD check is the
    JAX package's;
  - check_grad itself, with a torch.Generator, on a smooth function.
This file needs no JAX reference: it costs a few seconds.
"""
import dataclasses

import numpy as np
import pytest
import torch

from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.diff.fd import check_grad, directional_fd, grad
from lighthouse2_tpu_torch.diff.params import (
    displace_vertices, set_light_radiance, set_material_fields)
from lighthouse2_tpu_torch.diff.render import render_image
from lighthouse2_tpu_torch.scene.camera import Camera
from lighthouse2_tpu_torch.scene.host_scene import HostScene
from lighthouse2_tpu_torch.scene.presets import cornell_box

torch.set_num_threads(1)

FD_TOL = 0.03


def _proj_loss(cfg, ds, view, insert):
    """A fixed projection of the image, sensitive to every pixel. It is
    summed in float64: a float32 sum's last bits, divided by 2 eps, would
    be a noise of ~1e-3 in every central difference."""
    wgt = torch.from_numpy(np.random.RandomState(7).rand(
        cfg.width * cfg.height, 3))
    return lambda p: (render_image(insert(ds, p), view, cfg).double()
                      * wgt).sum()


@pytest.fixture(scope="module")
def cornell12():
    cfg = RenderConfig(width=12, height=12, spp_per_pass=1, max_path_length=3)
    host, cam = cornell_box(12, 12)
    return cfg, host.sync("cpu"), cam.get_view("cpu")


def _fd_along_jax_dirs(f, p, eps, n_dirs, seed=0, atol=1e-4, rtol=0.05):
    """lighthouse2_tpu.diff.fd.check_grad's comparison, on its directions
    (numpy RandomState(seed), unit norm), through the port's diff/fd.py."""
    g = grad(f, p)
    rng = np.random.RandomState(seed)
    worst, res = 0.0, []
    for _ in range(n_dirs):
        u = rng.randn(*p.shape).astype(np.float32)
        u = torch.from_numpy((u / max(np.sqrt(float((u * u).sum())), 1e-12)
                              ).astype(np.float32))
        ad = float((g * u).sum())
        fd = directional_fd(f, p, u, eps)
        worst = max(worst, abs(ad - fd) / max(abs(fd), abs(ad), atol / rtol))
        res.append((ad, fd))
    return worst, res, g


def test_classic_grads_equal_with_and_without_remat(cornell12):
    cfg, ds, view = cornell12
    insert = lambda s, p: displace_vertices(set_light_radiance(
        set_material_fields(s, color=p["color"]), p["light"]), p["offset"])
    p = dict(color=ds.materials.color, light=ds.lights.tri_radiance,
             offset=torch.zeros((ds.tris.count, 3, 3)))
    g0, g1 = (grad(_proj_loss(dataclasses.replace(cfg, remat=remat), ds, view,
                              insert), p) for remat in (False, True))
    for k in p:
        assert float(g0[k].abs().max()) > 0, k
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=0)


def test_material_color_grad_matches_fd(cornell12):
    cfg, ds, view = cornell12
    f = _proj_loss(cfg, ds, view, lambda s, c: set_material_fields(s, color=c))
    worst, res, _ = _fd_along_jax_dirs(f, ds.materials.color, 2e-3, 3)
    assert worst < FD_TOL, res


def test_light_radiance_grad_matches_fd(cornell12):
    cfg, ds, view = cornell12
    f = _proj_loss(cfg, ds, view, set_light_radiance)
    worst, res, g = _fd_along_jax_dirs(f, ds.lights.tri_radiance, 2e-3, 3)
    assert worst < FD_TOL, res
    assert float(g.max()) > 0


def test_check_grad_on_a_smooth_function():
    """A dict of tensors and an explicit generator: the same generator seed
    gives the same directions, and FD agrees with autograd."""
    rng = np.random.default_rng(5)
    p = {k: torch.from_numpy(rng.uniform(-1, 1, s).astype(np.float32))
         for k, s in (("a", (4, 3)), ("b", (5,)))}
    f = lambda q: (torch.sin(q["a"]).sum() * (q["b"] ** 2).sum()
                   + (q["a"] ** 3).sum())
    runs = [check_grad(f, p, eps=1e-2, n_dirs=3,
                       generator=torch.Generator().manual_seed(11))
            for _ in range(2)]
    assert runs[0] == runs[1]
    worst, res = runs[0]
    assert worst < 1e-3 and all(abs(ad) > 1e-3 for ad, _ in res), res


def _wall_scene(w=12, h=12):
    """tests/test_grad.py wall_scene on the port: a quad fills the view, lit
    by an area light behind the camera; no silhouette crosses a pixel for
    small eps, so FD is well posed for vertex positions."""
    scene = HostScene()
    mat = scene.add_material(name="wall", color=(0.7, 0.6, 0.5))
    scene.add_instance(scene.add_quad((0, 0, 1), (0, 0, 0), 40, 40, mat))
    lmat = scene.add_material(name="light", color=(40.0, 35.0, 30.0))
    scene.add_instance(scene.add_quad((0, 0, -1), (0, 0, 6), 2, 2, lmat))
    cam = Camera(pixel_count=(w, h), fov=40.0)
    cam.look_at((0.0, 0.0, 3.0), (0.0, 0.0, 0.0))
    cfg = RenderConfig(width=w, height=h, spp_per_pass=1, max_path_length=1)
    return cfg, scene.sync("cpu"), cam.get_view("cpu")


def test_vertex_grad_with_bvh_matches_fd():
    """Reparameterised hits: traversal frozen, refine_hit differentiable;
    directions move the wall's two triangles only (tests/test_grad.py
    _wall_only_dirs, seed 4, 2 directions)."""
    cfg, ds, view = _wall_scene()
    f = _proj_loss(cfg, ds, view, displace_vertices)
    t = ds.tris.count
    zero = torch.zeros((t, 3, 3))
    g = grad(f, zero)
    rng = np.random.RandomState(4)
    worst, res = 0.0, []
    for _ in range(2):
        u = np.zeros((t, 3, 3), np.float32)
        u[:2] = rng.randn(2, 3, 3)
        u /= np.linalg.norm(u)
        ut = torch.from_numpy(u)
        ad = float((g * ut).sum())
        fd = directional_fd(f, zero, ut, 1e-3)
        res.append((ad, fd))
        worst = max(worst, abs(ad - fd) / max(abs(ad), abs(fd), 1e-3))
    assert worst < FD_TOL, res
    assert float(g.abs().max()) > 0
