"""The core contract's leftovers in the port against the JAX package:
sample_skydome(bilinear=True), RenderCore.set_target / on_target_changed,
StageTimer, the registry of cores, and the render CLI with the "bdpt" core.

  1. sample_skydome with bilinear=True against JAX's, eagerly, on the
     golden 16x32 gradient sky and on a seeded random sky of that size
     (the golden sky is constant along u, so only the random one shows the
     wrap at the u seam); the directions are seeded, plus both poles and
     directions on and beside the seam. The golden sky within rtol 1e-6
     (atol 1e-7); the random sky within atol 1e-5, since XLA's arccos and
     ATen's differ by one ulp on ~14% of these lanes, which moves v by up
     to 2e-6 texels, times texel contrasts of up to 4. The default
     (nearest texel) gives the same texels as JAX's;
  2. set_target(12, 8, spp=2) on every registered core: the config equals
     JAX's after the same call, field for field; a core's state is dropped
     (accumulation state, the filter's history, TAA, previous view, frame
     index); the next render on the CPU has the new size;
  3. StageTimer sums each stage's host seconds as JAX's does (both read
     the same stubbed clock);
  4. the port registers exactly the cores that JAX's _REGISTRY holds after
     create_core (six);
  5. `render_cli --core bdpt --device cpu` at 16x16 writes its PNG and
     returns 0.
"""
import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import torch

from lighthouse2_tpu.core.types import RenderConfig as JConfig
from lighthouse2_tpu.render import sky as jsky
from lighthouse2_tpu.render.cores import base as jbase
from lighthouse2_tpu.scene.device_scene import DeviceSky as JSky
from lighthouse2_tpu_torch.apps import render_cli
from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.render import sky as tsky
from lighthouse2_tpu_torch.render.cores import base as tbase
from lighthouse2_tpu_torch.scene.device_scene import DeviceSky as TSky
from lighthouse2_tpu_torch.scene.presets import cornell_box
from lighthouse2_tpu_torch.utils.golden import golden_sky
from lighthouse2_tpu_torch.utils.image import read_png

torch.set_num_threads(1)

CORES = ("bdpt", "minimal", "preview", "primeref", "wavefront",
         "wavefront_filter")


def _directions(rng, n=2048):
    d = rng.standard_normal((n, 3))
    eps = 1e-4
    special = [(0, 1, 0), (0, -1, 0),                  # poles
               (0, 0, 1), (eps, 0, 1), (-eps, 0, 1),   # the u seam
               (eps, 0.5, 1), (-eps, -0.5, 1), (0, 0, -1), (1, 0, 0)]
    d = np.concatenate([d, np.asarray(special, np.float64)], 0)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


def test_sample_skydome_bilinear_matches_jax():
    rng = np.random.default_rng(11)
    d = _directions(rng)
    for px, atol in ((golden_sky(), 1e-7), (rng.uniform(
            0.0, 4.0, (16, 32, 3)).astype(np.float32), 1e-5)):
        jsd, tsd = JSky(pixels=jnp.asarray(px)), TSky(
            pixels=torch.from_numpy(px))
        for bilinear in (True, False):
            want = np.asarray(jsky.sample_skydome(jsd, jnp.asarray(d),
                                                  bilinear=bilinear))
            got = tsky.sample_skydome(tsd, torch.from_numpy(d),
                                      bilinear=bilinear).numpy()
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=atol)
        # the default is the nearest texel, as before
        np.testing.assert_array_equal(
            tsky.sample_skydome(tsd, torch.from_numpy(d)).numpy(),
            np.asarray(jsky.sample_skydome(jsd, jnp.asarray(d))))


def _cfg(cls):
    return cls(width=8, height=8, spp_per_pass=1, max_path_length=2,
               use_bvh=False)


def test_set_target_on_every_core():
    host, cam = cornell_box(8, 8)
    ds, view = host.sync("cpu"), cam.get_view("cpu")
    for name in CORES:
        jcore = jbase.create_core(name, _cfg(JConfig))
        core = tbase.create_core(name, _cfg(RenderConfig))
        core.render(ds, view)
        assert core.get_image().shape == (8, 8, 3)
        jcore.set_target(12, 8, 2)
        core.set_target(12, 8, 2)
        jfields = dataclasses.asdict(jcore.config)
        for k, v in dataclasses.asdict(core.config).items():
            assert v == jfields[k], (name, k)
        for attr in ("state", "filter_state", "taa_state", "prev_view"):
            assert getattr(core, attr, None) is None, (name, attr)
        assert getattr(core, "frame_idx", 0) == 0
        core.render(ds, view)
        img = core.get_image()
        assert img.shape == (8, 12, 3) and np.isfinite(img).all(), name


def test_stage_timer_matches_jax(monkeypatch):
    def run(cls):
        ticks = iter([0.0, 0.5, 1.0, 3.0, 3.25, 3.5])
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        timer = cls()
        for stage in ("trace", "shade", "trace"):
            with timer.stage(stage):
                pass
        return timer.times

    want = run(jbase.StageTimer)
    assert want == {"trace": 0.75, "shade": 2.0}
    assert run(tbase.StageTimer) == want


def test_registered_cores_match_jax():
    jbase.create_core("wavefront")
    tbase.create_core("wavefront")
    assert sorted(tbase._REGISTRY) == sorted(jbase._REGISTRY) == list(CORES)


def test_render_cli_bdpt_core_on_the_cpu(tmp_path):
    out = tmp_path / "bdpt.png"
    rc = render_cli.main(["cornell", "--size", "16", "--spp", "2",
                          "--spp-per-pass", "1", "--max-path", "3",
                          "--core", "bdpt", "--device", "cpu", "-o",
                          str(out)])
    assert rc == 0
    img = read_png(str(out))
    assert img.shape == (16, 16, 3) and img.max() > 0
