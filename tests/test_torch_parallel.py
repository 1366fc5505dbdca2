"""Ray-data-parallel rendering of the port (parallel/mesh.py,
parallel/distributed.py) in a two-rank gloo group on the CPU.

The contract is tests/test_parallel.py's: the sharded pass and its
gradients equal the single-process classic executor's, because every
path's random numbers are keyed on its global index. No JAX render is
compiled here: the single-process pass compared against is the one
tests/test_torch_classic.py holds against the JAX package, on the same
inputs. Its configuration (a 16x16 Cornell box, spp 1, path 4, at most 2
diffuse bounces, the classic executor on the BVH) and its scene (the
single-level sync with the numpy builder, which tests/test_torch_scene.py
holds equal to the JAX package's array for array) are used here; the 256
paths divide over the two ranks.

The two ranks are this file run as a script, started once per module with
a file:// rendezvous in a temporary directory and joined with a timeout.
Each rank runs every check and saves what it saw; the tests compare that
with a single-process run in the test process:
  1. the accumulator within rtol 1e-4 / atol 1e-5 (tests/test_parallel.py's
     bound: the adds of the per-rank sums come in another order), the
     stats totals equal, and both ranks hold the same image;
  2. train_step_sharded's loss within rtol 1e-5 and its gradient of the
     material colours within rtol 1e-4 / atol 1e-6 of the single-process
     gradient (a gradient scaled by the world size fails this);
  3. ValueError for path_regen=True and for n_paths % world_size != 0;
  4. measure_scaling, strong and weak, returns rows for 1 and 2 devices
     with efficiency 1.0 at 1; collective_bytes_per_pass equals the bytes
     of the all-reduced tensors (the [W*H, 4] f32 accumulator and the
     2 * path + 3 int32 stats).
"""
import argparse
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.diff.params import set_material_fields
from lighthouse2_tpu_torch.parallel.distributed import (
    collective_bytes_per_pass, global_mesh, init_distributed, measure_scaling)
from lighthouse2_tpu_torch.parallel.mesh import (
    render_pass_sharded, train_step_sharded)
from lighthouse2_tpu_torch.render.wavefront import AccumState, render_pass
from lighthouse2_tpu_torch.scene.presets import cornell_box

torch.set_num_threads(1)

SIZE, SPP, PATH, DIFFUSE = 16, 1, 4, 2
WORLD = 2
JOIN_TIMEOUT = 300.0       # seconds for both ranks together
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _config():
    """tests/test_torch_classic.py's configuration."""
    return RenderConfig(width=SIZE, height=SIZE, spp_per_pass=SPP,
                        max_path_length=PATH, max_diffuse_bounces=DIFFUSE,
                        path_regen=False)


def _scene():
    """tests/test_torch_classic.py's scene: the single-level numpy-built
    sync that equals the JAX package's."""
    host, cam = cornell_box(SIZE, SIZE)
    return (host.sync("cpu", two_level=False, native=False),
            cam.get_view("cpu"))


def _insert(scene, color):
    return set_material_fields(scene, color=color)


def _raises_value_error(fn):
    try:
        fn()
    except ValueError:
        return True
    return False


def _rank_main(rank: int, store: str, out: str):
    """One rank: every check of this file, saved to `out`."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    init_distributed(f"file://{store}", WORLD, rank, device="cpu")
    try:
        mesh = global_mesh()
        ds, view = _scene()
        cfg = _config()
        state, stats = render_pass_sharded(
            ds, view, AccumState.make(cfg, "cpu"), cfg, mesh)
        target = torch.zeros((SIZE * SIZE, 3))
        loss, grad = train_step_sharded(ds, view, target, cfg, mesh,
                                        lambda s: s.materials.color, _insert,
                                        ds.materials.color)
        odd = dataclasses.replace(cfg, width=3, height=3)
        res = dict(
            accumulator=state.accumulator, sample_count=state.sample_count,
            cam_seed=state.cam_seed,
            stats={k: v.clone() for k, v in stats.items()},
            loss=loss, grad=grad,
            regen_raises=_raises_value_error(lambda: render_pass_sharded(
                ds, view, AccumState.make(cfg, "cpu"),
                dataclasses.replace(cfg, path_regen=True), mesh)),
            indivisible_raises=_raises_value_error(lambda: render_pass_sharded(
                ds, view, AccumState.make(odd, "cpu"), odd, mesh)),
            strong=measure_scaling(ds, view, cfg, passes=1, warmup=0),
            weak=measure_scaling(ds, view, cfg, passes=1, warmup=0,
                                 weak=True),
            bytes=collective_bytes_per_pass(ds, view, cfg, mesh))
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, from one spawn of the two-rank group."""
    d = tmp_path_factory.mktemp("parallel")
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--store", str(d / "store"), "--out", str(d / f"rank{r}.pt")],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    deadline = time.monotonic() + JOIN_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1.0))[0].decode())
    except subprocess.TimeoutExpired:
        pytest.fail(f"the {WORLD} ranks did not finish in {JOIN_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"
    return [torch.load(d / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def single():
    """The single-process classic pass and its gradient."""
    ds, view = _scene()
    cfg = _config()
    state, stats = render_pass(ds, view, AccumState.make(cfg, "cpu"), cfg)
    color = ds.materials.color.detach().clone().requires_grad_()
    st, _ = render_pass(_insert(ds, color), view,
                        AccumState.make(cfg, "cpu"), cfg)
    loss = torch.mean((st.accumulator[:, :3] / SPP) ** 2)
    (grad,) = torch.autograd.grad(loss, color)
    return dict(state=state, stats=stats, loss=loss.detach(), grad=grad)


def test_sharded_pass_matches_single_process(ranks, single):
    want = single["state"]
    for r in ranks:
        np.testing.assert_allclose(r["accumulator"].numpy(),
                                   want.accumulator.numpy(),
                                   rtol=1e-4, atol=1e-5)
        assert r["sample_count"] == want.sample_count == SPP
        assert r["cam_seed"] == want.cam_seed
        for k in ("total_extension", "total_shadow", "primary_rays"):
            assert int(r["stats"][k]) == int(single["stats"][k]), k
        for k in ("extension_rays", "shadow_rays"):
            assert r["stats"][k].tolist() == single["stats"][k].tolist(), k
    torch.testing.assert_close(ranks[0]["accumulator"],
                               ranks[1]["accumulator"], rtol=0, atol=0)


def test_sharded_gradients_match_single_process(ranks, single):
    for r in ranks:
        assert np.isfinite(float(r["loss"]))
        np.testing.assert_allclose(float(r["loss"]), float(single["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(r["grad"].numpy(), single["grad"].numpy(),
                                   rtol=1e-4, atol=1e-6)
    assert float(single["grad"].abs().sum()) > 0


def test_sharded_pass_rejects_regen_and_uneven_paths(ranks):
    for r in ranks:
        assert r["regen_raises"] and r["indivisible_raises"]


def test_scaling_rows_and_collective_bytes(ranks):
    for r in ranks:
        for rows in (r["strong"], r["weak"]):
            assert [row["devices"] for row in rows] == [1, WORLD]
            assert rows[0]["efficiency"] == 1.0
            assert all(row["mrays_per_s"] > 0 for row in rows)
        want = dict(accumulator=SIZE * SIZE * 4 * 4, stats=(2 * PATH + 3) * 4)
        assert r["bytes"] == dict(tensors=want, total_bytes=sum(want.values()))
    assert ranks[0]["strong"] == ranks[1]["strong"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="one rank of this file's group")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--store", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    _rank_main(args.rank, args.store, args.out)
