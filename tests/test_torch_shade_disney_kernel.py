"""The Disney shade kernel (csrc/shade.cu shade_disney_kernel via
render/kernels/shade.py) held to the composed Disney shade code.

On the CPU (under a second, a Disney Cornell box at 8x8, no JAX): the
wrapper's plain branch is render/wavefront.py _shade_composed bit for bit,
lobe picks included, and neither launch counter moves. The kernel itself is
held to the composed code on the card by test_torch_shade_card.py.
"""
import torch

from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.render import wavefront as wf
from lighthouse2_tpu_torch.render.kernels import shade as shade_k
from lighthouse2_tpu_torch.scene import presets
from lighthouse2_tpu_torch.utils import telemetry

torch.set_num_threads(1)

SIZE = 8


def _same(a, b):
    p, acc, seed, shadow = a
    q, acc2, seed2, shadow2 = b
    assert seed == seed2
    assert torch.equal(acc, acc2)
    for k in p:
        assert torch.equal(p[k], q[k]), k
    for k in shadow:
        assert torch.equal(shadow[k], shadow2[k]), k


def test_plain_branch_is_the_composed_disney_code_on_a_cornell_bounce():
    host, cam = presets.cornell_box(SIZE, SIZE)
    scene, view = host.sync("cpu"), cam.get_view("cpu")
    cfg = RenderConfig(width=SIZE, height=SIZE, max_path_length=3,
                       bsdf="disney")
    assert shade_k.config_takes_kernel(cfg, scene)
    paths = wf.generate_eye_rays(view, cfg, 0)
    acc = torch.zeros((cfg.n_paths, 4))
    hit = wf._intersect(scene, paths["origin"], paths["dir"], paths["alive"],
                        cfg)[:4]
    counts = telemetry.lobe_counts("cpu")
    launches = shade_k.shade_kernel.launches
    disney = shade_k.shade_kernel.disney_launches
    picks = []
    results = []
    for fn in (wf._shade_composed, shade_k.shade_kernel):
        before = counts.clone()
        results.append(fn(scene, view, cfg, paths, acc, 7, 0, *hit,
                          marks=True))
        picks.append(counts - before)
    assert shade_k.shade_kernel.launches == launches
    assert shade_k.shade_kernel.disney_launches == disney
    _same(*results)
    assert torch.equal(picks[0], picks[1]) and int(picks[0].sum()) > 0
