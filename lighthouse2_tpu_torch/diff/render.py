"""Differentiable rendering entry points and the inverse-rendering loop.

Counterpart of lighthouse2_tpu/diff/render.py (render_image,
render_image_jit, make_loss, save_checkpoint, load_checkpoint, optimize)
and of the regen fwd+bwd step
that bench.py:82-112 defines inside run_workload (`fb_pass`), here as
regen_value_and_grad.

Differences from the JAX package:
  - parameters are a tensor or a dict of tensors; gradients come from
    torch.autograd and optimize steps torch.optim.Adam, set to optax.adam's
    defaults (b1 0.9, b2 0.999, eps 1e-8 outside the square root); its
    `optimizer`, where JAX takes an optax transformation, is a factory
    optimizer(leaves) -> torch.optim.Optimizer;
  - the checkpoint holds the optimizer's state_dict with its tensors as
    numpy arrays, where the JAX package pickles the optax state's leaves;
  - jax.jit's counterpart is a CUDA graph (render/graphs.py): on a card
    regen_value_and_grad, the step JAX jits, is captured at its second
    call with a key and replayed; fb_pass is its eager body. render_image,
    render_image_jit and optimize's loss run eagerly.
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch

from lighthouse2_tpu_torch.core import rng as rng_mod
from lighthouse2_tpu_torch.core.types import RenderConfig, ViewPyramid
from lighthouse2_tpu_torch.diff.fd import _leaves, _unflatten
from lighthouse2_tpu_torch.diff.params import (
    displace_vertices, set_light_radiance, set_material_fields)
from lighthouse2_tpu_torch.render import graphs
from lighthouse2_tpu_torch.render.wavefront import (
    AccumState, _check_config, ensure_regen_state, trace_paths,
    trace_paths_regen)
from lighthouse2_tpu_torch.scene.device_scene import DeviceScene
from lighthouse2_tpu_torch.utils import telemetry


def render_image(scene: DeviceScene, view: ViewPyramid, config: RenderConfig,
                 sample_base: int = 0):
    """One classic pass of spp_per_pass samples -> linear HDR image
    [W*H, 3]. Differentiable with respect to the scene's tensors;
    deterministic in sample_base."""
    _check_config(config)
    acc, _, _ = trace_paths(scene, view, config, None, sample_base,
                            rng_mod.CAM_RNG_SEED)
    img = acc[:, :3] / config.spp_per_pass
    telemetry.mark("end", view.pos.device)
    return img


def render_image_jit(scene: DeviceScene, view: ViewPyramid,
                     config: RenderConfig, sample_base: int = 0):
    """render_image (JAX :33 jit-compiles it with config static; here the
    same code, eagerly, and differentiable like it)."""
    return render_image(scene, view, config, sample_base)


def make_loss(target, view, config: RenderConfig, insert, scene: DeviceScene,
              sample_base: int = 0):
    """L2 image loss as a function of the parameters;
    insert(scene, params) -> scene (see diff/params.py)."""
    target = torch.as_tensor(target, device=scene.device).reshape(-1, 3)

    def loss(params):
        img = render_image(insert(scene, params), view, config, sample_base)
        return ((img - target) ** 2).mean()

    return loss


def fb_pass(scene: DeviceScene, view: ViewPyramid, state: AccumState,
            config: RenderConfig, target, params: dict):
    """The body of the headline's fwd+bwd step (bench.py:82-112 fb_pass,
    regen branch), eagerly, on a state that holds its pool: the insert, the
    pass, the loss and torch.autograd.grad. Returns regen_value_and_grad's
    (loss, grads, new AccumState), where JAX's fb_pass returns (state,
    grads)."""
    p = {k: v.detach().requires_grad_() for k, v in params.items()}
    s = set_material_fields(scene, color=p["color"])
    if "light" in p:
        s = set_light_radiance(s, p["light"])
    if "offset" in p:
        s = displace_vertices(s, p["offset"])
    acc_delta, count_px, cam_seed, pool, _ = trace_paths_regen(
        s, view, config, state)
    img = acc_delta[:, :3] / torch.clamp(count_px, min=1.0)[:, None]
    loss = ((img - target) ** 2).mean()
    # the forward pass ends here; the backward runs in no stage
    telemetry.mark("end", view.pos.device)
    grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
    paths, depth, sample_k = pool
    new_state = AccumState(
        accumulator=(state.accumulator + acc_delta).detach(),
        sample_count=state.sample_count + config.spp_per_pass,
        cam_seed=cam_seed,
        pixel_count=state.pixel_count + count_px,
        pool=({k: v.detach() for k, v in paths.items()}, depth, sample_k))
    return loss.detach(), grads, new_state


_step_graph = graphs.CapturedCall("regen_value_and_grad", fb_pass)


def regen_value_and_grad(scene: DeviceScene, view: ViewPyramid,
                         state: AccumState, config: RenderConfig, target,
                         params: dict):
    """One fwd+bwd pass of the regen executor: the training step of the
    headline (bench.py:82-112 fb_pass, regen branch), compiled as JAX's
    jax.jit of it: on a card the whole step (parameter leaves, insert,
    pass, loss and backward) is captured as a CUDA graph at the second call
    with the same key and replayed from then on (render/graphs.py).

    params: "color" [M,3] and optionally "light" [LT,3] and "offset"
    [T,3,3], inserted with set_material_fields, set_light_radiance and
    displace_vertices in that order. The loss is
    mean((acc_delta[:, :3] / max(count_px, 1) - target)^2) over this pass's
    samples. Returns (loss, grads {name: tensor}, new AccumState); the state
    is detached, so the next step neither backpropagates into this step's
    graph nor keeps it alive."""
    _check_config(config)
    state = ensure_regen_state(view, state, config)
    # fb_pass makes its own leaves: detached here, an optimizer's leaves
    # that require grad do not keep the step eager
    params = {k: v.detach() for k, v in params.items()}
    return _step_graph(scene, view, state, config, target, params)


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_numpy(v) for v in x)
    return x


def _to_torch(x):
    if isinstance(x, dict):
        return {k: _to_torch(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_torch(v) for v in x)
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x)
    return x


def save_checkpoint(path: str, params, opt_state, step: int,
                    history=None) -> None:
    """Persist an optimisation run: (params, optimizer state_dict, step,
    loss history) as a pickle of numpy arrays, written to a temporary file
    and renamed over `path`, so a crash never leaves a torn checkpoint."""
    blob = dict(params=_to_numpy(params), opt_state=_to_numpy(opt_state),
                step=int(step), history=list(history or []))
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        pickle.dump(blob, fh)
    os.replace(tmp, path)


def load_checkpoint(path: str):
    """dict(params, opt_state, step, history) with tensor leaves on the
    CPU, or None if there is no file. Load only checkpoints this program
    wrote: unpickling runs code."""
    if not os.path.exists(path):
        return None
    with open(path, "rb") as fh:
        blob = pickle.load(fh)
    return dict(params=_to_torch(blob["params"]),
                opt_state=_to_torch(blob["opt_state"]),
                step=int(blob["step"]), history=list(blob["history"]))


def optimize(loss_fn, params, steps: int = 32, lr: float = 5e-2,
             optimizer=None, sample_stride: int = 0, verbose: bool = False,
             checkpoint_path: str | None = None, checkpoint_every: int = 8):
    """Adam loop for inverse rendering; params is a tensor or a dict of
    tensors. optimizer(leaves) -> torch.optim.Optimizer replaces the Adam
    of optax.adam(lr)'s defaults. With sample_stride > 0, loss_fn takes
    (params, step) and is called with step = i * sample_stride to
    decorrelate the Monte Carlo noise across steps.

    checkpoint_path: resume from it if present, and save (params,
    optimizer state, step, history) every `checkpoint_every` steps and at
    the end. Returns (params, history)."""
    device = _leaves(params)[0].device
    start, history = 0, []
    ck = load_checkpoint(checkpoint_path) if checkpoint_path else None
    if ck is not None:
        params, start, history = ck["params"], ck["step"], ck["history"]
    leaves = [x.detach().to(device).clone().requires_grad_()
              for x in _leaves(params)]
    opt = (optimizer(leaves) if optimizer is not None else
           torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8))
    if ck is not None:
        opt.load_state_dict(ck["opt_state"])

    for i in range(start, steps):
        p = _unflatten(params, leaves)
        val = loss_fn(p, i * sample_stride) if sample_stride else loss_fn(p)
        opt.zero_grad(set_to_none=True)
        val.backward()
        opt.step()
        history.append(float(val.detach()))
        if verbose:
            print(f"step {i}: loss {history[-1]:.6e}")
        if checkpoint_path and ((i + 1) % checkpoint_every == 0
                                or i + 1 == steps):
            save_checkpoint(checkpoint_path, _unflatten(params, leaves),
                            opt.state_dict(), i + 1, history)
    return _unflatten(params, [x.detach() for x in leaves]), history
