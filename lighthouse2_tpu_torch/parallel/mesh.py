"""Ray-data-parallel rendering over torch.distributed.

Counterpart of lighthouse2_tpu/parallel/mesh.py (make_mesh,
replicate_scene, render_pass_sharded, render_image_sharded,
train_step_sharded). The global path index range [0, W*H*spp) is split
into contiguous blocks, one per rank, as P("rays") splits it over a JAX
mesh; every rank traces its block through the classic executor against a
replicated scene, and the per-rank accumulators and stats are summed with
torch.distributed.all_reduce. Per-path random numbers are keyed on the
global path index, so the image equals the single-process render up to
the order of the adds.

Differences from the JAX package:
  - a Mesh is a handle on a torch.distributed process group (the first
    `size` ranks) and this process's rank and device, where JAX's is a
    device array; without a process group it is a one-rank mesh and the
    sums are the identity;
  - render_pass_sharded raises ValueError where JAX asserts (path_regen,
    n_paths not divisible by the mesh size);
  - the accumulator's all-reduce passes the gradient through unchanged in
    the backward, as the transpose of JAX's psum does for a loss that every
    device computes, and train_step_sharded then sums the parameter
    gradients with one all_reduce (shard_map's implicit sum); a plain
    differentiable all_reduce would all-reduce the gradient again and
    scale it by the world size;
  - train_step_sharded takes no param_extract (JAX's signature has one;
    the port's step reads the parameters it is given).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.device import resolve_device
from lighthouse2_tpu_torch.render.wavefront import (
    AccumState, _check_config, trace_paths)


@dataclasses.dataclass
class Mesh:
    """The 1-D "rays" mesh: the first `size` ranks of the process group.
    `rank` is this process's rank in it (-1 outside it), `group` the
    torch.distributed group (None without one)."""
    size: int
    rank: int
    group: object
    device: torch.device


def make_mesh(n_devices: int | None = None, device=None) -> Mesh:
    """A mesh over the first n_devices ranks (all by default). With a
    process group every rank must call it (new_group is collective). The
    device defaults to the CPU under gloo and to this rank's card under
    NCCL."""
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"{n_devices} devices need a process group "
                             "(distributed.init_distributed)")
        return Mesh(1, 0, None, resolve_device(device))
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} devices in a world of {world}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if device is None:
        device = ("cpu" if dist.get_backend() == "gloo"
                  else torch.device("cuda", torch.cuda.current_device()))
    rank = dist.get_rank()
    return Mesh(n, rank if rank < n else -1, group, resolve_device(device))


def _to(obj, device):
    """A copy of a dataclass of tensors (nested) with every tensor on
    `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{
            f.name: _to(getattr(obj, f.name), device)
            for f in dataclasses.fields(obj)})
    return obj


def replicate_scene(scene, mesh: Mesh):
    """The scene on this rank's device (every rank holds all of it)."""
    return _to(scene, mesh.device)


class _SumOverRanks(torch.autograd.Function):
    """all_reduce(SUM) whose backward passes the gradient through: every
    rank computes the same loss of the summed image, so each rank's share
    of the image receives the plain gradient (psum's transpose)."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def _sum_over_ranks(x, mesh: Mesh):
    if mesh.group is None:
        return x
    return _SumOverRanks.apply(x, mesh.group)


# the stats summed over the ranks, flattened in this order into one tensor
_STAT_KEYS = ("extension_rays", "shadow_rays", "total_extension",
              "total_shadow", "primary_rays")


def local_pass(scene, view, state: AccumState, config: RenderConfig,
               mesh: Mesh):
    """This rank's share of a sharded pass: the k-th contiguous block of
    [0, n_paths) traced with the classic executor. Returns (accumulator
    [W*H, 4], the stats flattened in _STAT_KEYS order, cam_seed'): the two
    tensors render_pass_sharded sums over the ranks."""
    _check_config(config)
    if config.path_regen:
        raise ValueError("render_pass_sharded runs the classic fixed-spp "
                         "executor; set path_regen=False (the regen pool is "
                         "single-process)")
    n = config.n_paths
    if n % mesh.size:
        raise ValueError(f"n_paths {n} must divide over {mesh.size} devices")
    if mesh.rank < 0:
        raise ValueError("this process is not a rank of the mesh")
    block = n // mesh.size
    dev = state.accumulator.device
    path_idx = torch.arange(mesh.rank * block, (mesh.rank + 1) * block,
                            dtype=torch.int64, device=dev)
    acc, cam_seed, stats = trace_paths(scene, view, config, state.sample_count,
                                       state.cam_seed, path_idx=path_idx)
    flat = torch.cat([stats[k].reshape(-1).to(dev) for k in _STAT_KEYS])
    return acc, flat, cam_seed


def render_pass_sharded(scene, view, state: AccumState, config: RenderConfig,
                        mesh: Mesh):
    """One progressive pass with the path range split over the mesh: rank k
    traces its block (local_pass); the accumulator and every stat are summed
    over the ranks, the stats in one all_reduce. Returns (new AccumState,
    stats), the same on every rank."""
    acc, flat, cam_seed = local_pass(scene, view, state, config, mesh)
    acc = _sum_over_ranks(acc, mesh)
    flat = _sum_over_ranks(flat, mesh)
    length = config.max_path_length
    stats = dict(extension_rays=flat[:length],
                 shadow_rays=flat[length:2 * length],
                 total_extension=flat[2 * length],
                 total_shadow=flat[2 * length + 1],
                 primary_rays=flat[2 * length + 2])
    return AccumState(
        accumulator=state.accumulator + acc,
        sample_count=state.sample_count + config.spp_per_pass,
        cam_seed=cam_seed), stats


def render_image_sharded(scene, view, config: RenderConfig, mesh: Mesh):
    """One sharded pass from scratch -> the linear image [W*H, 3]."""
    state, _ = render_pass_sharded(
        scene, view, AccumState.make(config, mesh.device), config, mesh)
    return state.accumulator[:, :3] / float(max(state.sample_count, 1))


def train_step_sharded(scene, view, target, config: RenderConfig, mesh: Mesh,
                       param_insert, params):
    """One differentiable-rendering step over the mesh: the mean squared
    error of the sharded image against `target`, and its gradient with
    respect to `params` (a tensor or a dict of tensors), summed over the
    ranks. param_insert(scene, params) -> scene. Returns (loss, grads) on
    every rank."""
    names = sorted(params) if isinstance(params, dict) else None
    leaves = ([params[k] for k in names] if names is not None else [params])
    leaves = [p.detach().requires_grad_() for p in leaves]
    p = dict(zip(names, leaves)) if names is not None else leaves[0]
    img = render_image_sharded(param_insert(scene, p), view, config, mesh)
    loss = torch.mean((img - target) ** 2)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # all_reduce takes contiguous tensors only
    grads = [torch.zeros_like(x) if g is None else g.contiguous()
             for x, g in zip(leaves, grads)]
    if mesh.group is not None:
        for g in grads:
            dist.all_reduce(g, group=mesh.group)
    out = dict(zip(names, grads)) if names is not None else grads[0]
    return loss.detach(), out
