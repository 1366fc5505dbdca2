"""Process-group start-up and the scaling rig of ray-data-parallel rendering.

Counterpart of lighthouse2_tpu/parallel/distributed.py (init_distributed,
global_mesh, measure_scaling, collective_bytes_per_pass).

Differences from the JAX package:
  - init_distributed wraps torch.distributed.init_process_group and
    follows torchrun's launcher contract (MASTER_ADDR / MASTER_PORT, RANK,
    WORLD_SIZE, LOCAL_RANK through "env://") where JAX follows its own
    coordinator contract; arguments given by the caller win, under JAX's
    names: coordinator_address "host:port" (JAX's form, taken as
    tcp://host:port) or any torch.distributed init URL (tcp://, file://,
    env://), num_processes, process_id. NCCL for the card, gloo for
    device="cpu";
  - measure_scaling's meshes over the first nd ranks are torch.distributed
    subgroups (new_group); each row's wall time is the slowest member's,
    and every rank returns rank 0's rows;
  - collective_bytes_per_pass counts the bytes of the tensors that
    render_pass_sharded hands to all_reduce, by tensor, where JAX parses
    the compiled HLO and reports them by collective kind; it has no
    ici_lower_bound_ms_v5e (a TPU link rate).
"""
from __future__ import annotations

import dataclasses
import os
import time

import torch
import torch.distributed as dist

from lighthouse2_tpu_torch.core.types import RenderConfig
from lighthouse2_tpu_torch.device import resolve_device
from lighthouse2_tpu_torch.parallel.mesh import (
    Mesh, local_pass, make_mesh, render_pass_sharded, replicate_scene)
from lighthouse2_tpu_torch.render.wavefront import AccumState


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, device=None) -> int:
    """Start the process group, or do nothing for one process without an
    address. The address, world size and rank default to torchrun's
    environment (MASTER_ADDR -> "env://", WORLD_SIZE, RANK); the backend to
    NCCL on the card and gloo for device="cpu". Under NCCL this process
    takes card LOCAL_RANK (or its rank) modulo the cards it sees. Returns
    the world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    init_method, world_size, rank = (coordinator_address, num_processes,
                                     process_id)
    if init_method is not None and "://" not in init_method:
        init_method = f"tcp://{init_method}"
    env = os.environ
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None:
        if world_size not in (None, 1):
            raise ValueError(f"a world of {world_size} processes needs an "
                             "init_method or MASTER_ADDR")
        return 1
    world_size = 1 if world_size is None else world_size
    rank = 0 if rank is None else rank
    if backend is None:
        backend = "gloo" if resolve_device(device).type == "cpu" else "nccl"
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.get_world_size()


def global_mesh(axis: str = "rays") -> Mesh:
    """The mesh over every rank of the process group."""
    return make_mesh(None, axis=axis)


def _sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_scaling(scene, view, config: RenderConfig, device_counts=None,
                    passes: int = 3, warmup: int = 1,
                    weak: bool = False) -> list[dict]:
    """Rays/s at each device count, with the efficiency against the
    1-device rate (always measured first). Rays are the stats' extension +
    shadow rays, as in the single-device bench. weak=True scales
    spp_per_pass with the device count (fixed work per device). Every rank
    of the process group must call it."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    rows, base_rate = [], None
    for nd in sorted({1, *device_counts}):
        cfg = (dataclasses.replace(config, spp_per_pass=config.spp_per_pass
                                   * nd) if weak else config)
        if cfg.n_paths % nd != 0 or nd > world:
            continue
        mesh = make_mesh(nd)
        rate = torch.zeros(1, dtype=torch.float64, device=mesh.device)
        if mesh.rank >= 0:
            dsr = replicate_scene(scene, mesh)
            state = AccumState.make(cfg, mesh.device)
            for _ in range(warmup):
                state, _ = render_pass_sharded(dsr, view, state, cfg, mesh)
            _sync(mesh.device)
            all_stats = []
            t0 = time.perf_counter()
            for _ in range(passes):
                state, stats = render_pass_sharded(dsr, view, state, cfg, mesh)
                all_stats.append(stats)
            _sync(mesh.device)
            dt = torch.tensor([time.perf_counter() - t0], dtype=torch.float64,
                              device=mesh.device)
            if mesh.group is not None:
                dist.all_reduce(dt, op=dist.ReduceOp.MAX, group=mesh.group)
            rays = sum(int(s["total_extension"]) + int(s["total_shadow"])
                       for s in all_stats)
            rate[0] = rays / dt.item()
        if dist.is_initialized():
            dist.broadcast(rate, src=0)
        rate = rate.item()
        if base_rate is None:
            base_rate = rate / nd
        rows.append(dict(devices=nd, mrays_per_s=rate / 1e6,
                         mrays_per_s_per_device=rate / nd / 1e6,
                         efficiency=rate / (base_rate * nd)))
    return rows


def collective_bytes_per_pass(scene, view, config: RenderConfig,
                              mesh: Mesh) -> dict:
    """Per-rank collective traffic of one sharded render pass: the bytes of
    the two tensors render_pass_sharded hands to all_reduce, from one run of
    this rank's share of the pass (local_pass). Returns {"total_bytes":
    bytes, "tensors": {"accumulator": bytes, "stats": bytes}}."""
    with torch.no_grad():
        acc, flat, _ = local_pass(scene, view,
                                  AccumState.make(config, mesh.device),
                                  config, mesh)
    tensors = {name: x.numel() * x.element_size()
               for name, x in (("accumulator", acc), ("stats", flat))}
    return {"total_bytes": sum(tensors.values()), "tensors": tensors}
