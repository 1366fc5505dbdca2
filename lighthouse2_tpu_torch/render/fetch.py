"""Gradient re-attachment for payloads fetched by the cluster trace path.

Counterpart of lighthouse2_tpu/render/fetch.py (reattach_rows). The trace
path (render/kernels/cluster.py trace_cluster_bvh) fetches each ray's
shading rows from the cluster tiles, which carry no gradient. reattach_rows
closes the loop: its forward returns those rows unchanged, and its backward
scatter-adds the cotangents into the live pack at the rays' indices, which
is the backward of the gather pack[:, idx] the payload replaces. That holds
because the tiles are baked from the values the pack holds (cut_clusters,
rebake_geometry, bake_material_rows), so payload == pack[:, idx] on hit
lanes.

Difference from the JAX package: a torch.autograd.Function in place of
jax.custom_vjp; the backward's scatter is index_add_ (on a card its sums
are taken with atomics, in no fixed order).
"""
from __future__ import annotations

import torch


class _Reattach(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pack, idx, rows):
        ctx.save_for_backward(idx)
        ctx.pack_meta = (pack.shape, pack.dtype, pack.device)
        return rows.detach().view_as(rows)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        (idx,) = ctx.saved_tensors
        shape, dtype, device = ctx.pack_meta
        ok = idx >= 0
        safe = torch.where(ok, idx, 0).to(torch.int64)
        g = torch.where(ok[None, :], g, 0.0).to(dtype)
        d_pack = torch.zeros(shape, dtype=dtype, device=device)
        d_pack.index_add_(1, safe, g)
        return d_pack, None, None


def reattach_rows(pack, idx, rows):
    """rows == pack[:, idx] (fetched by the trace path). Returns rows, with
    gradients flowing to `pack` as if they had been gathered.

    pack: [K, T]; idx: [N] integer (negative = miss, no gradient);
    rows: [K, N]."""
    return _Reattach.apply(pack, idx, rows)
