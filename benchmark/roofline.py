"""Peaks of the card and the least work of a trace launch, frozen with the
benchmark so that the yardstick stays where later changes to the program
cannot move it.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit (the harness records the card's limit beside every run).

A closest-hit or any-hit launch over R rays against T triangles has to read
each triangle once (v0, e1, e2: 9 floats) and each ray once (origin,
direction, tmax: 7 floats) and write its answer once (t, triangle, u, v: 16
bytes; occluded: 1 byte). The least arithmetic a live ray needs is one walk
from the root of a binary tree over the triangles down to one of them: a
box pair (50 FP32 operations) per level and one triangle test (54), the
operation counts of the BVH2 walk the program's bound used before. Dead
lanes (tmax 0) are read and answered but walk nothing. The count depends on
the scene and the rays alone, so it is the same whichever kernel does the
work.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TRI_BYTES = 9 * 4
RAY_BYTES = 7 * 4
HIT_BYTES = 16
OCC_BYTES = 1
BOX_PAIR_OPS = 50
TRI_TEST_OPS = 54


def walk_ops(n_tris: int) -> int:
    """FP32 operations of one root-to-leaf walk of a binary tree."""
    return BOX_PAIR_OPS * max(1, math.ceil(math.log2(max(n_tris, 2)))) + TRI_TEST_OPS


def trace_work(n_tris, lanes, launches, live_closest, live_shadow):
    """(bytes, operations) of `launches` closest-hit and as many any-hit
    launches over `lanes` rays each, with live_closest and live_shadow live
    rays in all."""
    n_bytes = launches * (2 * n_tris * TRI_BYTES + lanes * (2 * RAY_BYTES
                                                            + HIT_BYTES + OCC_BYTES))
    n_ops = (live_closest + live_shadow) * walk_ops(n_tris)
    return n_bytes, n_ops


def least_seconds(n_bytes, n_ops):
    """(seconds, "bytes" or "operations"): the larger of the two bounds."""
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return (tb, "bytes") if tb >= to else (to, "operations")
