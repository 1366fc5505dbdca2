"""Finite-difference gradient checks.

Counterpart of lighthouse2_tpu/diff/fd.py (directional_fd, check_grad). The
renderer is a deterministic function of (scene, view, seeds), so f(p + eps u)
and f(p - eps u) follow the same sample paths and central differences agree
with autograd up to float32 rounding and the discontinuities that the
reparameterised estimator smooths.

Parameters are a tensor or a dict of tensors. Difference from the JAX
package: the random directions come from a torch.Generator the caller may
pass (default: one seeded with `seed`), in place of numpy's RandomState, so
they are other numbers than the JAX package's for the same seed.
"""
from __future__ import annotations

import math

import torch


def _leaves(p):
    return [p[k] for k in sorted(p)] if isinstance(p, dict) else [p]


def _unflatten(p, leaves):
    return dict(zip(sorted(p), leaves)) if isinstance(p, dict) else leaves[0]


def directional_fd(f, p, u, eps: float) -> float:
    """Central difference of scalar f along direction u at p."""
    shift = lambda s: _unflatten(p, [x + s * y for x, y
                                     in zip(_leaves(p), _leaves(u))])
    with torch.no_grad():
        fp = float(f(shift(eps)))
        fm = float(f(shift(-eps)))
    return (fp - fm) / (2.0 * eps)


def grad(f, p):
    """Gradient of scalar f at p, in the structure of p."""
    leaves = [x.detach().requires_grad_() for x in _leaves(p)]
    return _unflatten(p, list(torch.autograd.grad(f(_unflatten(p, leaves)),
                                                  leaves)))


def check_grad(f, p, eps: float = 1e-3, n_dirs: int = 4, seed: int = 0,
               rtol: float = 0.05, atol: float = 1e-4, verbose: bool = False,
               generator: torch.Generator | None = None):
    """Compare <grad f, u> with central differences along n_dirs random unit
    directions. Returns (max relative error, list of (ad, fd) pairs)."""
    gen = generator or torch.Generator().manual_seed(seed)
    g = _leaves(grad(f, p))
    results, worst = [], 0.0
    for k in range(n_dirs):
        u = [torch.randn(x.shape, generator=gen, dtype=torch.float32)
             for x in _leaves(p)]
        scale = 1.0 / max(math.sqrt(sum(float((v * v).sum()) for v in u)),
                          1e-12)
        u = [(v * scale).to(x.device) for v, x in zip(u, _leaves(p))]
        ad = sum(float((gl * ul).sum()) for gl, ul in zip(g, u))
        fd = directional_fd(f, p, _unflatten(p, u), eps)
        err = abs(ad - fd) / max(abs(fd), abs(ad), atol / rtol)
        worst = max(worst, err)
        results.append((ad, fd))
        if verbose:
            print(f"dir {k}: ad={ad:+.6e} fd={fd:+.6e} rel={err:.3e}")
    return worst, results
