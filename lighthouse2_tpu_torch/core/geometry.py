"""Vector math and intersection primitives on [..., 3] float32 tensors.

Counterpart of lighthouse2_tpu/core/geometry.py: dot, cross, length,
normalize, reflect, refract, fresnel_dielectric_exact, schlick_fresnel,
onb, oriented_frame, tangent_to_world, world_to_tangent, safe_origin,
consistent_normal, intersect_tri, mt_comp, intersect_aabb,
intersect_bruteforce, occluded_bruteforce, transform_point and
transform_vector, with the same arithmetic in the same order; sqrt0 and
per_lane are the port's own (a square root whose gradient at 0 is not NaN;
a scalar or tensor as a per-lane tensor without a host copy). The
brute-force intersectors scan the triangle chunks in a Python loop where JAX
runs lax.scan, and take a per-lane or scalar t_max in both functions.
"""
from __future__ import annotations

import math

import torch

EPSILON = 1e-6
BIG_T = 1e30


def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(a):
    return torch.sqrt(torch.clamp(dot(a, a), min=0.0))


def normalize(a):
    return a * torch.rsqrt(torch.clamp(dot(a, a), min=1e-20))[..., None]


def sqrt0(x):
    """sqrt(max(x, 0)), with a zero gradient where x <= 0: torch.sqrt's
    gradient is inf at 0, and the clamp's zero cotangent times inf is NaN
    (as in the JAX package, whose sqrt(maximum(x, 0)) has this NaN)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def reflect(d, n):
    """Mirror reflection of direction d about normal n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(d, n, eta):
    """Refraction of d through normal n with relative IOR eta = n1/n2 (a
    tensor). Returns (refracted_dir, tir_mask): on total internal
    reflection the direction is the reflection and tir_mask is True."""
    cos_i = -dot(d, n)
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    t = (eta[..., None] * d
         + (eta * cos_i - torch.sqrt(torch.clamp(k, min=0.0)))[..., None] * n)
    r = reflect(d, n)
    return torch.where(tir[..., None], r, normalize(t)), tir


def fresnel_dielectric_exact(cos_theta_i, eta):
    """Exact dielectric Fresnel (tools_shared.h:199-209). eta = n_i / n_t."""
    cos_theta_i = torch.clamp(cos_theta_i, 0.0, 1.0)
    sin_theta_t2 = eta * eta * (1.0 - cos_theta_i * cos_theta_i)
    tir = sin_theta_t2 > 1.0
    cos_theta_t = torch.sqrt(torch.clamp(1.0 - sin_theta_t2, min=0.0))
    rs = ((eta * cos_theta_i - cos_theta_t)
          / torch.clamp(eta * cos_theta_i + cos_theta_t, min=1e-20))
    rp = ((eta * cos_theta_t - cos_theta_i)
          / torch.clamp(eta * cos_theta_t + cos_theta_i, min=1e-20))
    f = 0.5 * (rs * rs + rp * rp)
    return torch.where(tir, 1.0, f)


def schlick_fresnel(cos_theta, n1, n2):
    """Schlick's approximation (sharedBSDFs/lambert.h:79-84)."""
    r0 = ((n1 - n2) / (n1 + n2)) ** 2
    c = 1.0 - cos_theta
    return r0 + (1.0 - r0) * c * c * c * c * c


def onb(n):
    """Build (tangent, bitangent) for unit normal n. Branchless Pixar ONB
    (tools_shared.h:211-240)."""
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, bt


def oriented_frame(n, tangent, bitangent):
    """Shading frame aligned to the uv tangent when one exists; zero
    tangents fall back to the branchless ONB."""
    t_proj = tangent - n * (n * tangent).sum(-1, keepdim=True)
    tl = torch.sqrt(torch.clamp((t_proj * t_proj).sum(-1, keepdim=True),
                                min=1e-20))
    has = ((tangent * tangent).sum(-1, keepdim=True) > 0.25) & (tl > 1e-6)
    t_uv = t_proj / tl
    b_uv = cross(n, t_uv)
    sign = torch.where((b_uv * bitangent).sum(-1, keepdim=True) < 0.0,
                       -1.0, 1.0)
    b_uv = b_uv * sign
    t_onb, b_onb = onb(n)
    return torch.where(has, t_uv, t_onb), torch.where(has, b_uv, b_onb)


def tangent_to_world(v, n):
    t, b = onb(n)
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def world_to_tangent(v, n):
    t, b = onb(n)
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def safe_origin(o, r, n, geo_epsilon):
    """Offset origin o along ray r / normal n blended by parallel-ness^2
    (tools_shared.h:279-293)."""
    parallel = 1.0 - torch.abs(dot(r, n))
    v = parallel * parallel
    return (o + (1.0 - v)[..., None] * (geo_epsilon * n)
            + v[..., None] * (geo_epsilon * r))


def consistent_normal(d, n, alpha):
    """Bend the interpolated shading normal n so reflections of d stay above
    the surface (Reshetov 2010; tools_shared.h:297-311)."""
    q = (1.0 - (2.0 / math.pi) * alpha)
    q = (q * q) / (1.0 + 2.0 * (1.0 - (2.0 / math.pi) * alpha))
    b = dot(-d, n)
    g = 1.0 + q * (b - 1.0)
    rho = torch.sqrt(torch.clamp(
        q * (1.0 + g) / torch.clamp(1.0 + b, min=1e-6), min=1e-12))
    r = (g + rho * b)[..., None] * n - rho[..., None] * (-d)
    return normalize(-d + r)


def intersect_tri(o, d, v0, e1, e2, t_min=EPSILON, t_max=BIG_T):
    """Broadcast Moller-Trumbore on [..., 3] rays o, d and triangles v0,
    e1, e2 (v0 and edges). Returns (t, u, v, hit), t = BIG_T where there is
    no hit."""
    h = cross(d, e2)
    a = dot(e1, h)
    # two-sided test, reject near-parallel
    valid = torch.abs(a) > 1e-9
    f = 1.0 / torch.where(valid, a, 1.0)
    s = o - v0
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(d, q)
    t = f * dot(e2, q)
    hit = valid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    hit = hit & (t > t_min) & (t < t_max)
    return torch.where(hit, t, BIG_T), u, v, hit


def mt_comp(ox, oy, oz, dx, dy, dz,
            v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
            t_min, t_max, det_eps=1e-9):
    """Component-major Möller–Trumbore (common.h:19-51). Broadcasts.

    The trace kernels (csrc/trace.cu) repeat this arithmetic operation for
    operation; keep the two in step. Returns (t, u, v, hit), t = BIG_T
    where there is no hit."""
    hx = dy * e2z - dz * e2y
    hy = dz * e2x - dx * e2z
    hz = dx * e2y - dy * e2x
    a = e1x * hx + e1y * hy + e1z * hz
    valid = torch.abs(a) > det_eps
    f = 1.0 / torch.where(valid, a, 1.0)
    sx = ox - v0x
    sy = oy - v0y
    sz = oz - v0z
    u = f * (sx * hx + sy * hy + sz * hz)
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = f * (dx * qx + dy * qy + dz * qz)
    t = f * (e2x * qx + e2y * qy + e2z * qz)
    hit = (valid & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
           & (t > t_min) & (t < t_max))
    return torch.where(hit, t, BIG_T), u, v, hit


def _chunks(v0, e1, e2, chunk):
    """Yield (first triangle, the 9 component rows [1, chunk] of v0, e1,
    e2) per chunk, the last one padded with zero (never hit) triangles."""
    pad = (-v0.shape[0]) % chunk
    if pad:
        z = v0.new_zeros((pad, 3))
        v0, e1, e2 = (torch.cat([x, z], 0) for x in (v0, e1, e2))
    for s in range(0, v0.shape[0], chunk):
        yield s, [x[None, s:s + chunk, k] for x in (v0, e1, e2)
                  for k in range(3)]


def intersect_aabb(o, inv_d, bmin, bmax, t_max):
    """Slab test (bvh.cpp:7-42) of [..., 3] rays against boxes. inv_d =
    1/d. Returns (t_near, hit)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    tsm = torch.minimum(t0, t1)
    tbg = torch.maximum(t0, t1)
    t_near = tsm.amax(dim=-1)
    t_far = tbg.amin(dim=-1)
    hit = (t_far >= torch.clamp(t_near, min=0.0)) & (t_near < t_max)
    return t_near, hit


def per_lane(x, n: int, device, dtype=torch.float32):
    """x, a tensor or a Python number, as an [n] tensor on `device`. A
    number is filled on the device (torch.full), not copied from the host:
    a host-to-device copy of a fresh CPU tensor synchronises the stream."""
    if isinstance(x, torch.Tensor):
        return torch.broadcast_to(x.to(device=device, dtype=dtype), (n,))
    return torch.full((n,), x, dtype=dtype, device=device)


def _rays(o, d):
    """The 6 component columns [N, 1] of o and d."""
    return [x[:, k:k + 1] for x in (o, d) for k in range(3)]


def intersect_bruteforce(o, d, v0, e1, e2, t_max=BIG_T, chunk=1024):
    """Closest hit of [N] rays against [T] triangles without a BVH: every
    ray against every triangle, `chunk` triangles at a time (the last chunk
    padded), the lowest index winning a tie in t. Returns (t [N], prim [N]
    int32 (-1 on a miss, then t = BIG_T), u [N], v [N])."""
    n = o.shape[0]
    rays = _rays(o, d)
    t_max = per_lane(t_max, n, o.device, o.dtype)
    bt = torch.full((n,), BIG_T, dtype=o.dtype, device=o.device)
    bp = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    bu = torch.zeros_like(bt)
    bv = torch.zeros_like(bt)
    for base, tri in _chunks(v0, e1, e2, chunk):
        t, u, v, hit = mt_comp(*rays, *tri, EPSILON,
                               torch.minimum(bt, t_max)[:, None])
        t = torch.where(hit, t, BIG_T)
        j = torch.argmin(t, dim=1, keepdim=True)
        tj = torch.take_along_dim(t, j, 1)[:, 0]
        better = tj < bt
        bt = torch.where(better, tj, bt)
        bp = torch.where(better, (base + j[:, 0]).to(torch.int32), bp)
        bu = torch.where(better, torch.take_along_dim(u, j, 1)[:, 0], bu)
        bv = torch.where(better, torch.take_along_dim(v, j, 1)[:, 0], bv)
    bp = torch.where(bp < v0.shape[0], bp, -1)
    return bt, bp, bu, bv


def occluded_bruteforce(o, d, t_max, v0, e1, e2, chunk=1024):
    """Any-hit occlusion of [N] rays against [T] triangles: True where a
    triangle is hit with EPSILON < t < t_max (a scalar or [N])."""
    n = o.shape[0]
    rays = _rays(o, d)
    t_max = per_lane(t_max, n, o.device, o.dtype)
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    for _, tri in _chunks(v0, e1, e2, chunk):
        occ = occ | mt_comp(*rays, *tri, EPSILON, t_max[:, None])[3].any(1)
    return occ


def transform_point(m, p):
    """Apply 4x4 matrices [..., 4, 4] to points [..., 3]."""
    return (m[..., :3, :3] @ p[..., None])[..., 0] + m[..., :3, 3]


def transform_vector(m, v):
    return (m[..., :3, :3] @ v[..., None])[..., 0]
