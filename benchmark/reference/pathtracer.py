"""The plain reference of the path-regeneration pass, in PyTorch.

An independent, readable statement of the estimator the program renders
(Lighthouse 2's rendercore_optix7 path tracer as the JAX package defines
it): WangHash / xorshift32 counter-based random numbers with blue-noise
dimensions, pinhole eye rays in 32x32-tile pixel order, a persistent pool
of lanes that restart on the next sample of their own pixel when their path
ends, closest-hit and shadow rays by brute force against every triangle,
interpolated and consistent shading normals, trilinear MIP texture fetches
with ray-cone LOD, next-event estimation over area, point and spot lights
with the potential-proportional pick and MIS against implicit light hits,
the Lambert / mirror / dielectric BSDF, Russian roulette and firefly clamps.

It follows a chosen set of lanes only (each lane is independent of the
others but for the per-bounce camera seed, a host integer here), so a pass
over a few thousand lanes costs a few hundred milliseconds on the card. It
imports nothing of the program and reads only the benchmark's raw scene
(through reference/scene.py) and, where asked, a pool state to start from.
Every float is computed in the RefScene's dtype: float32 is the reference,
a lower precision is the control.
"""
from __future__ import annotations

import math

import torch

from benchmark.reference import bluenoise as bn

M32 = 0xFFFFFFFF
INV_2_32 = 2.3283064365387e-10
INV_PI = 1.0 / math.pi
BIG_T = 1e30
T_MIN = 1e-6


# ---------------------------------------------------------------- RNG
def wang_hash(s):
    s = s & M32
    s = (s ^ 61) ^ (s >> 16)
    s = (s * 9) & M32
    s = s ^ (s >> 4)
    s = (s * 0x27D4EB2D) & M32
    return s ^ (s >> 15)


def xorshift(s):
    s = s ^ ((s << 13) & M32)
    s = s ^ (s >> 17)
    return s ^ ((s << 5) & M32)


def rand(seed, dtype):
    seed = xorshift(seed)
    return seed, (seed.to(torch.float32) * INV_2_32).to(dtype)


# ---------------------------------------------------------------- vectors
def dot(a, b):
    return (a * b).sum(-1)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def normalize(a):
    return a * torch.rsqrt(torch.clamp(dot(a, a), min=1e-20))[..., None]


def sqrt0(x):
    """sqrt(max(x, 0)) with a zero gradient where x <= 0."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_origin(o, r, n, eps):
    par = 1.0 - torch.abs(dot(r, n))
    v = par * par
    return o + (1.0 - v)[..., None] * (eps * n) + v[..., None] * (eps * r)


def onb(n):
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2])
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], -1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], -1)
    return t, bt


def consistent_normal(d, n, alpha):
    """Reshetov's bent shading normal (tools_shared.h:297-311)."""
    q = 1.0 - (2.0 / math.pi) * alpha
    q = (q * q) / (1.0 + 2.0 * (1.0 - (2.0 / math.pi) * alpha))
    b = dot(-d, n)
    g = 1.0 + q * (b - 1.0)
    rho = torch.sqrt(torch.clamp(q * (1.0 + g) / torch.clamp(1.0 + b, min=1e-6),
                                 min=1e-12))
    r = (g + rho * b)[..., None] * n - rho[..., None] * (-d)
    return normalize(-d + r)


def clamp_intensity(c, clamp_value):
    v = c.amax(-1, keepdim=True)
    scale = torch.where(v > clamp_value, clamp_value / torch.clamp(v, min=clamp_value), 1.0)
    return c * scale


def fixnan(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def mdiv(num, den, mask):
    den = torch.where(mask, den, 1.0)
    if num.dim() != den.dim():
        return torch.where(mask[..., None], num / den[..., None], 0.0)
    return torch.where(mask, num / den, 0.0)


# ---------------------------------------------------------------- geometry
def moller_trumbore(o, d, v0, e1, e2, det_eps):
    """[S, 1, 3] rays against [1, C, 3] triangles: (t, u, v, valid)."""
    h = cross(d, e2)
    a = dot(e1, h)
    valid = torch.abs(a) > det_eps
    f = 1.0 / torch.where(valid, a, 1.0)
    s = o - v0
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(d, q)
    t = f * dot(e2, q)
    return t, u, v, valid


def closest_hit(sc, o, d, tmax, chunk):
    """Brute-force closest hit: T_MIN < t < tmax, the lowest index on a tie
    in t. Returns the search's (t, prim, u, v); t = BIG_T on a miss."""
    n = o.shape[0]
    best = torch.full((n,), BIG_T, dtype=torch.float32, device=o.device)
    prim = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    bu = torch.zeros(n, dtype=o.dtype, device=o.device)
    bv = torch.zeros_like(bu)
    oo, dd = o[:, None], d[:, None]
    lim = tmax.to(torch.float32)
    for s in range(0, sc.count, chunk):
        t, u, v, ok = moller_trumbore(oo, dd, sc.v0[None, s:s + chunk],
                                      sc.e1[None, s:s + chunk],
                                      sc.e2[None, s:s + chunk], 1e-9)
        t = t.to(torch.float32)
        hit = (ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
               & (t > T_MIN) & (t < torch.minimum(best, lim)[:, None]))
        t = torch.where(hit, t, BIG_T)
        tj, j = t.min(1)
        better = tj < best
        best = torch.where(better, tj, best)
        prim = torch.where(better, s + j, prim)
        bu = torch.where(better, u.gather(1, j[:, None])[:, 0], bu)
        bv = torch.where(better, v.gather(1, j[:, None])[:, 0], bv)
    return best.to(o.dtype), prim, bu, bv


def _retest(o, d, v0, e1, e2):
    t, u, v, ok = moller_trumbore(o, d, v0, e1, e2, 1e-6)
    return t, u, v, ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)


def refine(sc, o, d, t, prim, u, v):
    """The search's winner re-tested on its own triangle (det > 1e-6, any
    t); a lane whose re-test fails keeps the search's values."""
    p = torch.clamp(prim, min=0)
    rt, ru, rv, ok = _retest(o, d, sc.v0[p], sc.e1[p], sc.e2[p])
    keep = ok & (prim >= 0)
    return (torch.where(keep, rt, t), torch.where(keep, ru, u),
            torch.where(keep, rv, v))


def occluded(sc, o, d, tmax, chunk):
    """Brute-force any hit with T_MIN < t < tmax."""
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    oo, dd = o[:, None], d[:, None]
    lim = tmax.to(torch.float32)[:, None]
    for s in range(0, sc.count, chunk):
        t, u, v, ok = moller_trumbore(oo, dd, sc.v0[None, s:s + chunk],
                                      sc.e1[None, s:s + chunk],
                                      sc.e2[None, s:s + chunk], 1e-9)
        t = t.to(torch.float32)
        hit = (ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
               & (t > T_MIN) & (t < lim))
        occ = occ | hit.any(1)
    return occ


# ---------------------------------------------------------------- textures
def _bilinear(sc, tid, uv, level):
    di = sc.tex_desc[torch.clamp(tid, min=0), torch.clamp(level, 0, 4)]
    off, w, h = di[:, 0], di[:, 1], di[:, 2]
    x = (uv[:, 0] + 1000.0) * w.to(uv.dtype) - 0.5
    y = (uv[:, 1] + 1000.0) * h.to(uv.dtype) - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]

    def texel(xi, yi):
        xi = torch.remainder(xi.to(torch.int64), torch.clamp(w, min=1))
        yi = torch.remainder(yi.to(torch.int64), torch.clamp(h, min=1))
        return sc.tex_pool[off + xi + yi * w]

    top = texel(x0, y0) * (1 - fx) + texel(x0 + 1, y0) * fx
    bot = texel(x0, y0 + 1) * (1 - fx) + texel(x0 + 1, y0 + 1) * fx
    return top * (1 - fy) + bot * fy


def trilinear(sc, tid, uv, lam):
    lam = torch.clamp(lam, 0.0, 4.0)
    l0 = torch.floor(lam).to(torch.int64)
    frac = (lam - l0.to(lam.dtype))[:, None]
    a = _bilinear(sc, tid, uv, l0)
    b = _bilinear(sc, tid, uv, torch.clamp(l0 + 1, max=4))
    return a * (1 - frac) + b * frac


# ---------------------------------------------------------------- lights
def _potentials(sc, pos, nrm, area_pt):
    """[N, L] potentials of area (toward area_pt [N, LT, 3]), point and spot
    lights seen from pos with normal nrm."""
    blocks = []
    if sc.l_v0.shape[0]:
        lv = area_pt - pos[:, None]
        d2 = dot(lv, lv)
        l = lv * torch.where(d2 > 0, 1.0 / torch.sqrt(torch.clamp(d2, min=1e-30)), 0.0)[..., None]
        att = 1.0 / torch.clamp(d2, min=1e-12)
        lnl = torch.clamp(-dot(sc.l_n[None], l), min=0.0)
        nl = torch.clamp(dot(nrm[:, None], l), min=0.0)
        blocks.append(sc.l_energy[None] * lnl * nl * att)
    for posl, en, spot in ((sc.p_pos, sc.p_rad.sum(-1), False),
                           (sc.s_pos, sc.s_rad.sum(-1), True)):
        if not posl.shape[0]:
            continue
        lv = posl[None] - pos[:, None]
        d2 = dot(lv, lv)
        l = lv * torch.where(d2 > 0, 1.0 / torch.sqrt(torch.clamp(d2, min=1e-30)), 0.0)[..., None]
        pot = en[None] * torch.clamp(dot(nrm[:, None], l), min=0.0) / torch.clamp(d2, min=1e-12)
        if spot:
            fall = ((torch.clamp(-dot(l, sc.s_dir[None]), min=0.0) - sc.s_cos_out[None])
                    / torch.clamp(sc.s_cos_in - sc.s_cos_out, min=1e-6)[None])
            pot = pot * torch.clamp(fall, 0.0, 1.0)
        blocks.append(pot)
    return torch.cat(blocks, 1)


def random_barycentrics(r):
    """Base-4 subdivision warp of [0, 1) onto the triangle (lights_shared.h
    :145-164)."""
    uf = torch.clamp((r.to(torch.float32) * 4294967296.0).to(torch.int64), 0, M32)
    z = torch.zeros_like(r)
    a, b, c, d, e, f, g, h, i = z + 1, z, z, z, z + 1, z, z, z, z + 1
    for _ in range(16):
        uf = (uf * 4) & M32
        k = uf >> 30
        an, bn, cn = 0.5 * (b + c), 0.5 * (c + a), 0.5 * (a + b)
        dn, en, fn = 0.5 * (e + f), 0.5 * (f + d), 0.5 * (d + e)
        gn, hn, inn = 0.5 * (h + i), 0.5 * (i + g), 0.5 * (g + h)

        def pick(x0, x1, x2, x3):
            return torch.where(k == 0, x0, torch.where(k == 1, x1, torch.where(k == 2, x2, x3)))
        a, b, c, d, e, f, g, h, i = (
            pick(an, a, an, bn), pick(bn, bn, b, an), pick(cn, cn, cn, c),
            pick(dn, d, dn, en), pick(en, en, e, dn), pick(fn, fn, fn, f),
            pick(gn, g, gn, hn), pick(hn, hn, h, gn), pick(inn, inn, inn, i))
    return (a + b + c) / 3.0, (d + e + f) / 3.0


def sample_light(sc, r0, r1, pos, nrm):
    """RandomPointOnLight: (point, pdf, pick probability, radiance)."""
    n, lt = pos.shape[0], sc.l_v0.shape[0]
    lp, ls = sc.p_pos.shape[0], sc.s_pos.shape[0]
    bu, bv = random_barycentrics(r0)
    bw = 1.0 - bu - bv
    pts = (bu[:, None, None] * sc.l_v0[None] + bv[:, None, None] * sc.l_v1[None]
           + bw[:, None, None] * sc.l_v2[None])
    pot = _potentials(sc, pos, nrm, pts)
    s = pot.sum(1)
    cdf = torch.cumsum(pot, 1)
    pick = torch.clamp((cdf < (r1 * s)[:, None]).sum(1), 0, pot.shape[1] - 1)
    pick_p = torch.where(s > 0, pot.gather(1, pick[:, None])[:, 0]
                         / torch.where(s > 0, s, 1.0), 0.0)
    ar = torch.arange(n, device=pos.device)
    point, pdf = pos + torch.tensor([1.0, 0.0, 0.0], dtype=pos.dtype, device=pos.device), torch.zeros_like(s)
    col = torch.zeros_like(pos)

    def towards(lpos):
        lr = pos - lpos
        d2 = dot(lr, lr)
        lrn = lr * torch.where(d2 > 0, 1.0 / torch.sqrt(torch.clamp(d2, min=1e-30)), 0.0)[:, None]
        return lrn, d2

    if lt:
        ai = torch.clamp(pick, 0, lt - 1)
        pa = pts[ar, ai]
        lrn, d2 = towards(pa)
        lnl = dot(lrn, sc.l_n[ai])
        ok = (lnl > 0) & (dot(lrn, nrm) < 0)
        pdf_a = torch.where(ok, d2 / torch.where(ok, torch.clamp(sc.l_area[ai] * lnl, min=1e-30), 1.0), 0.0)
        m = pick < lt
        point = torch.where(m[:, None], pa, point)
        pdf = torch.where(m, pdf_a, pdf)
        col = torch.where(m[:, None], sc.l_rad[ai], col)
    if lp:
        pi = torch.clamp(pick - lt, 0, lp - 1)
        pp = sc.p_pos[pi]
        lrn, d2 = towards(pp)
        m = (pick >= lt) & (pick < lt + lp)
        point = torch.where(m[:, None], pp, point)
        pdf = torch.where(m, torch.where(dot(lrn, nrm) < 0, d2, 0.0), pdf)
        col = torch.where(m[:, None], sc.p_rad[pi], col)
    if ls:
        si = torch.clamp(pick - lt - lp, 0, ls - 1)
        sp = sc.s_pos[si]
        lrn, d2 = towards(sp)
        fall = ((torch.clamp(dot(lrn, sc.s_dir[si]), min=0.0) - sc.s_cos_out[si])
                / torch.clamp(sc.s_cos_in[si] - sc.s_cos_out[si], min=1e-6))
        fall = torch.clamp(fall, max=1.0)
        ok = (fall > 0) & (dot(lrn, nrm) < 0)
        m = pick >= lt + lp
        point = torch.where(m[:, None], sp, point)
        pdf = torch.where(m, torch.where(ok, d2 / torch.where(ok, torch.clamp(fall, min=1e-30), 1.0), 0.0), pdf)
        col = torch.where(m[:, None], sc.s_rad[si], col)
    return point, torch.where(s > 0, pdf, 0.0), pick_p, col


def light_pick_prob(sc, ltri, o, last_n, hit_pos):
    """MIS probability that NEE at the previous vertex picks this area
    light, the area lights evaluated toward the hit point."""
    lt = sc.l_v0.shape[0]
    pot = _potentials(sc, o, last_n, hit_pos[:, None].expand(-1, lt, -1))
    s = pot.sum(1)
    p = pot.gather(1, torch.clamp(ltri, 0, pot.shape[1] - 1)[:, None])[:, 0]
    return torch.where(s > 0, p / torch.where(s > 0, s, 1.0), 0.0)


# ---------------------------------------------------------------- BSDF
def _fresnel(v_dot_n, eio):
    flip = v_dot_n < 0.0
    eio = torch.where(flip, 1.0 / eio, eio)
    v_dot_n = torch.abs(v_dot_n)
    st2 = eio * eio * (1.0 - v_dot_n * v_dot_n)
    ldn = sqrt0(1.0 - st2)
    r1 = (v_dot_n - eio * ldn) / torch.clamp(v_dot_n + eio * ldn, min=1e-20)
    r2 = (ldn - eio * v_dot_n) / torch.clamp(ldn + eio * v_dot_n, min=1e-20)
    return torch.where(st2 > 1.0, 1.0, 0.5 * (r1 * r1 + r2 * r2))


def sample_bsdf(color, rough, trans, eta, absorb, i_n, n_geom, wo, dist, r3, r4):
    """Lambert + mirror + dielectric sample (lambert.h:72-125)."""
    flip = torch.where(dot(wo, n_geom) < 0, -1.0, 1.0).to(wo.dtype)
    i_n = i_n * flip[:, None]
    eio = torch.where(flip < 0, 1.0 / torch.clamp(eta, min=1e-6), eta)
    fr = _fresnel(dot(i_n, wo), eio)
    beer = torch.exp(-absorb * (dist * 2.0)[:, None])
    wi_refl = -wo - 2.0 * dot(-wo, i_n)[:, None] * i_n
    bsdf_refl = color * beer / torch.clamp(torch.abs(dot(i_n, wi_refl))[:, None], min=1e-9)
    cos_i = torch.abs(dot(i_n, wo))
    s2t = eio * eio * torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    wt = eio[:, None] * (-wo) + (eio * cos_i - sqrt0(1.0 - s2t))[:, None] * i_n
    bsdf_refr = color * beer / torch.clamp(torch.abs(dot(i_n, wt))[:, None], min=1e-9)
    refl = r3 < fr
    wi_t = torch.where(refl[:, None], wi_refl, wt)
    bsdf_t = torch.where(refl[:, None], bsdf_refl,
                         torch.where((s2t < 1.0)[:, None], bsdf_refr, 0.0))
    p_reflect = 1.0 - rough
    pure = r3 < p_reflect
    bsdf_m = color / torch.clamp(torch.abs(dot(i_n, wi_refl))[:, None], min=1e-9)
    r5 = (r3 - p_reflect) / torch.clamp(1.0 - p_reflect, min=1e-9)
    r6 = (r4 - trans) / torch.clamp(1.0 - trans, min=1e-9)
    phi = 2.0 * math.pi * r5
    sq = torch.sqrt(torch.clamp(r6, min=0.0))
    local = torch.stack([torch.cos(phi) * sq, torch.sin(phi) * sq,
                         torch.sqrt(torch.clamp(1.0 - r6, min=0.0))], -1)
    tt, bb = onb(i_n)
    wi_d = normalize(local[:, 0:1] * tt + local[:, 1:2] * bb + local[:, 2:3] * i_n)
    pdf_d = torch.clamp(dot(wi_d, i_n), min=0.0) * INV_PI
    wi_r = torch.where(pure[:, None], wi_refl, wi_d)
    bsdf_r = torch.where(pure[:, None], bsdf_m, color * INV_PI)
    pdf_r = torch.where(pure, 1.0, pdf_d)
    transmit = r4 < trans
    wi = torch.where(transmit[:, None], wi_t, wi_r)
    bsdf = torch.where(transmit[:, None], bsdf_t, bsdf_r)
    pdf = torch.where(transmit, 1.0, pdf_r)
    pdf = torch.where(dot(n_geom * flip[:, None], wi) <= 0.0, 0.0, pdf)
    return wi, bsdf, pdf, transmit | pure


# ---------------------------------------------------------------- the pass
class Settings:
    """The render settings the reference follows (the configuration's)."""

    def __init__(self, width, height, spp=1, max_path=16, max_diffuse=1000,
                 geometry_epsilon=1e-4, clamp_value=10.0, chunk=8192):
        self.width, self.height, self.spp = width, height, spp
        self.max_path, self.max_diffuse = max_path, max_diffuse
        self.eps, self.clamp, self.chunk = geometry_epsilon, clamp_value, chunk


def lane_pixel(lane, w, h):
    """Slot -> pixel in 32x32-tile order (row-major without whole tiles)."""
    slot = lane % (w * h)
    if w % 32 or h % 32:
        return slot
    tile, within = slot >> 10, slot & 1023
    tx, ty = tile % (w // 32), tile // (w // 32)
    return (ty * 32 + (within >> 5)) * w + tx * 32 + (within & 31)


def eye_rays(sc, st, lane, sample, mask):
    """Primary rays of `sample` of each lane's pixel (pinhole camera)."""
    w, h = st.width, st.height
    pixel = lane_pixel(lane, w, h)
    seed = wang_hash((lane * 16789 + sample * 1791) & M32)
    seed, r0 = rand(seed, sc.dtype)
    seed, r1 = rand(seed, sc.dtype)
    px, py = pixel % w, pixel // w
    use = sample < 256
    zero = torch.zeros_like(lane)
    r0 = torch.where(use, bn.sample(mask, px, py, sample, zero).to(sc.dtype), r0)
    r1 = torch.where(use, bn.sample(mask, px, py, sample, zero + 1).to(sc.dtype), r1)
    right, up = sc.p2 - sc.p1, sc.p3 - sc.p1
    u = (px.to(sc.dtype) + r0) / w
    v = (py.to(sc.dtype) + r1) / h
    target = sc.p1[None] + u[:, None] * right[None] + v[:, None] * up[None]
    origin = sc.cam_pos[None].expand(lane.shape[0], 3)
    d = normalize(target - origin)
    n = lane.shape[0]
    return dict(origin=origin, dir=d,
                throughput=torch.ones((n, 3), dtype=sc.dtype, device=d.device),
                bsdf_pdf=torch.ones(n, dtype=sc.dtype, device=d.device),
                last_n=d.clone(),
                prev_spec=torch.ones(n, dtype=torch.bool, device=d.device),
                n_diffuse=torch.zeros(n, dtype=torch.int64, device=d.device),
                alive=torch.ones(n, dtype=torch.bool, device=d.device),
                pixel=pixel, sample=sample)


def fresh_pool(sc, st, lane, mask):
    """The pool's first state: lane k on sample k // (W*H) of its pixel."""
    sample = lane // (st.width * st.height)
    return dict(eye_rays(sc, st, lane, sample, mask),
                depth=torch.zeros_like(lane), sample_k=sample)


def _shade(sc, st, p, li, t, prim, u, v, cam_seed, mask, lane):
    """One bounce's shading of the lanes in `p`: returns (lanes', rgb added,
    depth added, shadow ray, cam_seed')."""
    dt = sc.dtype
    path_length = li + 1
    o, d, alive = p["origin"], p["dir"], p["alive"]
    thr, pdf0 = p["throughput"], p["bsdf_pdf"]
    prim = torch.where(alive, prim, -1)
    depth_add = torch.where((li == 0) & alive,
                            torch.where(prim >= 0, t, 10000.0), 0.0)
    t = torch.where(prim >= 0, t, 1.0)
    hit = alive & (prim >= 0)
    i_pos = o + t[:, None] * d
    q = torch.clamp(prim, min=0)
    w = 1.0 - u - v
    n_geom = sc.face_n[q]
    n_int = normalize(w[:, None] * sc.n0[q] + u[:, None] * sc.n1[q]
                      + v[:, None] * sc.n2[q])
    uv = w[:, None] * sc.uv0[q] + u[:, None] * sc.uv1[q] + v[:, None] * sc.uv2[q]
    mat = sc.mat[q]
    color, rough = sc.m_color[mat], sc.m_rough[mat]
    lam = sc.lod[q] + torch.log2(torch.clamp(sc.spread * t, min=1e-20)
                                 / torch.clamp(torch.abs(dot(d, n_int)), min=1e-6))
    td, tr = sc.m_tex_d[mat], sc.m_tex_r[mat]
    color = torch.where((td >= 0)[:, None],
                        color * trilinear(sc, td, uv, lam)[:, :3], color)
    rough = torch.where(tr >= 0, rough * trilinear(sc, tr, uv, lam)[:, 0], rough)
    a3 = sc.alpha[q]
    alpha = w * a3[:, 0] + u * a3[:, 1] + v * a3[:, 2]
    back = dot(d, n_int) > 0
    n_in = torch.where(back[:, None], -n_int, n_int)
    n_c = consistent_normal(d, n_in, alpha)
    n_sh = torch.where((alpha > 0)[:, None],
                       torch.where(back[:, None], -n_c, n_c), n_int)
    face_dir = torch.where(dot(d, n_geom) > 0, -1.0, 1.0).to(dt)
    emissive = color.amax(-1) > 1.0
    trans, eta = sc.m_trans[mat], sc.m_eta[mat]
    absorb = torch.where((face_dir == 1.0)[:, None], 0.0, sc.m_absorb[mat])

    # an implicit light hit, MIS against NEE from the previous vertex
    lit = hit & emissive & (-dot(d, n_geom) > 0)
    l_pdf = (t * t) / (-dot(d, n_geom) * sc.area[q])
    pick_p = light_pick_prob(sc, sc.ltri[q], o, p["last_n"], i_pos)
    den = pdf0 + l_pdf * pick_p
    c_light = torch.where(p["prev_spec"][:, None], mdiv(thr * color, pdf0, lit),
                          mdiv(thr * color, den, lit & (den > 0)))
    rgb = torch.where(lit[:, None], fixnan(clamp_intensity(c_light, st.clamp)), 0.0)

    active = hit & ~emissive
    spec = (trans > 0.999) | (rough <= 0.001)
    cam_seed = xorshift(cam_seed)
    seed = wang_hash((lane * 17 + ((cam_seed + 91771 * path_length) & M32)) & M32)
    thr = mdiv(thr, pdf0, active)
    fn_flip = n_sh * face_dir[:, None]
    px, py = p["pixel"] % st.width, p["pixel"] // st.width
    dim0 = 4 * path_length

    def bn_or(r, dim, cap):
        return torch.where(p["sample"] < cap,
                           bn.sample(mask, px, py, p["sample"], dim0 + dim).to(dt), r)

    # next-event estimation
    seed, r0 = rand(seed, dt)
    seed, r1 = rand(seed, dt)
    r0, r1 = bn_or(r0, 4, 2), bn_or(r1, 5, 2)
    lpt, lpdf, lpick, lcol = sample_light(sc, r0, r1, i_pos, fn_flip)
    lv = lpt - i_pos
    dist = torch.sqrt(torch.clamp(dot(lv, lv), min=1e-20))
    ldir = lv / dist[:, None]
    ndl = dot(ldir, fn_flip)
    e_pdf = torch.where(spec, 0.0, torch.abs(dot(ldir, n_sh)) * INV_PI)
    e_bsdf = torch.where(spec[:, None], 0.0, color * INV_PI) * rough[:, None]
    conn = active & ~spec & (ndl > 0) & (lpdf > 0) & (e_pdf > 0)
    pot = thr * e_bsdf * lcol * mdiv(ndl, lpick * lpdf + e_pdf, conn)[:, None]
    pot = clamp_intensity(fixnan(pot), st.clamp)
    shadow = dict(o=safe_origin(i_pos, ldir, n_geom * face_dir[:, None], st.eps),
                  d=ldir, tmax=torch.where(conn, dist - 2.0 * st.eps, 0.0),
                  pot=pot, conn=conn)

    # the bounce, with Russian roulette after the first diffuse vertex
    may = active & (p["n_diffuse"] < st.max_diffuse) & (path_length < st.max_path)
    seed, r3 = rand(seed, dt)
    seed, r4 = rand(seed, dt)
    r3, r4 = bn_or(r3, 6, 256), bn_or(r4, 7, 256)
    wi, bsdf, pdf, new_spec = sample_bsdf(color, rough, trans, eta, absorb, n_sh,
                                          n_geom, -d, t, r3, r4)
    ok_pdf = (pdf >= 1e-4) & torch.isfinite(pdf)
    seed, r5 = rand(seed, dt)
    surv = torch.clamp(bsdf.amax(-1), max=1.0)
    p_surv = torch.where(new_spec | ~(p["n_diffuse"] > 0), 1.0, surv)
    ext = may & ok_pdf & (r5 <= p_surv)
    new_thr = fixnan(mdiv(thr, p_surv, ext) * bsdf * torch.abs(dot(n_sh, wi))[:, None])
    e3 = ext[:, None]
    out = dict(p, origin=torch.where(e3, safe_origin(i_pos, wi, n_geom * face_dir[:, None], st.eps), o),
               dir=torch.where(e3, wi, d),
               throughput=torch.where(e3, new_thr, thr),
               bsdf_pdf=torch.where(ext, pdf, 1.0),
               last_n=torch.where(e3, fn_flip, p["last_n"]),
               prev_spec=torch.where(ext, new_spec, p["prev_spec"]),
               n_diffuse=p["n_diffuse"] + (ext & ~new_spec).to(torch.int64),
               alive=ext)
    return out, rgb, depth_add, shadow, cam_seed


def regen_pass(sc, st, pool, lane, cam_seed, mask):
    """One pass of max_path bounce iterations of the lanes `lane` from their
    pool state: (acc [S, 4], completed samples [S], pool', cam_seed', rays
    [S]), where rays counts each lane's extension rays (one a bounce: every
    lane is alive after regeneration) and its shadow rays (the NEE
    connections it tests)."""
    p = dict(pool)
    dev = lane.device
    acc = torch.zeros((lane.shape[0], 4), dtype=sc.dtype, device=dev)
    count = torch.zeros(lane.shape[0], dtype=torch.float32, device=dev)
    rays = torch.zeros(lane.shape[0], dtype=torch.int64, device=dev)
    cs = torch.full((), cam_seed & M32, dtype=torch.int64, device=dev)
    keys = ("origin", "dir", "throughput", "bsdf_pdf", "last_n", "prev_spec",
            "n_diffuse", "alive", "pixel", "sample")
    for _ in range(st.max_path):
        dead = ~p["alive"]
        p["sample_k"] = p["sample_k"] + st.spp * dead.to(torch.int64)
        fresh = eye_rays(sc, st, lane, p["sample_k"], mask)
        for k in keys:
            m = dead if fresh[k].dim() == 1 else dead[:, None]
            p[k] = torch.where(m, fresh[k], p[k])
        p["depth"] = torch.where(dead, 0, p["depth"])
        tmax = torch.where(p["alive"], BIG_T, 0.0)
        rays = rays + p["alive"].to(torch.int64)
        t, prim, u, v = closest_hit(sc, p["origin"], p["dir"], tmax, st.chunk)
        t, u, v = refine(sc, p["origin"], p["dir"], t, prim, u, v)
        p, rgb, dadd, sh, cs = _shade(sc, st, p, p["depth"], t, prim, u, v, cs,
                                      mask, lane)
        rays = rays + sh["conn"].to(torch.int64)
        occ = occluded(sc, sh["o"], sh["d"], sh["tmax"], st.chunk)
        rgb = rgb + torch.where((sh["conn"] & ~occ)[:, None], sh["pot"], 0.0)
        acc = acc + torch.cat([rgb, dadd[:, None]], 1)
        p["depth"] = p["depth"] + p["alive"].to(torch.int64)
        count = count + (~p["alive"]).to(torch.float32)
    return acc, count, p, int(cs.item()), rays
