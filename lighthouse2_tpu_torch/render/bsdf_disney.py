"""Disney principled BRDF (lib/sharedBSDFs/disney.h, adapted by the reference
from AppleSeed; microfacet functions lib/sharedBSDFs/ggxmdf.h).

Counterpart of lighthouse2_tpu/render/bsdf_disney.py: the GGX and GTR1
functions, the shading frame, the lobe weights, is_specular_material,
evaluate and sample, with the same arithmetic in the same order. As there,
every lobe is computed on every lane and the result selected with `where`
(no branch on a mask, so gradients and random-number use match the
reference), the dielectric path is the Lambert shader's (_fr_l, _refract_l
of the port's bsdf_lambert), and the lobe pick and its renormalised random
are detached in sample, where the JAX package puts stop_gradient.
jax.lax.rsqrt becomes torch.rsqrt.

Differences, both in the gradient only: where the square roots of the
microfacet functions (sin theta in _ggx_d, _ggx_lambda, _gtr1_lambda and
_gtr1_sample, the anisotropic alpha, the GTR1 cotangent) take an argument
of 0, for instance at m = n when wi is the mirror of wo, the JAX package's
gradient is 0 * inf = NaN (jax.grad of its _ggx_d at m = (0, 0, 1) is
NaN). Here geometry.sqrt0 gives the same value and a zero gradient there.
And where a `where` drops a branch that divides by zero (_ggx_d at
m.z = 0, _ggx_pdf and _gtr1_lambda at v.z = 0), the dropped lanes divide
by 1 instead: the value is the same, and the backward no longer forms
0 / 0 there. So the backward through a Disney bounce stays finite.
"""
from __future__ import annotations

import math

import torch

from lighthouse2_tpu_torch.core.geometry import (
    dot, normalize, oriented_frame, reflect, sqrt0)
from lighthouse2_tpu_torch.core.sampling import cosine_hemisphere
from lighthouse2_tpu_torch.render.bsdf_lambert import _fr_l, _refract_l

INV_PI = 1.0 / math.pi
PI = math.pi


# colour helpers (tint, material_shared.h:70-71)

def _luminance_y(rgb):
    return (0.212671 * rgb[..., 0] + 0.715160 * rgb[..., 1]
            + 0.072169 * rgb[..., 2])


def tint_and_luminance(color):
    y = _luminance_y(color)
    tint = torch.where((y > 0)[..., None],
                       color / torch.clamp(y, min=1e-9)[..., None], 1.0)
    return tint, y


def _schlick(u):
    m = torch.clamp(1.0 - u, 0.0, 1.0)
    m2 = m * m
    return m2 * m2 * m


# GGX / GTR1 microfacet functions (ggxmdf.h) on tangent-space z-up vectors
# given as components

def _ggx_d(mx, my, mz, ax, ay):
    c2 = mz * mz
    s = sqrt0(1.0 - c2)
    c4 = torch.where(c2 > 1e-12, c2 * c2, 1.0)
    tan2 = (1.0 - c2) / torch.clamp(c2, min=1e-12)
    iso = (torch.abs(ax - ay) < 1e-7) | (s == 0.0)
    cos_phi2 = (mx / torch.clamp(s * ax, min=1e-12)) ** 2
    sin_phi2 = (my / torch.clamp(s * ay, min=1e-12)) ** 2
    a_aniso = cos_phi2 + sin_phi2
    a = torch.where(iso, 1.0 / (ax * ax), a_aniso)
    tmp = 1.0 + tan2 * a
    d = 1.0 / (PI * ax * ay * c4 * tmp * tmp)
    return torch.where(c2 > 1e-12, d, ax * ax * INV_PI)


def _ggx_lambda(vx, vy, vz, ax, ay):
    c2 = vz * vz
    s = sqrt0(1.0 - c2)
    iso = (torch.abs(ax - ay) < 1e-7) | (s == 0.0)
    cos_phi2 = (vx / torch.clamp(s, min=1e-12)) ** 2
    sin_phi2 = (vy / torch.clamp(s, min=1e-12)) ** 2
    alpha_aniso = sqrt0(cos_phi2 * ax * ax + sin_phi2 * ay * ay)
    alpha = torch.where(iso, ax, alpha_aniso)
    tan2 = (s * s) / torch.clamp(c2, min=1e-12)
    lam = 0.5 * (-1.0 + torch.sqrt(1.0 + alpha * alpha * tan2))
    return torch.where(torch.abs(vz) > 1e-12, lam, 0.0)


def _ggx_g(wix, wiy, wiz, wox, woy, woz, ax, ay):
    return 1.0 / (1.0 + _ggx_lambda(wox, woy, woz, ax, ay)
                  + _ggx_lambda(wix, wiy, wiz, ax, ay))


def _ggx_sample(vx, vy, vz, r0, r1, ax, ay):
    """Sample the GGX visible-normal distribution (ggxmdf.h:102-121)."""
    sign = torch.where(vz < 0, -1.0, 1.0)
    sx, sy, sz = sign * vx * ax, sign * vy * ay, sign * vz
    inv = torch.rsqrt(torch.clamp(sx * sx + sy * sy + sz * sz, min=1e-20))
    sx, sy, sz = sx * inv, sy * inv, sz * inv
    # ONB around the stretched vector: t1 = normalize(cross(s, z)) or (1,0,0)
    denom = torch.sqrt(torch.clamp(sx * sx + sy * sy, min=1e-20))
    straight = vz >= 0.9999
    t1x = torch.where(straight, 1.0, sy / denom)
    t1y = torch.where(straight, 0.0, -sx / denom)
    t1z = 0.0 * t1x
    # t2 = cross(t1, s)
    t2x = t1y * sz - t1z * sy
    t2y = t1z * sx - t1x * sz
    t2z = t1x * sy - t1y * sx
    a = 1.0 / (1.0 + sz)
    r = torch.sqrt(torch.clamp(r0, min=0.0))
    low = r1 < a
    phi = torch.where(low, r1 / torch.clamp(a, min=1e-9) * PI,
                      PI + (r1 - a) / torch.clamp(1.0 - a, min=1e-9) * PI)
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi) * torch.where(low, 1.0, sz)
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    hx = p1 * t1x + p2 * t2x + p3 * sx
    hy = p1 * t1y + p2 * t2y + p3 * sy
    hz = p1 * t1z + p2 * t2z + p3 * sz
    mx, my, mz = hx * ax, hy * ay, torch.clamp(hz, min=0.0)
    inv = torch.rsqrt(torch.clamp(mx * mx + my * my + mz * mz, min=1e-20))
    return mx * inv, my * inv, mz * inv


def _ggx_pdf(vx, vy, vz, mx, my, mz, ax, ay):
    g1 = 1.0 / (1.0 + _ggx_lambda(vx, vy, vz, ax, ay))
    vm = torch.abs(vx * mx + vy * my + vz * mz)
    ok = torch.abs(vz) > 1e-12
    return torch.where(ok, g1 * vm * _ggx_d(mx, my, mz, ax, ay)
                       / torch.where(ok, torch.abs(vz), 1.0), 0.0)


def _gtr1_d(mz, alpha):
    alpha = torch.clamp(alpha, 0.001, 0.999)
    a2 = alpha * alpha
    a = (a2 - 1.0) / (PI * torch.log(a2))
    b = 1.0 / (1.0 + (a2 - 1.0) * mz * mz)
    return a * b


def _gtr1_lambda(vz, alpha):
    c2 = vz * vz
    s = sqrt0(1.0 - c2)
    ok = (torch.abs(vz) > 1e-9) & (s > 1e-9)
    cot2 = torch.where(ok, c2 / torch.clamp(s * s, min=1e-12), 1.0)
    cot = sqrt0(cot2)
    alpha = torch.clamp(alpha, 0.001, 0.999)
    a2 = alpha * alpha
    a = torch.sqrt(cot2 + a2)
    b = torch.sqrt(cot2 + 1.0)
    c = torch.log(torch.clamp(cot + b, min=1e-20))
    d_ = torch.log(torch.clamp(cot + a, min=1e-20))
    lam = (a - b + cot * (c - d_)) / (cot * torch.log(a2))
    return torch.where(ok, lam, 0.0)


def _gtr1_g(wiz, woz, alpha):
    return 1.0 / (1.0 + _gtr1_lambda(woz, alpha) + _gtr1_lambda(wiz, alpha))


def _gtr1_sample(r0, r1, alpha):
    alpha = torch.clamp(alpha, 0.001, 0.999)
    a2 = alpha * alpha
    a = 1.0 - torch.pow(a2, 1.0 - r0)
    c2 = a / (1.0 - a2)
    cz = torch.sqrt(torch.clamp(c2, min=0.0))
    s = sqrt0(1.0 - c2)
    phi = 2.0 * PI * r1
    return s * torch.cos(phi), s * torch.sin(phi), cz


def _gtr1_pdf(mz, alpha):
    return _gtr1_d(mz, alpha) * torch.abs(mz)


# frame helpers

def _frame(i_n, sd):
    """Shading frame: aligned to the uv tangent where the mesh has one,
    the branchless ONB elsewhere."""
    return oriented_frame(i_n, sd.tangent, sd.bitangent)


def _to_local(v, i_n, t, b):
    return dot(v, t), dot(v, b), dot(v, i_n)


def _to_world(x, y, z, i_n, t, b):
    return x[..., None] * t + y[..., None] * b + z[..., None] * i_n


# lobes (disney.h)

def _lobe_weights(sd):
    """disney.h:239-246: (diffuse, sheen, specular, clearcoat) normalised."""
    _, lum = tint_and_luminance(sd.color)
    w0 = lum * (1.0 - sd.metallic)
    w1 = sd.sheen * (1.0 - sd.metallic)
    w2 = sd.specular + sd.metallic * (1.0 - sd.specular)
    w3 = sd.clearcoat * 0.25
    total = torch.clamp(w0 + w1 + w2 + w3, min=1e-9)
    return w0 / total, w1 / total, w2 / total, w3 / total


def _spec_alphas(sd):
    sq = sd.roughness * sd.roughness
    aspect = torch.sqrt(1.0 + sd.anisotropic
                        * torch.where(sd.anisotropic < 0, 0.9, -0.9))
    ax = torch.clamp(sq / aspect, min=0.001)
    ay = torch.clamp(sq * aspect, min=0.001)
    return ax, ay


def _clearcoat_alpha(sd):
    return 0.1 + (0.001 - 0.1) * sd.clearcoat_gloss


def _spec_fresnel(sd, cos_oh):
    tint, _ = tint_and_luminance(sd.color)
    val = (1.0 - sd.spec_tint[..., None]) + sd.spec_tint[..., None] * tint
    val = val * (sd.specular * 0.08)[..., None]
    val = ((1.0 - sd.metallic[..., None]) * val
           + sd.metallic[..., None] * sd.color)
    f = _schlick(torch.abs(cos_oh))
    return (1.0 - f[..., None]) * val + f[..., None]


def _coat_fresnel(sd, cos_oh):
    f = 0.04 + (1.0 - 0.04) * _schlick(torch.abs(cos_oh))
    return (f * 0.25 * sd.clearcoat)[..., None].expand(*f.shape, 3)


def _evaluate_diffuse(sd, i_n, wo, wi):
    """disney.h:137-165. Returns (value [N,3], pdf [N])."""
    h = normalize(wi + wo)
    cos_on = dot(i_n, wo)
    cos_in = dot(i_n, wi)
    cos_ih = dot(wi, h)
    fl = _schlick(cos_in)
    fv = _schlick(cos_on)
    fd90 = 0.5 + 2.0 * cos_ih * cos_ih * sd.roughness
    fd = (1.0 + (fd90 - 1.0) * fl) * (1.0 + (fd90 - 1.0) * fv)
    fd = torch.where(sd.subsurface != 1.0, fd, 0.0)
    fss90 = cos_ih * cos_ih * sd.roughness
    fss = (1.0 + (fss90 - 1.0) * fl) * (1.0 + (fss90 - 1.0) * fv)
    ss = 1.25 * (fss * (1.0 / torch.clamp(torch.abs(cos_on)
                                          + torch.abs(cos_in), min=1e-9)
                        - 0.5) + 0.5)
    fd = fd + sd.subsurface * (ss - fd)
    value = sd.color * (fd * INV_PI * (1.0 - sd.metallic))[..., None]
    pdf = torch.abs(cos_in) * INV_PI
    return value, pdf


def _evaluate_sheen(sd, wo, wi):
    """disney.h:180-190 (the reference's quirk kept: h built from wo + wo)."""
    h = normalize(wo + wo)
    cos_ih = dot(wi, h)
    fh = _schlick(cos_ih)
    tint, _ = tint_and_luminance(sd.color)
    val = (1.0 - sd.sheen_tint[..., None]) + sd.sheen_tint[..., None] * tint
    value = val * (fh * sd.sheen * (1.0 - sd.metallic))[..., None]
    return value, torch.full(wo.shape[:-1], 1.0 / (2.0 * PI),
                             device=wo.device)


def _evaluate_mf(sd, i_n, t, b, wo, wi, ggx: bool):
    """evaluate_mf (disney.h:118-135). Returns (value, pdf)."""
    wox, woy, woz = _to_local(wo, i_n, t, b)
    wix, wiy, wiz = _to_local(wi, i_n, t, b)
    msx = wix + wox
    msy = wiy + woy
    msz = wiz + woz
    inv = torch.rsqrt(torch.clamp(msx * msx + msy * msy + msz * msz,
                                  min=1e-20))
    mx, my, mz = msx * inv, msy * inv, msz * inv
    cos_oh = wox * mx + woy * my + woz * mz
    if ggx:
        ax, ay = _spec_alphas(sd)
        d = _ggx_d(mx, my, mz, ax, ay)
        g = _ggx_g(wix, wiy, wiz, wox, woy, woz, ax, ay)
        fres = _spec_fresnel(sd, cos_oh)
        pdf = (_ggx_pdf(wox, woy, woz, mx, my, mz, ax, ay)
               / torch.clamp(torch.abs(4.0 * cos_oh), min=1e-9))
    else:
        alpha = _clearcoat_alpha(sd)
        d = _gtr1_d(mz, alpha)
        g = _gtr1_g(wiz, woz, alpha)
        fres = _coat_fresnel(sd, cos_oh)
        pdf = _gtr1_pdf(mz, alpha) / torch.clamp(torch.abs(4.0 * cos_oh),
                                                 min=1e-9)
    denom = torch.clamp(torch.abs(4.0 * woz * wiz), min=1e-9)
    value = fres * (d * g / denom)[..., None]
    ok = ((torch.abs(woz) > 1e-9) & (torch.abs(wiz) > 1e-9)
          & (torch.abs(cos_oh) > 1e-9))
    return torch.where(ok[..., None], value, 0.0), torch.where(ok, pdf, 0.0)


def _sample_mf(sd, i_n, t, b, n_geom_flip, wo, r0, r1, ggx: bool):
    """sample_mf (disney.h:96-116). Returns (wi [N,3], ok mask)."""
    wox, woy, woz = _to_local(wo, i_n, t, b)
    if ggx:
        ax, ay = _spec_alphas(sd)
        mx, my, mz = _ggx_sample(wox, woy, woz, r0, r1, ax, ay)
    else:
        alpha = _clearcoat_alpha(sd)
        mx, my, mz = _gtr1_sample(r0, r1, alpha)
    # wi = reflect(-wo, m)
    k = 2.0 * (wox * mx + woy * my + woz * mz)
    wix, wiy, wiz = k * mx - wox, k * my - woy, k * mz - woz
    wi = _to_world(wix, wiy, wiz, i_n, t, b)
    # force above the geometric surface (disney.h:64-71)
    cos_g = dot(wi, n_geom_flip)
    corr = 1e-4 - cos_g
    wi_fixed = normalize(wi + corr[..., None] * n_geom_flip)
    wi = torch.where((corr > 0)[..., None], wi_fixed, wi)
    ok = torch.abs(woz) > 1e-9
    return wi, ok


# public API (the signatures of bsdf_lambert)

def is_specular_material(sd):
    return (sd.transmission > 0.999) | (sd.roughness <= 0.001)


def evaluate(sd, i_n, wo, wi):
    """EvaluateBSDF (disney.h:298-335). Returns (bsdf [N,3], pdf [N])."""
    spec = is_specular_material(sd)
    t, b = _frame(i_n, sd)
    w_d, w_sh, w_sp, w_c = _lobe_weights(sd)
    v_d, p_d = _evaluate_diffuse(sd, i_n, wo, wi)
    v_sh, p_sh = _evaluate_sheen(sd, wo, wi)
    v_sp, p_sp = _evaluate_mf(sd, i_n, t, b, wo, wi, ggx=True)
    v_c, p_c = _evaluate_mf(sd, i_n, t, b, wo, wi, ggx=False)
    value = (torch.where((w_d > 0)[..., None], v_d, 0.0)
             + torch.where((w_sh > 0)[..., None], v_sh, 0.0)
             + torch.where(((w_sp > 0) & (p_sp > 0))[..., None], v_sp, 0.0)
             + torch.where(((w_c > 0) & (p_c > 0))[..., None], v_c, 0.0))
    pdf = (torch.where(w_d > 0, w_d * p_d, 0.0)
           + torch.where(w_sh > 0, w_sh * p_sh, 0.0)
           + torch.where(w_sp > 0, w_sp * p_sp, 0.0)
           + torch.where(w_c > 0, w_c * p_c, 0.0))
    return (torch.where(spec[..., None], 0.0, value),
            torch.where(spec, 0.0, pdf))


def sample(sd, i_n, n_geom, wo, distance, r3, r4):
    """SampleBSDF (disney.h:203-297), masked. Returns dict(wi, pdf, bsdf,
    specular) like bsdf_lambert.sample. r4 selects transmission and the
    lobe, r3 is the second dimension (the reference's r0 / r1)."""
    flip = torch.where(dot(wo, n_geom) < 0, -1.0, 1.0)
    i_n = i_n * flip[:, None]
    n_flip = n_geom * flip[:, None]
    t, b = _frame(i_n, sd)

    # dielectric path (shared with lambert; disney.h:211-234)
    eio = torch.where(flip < 0, 1.0 / torch.clamp(sd.eta, min=1e-6), sd.eta)
    fr = _fr_l(dot(i_n, wo), eio)
    beer = torch.exp(-sd.absorption * (distance * 2.0)[:, None])
    wi_refl = reflect(-wo, i_n)
    refl_ok = dot(n_flip, wi_refl) > 0
    bsdf_refl = sd.color * beer / torch.clamp(
        torch.abs(dot(i_n, wi_refl))[:, None], min=1e-9)
    wt, refr_ok = _refract_l(wo, i_n, eio)
    bsdf_refr = sd.color * beer / torch.clamp(
        torch.abs(dot(i_n, wt))[:, None], min=1e-9)
    t_reflects = r3 < fr
    wi_t = torch.where(t_reflects[:, None], wi_refl, wt)
    bsdf_t = torch.where(t_reflects[:, None], bsdf_refl,
                         torch.where(refr_ok[:, None], bsdf_refr, 0.0))
    pdf_t = torch.where(t_reflects & ~refl_ok, 0.0, 1.0)

    # lobe CDF (disney.h:239-247). The pick and the renormalised random are
    # sampling quantities, detached as the JAX package stop_gradients them:
    # differentiating the renormalisation gave NaN gradients at near-empty
    # lobes, for a discrete-choice term the estimator drops anyway
    transmit = r4 < sd.transmission.detach()
    r3n = ((r4 - sd.transmission)
           / torch.clamp(1.0 - sd.transmission, min=1e-9)).detach()
    w_d, w_sh, w_sp, w_c = _lobe_weights(sd)
    c0, c1, c2 = w_d.detach(), (w_d + w_sh).detach(), \
        (w_d + w_sh + w_sp).detach()
    pick_d = r3n < c0
    pick_sh = (r3n >= c0) & (r3n < c1)
    pick_sp = (r3n >= c1) & (r3n < c2)
    pick_c = r3n >= c2

    # renormalised first random of the picked lobe
    r2 = torch.where(
        pick_d, r3n / torch.clamp(c0, min=1e-9),
        torch.where(pick_sh, (r3n - c0) / torch.clamp(c1 - c0, min=1e-9),
                    torch.where(pick_sp,
                                (r3n - c1) / torch.clamp(c2 - c1, min=1e-9),
                                (r3n - c2) / torch.clamp(1.0 - c2,
                                                         min=1e-9))))
    r1 = r3  # second dimension

    # candidate directions per lobe
    ch = cosine_hemisphere(r2, r1)
    wi_cos = normalize(_to_world(ch[..., 0], ch[..., 1], ch[..., 2],
                                 i_n, t, b))
    wi_sp, _ = _sample_mf(sd, i_n, t, b, n_flip, wo, r2, r1, ggx=True)
    wi_co, _ = _sample_mf(sd, i_n, t, b, n_flip, wo, r2, r1, ggx=False)
    wi = torch.where(pick_sp[:, None], wi_sp,
                     torch.where(pick_c[:, None], wi_co, wi_cos))

    # combined value + pdf over all lobes (MIS inside the BSDF)
    v_d, p_d = _evaluate_diffuse(sd, i_n, wo, wi)
    v_sh, p_sh = _evaluate_sheen(sd, wo, wi)
    v_sp, p_sp = _evaluate_mf(sd, i_n, t, b, wo, wi, ggx=True)
    v_c, p_c = _evaluate_mf(sd, i_n, t, b, wo, wi, ggx=False)
    value = (torch.where((w_d > 0)[:, None], v_d, 0.0)
             + torch.where((w_sh > 0)[:, None], v_sh, 0.0)
             + torch.where((w_sp > 0)[:, None], v_sp, 0.0)
             + torch.where((w_c > 0)[:, None], v_c, 0.0))
    pdf_lobes = w_d * p_d + w_sh * p_sh + w_sp * p_sp + w_c * p_c
    # a sampled direction below the surface is a dead sample
    below = dot(wi, i_n) <= 0
    pdf_lobes = torch.where(below & ~(pick_sp | pick_c), 0.0, pdf_lobes)

    wi_out = torch.where(transmit[:, None], wi_t, wi)
    bsdf_out = torch.where(transmit[:, None], bsdf_t, value)
    pdf_out = torch.where(transmit, pdf_t, pdf_lobes)
    return dict(wi=wi_out, pdf=pdf_out, bsdf=bsdf_out, specular=transmit)
