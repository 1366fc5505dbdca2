"""Lambert + pure-specular + dielectric BSDF (sharedBSDFs/lambert.h).

Counterpart of lighthouse2_tpu/render/bsdf_lambert.py (is_specular_material,
evaluate, sample and their Fresnel / refraction helpers), branch-free and
masked exactly as there. Difference: the cosines of the refracted direction
under total internal reflection (_fr_l, _refract_l) use geometry.sqrt0,
whose gradient is 0 where the JAX package's is NaN; the values are equal.
"""
from __future__ import annotations

import math

import torch

from lighthouse2_tpu_torch.core.geometry import (
    dot, normalize, reflect, sqrt0, tangent_to_world)
from lighthouse2_tpu_torch.core.sampling import cosine_hemisphere

INV_PI = 1.0 / math.pi
SPECULAR_TRANSMISSION = 0.999   # lambert.h:64
SPECULAR_ROUGHNESS = 0.001


def is_specular_material(sd):
    """lambert.h:64 / pathtracer.h:154 pure-specular detection."""
    return ((sd.transmission > SPECULAR_TRANSMISSION)
            | (sd.roughness <= SPECULAR_ROUGHNESS))


def _fr_l(v_dot_n, eio):
    """Exact dielectric Fresnel Fr_L (lambert.h:33-46)."""
    flip = v_dot_n < 0.0
    eio = torch.where(flip, 1.0 / eio, eio)
    v_dot_n = torch.abs(v_dot_n)
    sin_t2 = eio * eio * (1.0 - v_dot_n * v_dot_n)
    tir = sin_t2 > 1.0
    l_dot_n = sqrt0(1.0 - sin_t2)
    r1 = (v_dot_n - eio * l_dot_n) / torch.clamp(v_dot_n + eio * l_dot_n,
                                                 min=1e-20)
    r2 = (l_dot_n - eio * v_dot_n) / torch.clamp(l_dot_n + eio * v_dot_n,
                                                 min=1e-20)
    return torch.where(tir, 1.0, 0.5 * (r1 * r1 + r2 * r2))


def _refract_l(wi, n, eta):
    """Refract_L (lambert.h:49-57). Returns (wt, ok)."""
    cos_i = torch.abs(dot(n, wi))
    sin2_i = torch.clamp(1.0 - cos_i * cos_i, min=0.0)
    sin2_t = eta * eta * sin2_i
    ok = sin2_t < 1.0
    cos_t = sqrt0(1.0 - sin2_t)
    wt = eta[..., None] * (-wi) + (eta * cos_i - cos_t)[..., None] * n
    return wt, ok


def evaluate(sd, i_n, wo, wi):
    """EvaluateBSDF (lambert.h:60-70). Returns (bsdf [N,3], pdf [N])."""
    spec = is_specular_material(sd)
    pdf = torch.where(spec, 0.0, torch.abs(dot(wi, i_n)) * INV_PI)
    bsdf = torch.where(spec[:, None], 0.0, sd.color * INV_PI)
    return bsdf, pdf


def sample(sd, i_n, n_geom, wo, distance, r3, r4):
    """SampleBSDF (lambert.h:72-125), masked. wo points away from the
    surface. Returns dict(wi [N,3], pdf [N], bsdf [N,3], specular [N])."""
    flip = torch.where(dot(wo, n_geom) < 0, -1.0, 1.0)
    i_n = i_n * flip[:, None]

    # dielectric branch (r4 < TRANSMISSION)
    eio = torch.where(flip < 0, 1.0 / torch.clamp(sd.eta, min=1e-6), sd.eta)
    f = _fr_l(dot(i_n, wo), eio)
    # Beer: exp(-absorption * dist * 2) (lambert.h:87-89); the shade stage
    # zeroes the absorption of front-side hits
    beer = torch.exp(-sd.absorption * (distance * 2.0)[:, None])
    wi_refl = reflect(-wo, i_n)
    bsdf_refl = sd.color * beer / torch.clamp(
        torch.abs(dot(i_n, wi_refl))[:, None], min=1e-9)
    wt, refr_ok = _refract_l(wo, i_n, eio)
    bsdf_refr = sd.color * beer / torch.clamp(
        torch.abs(dot(i_n, wt))[:, None], min=1e-9)
    t_reflects = r3 < f
    wi_t = torch.where(t_reflects[:, None], wi_refl, wt)
    bsdf_t = torch.where(t_reflects[:, None], bsdf_refl,
                         torch.where(refr_ok[:, None], bsdf_refr, 0.0))

    # reflective branch (r4 >= TRANSMISSION)
    p_reflect = 1.0 - sd.roughness
    pure_spec = r3 < p_reflect
    bsdf_mirror = sd.color / torch.clamp(
        torch.abs(dot(i_n, wi_refl))[:, None], min=1e-9)
    r5 = (r3 - p_reflect) / torch.clamp(1.0 - p_reflect, min=1e-9)
    r6 = (r4 - sd.transmission) / torch.clamp(1.0 - sd.transmission, min=1e-9)
    wi_diff = normalize(tangent_to_world(cosine_hemisphere(r5, r6), i_n))
    pdf_diff = torch.clamp(dot(wi_diff, i_n), min=0.0) * INV_PI
    bsdf_diff = sd.color * INV_PI

    wi_r = torch.where(pure_spec[:, None], wi_refl, wi_diff)
    bsdf_r = torch.where(pure_spec[:, None], bsdf_mirror, bsdf_diff)
    pdf_r = torch.where(pure_spec, 1.0, pdf_diff)

    transmit = r4 < sd.transmission
    wi = torch.where(transmit[:, None], wi_t, wi_r)
    bsdf = torch.where(transmit[:, None], bsdf_t, bsdf_r)
    pdf = torch.where(transmit, 1.0, pdf_r)
    specular = transmit | pure_spec

    # APPLYSAFENORMALS (lambert.h:122): kill samples below the geometric plane
    below = dot(n_geom * flip[:, None], wi) <= 0.0
    pdf = torch.where(below, 0.0, pdf)
    return dict(wi=wi, pdf=pdf, bsdf=bsdf, specular=specular)
