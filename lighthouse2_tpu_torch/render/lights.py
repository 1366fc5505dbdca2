"""Light importance sampling, vectorized over all lights per ray.

Counterpart of lighthouse2_tpu/render/lights.py (potential_contributions,
calculate_light_pdf, light_pick_prob, sky_pick_prob, random_point_on_light,
and the emission sampling of bidirectional transport: sample_emission,
emission_pick_prob) for the four analytic light types and the sky as an NEE
light (IBL).
Per-light-per-ray intermediates are [L, N], rays on the minor axis, as in
the JAX package. Unified light index space: [0, LT) area, [LT, LT+LP)
point, then spot, then directional, then (with IBL) the sky as the last
slot. potential_contributions returns the potentials only, where the JAX
function also returns the slot layout, which no caller reads.
sample_emission finds its energy-proportional pick with torch.searchsorted
over the light CDF, where JAX counts `cdf < r0 * tot` over an [L, N]
matrix: the same index (the first CDF entry >= r0 * tot), without a matrix
of lights x lanes. The actual light counts are the static s_tri / s_point
ints (JAX's device scalars n_tri / n_point).
"""
from __future__ import annotations

import math

import torch

from lighthouse2_tpu_torch.core.geometry import dot, normalize, tangent_to_world
from lighthouse2_tpu_torch.core.sampling import (
    cosine_hemisphere, random_barycentrics)
from lighthouse2_tpu_torch.render.sky import sample_sky
from lighthouse2_tpu_torch.scene.device_scene import DeviceLights, DeviceSky

DIR_LIGHT_DISTANCE = 1000.0  # lights_shared.h:257 (I - 1000*L)


def _comps(a):
    """[K,3] light-constant array -> three [K,1] column vectors."""
    return a[:, 0:1], a[:, 1:2], a[:, 2:3]


def _rows(v):
    """[N,3] ray array -> three [1,N] rows."""
    return v[:, 0][None], v[:, 1][None], v[:, 2][None]


def _normalize3(x, y, z):
    d2 = x * x + y * y + z * z
    inv = torch.where(d2 > 0, 1.0 / torch.sqrt(torch.clamp(d2, min=1e-30)), 0.0)
    return x * inv, y * inv, z * inv, d2


def _present(lights: DeviceLights):
    return (lights.s_tri > 0, lights.s_point > 0, lights.s_spot > 0,
            lights.s_dir > 0)


def potential_contributions(lights: DeviceLights, i_pos, n, area_point=None):
    """Potential light contributions [L_eff, N] from points i_pos [N,3] with
    normals n [N,3]; area_point optionally gives per-ray target points on
    each area light as ([LT,N] x, y, z) rows (default: the light centre).
    Absent light types contribute no rows."""
    has_a, has_p, has_s, has_d = _present(lights)
    ix, iy, iz = _rows(i_pos)
    nx, ny, nz = _rows(n)
    n_rays = ix.shape[1]
    blocks = []

    if has_a:          # PotentialAreaLightContribution, lights_shared.h:36-58
        lt = lights.tri_v0.shape[0]
        if area_point is not None:
            tx, ty, tz = area_point
        else:
            tx, ty, tz = (torch.broadcast_to(c, (lt, n_rays))
                          for c in _comps(lights.tri_centre))
        lx, ly, lz, d2 = _normalize3(tx - ix, ty - iy, tz - iz)
        att = 1.0 / torch.clamp(d2, min=1e-12)
        tnx, tny, tnz = _comps(lights.tri_n)
        ln_dot_l = torch.clamp(-(tnx * lx + tny * ly + tnz * lz), min=0.0)
        n_dot_l = torch.clamp(nx * lx + ny * ly + nz * lz, min=0.0)
        blocks.append(lights.tri_energy[:, None] * ln_dot_l * n_dot_l * att)

    if has_p:          # lights_shared.h:64-73
        px, py, pz = _comps(lights.point_pos)
        lx, ly, lz, d2 = _normalize3(px - ix, py - iy, pz - iz)
        blocks.append(lights.point_energy[:, None]
                      * torch.clamp(nx * lx + ny * ly + nz * lz, min=0.0)
                      / torch.clamp(d2, min=1e-12))

    if has_s:          # lights_shared.h:79-92
        sx, sy, sz = _comps(lights.spot_pos)
        lx, ly, lz, d2 = _normalize3(sx - ix, sy - iy, sz - iz)
        dx, dy, dz = _comps(lights.spot_dir)
        fall = ((torch.clamp(-(lx * dx + ly * dy + lz * dz), min=0.0)
                 - lights.spot_cos_outer[:, None])
                / torch.clamp((lights.spot_cos_inner
                               - lights.spot_cos_outer)[:, None], min=1e-6))
        blocks.append(lights.spot_energy[:, None] * torch.clamp(fall, 0.0, 1.0)
                      * torch.clamp(nx * lx + ny * ly + nz * lz, min=0.0)
                      / torch.clamp(d2, min=1e-12))

    if has_d:          # lights_shared.h:100-107
        dx, dy, dz = _comps(lights.dir_dir)
        blocks.append(lights.dir_energy[:, None] * torch.clamp(
            -(nx * dx + ny * dy + nz * dz), min=0.0))

    if not blocks:
        return torch.zeros((0, n_rays), device=i_pos.device)
    return torch.cat(blocks, dim=0)


def calculate_light_pdf(d, t, light_area, light_normal):
    """Solid-angle pdf of hitting a light (lights_shared.h:113-116)."""
    return (t * t) / (-dot(d, light_normal) * light_area)


def _pick_row(mat, idx):
    """mat[idx[n], n] for [L,N] mat and [N] idx."""
    return mat.gather(0, idx.to(torch.int64)[None])[0]


def _has_ibl(sky) -> bool:
    return sky is not None and sky.has_ibl


def light_pick_prob(lights: DeviceLights, ltri_idx, o, last_n, i_pos,
                    sky: DeviceSky | None = None):
    """MIS pick probability for an implicit area-light hit
    (lights_shared.h:123-138): potentials from the previous vertex o/last_n,
    area lights evaluated toward the actual hit point i_pos. With an IBL
    sky its potential joins the normalisation, so the pick probabilities
    stay a partition of unity over all slots."""
    if not _present(lights)[0]:
        return torch.zeros(i_pos.shape[0], device=i_pos.device)
    lt = lights.tri_v0.shape[0]
    n = i_pos.shape[0]
    target = tuple(torch.broadcast_to(c, (lt, n)) for c in _rows(i_pos))
    pot = potential_contributions(lights, o, last_n, area_point=target)
    s = pot.sum(dim=0)
    if _has_ibl(sky):
        s = s + sky.nee_energy
    p = _pick_row(pot, torch.clamp(ltri_idx, 0, pot.shape[0] - 1))
    return torch.where(s > 0, p / torch.where(s > 0, s, 1.0), 0.0)


def sky_pick_prob(lights: DeviceLights, sky: DeviceSky, o, last_n):
    """Probability that NEE at the previous vertex picked the sky slot: the
    skydome counterpart of light_pick_prob for MIS on misses."""
    pot = potential_contributions(lights, o, last_n)
    s = pot.sum(dim=0) + sky.nee_energy
    return torch.where(s > 0, sky.nee_energy / torch.where(s > 0, s, 1.0),
                       0.0)


def random_point_on_light(lights: DeviceLights, r0, r1, i_pos, n,
                          sky: DeviceSky | None = None, r2=None, r3=None):
    """RandomPointOnLight (lights_shared.h:172-261), vectorized.

    An IBL `sky` adds the skydome as the last slot of the pick CDF, with
    potential sky.nee_energy: a lane that picks it importance-samples a
    direction with sample_sky(r2, r3) and gets a virtual point at
    DIR_LIGHT_DISTANCE along it, with the solid-angle pdf.

    Returns dict(point [N,3], light_pdf [N], pick_prob [N], color [N,3],
    ltri [N] — the picked area-light slot, or -1 for delta lights)."""
    has_a, has_p, has_s, has_d = _present(lights)
    has_sky = _has_ibl(sky)
    n_rays = i_pos.shape[0]
    dev = i_pos.device
    zero = torch.zeros((n_rays,), device=dev)
    if not (has_a or has_p or has_s or has_d or has_sky):
        return dict(point=i_pos + 1.0, light_pdf=zero, pick_prob=zero,
                    color=torch.zeros((n_rays, 3), device=dev),
                    ltri=torch.full((n_rays,), -1, dtype=torch.int64,
                                    device=dev))
    lt = lights.tri_v0.shape[0] if has_a else 0
    lp = lights.point_pos.shape[0] if has_p else 0
    ls = lights.spot_pos.shape[0] if has_s else 0
    ld = lights.dir_dir.shape[0] if has_d else 0

    area_pt = None
    if has_a:
        bu, bv = random_barycentrics(r0)
        bw = 1.0 - bu - bv
        v0x, v0y, v0z = _comps(lights.tri_v0)
        v1x, v1y, v1z = _comps(lights.tri_v1)
        v2x, v2y, v2z = _comps(lights.tri_v2)
        bu_, bv_, bw_ = bu[None], bv[None], bw[None]
        ptx = bu_ * v0x + bv_ * v1x + bw_ * v2x
        pty = bu_ * v0y + bv_ * v1y + bw_ * v2y
        ptz = bu_ * v0z + bv_ * v1z + bw_ * v2z
        area_pt = (ptx, pty, ptz)

    pot = potential_contributions(lights, i_pos, n, area_point=area_pt)
    if has_sky:
        pot = torch.cat([pot, torch.broadcast_to(sky.nee_energy,
                                                 (1, n_rays))], dim=0)
    s = pot.sum(dim=0)
    cdf = torch.cumsum(pot, dim=0)
    pick = (cdf < (r1 * s)[None]).to(torch.int64).sum(dim=0)
    pick = torch.clamp(pick, 0, pot.shape[0] - 1)
    pick_prob = _pick_row(pot, pick) / torch.where(s > 0, s, 1.0)
    pick_prob = torch.where(s > 0, pick_prob, 0.0)

    ix, iy, iz = i_pos[:, 0], i_pos[:, 1], i_pos[:, 2]
    nx, ny, nz = n[:, 0], n[:, 1], n[:, 2]

    def g(const_k3, idx):
        """[K,3] light constants gathered by [N] idx -> rows [3,N]."""
        return const_k3.T[:, idx]

    px, py, pz = ix + 1.0, iy, iz          # finite dummy (pdf=0 lanes)
    light_pdf = zero
    col = [zero, zero, zero]
    ltri = torch.full((n_rays,), -1, dtype=torch.int64, device=dev)

    if has_a:          # area light sample (lights_shared.h:205-221)
        is_area = pick < lt
        a_i = torch.clamp(pick, 0, lt - 1)
        pax, pay, paz = (_pick_row(c, a_i) for c in area_pt)
        lrx_n, lry_n, lrz_n, sq = _normalize3(ix - pax, iy - pay, iz - paz)
        tn = g(lights.tri_n, a_i)
        ln_dot_l = lrx_n * tn[0] + lry_n * tn[1] + lrz_n * tn[2]
        to_n = lrx_n * nx + lry_n * ny + lrz_n * nz
        area_ok = (ln_dot_l > 0) & (to_n < 0)
        den = lights.tri_area[a_i] * ln_dot_l
        pdf_area = torch.where(area_ok, sq / torch.where(
            area_ok, torch.clamp(den, min=1e-30), 1.0), 0.0)
        ca = g(lights.tri_radiance, a_i)
        px = torch.where(is_area, pax, px)
        py = torch.where(is_area, pay, py)
        pz = torch.where(is_area, paz, pz)
        light_pdf = torch.where(is_area, pdf_area, light_pdf)
        col = [torch.where(is_area, ca[c], col[c]) for c in range(3)]
        ltri = torch.where(is_area, a_i, ltri)

    if has_p:          # point light (lights_shared.h:224-233)
        is_point = (pick >= lt) & (pick < lt + lp)
        p_i = torch.clamp(pick - lt, 0, lp - 1)
        pp = g(lights.point_pos, p_i)
        lrx_n, lry_n, lrz_n, sq_p = _normalize3(ix - pp[0], iy - pp[1],
                                                iz - pp[2])
        pdf_point = torch.where(lrx_n * nx + lry_n * ny + lrz_n * nz < 0,
                                sq_p, 0.0)
        cp = g(lights.point_radiance, p_i)
        px = torch.where(is_point, pp[0], px)
        py = torch.where(is_point, pp[1], py)
        pz = torch.where(is_point, pp[2], pz)
        light_pdf = torch.where(is_point, pdf_point, light_pdf)
        col = [torch.where(is_point, cp[c], col[c]) for c in range(3)]

    if has_s:          # spot light (lights_shared.h:236-250)
        is_spot = (pick >= lt + lp) & (pick < lt + lp + ls)
        s_i = torch.clamp(pick - lt - lp, 0, ls - 1)
        sp = g(lights.spot_pos, s_i)
        sd = g(lights.spot_dir, s_i)
        lrx_n, lry_n, lrz_n, sq_s = _normalize3(ix - sp[0], iy - sp[1],
                                                iz - sp[2])
        ci = lights.spot_cos_inner[s_i]
        co = lights.spot_cos_outer[s_i]
        dfall = ((torch.clamp(lrx_n * sd[0] + lry_n * sd[1] + lrz_n * sd[2],
                              min=0.0) - co)
                 / torch.clamp(ci - co, min=1e-6))
        ln_dot_l_s = torch.clamp(dfall, max=1.0)
        spot_ok = (ln_dot_l_s > 0) & (lrx_n * nx + lry_n * ny + lrz_n * nz < 0)
        pdf_spot = torch.where(spot_ok, sq_s / torch.where(
            spot_ok, torch.clamp(ln_dot_l_s, min=1e-30), 1.0), 0.0)
        cs = g(lights.spot_radiance, s_i)
        px = torch.where(is_spot, sp[0], px)
        py = torch.where(is_spot, sp[1], py)
        pz = torch.where(is_spot, sp[2], pz)
        light_pdf = torch.where(is_spot, pdf_spot, light_pdf)
        col = [torch.where(is_spot, cs[c], col[c]) for c in range(3)]

    if has_d:          # directional light (lights_shared.h:253-259)
        is_dir = pick >= lt + lp + ls
        d_i = torch.clamp(pick - lt - lp - ls, 0, ld - 1)
        dd = g(lights.dir_dir, d_i)
        pdf_dir = torch.where(dd[0] * nx + dd[1] * ny + dd[2] * nz < 0,
                              1.0, 0.0)
        cd = g(lights.dir_radiance, d_i)
        px = torch.where(is_dir, ix - DIR_LIGHT_DISTANCE * dd[0], px)
        py = torch.where(is_dir, iy - DIR_LIGHT_DISTANCE * dd[1], py)
        pz = torch.where(is_dir, iz - DIR_LIGHT_DISTANCE * dd[2], pz)
        light_pdf = torch.where(is_dir, pdf_dir, light_pdf)
        col = [torch.where(is_dir, cd[c], col[c]) for c in range(3)]

    if has_sky:        # the sky slot, last
        is_sky = pick >= lt + lp + ls + ld
        ss = sample_sky(sky, r2, r3)
        sdir = ss["dir"]
        px = torch.where(is_sky, ix + DIR_LIGHT_DISTANCE * sdir[:, 0], px)
        py = torch.where(is_sky, iy + DIR_LIGHT_DISTANCE * sdir[:, 1], py)
        pz = torch.where(is_sky, iz + DIR_LIGHT_DISTANCE * sdir[:, 2], pz)
        light_pdf = torch.where(is_sky, ss["pdf"], light_pdf)
        col = [torch.where(is_sky, ss["radiance"][:, c], col[c])
               for c in range(3)]

    light_pdf = torch.where(s > 0, light_pdf, 0.0)
    return dict(point=torch.stack([px, py, pz], dim=-1), light_pdf=light_pdf,
                pick_prob=pick_prob, color=torch.stack(col, dim=-1), ltri=ltri)


# ---------------------------------------------------------------------------
# Emission sampling for bidirectional transport (Sample_Le analog,
# lights_shared.h:267-409)
# ---------------------------------------------------------------------------

def _emission_energies(lights: DeviceLights):
    """Energies of the emission pick's slots: [area..., point...], padding
    rows masked to 0."""
    lt = lights.tri_v0.shape[0]
    lp = lights.point_pos.shape[0]
    dev = lights.tri_energy.device
    tri = lights.tri_energy * (torch.arange(lt, device=dev) < lights.s_tri)
    point = (lights.point_energy
             * (torch.arange(lp, device=dev) < lights.s_point))
    return tri, point


def sample_emission(lights: DeviceLights, r0, r1, r2, r3):
    """Sample a light-subpath origin and emission direction.

    The light pick is energy-proportional over area and point lights (spot
    and directional lights contribute through the eye walk's strategies).
    Area: a uniform point on the triangle, cosine emission about its
    normal; point: a uniform sphere. Returns a dict of [N] / [N,3] tensors:
    origin, dir, normal (dir for a point light), radiance, pdf_pos (area
    measure x pick probability; the pick probability alone for a delta
    light), pdf_dir (solid angle), ltri (the picked area-light slot, or -1),
    delta_pos (a point light) and pick_prob."""
    lt = lights.tri_v0.shape[0]
    lp = lights.point_pos.shape[0]
    en = torch.cat(_emission_energies(lights), 0)          # [lt+lp]
    tot = en.sum()
    cdf = torch.cumsum(en, 0)
    pick = torch.searchsorted(cdf, (r0 * tot).contiguous())
    pick = torch.clamp(pick, 0, lt + lp - 1)
    pick_prob = en[pick] / torch.where(tot > 0, tot, 1.0)

    is_area = pick < lt
    a_i = torch.clamp(pick, 0, lt - 1)
    p_i = torch.clamp(pick - lt, 0, lp - 1)

    # area: uniform point on the triangle, cosine emission about its normal
    bu, bv = random_barycentrics(r1)
    bw = 1.0 - bu - bv
    apos = (bu[:, None] * lights.tri_v0[a_i] + bv[:, None] * lights.tri_v1[a_i]
            + bw[:, None] * lights.tri_v2[a_i])
    an = lights.tri_n[a_i]
    adir = normalize(tangent_to_world(cosine_hemisphere(r2, r3), an))
    acos = torch.clamp(dot(adir, an), min=0.0)
    apdf_dir = acos * (1.0 / math.pi)
    apdf_pos = pick_prob / torch.clamp(lights.tri_area[a_i], min=1e-12)

    # point: uniform sphere
    z = 1.0 - 2.0 * r2
    rr = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * r3
    pdir = torch.stack([rr * torch.cos(phi), rr * torch.sin(phi), z], -1)
    ppos = lights.point_pos[p_i]

    area = is_area[:, None]
    return dict(
        origin=torch.where(area, apos, ppos),
        dir=torch.where(area, adir, pdir),
        normal=torch.where(area, an, pdir),
        radiance=torch.where(area, lights.tri_radiance[a_i],
                             lights.point_radiance[p_i]),
        pdf_pos=torch.where(is_area, apdf_pos, pick_prob),
        pdf_dir=torch.where(is_area, apdf_dir, 1.0 / (4.0 * math.pi)),
        ltri=torch.where(is_area, a_i, -1),
        delta_pos=~is_area,
        pick_prob=pick_prob,
    )


def emission_pick_prob(lights: DeviceLights, ltri):
    """The probability with which sample_emission picks area light `ltri`
    (0 where ltri < 0): BDPT's MIS needs it for the ratios between the
    strategies with and without a light-sampled vertex."""
    lt = lights.tri_v0.shape[0]
    tri, point = _emission_energies(lights)
    tot = tri.sum() + point.sum()
    e = lights.tri_energy[torch.clamp(ltri, 0, lt - 1)]
    return torch.where(ltri >= 0, e / torch.where(tot > 0, tot, 1.0), 0.0)
