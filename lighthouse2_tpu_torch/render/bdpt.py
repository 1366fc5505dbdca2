"""The bidirectional path tracer (RenderCore_OptixPrime_BDPT), in PyTorch.

Counterpart of lighthouse2_tpu/render/bdpt.py (_remap0, _f_pdf, _to_area,
_walk, _eye_ratio_chain, _light_ratio_chain, trace_paths_bdpt,
render_pass_bdpt, render_pass_bdpt_jit; the last runs the same code,
eagerly, where JAX jit-compiles it). Both subpaths are lists of vertex
batches, [N] lanes per vertex and at most LIGHT_DEPTH / EYE_DEPTH vertices
a side:

  1. the eye walk from generate_eye_rays and the light walk from
     lights.sample_emission, each a BSDF random walk that traces every
     step as one batch (the closest-hit kernel on a card);
  2. s=0: sky on a miss and implicit emissive hits, during the eye walk;
  3. every (s>=1, t>=2) strategy: one connection batch of N lanes, both
     junction BSDFs, the geometry term and one visibility batch (the
     any-hit kernel);
  4. t=1: each light vertex connects to one point of the 9-bladed lens and
     splats into the pixel its projection lands in (light tracing), with
     the film-measure camera pdf p_omega = f_ax^2 / (A_film cos^3).

MIS is the balance heuristic over the strategies this core samples, by
Veach's pdf-ratio recurrence over the stored per-vertex area pdfs; delta
vertices are remapped to 1 and their flanking strategies gated out. The
reference's arithmetic and gates are kept as they are: the Lambert
`roughness` scaling of f and pdf (_f_pdf), the connection gate on
light-walk vertices that lie on an emitter, the film-measure camera pdf,
and the scope notes of the JAX module (light subpaths start on area and
point lights; the sky only through s=0 misses; t=1 ignores barrel
distortion and does not splat delta-position lights).

Differences from the JAX package:
  - the JAX module reads the debugging shell variables BDPT_T1_SCALE and
    BDPT_NO_T1_CHAINS when it is imported; this module reads neither and
    keeps their defaults: the t=1 splats at scale 1 and the t=1 strategy
    in the eye-side MIS chain;
  - whether the scene has an area or point light is a host bool (the
    static s_tri / s_point counts), where JAX tests device scalars; the
    light walk is traced either way, so the launches do not depend on it;
  - the t=1 pixel coordinates are clamped in float (NaN to 0) before the
    integer conversion, which XLA saturates and ATen leaves undefined;
    only lanes that are not splatted can hold such values;
  - the splat is an index_add_, whose order of adds on a card differs
    from run to run in the last bits;
  - the radiance and the primary depth are accumulated in two tensors and
    joined at the end, where JAX adds into the [N, 4] accumulator's slices.
"""
from __future__ import annotations

import math

import torch

from lighthouse2_tpu_torch.core import rng as rng_mod
from lighthouse2_tpu_torch.core.geometry import (
    cross, dot, normalize, safe_origin)
from lighthouse2_tpu_torch.core.types import RenderConfig, ViewPyramid
from lighthouse2_tpu_torch.render import bsdf_disney, bsdf_lambert
from lighthouse2_tpu_torch.render.lights import (
    emission_pick_prob, sample_emission)
from lighthouse2_tpu_torch.render.sky import sample_skydome
from lighthouse2_tpu_torch.render.wavefront import (
    AccumState, _clamp_intensity, _fixnan, _intersect, _occluded,
    generate_eye_rays, make_shading, prepare_cluster_pay, untile_image)

# per-side depth cap (RenderCore_OptixPrime_BDPT/core_settings.h:45-47)
LIGHT_DEPTH = 5
EYE_DEPTH = 5


def _remap0(x):
    """Veach remap: a 0 pdf (delta / unset) contributes a neutral ratio."""
    return torch.where(x != 0.0, x, 1.0)


def _f_pdf(bsdf_mod, config: RenderConfig, sd, wo, wi):
    """Junction BSDF evaluate: (f [N,3], solid-angle pdf [N]). For Lambert
    both are scaled by `roughness`, the probability of the diffuse lobe
    (lambert.h:72-125 picks the mirror with 1 - roughness without folding
    it into the pdf), so the connections stay consistent with the walk's
    marginals."""
    f, pdf = bsdf_mod.evaluate(sd, sd.n_shading, wo, wi)
    if config.bsdf == "lambert":
        f = f * sd.roughness[:, None]
        pdf = pdf * sd.roughness
    return f, pdf


def _to_area(pdf_sa, cos_at_target, dist2):
    """Solid-angle pdf at the sampling vertex -> area pdf at the target."""
    return pdf_sa * torch.abs(cos_at_target) / torch.clamp(dist2, min=1e-12)


def _walk(scene, config: RenderConfig, bsdf_mod, o, d, beta, pdf_fwd1_sa,
          seed, depth, cos_from_prev=None, pay_tiles=None):
    """The BSDF random walk shared by both subpaths (extendEyePath /
    extendLightPath). o, d: the first segment; beta [N,3]: the throughput
    arriving at vertex 1; pdf_fwd1_sa: the solid-angle pdf of d at the
    origin (None: vertex 1's pdf_fwd stays 0).

    Returns (vertices, misses): vertices[i] is a dict of [N] tensors for
    vertex i+1 (pos, sd, d_in, dist_in2, beta, pdf_fwd as an area pdf,
    valid, delta, emissive, pdf_rev_prev: the walk-reverse area pdf of
    vertex i, computed at vertex i+1); misses[i] = (mask, beta, d) of the
    lanes that escaped on segment i."""
    n = d.shape[0]
    dev = d.device
    alive = torch.isfinite(beta[:, 0])
    verts, misses = [], []
    prev_ns = pdf_fwd_sa_next = None
    for i in range(depth):
        t, prim, u, v, payload = _intersect(scene, o, d, alive, config,
                                            pay_tiles=pay_tiles)
        hit = alive & (prim >= 0)
        misses.append((alive & (prim < 0), beta, d))
        t = torch.where(hit, t, 1.0)
        sd = make_shading(scene, d, t, prim, u, v, 0.0, config, payload)
        pos = o + t[:, None] * d
        dist2 = torch.clamp(t * t, min=1e-12)
        cos_here = torch.abs(dot(d, sd.n_shading))
        if i == 0:
            pdf_fwd = (torch.zeros(n, device=dev) if pdf_fwd1_sa is None
                       else _to_area(pdf_fwd1_sa, cos_here, dist2))
        else:
            pdf_fwd = _to_area(pdf_fwd_sa_next, cos_here, dist2)
        vert = dict(pos=pos, sd=sd, d_in=d, dist_in2=dist2, beta=beta,
                    pdf_fwd=pdf_fwd, valid=hit,
                    delta=bsdf_mod.is_specular_material(sd),
                    emissive=hit & sd.emissive)

        # sample the continuation (which also gives vertex i-1's reverse pdf)
        seed, r3 = rng_mod.random_float(seed)
        seed, r4 = rng_mod.random_float(seed)
        smp = bsdf_mod.sample(sd, sd.n_shading, sd.n_geom, -d, t, r3, r4)
        if config.bsdf == "lambert":
            # the diffuse lobe's marginal pdf (see _f_pdf); beta's f/pdf
            # ratio is unchanged, so only MIS sees the scale
            pdf_marg = torch.where(smp["specular"], 0.0,
                                   smp["pdf"] * sd.roughness)
        else:
            pdf_marg = torch.where(smp["specular"], 0.0, smp["pdf"])
        ok = (hit & ~sd.emissive & (smp["pdf"] > 1e-6)
              & torch.isfinite(smp["pdf"]))
        cos_out = torch.abs(dot(smp["wi"], sd.n_shading))
        new_beta = torch.where(
            ok[:, None],
            beta * smp["bsdf"]
            * (cos_out / torch.clamp(smp["pdf"], min=1e-12))[:, None], 0.0)
        new_beta = _fixnan(new_beta)

        # reverse pdf of the previous vertex: resample -d_in here with the
        # new outgoing direction as wo, converted to area at that vertex
        _, pdf_rev_sa = _f_pdf(bsdf_mod, config, sd, smp["wi"], -d)
        if i > 0:
            cos_prev = torch.abs(dot(d, prev_ns))
        elif cos_from_prev is not None:
            cos_prev = cos_from_prev          # the light origin's normal
        else:
            cos_prev = torch.ones(n, device=dev)   # eye origin (never read)
        vert["pdf_rev_prev"] = _to_area(torch.where(ok, pdf_rev_sa, 0.0),
                                        cos_prev, dist2)
        verts.append(vert)

        o = safe_origin(pos, smp["wi"], sd.n_geom * sd.face_dir[:, None],
                        config.geometry_epsilon)
        d = torch.where(ok[:, None], smp["wi"], d)
        beta = new_beta
        alive = ok
        pdf_fwd_sa_next = pdf_marg
        prev_ns = sd.n_shading
    return verts, misses


def _eye_ratio_chain(everts, j, pdf_rev_top, pdf_rev_top1, max_light,
                     s_base):
    """Eye-side MIS sum for a junction at eye vertex everts[j] (= z_{t-1},
    t = j+2). Term k moves k eye vertices to the light side: strategy
    (s_base+k, t-k) for t-k >= 2 while s_base+k <= max_light, and for
    k = j+1 the light-tracing strategy (s_base+t-1, 1). pdf_rev_top / pdf_rev_top1 are the junction-updated reverse
    area pdfs of z_{t-1} / z_{t-2}."""
    t = j + 2
    sum_ri = torch.zeros_like(everts[j]["pdf_fwd"])
    ri = 1.0
    for k in range(1, j + 2):              # k = j+1 <-> t' = 1
        zi = everts[j + 1 - k]             # z_{t-k}
        if k == 1:
            rev = pdf_rev_top
        elif k == 2:
            rev = pdf_rev_top1
        else:
            # walk-stored: z_{t-k}'s reverse pdf was computed at z_{t-k+1}
            rev = everts[j + 2 - k]["pdf_rev_prev"]
        ri = ri * _remap0(rev) / _remap0(zi["pdf_fwd"])
        if s_base + k > max_light:
            continue
        if t - k >= 2:
            znew = everts[j - k]           # z_{t-k-1}, the new eye endpoint
            gate = ~zi["delta"] & ~znew["delta"]
            sum_ri = sum_ri + torch.where(gate, ri, 0.0)
        else:                              # t-k == 1: the lens endpoint
            sum_ri = sum_ri + torch.where(~zi["delta"], ri, 0.0)
    return sum_ri


def _light_ratio_chain(lverts, s, pdf_rev_top, pdf_rev_top1, t, max_eye,
                       delta_light):
    """Light-side MIS sum for a junction at light vertex lverts[s-1]
    (= y_{s-1}). Term k <-> strategy (s-k, t+k), included iff t+k-1 <=
    max_eye."""
    sum_ri = torch.zeros_like(lverts[0]["pdf_fwd"])
    ri = 1.0
    for k in range(1, s + 1):
        yi = lverts[s - k]                 # y_{s-k}
        if k == 1:
            rev = pdf_rev_top
        elif k == 2:
            rev = pdf_rev_top1
        else:
            rev = lverts[s - k + 1]["pdf_rev_prev"]
        ri = ri * _remap0(rev) / _remap0(yi["pdf_fwd"])
        if t + k - 1 <= max_eye:
            if s - k >= 1:
                gate = ~yi["delta"] & ~lverts[s - k - 1]["delta"]
            else:                          # strategy (0, t+s): a pure PT hit
                gate = ~yi["delta"] & ~delta_light
            sum_ri = sum_ri + torch.where(gate, ri, 0.0)
    return sum_ri


def trace_paths_bdpt(scene, view: ViewPyramid, config: RenderConfig,
                     sample_base, cam_seed):
    """One full BDPT wavefront. Returns (acc_delta [W*H,4], cam_seed',
    stats); stats hold int32 device tensors with JAX's keys."""
    bsdf_mod = bsdf_disney if config.bsdf == "disney" else bsdf_lambert
    geo_eps = config.geometry_epsilon
    n = config.n_paths
    s_l = min(LIGHT_DEPTH, config.max_path_length)
    s_e = min(EYE_DEPTH, config.max_path_length)
    dev = view.pos.device
    lights = scene.lights
    pay_tiles = prepare_cluster_pay(scene, config)

    # ---- eye subpath --------------------------------------------------------
    paths = generate_eye_rays(view, config, sample_base)
    eseed = rng_mod.raygen_seed(paths["path_idx"] ^ 0x9E3779B9, sample_base)
    # the film-measure camera pdf p_omega = f_ax^2 / (A_film cos^3) of the
    # plane through p1/p2/p3 (ViewPyramid.imagePlane, camera.cpp:111-115),
    # in z_1's forward pdf and in the t=1 splat weight alike
    right = view.p2 - view.p1
    up = view.p3 - view.p1
    plane_n = normalize(cross(right, up)[None])[0]
    view_dir = (view.p1 + 0.5 * right + 0.5 * up) - view.pos
    plane_n = plane_n * torch.sign(dot(view_dir[None], plane_n[None])[0])
    a_film = torch.linalg.norm(cross(right, up))
    f_ax = dot(view.p1[None] - paths["origin"], plane_n[None])
    cos_eye = torch.clamp(dot(paths["dir"], plane_n[None]), min=1e-6)
    p_omega_eye = (f_ax * f_ax) / (a_film * cos_eye ** 3)
    everts, emisses = _walk(scene, config, bsdf_mod, paths["origin"],
                            paths["dir"], paths["throughput"], p_omega_eye,
                            eseed, s_e, pay_tiles=pay_tiles)

    # ---- light subpath ------------------------------------------------------
    lseed = rng_mod.raygen_seed(paths["path_idx"] ^ 0x85EBCA6B, sample_base)
    lseed, r0 = rng_mod.random_float(lseed)
    lseed, r1 = rng_mod.random_float(lseed)
    lseed, r2 = rng_mod.random_float(lseed)
    lseed, r3 = rng_mod.random_float(lseed)
    le = sample_emission(lights, r0, r1, r2, r3)
    any_light = (lights.s_tri + lights.s_point) > 0
    y0_beta = (le["radiance"] / torch.clamp(le["pdf_pos"], min=1e-12)[:, None]
               if any_light else torch.zeros((n, 3), device=dev))
    y0 = dict(pos=le["origin"], ns=le["normal"], beta=y0_beta,
              pdf_fwd=le["pdf_pos"],
              delta=torch.zeros(n, dtype=torch.bool, device=dev),
              delta_pos=le["delta_pos"], ltri=le["ltri"],
              valid=torch.full((n,), any_light, dtype=torch.bool, device=dev))
    # beta arriving at y1 = Le cos0 / (pdf_pos pdf_dir); delta lights carry
    # no cosine (uniform-sphere emission)
    cos0 = torch.where(le["delta_pos"], 1.0,
                       torch.abs(dot(le["dir"], le["normal"])))
    y1_beta = y0_beta * (cos0 / torch.clamp(le["pdf_dir"], min=1e-12))[:, None]
    l_origin = torch.where(le["delta_pos"][:, None], le["origin"],
                           le["origin"] + geo_eps * le["normal"])
    lverts, _ = _walk(scene, config, bsdf_mod, l_origin, le["dir"],
                      torch.where(y0["valid"][:, None], y1_beta, 0.0),
                      le["pdf_dir"], lseed, s_l - 1, cos_from_prev=cos0,
                      pay_tiles=pay_tiles)

    rgb = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    n_conn = []
    n_ext_rays = n * (s_e + max(s_l - 1, 0))

    def clamp(c):
        c = _fixnan(c)
        return (_clamp_intensity(c, config.clamp_value)
                if config.clamp_fireflies else c)

    def add(rgb, contrib, mask):
        return rgb + torch.where(mask[:, None], clamp(contrib), 0.0)

    def light_rev_top1(yv, s, w_out):
        """Junction-updated reverse area pdf of y_{s-2} when y_{s-1} = yv
        leaves along w_out, and the light chain [y0, y1, ..., y_{s-1}]."""
        if s == 1:
            return torch.zeros(n, device=dev), [y0]
        _, pdf_back_sa = _f_pdf(bsdf_mod, config, yv["sd"], w_out,
                                -yv["d_in"])
        prev_ns = y0["ns"] if s == 2 else lverts[s - 3]["sd"].n_shading
        return (_to_area(pdf_back_sa, torch.abs(dot(yv["d_in"], prev_ns)),
                         yv["dist_in2"]), [y0] + lverts[:s - 1])

    # ---- s=0: sky on a miss and implicit emissive hits ----------------------
    for miss, beta_m, d_m in emisses:
        rgb = add(rgb, beta_m * sample_skydome(scene.sky, d_m), miss)
    for j, z in enumerate(everts):
        zsd = z["sd"]
        lit = z["emissive"] & (dot(z["d_in"], zsd.n_geom) < 0)
        # MIS against the strategies (k, t-k): the junction's reverse pdfs
        # come from sample_emission's pdfs
        rev_top = (emission_pick_prob(lights, zsd.ltri)
                   / torch.clamp(zsd.area, min=1e-12))
        pdf_dir_sa = torch.abs(dot(z["d_in"], zsd.n_shading)) * (1.0 / math.pi)
        if j >= 1:
            rev_top1 = _to_area(
                pdf_dir_sa,
                torch.abs(dot(z["d_in"], everts[j - 1]["sd"].n_shading)),
                z["dist_in2"])
        else:
            rev_top1 = torch.zeros(n, device=dev)
        sum_ri = _eye_ratio_chain(everts, j, rev_top, rev_top1, max_light=s_l,
                                  s_base=0)
        w = 1.0 / (1.0 + sum_ri)
        rgb = add(rgb, z["beta"] * zsd.color * w[:, None], lit)

    # the primary depth (the .w channel of the PT accumulator contract)
    depth = (torch.where(everts[0]["valid"], torch.sqrt(everts[0]["dist_in2"]),
                         10000.0) if everts else torch.zeros(n, device=dev))

    # ---- connections (s>=1, t>=2) -------------------------------------------
    for s in range(1, s_l + 1):
        yv = y0 if s == 1 else lverts[s - 2]
        for j, z in enumerate(everts):
            zsd = z["sd"]
            w_vec = yv["pos"] - z["pos"]
            dist2 = torch.clamp(dot(w_vec, w_vec), min=1e-12)
            dist = torch.sqrt(dist2)
            dir_zy = w_vec / dist[:, None]

            # junction cosines (signed gates against the outward normals)
            z_out_n = zsd.n_geom * zsd.face_dir[:, None]
            cos_z_g = dot(dir_zy, z_out_n)
            cos_z = torch.abs(dot(dir_zy, zsd.n_shading))
            if s == 1:
                cos_y_g = torch.where(yv["delta_pos"], 1.0,
                                      dot(-dir_zy, yv["ns"]))
                cos_y = torch.abs(cos_y_g)
                f_y = 1.0
                pdf_y_toward_z_sa = torch.where(
                    yv["delta_pos"], 1.0 / (4.0 * math.pi),
                    torch.abs(cos_y_g) * (1.0 / math.pi))
                y_valid = yv["valid"]
            else:
                ysd = yv["sd"]
                cos_y_g = dot(-dir_zy, ysd.n_geom * ysd.face_dir[:, None])
                cos_y = torch.abs(dot(dir_zy, ysd.n_shading))
                f_y, pdf_y_toward_z_sa = _f_pdf(bsdf_mod, config, ysd,
                                                -yv["d_in"], -dir_zy)
                # a light-walk vertex on an emitter is a path terminal, not
                # a reflector: its classes are the (s-1, t) strategies'
                # implicit endpoints (connecting it would count them twice)
                y_valid = yv["valid"] & ~yv["emissive"]

            f_z, pdf_z_toward_y_sa = _f_pdf(bsdf_mod, config, zsd,
                                            -z["d_in"], dir_zy)
            ok = (z["valid"] & ~z["emissive"] & y_valid & ~z["delta"]
                  & ~yv["delta"] & (cos_z_g > 0) & (cos_y_g > 0))
            g_term = cos_z * cos_y / dist2
            contrib = z["beta"] * f_z * g_term[:, None] * f_y * yv["beta"]

            # visibility
            sh_o = safe_origin(z["pos"], dir_zy, z_out_n, geo_eps)
            sh_tmax = torch.where(ok, dist - 2.0 * geo_eps, 0.0)
            ok = ok & ~_occluded(scene, sh_o, dir_zy, sh_tmax, config)
            n_conn.append(ok.sum())

            # ---- MIS ----
            rev_z_top = _to_area(pdf_y_toward_z_sa, cos_z, dist2)
            if j >= 1:
                _, pdf_z_back_sa = _f_pdf(bsdf_mod, config, zsd, dir_zy,
                                          -z["d_in"])
                rev_z_top1 = _to_area(
                    pdf_z_back_sa,
                    torch.abs(dot(z["d_in"], everts[j - 1]["sd"].n_shading)),
                    z["dist_in2"])
            else:
                rev_z_top1 = torch.zeros(n, device=dev)
            sum_eye = _eye_ratio_chain(everts, j, rev_z_top, rev_z_top1,
                                       max_light=s_l, s_base=s)
            rev_y_top = _to_area(pdf_z_toward_y_sa, cos_y, dist2)
            rev_y_top1, lchain = light_rev_top1(yv, s, -dir_zy)
            sum_light = _light_ratio_chain(lchain, s, rev_y_top, rev_y_top1,
                                           j + 2, max_eye=s_e,
                                           delta_light=y0["delta_pos"])
            w_mis = 1.0 / (1.0 + sum_eye + sum_light)
            rgb = add(rgb, contrib * w_mis[:, None], ok)

    # ---- t=1: light tracing with lens splats --------------------------------
    # each light vertex connects to one lens point per lane (the eye
    # sampler's aperture convention: the lens sample is not divided out),
    # projects through the lens onto the focal plane and splats into the
    # pixel it lands in
    w_img, h_img = config.width, config.height
    wh = w_img * h_img
    splat = torch.zeros((wh, 3), dtype=torch.float32, device=dev)
    lseed, ra = rng_mod.random_float(lseed)
    lseed, rb = rng_mod.random_float(lseed)
    # 9-bladed lens sample (generate_eye_rays, .optix.cu:52-64)
    blade = torch.floor(ra * 9.0)
    r2b = (ra - blade * (1.0 / 9.0)) * 9.0
    a1 = blade * (math.pi / 4.5)
    a2 = (blade + 1.0) * (math.pi / 4.5)
    bflip = (rb + r2b) > 1.0
    br3 = torch.where(bflip, 1.0 - rb, rb)
    br2 = torch.where(bflip, 1.0 - r2b, r2b)
    lens_x = torch.sin(a1) * br3 + torch.sin(a2) * br2
    lens_y = torch.cos(a1) * br3 + torch.cos(a2) * br2
    o_l = view.pos[None] + view.aperture * (right[None] * lens_x[:, None]
                                            + up[None] * lens_y[:, None])
    rr2 = torch.clamp(dot(right, right), min=1e-12)
    uu2 = torch.clamp(dot(up, up), min=1e-12)
    pn = plane_n[None]
    f_ax_l = dot(view.p1[None] - o_l, pn)
    for s in range(1, s_l + 1):
        yv = y0 if s == 1 else lverts[s - 2]
        w_vec = o_l - yv["pos"]
        dist2 = torch.clamp(dot(w_vec, w_vec), min=1e-12)
        dist = torch.sqrt(dist2)
        dir_yl = w_vec / dist[:, None]             # y -> lens
        dir_ly = -dir_yl                           # lens -> y (the eye ray)
        # project: intersect (o_l, dir_ly) with the focal plane -> pixel
        denom = dot(dir_ly, pn)                    # cos theta at the lens
        t_pl = f_ax_l / torch.where(torch.abs(denom) > 1e-9, denom, 1e-9)
        q = o_l + t_pl[:, None] * dir_ly - view.p1[None]
        su = dot(q, right[None]) / rr2
        sv = dot(q, up[None]) / uu2
        inside = ((denom > 1e-6) & (t_pl > 0)
                  & (su >= 0) & (su < 1) & (sv >= 0) & (sv < 1))
        # clamp in float first: the lanes outside may hold NaN or huge
        # coordinates, whose integer conversion ATen leaves undefined
        px = torch.clamp(torch.nan_to_num(su * w_img, nan=0.0), 0,
                         w_img - 1).to(torch.int64)
        py = torch.clamp(torch.nan_to_num(sv * h_img, nan=0.0), 0,
                         h_img - 1).to(torch.int64)
        pix = py * w_img + px
        cos_l = torch.clamp(denom, min=1e-6)
        p_omega = (f_ax_l * f_ax_l) / (a_film * cos_l ** 3)

        if s == 1:
            cos_y_g = torch.where(yv["delta_pos"], 1.0, dot(dir_yl, yv["ns"]))
            cos_y = torch.abs(cos_y_g)
            f_y = 1.0
            # a delta-position light seen directly by the lens is a point
            # image that no other strategy samples: not splatted
            y_valid = yv["valid"] & ~yv["delta_pos"]
            y_out_n = torch.where(yv["delta_pos"][:, None], dir_yl, yv["ns"])
        else:
            ysd = yv["sd"]
            y_out_n = ysd.n_geom * ysd.face_dir[:, None]
            cos_y_g = dot(dir_yl, y_out_n)
            cos_y = torch.abs(dot(dir_yl, ysd.n_shading))
            f_y, _ = _f_pdf(bsdf_mod, config, ysd, -yv["d_in"], dir_yl)
            y_valid = yv["valid"] & ~yv["emissive"]

        ok = y_valid & ~yv["delta"] & (cos_y_g > 0) & inside
        contrib = yv["beta"] * f_y * (p_omega * cos_y / dist2)[:, None]

        # visibility y <-> lens
        sh_o = safe_origin(yv["pos"], dir_yl, y_out_n, geo_eps)
        sh_tmax = torch.where(ok, dist - 2.0 * geo_eps, 0.0)
        ok = ok & ~_occluded(scene, sh_o, dir_yl, sh_tmax, config)
        n_conn.append(ok.sum())

        # ---- MIS vs (s-k, 1+k): the camera -> y area pdf seeds the chain
        rev_top = p_omega * cos_y / dist2
        rev_top1, lchain = light_rev_top1(yv, s, dir_yl)
        sum_light = _light_ratio_chain(lchain, s, rev_top, rev_top1, 1,
                                       max_eye=s_e,
                                       delta_light=y0["delta_pos"])
        w_mis = 1.0 / (1.0 + sum_light)
        val = torch.where(ok[:, None], clamp(contrib * w_mis[:, None]), 0.0)
        splat.index_add_(0, torch.where(ok, pix, 0),
                         torch.where(ok[:, None], val, 0.0))

    # per path -> per pixel
    spp = config.spp_per_pass
    acc = torch.cat([rgb, depth[:, None]], 1)
    acc = untile_image(acc.reshape(spp, wh, 4), config).sum(0)
    acc = acc + torch.nn.functional.pad(splat, (0, 1))
    cam_seed, _ = rng_mod.frame_r0(cam_seed, 1)
    n_conn_rays = torch.stack(n_conn).sum().to(torch.int32)
    n_ext = torch.full((), n_ext_rays, dtype=torch.int32, device=dev)
    # per-bounce slots as in the other executors, the totals in slot 0
    rest = torch.zeros(config.max_path_length - 1, dtype=torch.int32,
                       device=dev)
    stats = dict(
        primary_rays=torch.full((), n, dtype=torch.int32, device=dev),
        extension_rays=torch.cat([n_ext[None], rest]),
        shadow_rays=torch.cat([n_conn_rays[None], rest]),
        total_extension=n_ext,
        total_shadow=n_conn_rays,
    )
    return acc, cam_seed, stats


def render_pass_bdpt(scene, view, state: AccumState, config: RenderConfig):
    """One BDPT pass into `state`. Returns (new AccumState, stats)."""
    acc_delta, cam_seed, stats = trace_paths_bdpt(
        scene, view, config, state.sample_count, state.cam_seed)
    return AccumState(
        accumulator=state.accumulator + acc_delta,
        sample_count=state.sample_count + config.spp_per_pass,
        cam_seed=cam_seed), stats


def render_pass_bdpt_jit(scene, view, state: AccumState, config: RenderConfig):
    """render_pass_bdpt (JAX :590 jit-compiles it with config static; here
    the same code, eagerly)."""
    return render_pass_bdpt(scene, view, state, config)
