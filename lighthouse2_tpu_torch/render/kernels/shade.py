"""The shade stage of a bounce as one kernel: build, bind and call csrc/shade.cu.

It replaces no Pallas kernel: the JAX package leaves shading to XLA's
fusions (its shade_bounce with bsdf_lambert or bsdf_disney), and the port
composed the same stage from small ATen kernels (render/wavefront.py
_shade_composed): ~2,700 a bounce for Lambert, ~4,400 for Disney, each
costing about its launch spacing rather than its bytes. A kernel runs the
stage for the forward Lambert or Disney path in one launch a bounce, one
lane a thread; the library holds one kernel a BSDF (shade_bounce_kernel,
shade_disney_kernel), two instantiations of one templated body, so that
each has its own register allocation. The Lambert kernel is bound by the
bytes of the gathered lane state (path state, hit, the hit triangle's and
material's rows or the cluster payload, texels, lights: ~95-112 MB a bounce
at 262,144 lanes); the Disney kernel reads nearly the same bytes but does
two four-lobe BSDF evaluations and a GGX/GTR1 sample a lane on warps split
by lobe, so its arithmetic and divergence bound it. Both keep every
intermediate in registers and read the scene's own tensors in place; the
Disney kernel computes a lane's lobe weights, tints and alphas once and
builds only the picked lobe's direction; the CUDA source says more.

use_kernel is the rule render/wavefront.py shade_bounce applies before any
launch: a kernel for CUDA tensors, the Lambert or Disney BSDF, no filter,
no IBL sky NEE, no scene sharding and no gradient needed (grad mode off, or
no tensor the shading reads requires grad); the composed, differentiable
code for everything else. shade_kernel launches config.bsdf's kernel or
raises; for CPU tensors it runs that composed code, their plain version.
The shading data come from the cluster payload when one is given (the
geom_reattach=True rows of bvh/clusters.py PAY_*), else from the scene's
triangle and material tensors. `shade_kernel.launches` counts the Lambert
kernel's launches, `shade_kernel.disney_launches` the Disney kernel's; with
`marks` a Disney launch adds its lobe picks to utils/telemetry.py's counts,
reduced a block in shared memory first. config_takes_kernel is the rule's
configuration half, which the launch gates of chip_smoke.py read too;
agreement is how a kernel is held to the composed code on the card
(tests, chip_smoke.py).

The library is built like the trace kernels' (render/kernels/trace.py
build_library: nvcc, sm_90a, -fmad=false, hashed into
build/lighthouse2_tpu_torch/) and loaded with ctypes. The launch neither
synchronises nor reads anything back, so CUDA graphs (render/graphs.py)
capture it as they capture the composed code.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os

import torch

from lighthouse2_tpu_torch.bvh import clusters as CL
from lighthouse2_tpu_torch.core import bluenoise as bn
from lighthouse2_tpu_torch.core import rng as rng_mod
from lighthouse2_tpu_torch.render.kernels.trace import (
    _PKG, _check_rc, build_library)
from lighthouse2_tpu_torch.scene.host_material import MAT_HASALPHA
from lighthouse2_tpu_torch.scene.host_texture import MIP_LEVELS
from lighthouse2_tpu_torch.utils import telemetry

SOURCE = os.path.join(_PKG, "csrc", "shade.cu")

# csrc/shade.cu ShadeArgs, in its order: pointers, then ints, then floats
_POINTERS = (
    "o d tp pdf last_n prev_spec n_diffuse alive pixel sample path_idx acc "
    "t prim u v depth cam_seed spread payload "
    "n0 n1 n2 face_n uv0 uv1 uv2 alpha area lod tangent bitangent mat ltri "
    "m_color m_absorption m_rough m_transmission m_eta m_flags m_tex_diffuse "
    "m_tex_normal m_tex_rough m_tex_mr m_tex_absorption pool desc "
    "tri_v0 tri_v1 tri_v2 tri_n tri_rad tri_area tri_energy "
    "pt_pos pt_rad pt_energy sp_pos sp_rad sp_dir sp_cos_in sp_cos_out "
    "sp_energy dl_dir dl_rad dl_energy sky bn_mask "
    "o_out d_out tp_out pdf_out last_n_out prev_spec_out n_diffuse_out "
    "alive_out acc_out cam_seed_out sh_o sh_d sh_tmax sh_pot sh_conn "
    "sh_direct m_metallic m_subsurface m_specular m_spec_tint m_anisotropic "
    "m_sheen m_sheen_tint m_clearcoat m_clearcoat_gloss m_tex_sheen "
    "m_tex_clearcoat m_tex_specular m_tex_anisotropic lobes").split()
_INTS = (
    "n li lt lp ls ld pool_n desc_mips mip_levels base_maps param_maps "
    "sky_h sky_w width max_path max_diffuse russian_roulette "
    "clamp_fireflies consistent_normals").split()
_FLOATS = ("geo_eps", "clamp_value")


class _Args(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in _POINTERS]
                + [(k, ctypes.c_int) for k in _INTS]
                + [(k, ctypes.c_float) for k in _FLOATS])


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library(SOURCE)[0])
        for fn in (lib.lh2_shade_bounce, lib.lh2_shade_disney):
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.lh2_shade_layout.restype = ctypes.c_char_p
        want = [CL.PAY_V0, CL.PAY_N0, CL.PAY_UV0, CL.PAY_ALPHA, CL.PAY_MAT,
                CL.PAY_LTRI, CL.PAY_LOD, CL.PAY_TAN, CL.PAY_BIT,
                CL.PAY_GEO_ROWS, CL.PAY_ROWS, MAT_HASALPHA,
                ctypes.sizeof(_Args)]
        got = [int(x) for x in lib.lh2_shade_layout().decode().split()]
        if got != want:
            raise RuntimeError(f"csrc/shade.cu assumes the layout {got}, "
                               f"the Python side {want} (payload rows, "
                               "MAT_HASALPHA, sizeof(ShadeArgs))")
        _lib = lib
    return _lib


def _tensors(*objs):
    """The tensors of dicts, dataclasses and tensors."""
    for x in objs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, dict):
            yield from _tensors(*x.values())
        elif dataclasses.is_dataclass(x):
            yield from _tensors(*(getattr(x, f.name)
                                  for f in dataclasses.fields(x)))


def config_takes_kernel(config, scene) -> bool:
    """The configuration's half of use_kernel: config.bsdf "lambert" or
    "disney" (each its own kernel), no filter, no IBL sky NEE
    (config.sky_ibl with the scene's IBL tables), not scene-sharded."""
    return (config.bsdf in ("lambert", "disney") and not config.filter_enabled
            and not config.scene_sharded
            and not (config.sky_ibl and scene.sky.has_ibl))


def use_kernel(scene, view, config, paths, acc, hit, payload=None) -> bool:
    """Whether shade_bounce takes the kernel: CUDA tensors, a configuration
    the kernel shades (config_takes_kernel), and no gradient needed (grad
    mode off, or none of the tensors the shading reads requires grad).
    `hit` is (t, prim, u, v)."""
    if paths["origin"].device.type != "cuda":
        return False
    if not config_takes_kernel(config, scene):
        return False
    if not torch.is_grad_enabled():
        return True
    return not any(x.requires_grad for x in _tensors(
        paths, acc, *hit, payload, view.spread_angle, scene.tris,
        scene.materials, scene.lights, scene.sky, scene.textures))


def _ptr(x, dtype, name):
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    return x.contiguous()


def shade_kernel(scene, view, config, paths, acc, cam_seed, li, t, prim, u,
                 v, payload=None, marks=False):
    """shade_bounce's result (paths', acc', cam_seed', shadow) through one
    launch of csrc/shade.cu for CUDA tensors, the kernel of config.bsdf;
    the composed code for CPU tensors. `li` is the path depth, an int or an
    int64 [N] tensor; `cam_seed` an int or an int64 0-d tensor, returned as
    the same kind; `payload` the cluster path's [PAY_ROWS, N] rows or None
    (gathers). With `marks` (the bounce loop's first run of the bounce) a
    Disney launch adds its lobe picks to the device's counts
    (utils/telemetry.py lobe_picks), as the composed code does."""
    dev = paths["origin"].device
    if dev.type == "cpu":
        from lighthouse2_tpu_torch.render.wavefront import _shade_composed
        return _shade_composed(scene, view, config, paths, acc, cam_seed, li,
                               t, prim, u, v, payload=payload, marks=marks)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    disney = config.bsdf == "disney"
    lobes = telemetry.lobe_counts(dev) if disney and marks else None
    args, out, keep = _args(scene, view, config, paths, acc, cam_seed, li, t,
                            prim, u, v, payload, lobes)
    lib = _load()
    launch = lib.lh2_shade_disney if disney else lib.lh2_shade_bounce
    rc = launch(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    _check_rc(rc, "shade_kernel")
    if disney:
        shade_kernel.disney_launches += 1
    else:
        shade_kernel.launches += 1
    return _result(paths, out, cam_seed)


def _args(scene, view, config, paths, acc, cam_seed, li, t, prim, u, v,
          payload, lobes=None):
    """The launch's ShadeArgs, its outputs (allocated here) and the input
    tensors whose pointers it holds (kept alive by the caller until the
    launch is queued); checks dtypes, devices and shapes. `lobes`: the
    device's int64 [5] lobe counts, or None."""
    dev = paths["origin"].device
    if not config_takes_kernel(config, scene):
        raise ValueError("the shade kernels shade the forward Lambert and "
                         "Disney paths only (no filter, IBL sky NEE or "
                         "scene sharding)")
    n = paths["origin"].shape[0]
    f32, i32, i64, b8 = torch.float32, torch.int32, torch.int64, torch.bool
    keep = []      # every tensor whose pointer the launch takes

    def p(x, dtype, name):
        x = _ptr(x, dtype, name)
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the lanes on {dev}")
        keep.append(x)
        return x.data_ptr()

    a = {}
    for k, key in (("o", "origin"), ("d", "dir"), ("tp", "throughput"),
                   ("pdf", "bsdf_pdf"), ("last_n", "last_n")):
        a[k] = p(paths[key], f32, key)
    a["prev_spec"] = p(paths["prev_specular"], b8, "prev_specular")
    a["alive"] = p(paths["alive"], b8, "alive")
    a["n_diffuse"] = p(paths["n_diffuse"], i32, "n_diffuse")
    for k in ("pixel", "sample", "path_idx"):
        a[k] = p(paths[k], i64, k)
    a["acc"] = p(acc, f32, "acc")
    a["t"], a["u"], a["v"] = (p(x, f32, k) for x, k in ((t, "t"), (u, "u"),
                                                        (v, "v")))
    a["prim"] = p(prim.to(i32), i32, "prim")
    if isinstance(li, torch.Tensor):
        a["depth"] = p(li, i64, "li")
    else:
        a["li"] = int(li)
    seed_in = (cam_seed if isinstance(cam_seed, torch.Tensor) else
               torch.full((), cam_seed & rng_mod.M32, dtype=i64, device=dev))
    a["cam_seed"] = p(seed_in, i64, "cam_seed")
    a["spread"] = p(view.spread_angle.to(f32), f32, "spread_angle")
    if payload is not None:
        if payload.dim() != 2 or payload.shape != (CL.PAY_ROWS, n):
            raise ValueError(f"payload must be [{CL.PAY_ROWS}, {n}], got "
                             f"{tuple(payload.shape)}")
        a["payload"] = p(payload.detach(), f32, "payload")

    tr, m, lt_ = scene.tris, scene.materials, scene.lights
    for k in ("n0", "n1", "n2", "face_n", "uv0", "uv1", "uv2", "alpha",
              "area", "lod", "tangent", "bitangent"):
        a[k] = p(getattr(tr, k).detach(), f32, f"tris.{k}")
    a["mat"] = p(tr.mat, i32, "tris.mat")
    a["ltri"] = p(tr.ltri, i32, "tris.ltri")
    for k, f in (("m_color", "color"), ("m_absorption", "absorption"),
                 ("m_rough", "roughness"), ("m_transmission", "transmission"),
                 ("m_eta", "eta")):
        a[k] = p(getattr(m, f).detach(), f32, f"materials.{f}")
    for f in ("metallic", "subsurface", "specular", "spec_tint",
              "anisotropic", "sheen", "sheen_tint", "clearcoat",
              "clearcoat_gloss"):      # the Disney kernel's only
        a["m_" + f] = p(getattr(m, f).detach(), f32, f"materials.{f}")
    for k, f in (("m_flags", "flags"), ("m_tex_diffuse", "tex_diffuse"),
                 ("m_tex_normal", "tex_normal"),
                 ("m_tex_rough", "tex_roughness"),
                 ("m_tex_mr", "tex_metal_rough"),
                 ("m_tex_absorption", "tex_absorption"),
                 ("m_tex_sheen", "tex_sheen"),
                 ("m_tex_clearcoat", "tex_clearcoat"),
                 ("m_tex_specular", "tex_specular"),
                 ("m_tex_anisotropic", "tex_anisotropic")):
        a[k] = p(getattr(m, f), i32, f"materials.{f}")
    tex = scene.textures
    a["pool"] = p(tex.pool.detach(), f32, "textures.pool")
    a["desc"] = p(tex.desc, i32, "textures.desc")
    has_tex = tex.pool.shape[1] > 1
    for k, f in (("tri_v0", "tri_v0"), ("tri_v1", "tri_v1"),
                 ("tri_v2", "tri_v2"), ("tri_n", "tri_n"),
                 ("tri_rad", "tri_radiance"), ("tri_area", "tri_area"),
                 ("tri_energy", "tri_energy"), ("pt_pos", "point_pos"),
                 ("pt_rad", "point_radiance"), ("pt_energy", "point_energy"),
                 ("sp_pos", "spot_pos"), ("sp_rad", "spot_radiance"),
                 ("sp_dir", "spot_dir"), ("sp_cos_in", "spot_cos_inner"),
                 ("sp_cos_out", "spot_cos_outer"), ("sp_energy", "spot_energy"),
                 ("dl_dir", "dir_dir"), ("dl_rad", "dir_radiance"),
                 ("dl_energy", "dir_energy")):
        a[k] = p(getattr(lt_, f).detach(), f32, f"lights.{f}")
    sky = scene.sky.pixels.detach()
    a["sky"] = p(sky, f32, "sky.pixels")
    if config.blue_noise:
        a["bn_mask"] = p(bn.device_mask(dev), f32, "blue-noise mask")
    if lobes is not None:
        a["lobes"] = p(lobes, i64, "lobes")

    out = dict(o=torch.empty((n, 3), dtype=f32, device=dev),
               d=torch.empty((n, 3), dtype=f32, device=dev),
               tp=torch.empty((n, 3), dtype=f32, device=dev),
               pdf=torch.empty(n, dtype=f32, device=dev),
               last_n=torch.empty((n, 3), dtype=f32, device=dev),
               prev_spec=torch.empty(n, dtype=b8, device=dev),
               n_diffuse=torch.empty(n, dtype=i32, device=dev),
               alive=torch.empty(n, dtype=b8, device=dev),
               acc=torch.empty((n, 4), dtype=f32, device=dev),
               cam_seed=torch.empty((), dtype=i64, device=dev),
               sh_o=torch.empty((n, 3), dtype=f32, device=dev),
               sh_d=torch.empty((n, 3), dtype=f32, device=dev),
               sh_tmax=torch.empty(n, dtype=f32, device=dev),
               sh_pot=torch.empty((n, 3), dtype=f32, device=dev),
               sh_conn=torch.empty(n, dtype=b8, device=dev),
               sh_direct=torch.empty(n, dtype=b8, device=dev))
    for k, x in out.items():
        a[k if k.startswith("sh_") else k + "_out"] = x.data_ptr()

    present = lambda s, x: x.shape[0] if s > 0 else 0
    a.update(
        n=n, lt=present(lt_.s_tri, lt_.tri_v0),
        lp=present(lt_.s_point, lt_.point_pos),
        ls=present(lt_.s_spot, lt_.spot_pos),
        ld=present(lt_.s_dir, lt_.dir_dir),
        pool_n=tex.pool.shape[1], desc_mips=tex.desc.shape[1],
        mip_levels=MIP_LEVELS,
        base_maps=m.s_base_maps if has_tex else 0,
        param_maps=m.s_param_maps if has_tex else 0,
        sky_h=sky.shape[0], sky_w=sky.shape[1], width=config.width,
        max_path=config.max_path_length,
        max_diffuse=config.max_diffuse_bounces,
        russian_roulette=int(config.russian_roulette),
        clamp_fireflies=int(config.clamp_fireflies),
        consistent_normals=int(config.consistent_normals),
        geo_eps=config.geometry_epsilon, clamp_value=config.clamp_value)
    return _Args(**a), out, keep


def _result(paths, out, cam_seed):
    """shade_bounce's (paths', acc', cam_seed', shadow) from the outputs;
    cam_seed' an int where `cam_seed` was one."""
    new_seed = out["cam_seed"]
    if not isinstance(cam_seed, torch.Tensor):
        new_seed, _ = rng_mod.frame_r0(cam_seed & rng_mod.M32, 1)
    paths = dict(paths, origin=out["o"], dir=out["d"], throughput=out["tp"],
                 bsdf_pdf=out["pdf"], last_n=out["last_n"],
                 prev_specular=out["prev_spec"], n_diffuse=out["n_diffuse"],
                 alive=out["alive"])
    shadow = dict(o=out["sh_o"], d=out["sh_d"], tmax=out["sh_tmax"],
                  potential=out["sh_pot"], conn_ok=out["sh_conn"],
                  to_direct=out["sh_direct"])
    return paths, out["acc"], new_seed, shadow


shade_kernel.launches = 0           # the Lambert kernel's
shade_kernel.disney_launches = 0    # the Disney kernel's


# the kernel against its plain version on one bounce (agreement): the
# share of lanes whose branches must agree, and the share of lanes on which
# any one output may be off
AGREE_MIN = 0.999
OFF_MAX = 1e-3


def agreement(want, got):
    """How far shade_bounce's result `got` (the kernel's) is from `want`
    (the composed code's) on the same inputs: (share of the lanes off, by
    output; share of the lanes whose branches agree). The branches are
    alive, prev_specular, n_diffuse, conn_ok and to_direct. An integer or
    bool output is off where it differs; a float one, on the lanes whose
    branches agree, where it is neither equal nor within 1e-5 of the larger
    magnitude of its row (a direction's last bits relative to its length).
    The cam_seed's must be equal. A bounce passes with agree >= AGREE_MIN
    and every output's off <= OFF_MAX."""
    def outputs(res):
        p, acc, seed, shadow = res
        out = {f"paths.{k}": p[k] for k in (
            "origin", "dir", "throughput", "bsdf_pdf", "last_n",
            "prev_specular", "n_diffuse", "alive")}
        out["acc"] = acc
        out.update({f"shadow.{k}": x for k, x in shadow.items()})
        return out, int(seed)

    (w, ws), (g, gs) = outputs(want), outputs(got)
    if ws != gs:
        raise AssertionError(f"cam_seed {gs}, the composed code's {ws}")
    agree = torch.ones_like(w["paths.alive"])
    for k in ("paths.alive", "paths.prev_specular", "paths.n_diffuse",
              "shadow.conn_ok", "shadow.to_direct"):
        agree &= w[k] == g[k]
    off = {}
    for k, a in w.items():
        b = g[k]
        if not a.is_floating_point():
            off[k] = (a != b).float().mean().item()
            continue
        a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        mag = torch.maximum(a2.abs().amax(1), b2.abs().amax(1))
        ok = ((a2 == b2) | ((a2 - b2).abs() <= 1e-5 * mag[:, None])).all(1)
        off[k] = (agree & ~ok).float().mean().item()
    return off, agree.float().mean().item()
