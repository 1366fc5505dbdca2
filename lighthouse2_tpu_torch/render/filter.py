"""SVGF spatiotemporal filter + TAA (finalize_shared.h,
RenderCore_Optix7Filter), in PyTorch.

Counterpart of lighthouse2_tpu/render/filter.py: FilterState, jittered_view,
project_to_view, _bilinear_taps, reproject_history, the luminance and YCoCg
helpers, _shift (edge clamp), _TAPS, atrous_pass, _neighborhood_clamp,
svgf_filter, TAAState, _mitchell_weight, _mitchell_taps, taa and unsharpen,
with the reference's arithmetic. The pipeline of a frame: demodulate and
clamp, temporal moments (reprojected through the previous view when the
camera moved), three a-trous phases (the first blended with the clamped
history), remodulate; then TAA with variance clipping and an unsharp mask.

Differences from the JAX module:
  - a stencil gathers all its taps at once: `_neighbours` reads the K
    edge-clamped shifts of an image with one indexing op into [K, H, W, C]
    (each tap equal to _shift's), and the tap sums reduce over that axis,
    where JAX pads the image once per tap and adds the taps in order (XLA
    fuses them). The weights are the reference's expressions; only the
    order of the final sums differs (float32 rounding). On the card this
    keeps a frame to a few hundred launches instead of thousands;
  - _bilinear_taps and _mitchell_taps return stacked (index [K, ...],
    weight [K, ...]) tensors instead of a list / generator of pairs;
  - float pixel coordinates are clamped to [-2, size + 1] (NaN to 0, as
    XLA converts it) before their conversion to int, because ATen's
    conversion of an out-of-range or NaN float is undefined and differs
    between CPU and CUDA (XLA's saturates). Every tap that the clamp moves
    is out of bounds before and after it, so it keeps its zero weight and
    only its (ignored) index changes;
  - the 3-vector dots of project_to_view round as XLA:CPU's do (_dot,
    _vdot), and the norms are sqrt(sum(x * x)), so the motion vectors, and
    with them the truncated history lengths, match JAX's bit for bit on
    the CPU;
  - w_normal ** 128 is seven squarings, as XLA lowers the integer power;
  - FilterState and TAAState are dataclasses of tensors whose make(h, w,
    device) defaults to the card (device.resolve_device).
"""
from __future__ import annotations

import dataclasses

import torch

from lighthouse2_tpu_torch.core.geometry import cross
from lighthouse2_tpu_torch.device import resolve_device


@dataclasses.dataclass
class FilterState:
    """Temporal history: the prev* ping-pong buffers of
    rendercore.cpp:845-859."""
    moments: torch.Tensor     # [H,W,4] lumDir, lumDir2, lumInd, lumInd2
    shading: torch.Tensor     # [H,W,6] filtered direct+indirect of prev frame
    world_pos: torch.Tensor   # [H,W,3]
    history: torch.Tensor     # [H,W] int32 history length (0..15)

    @staticmethod
    def make(h, w, device=None):
        device = resolve_device(device)
        f = dict(dtype=torch.float32, device=device)
        return FilterState(
            moments=torch.zeros((h, w, 4), **f),
            shading=torch.zeros((h, w, 6), **f),
            world_pos=torch.full((h, w, 3), 1e30, **f),
            history=torch.zeros((h, w), dtype=torch.int32, device=device))


# 4-phase Halton(2,3) subpixel offsets (Optix7Filter/rendercore.cpp:734-743)
_HALTON4 = ((0.5, 1.0 / 3.0), (0.25, 2.0 / 3.0),
            (0.75, 1.0 / 9.0), (0.125, 4.0 / 9.0))


def jittered_view(view, frame_idx: int, w: int, h: int):
    """Shift the image plane by a subpixel Halton offset for TAA.

    Returns (view', (jx, jy)) with jx/jy in [-0.5, 0.5) pixels."""
    jx, jy = _HALTON4[frame_idx % 4]
    jx, jy = jx - 0.5, jy - 0.5
    right = (view.p2 - view.p1) * (1.0 / w)
    down = (view.p3 - view.p1) * (1.0 / h)
    off = jx * right + jy * down
    return dataclasses.replace(view, p1=view.p1 + off, p2=view.p2 + off,
                               p3=view.p3 + off), (jx, jy)


def _dot(a, b):
    """a . b over a last axis of 3 as XLA:CPU computes JAX's
    einsum("...i,i->..."): fma(a2, b2, fma(a1, b1, a0 * b0)). Each fused
    multiply-add is formed in float64 (the float32 product is exact there)
    and rounded to float32."""
    a64, b64 = a.double(), b.double()
    acc = a[..., 0] * b[..., 0]
    for k in (1, 2):
        acc = (a64[..., k] * b64[..., k] + acc.double()).float()
    return acc


def _vdot(a, b):
    """The dot of two 3-vectors as JAX's jnp.dot computes it: three float32
    products added in order."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _norm(x):
    """sqrt(sum(x * x)) over the last axis, as jnp.linalg.norm."""
    return torch.sqrt((x * x).sum(-1))


def project_to_view(world_pos, view, w: int, h: int):
    """Screen coordinates of world points in a (previous) ViewPyramid, the
    motion-vector source: the inverse of the eye-ray mapping (pinhole; DOF
    and jitter ignored, the consistency gate absorbs the residual).

    world_pos [...,3] -> (px, py, valid) with px/py in pixel units."""
    right = view.p2 - view.p1
    down = view.p3 - view.p1
    n = cross(right, down)
    d = world_pos - view.pos
    denom = _dot(d, n)
    num = _vdot(view.p1 - view.pos, n)
    t = num / torch.where(torch.abs(denom) < 1e-20, 1e-20, denom)
    q = view.pos + t[..., None] * d - view.p1
    u = _dot(q, right) / _vdot(right, right)
    v = _dot(q, down) / _vdot(down, down)
    px = u * w - 0.5
    py = v * h - 0.5
    valid = (t > 0) & (u >= 0) & (u < 1) & (v >= 0) & (v < 1)
    return px, py, valid


def _to_index(x, hi):
    """Integer-valued float coordinates -> int64 as XLA converts them (NaN
    to 0, out-of-range values saturated), clamped in float to [-2, hi]
    first: both ends are out of bounds for every tap that reaches them, and
    the conversion stays defined in ATen."""
    return torch.nan_to_num(x, nan=0.0).clamp(-2.0, float(hi)).to(torch.int64)


def _bilinear_taps(px, py, w, h):
    """The 4 integer taps + bilinear weights of fractional pixel coords:
    (flat index [4, ...] int64, weight [4, ...]), taps in the reference's
    order (dy, then dx)."""
    x0f = torch.floor(px)
    y0f = torch.floor(py)
    fx = px - x0f
    fy = py - y0f
    x0 = _to_index(x0f, w + 1)
    y0 = _to_index(y0f, h + 1)
    col = lambda vals, t: torch.tensor(vals, dtype=t.dtype, device=t.device
                                       ).reshape(-1, *([1] * t.dim()))
    dy, dx = col([0, 0, 1, 1], x0), col([0, 1, 0, 1], x0)
    wy = torch.stack([1.0 - fy, 1.0 - fy, fy, fy])
    wx = torch.stack([1.0 - fx, fx, 1.0 - fx, fx])
    xx = x0 + dx
    yy = y0 + dy
    inb = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
    idx = yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)
    # a select, as XLA folds the multiply by the converted mask: an
    # out-of-bounds tap weighs 0 even where wx or wy is NaN
    return idx, torch.where(inb, wx * wy, 0.0)


def reproject_history(state: FilterState, world_pos, normal, allowed,
                      prev_view):
    """Fetch history at the previous frame's pixel positions with
    consistency-gated bilinear taps (finalize_shared.h:102-199): a tap
    contributes only if its stored world position lies on the current
    surface's tangent plane, within 64 x allowed of the point.

    Returns (moments, shading, history, consistent); consistent=False marks
    disocclusions (no valid tap survived)."""
    h, w = world_pos.shape[:2]
    px, py, valid = project_to_view(world_pos, prev_view, w, h)
    mom = state.moments.reshape(h * w, -1)
    sha = state.shading.reshape(h * w, -1)
    wp = state.world_pos.reshape(h * w, 3)
    his = state.history.reshape(h * w).to(torch.float32)

    idx, wgt = _bilinear_taps(px, py, w, h)
    dvec = wp[idx] - world_pos
    plane_d = torch.abs((dvec * normal).sum(-1))
    ok = (plane_d < allowed) & (_norm(dvec) < 64.0 * allowed)
    tw = wgt * ok * valid
    # the taps' sums in the reference's order
    mom_acc, sha_acc, his_acc, w_acc = mom[idx[0]] * tw[0, ..., None], \
        sha[idx[0]] * tw[0, ..., None], his[idx[0]] * tw[0], tw[0]
    for k in (1, 2, 3):
        mom_acc = mom_acc + mom[idx[k]] * tw[k, ..., None]
        sha_acc = sha_acc + sha[idx[k]] * tw[k, ..., None]
        his_acc = his_acc + his[idx[k]] * tw[k]
        w_acc = w_acc + tw[k]
    consistent = w_acc > 0.05
    inv = 1.0 / torch.clamp(w_acc, min=1e-6)
    # truncation toward zero, as the reference's astype(int32)
    hist = torch.nan_to_num(his_acc * inv, nan=0.0).clamp(-1.0, 16.0)
    return (mom_acc * inv[..., None], sha_acc * inv[..., None],
            hist.to(torch.int32), consistent)


def _luminance(v):
    return 0.2126 * v[..., 0] + 0.7152 * v[..., 1] + 0.0722 * v[..., 2]


def _rgb_to_ycocg(c):
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([0.25 * r + 0.5 * g + 0.25 * b,
                        0.5 * r - 0.5 * b,
                        -0.25 * r + 0.5 * g - 0.25 * b], -1)


def _ycocg_to_rgb(c):
    y, co, cg = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack([y + co - cg, y + cg, y - co - cg], -1)


def _shift(img, dy, dx):
    """Shift with edge clamp: out[y,x] = img[y+dy, x+dx]."""
    return _neighbours(img, ((dy, dx),))[0]


def _neighbours(img, offsets):
    """The edge-clamped shifts of img [H,W,...] by each (dy, dx) of
    `offsets`, stacked: [K,H,W,...], out[k,y,x] = img[y+dy_k, x+dx_k]."""
    h, w = img.shape[:2]
    dev = img.device
    off = torch.tensor(offsets, dtype=torch.int64, device=dev).reshape(-1, 2)
    ys = (torch.arange(h, device=dev)[None] + off[:, :1]).clamp(0, h - 1)
    xs = (torch.arange(w, device=dev)[None] + off[:, 1:]).clamp(0, w - 1)
    return img[ys[:, :, None], xs[:, None, :]]


# a-trous tap pattern (finalize_shared.h:244-249): vv in -2..2, the uu
# range narrows to +-1 on the outer rows
_TAPS = [(vv, uu) for vv in range(-2, 3)
         for uu in range(-(1 if abs(vv) == 2 else 2),
                         (1 if abs(vv) == 2 else 2) + 1)
         if not (uu == 0 and vv == 0)]
# the 3x3 neighbourhood without its centre, in the reference's order
_RING = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)
         if not (dy == 0 and dx == 0)]


def _pow128(x):
    for _ in range(7):
        x = x * x
    return x


def atrous_pass(direct, indirect, albedo, normal, depth, ddxy, moments,
                history, phase):
    """One a-trous wavelet pass (applyFilterKernel,
    finalize_shared.h:205-369). All inputs are [H,W,...] images. Returns
    the filtered (direct, indirect)."""
    step = 1 << (phase - 1)
    sigma = 10.0 * (0.5 ** (phase - 1))
    dev = direct.device
    factor = torch.where(history == 0, 400.0, 1.0)
    var_dir = torch.clamp(moments[..., 1] - moments[..., 0] ** 2, min=0.0)
    var_ind = torch.clamp(moments[..., 3] - moments[..., 2] ** 2, min=0.0)
    reci_dir = -1.0 / (sigma * factor * torch.sqrt(var_dir + 1e-5) + 1e-5)
    reci_ind = -1.0 / (sigma * factor * torch.sqrt(var_ind + 1e-5) + 1e-5)

    lum_dir = _luminance(direct)
    lum_ind = _luminance(indirect)
    ddx = ddxy[..., 0]
    ddy = ddxy[..., 1]

    # every tap of the five fields in one gather: [24, H, W, 13]
    fields = torch.cat([direct, indirect, normal, depth[..., None], albedo],
                       -1)
    nb = _neighbours(fields, [(vv * step, uu * step) for vv, uu in _TAPS])
    n_dir, n_ind, n_nrm = nb[..., 0:3], nb[..., 3:6], nb[..., 6:9]
    n_dep, n_alb = nb[..., 9], nb[..., 10:13]
    col = lambda vals: torch.tensor(vals, dtype=torch.float32,
                                    device=dev)[:, None, None]
    w_dist = col([(uu * uu + vv * vv) * (-1.0 / 7.5) for vv, uu in _TAPS])
    u_step = col([float(uu * step) for _, uu in _TAPS])
    v_step = col([float(vv * step) for vv, _ in _TAPS])

    w_normal = _pow128(torch.clamp((n_nrm * normal).sum(-1), min=0.0))
    expected = depth + ddx * u_step + ddy * v_step
    depth_err = torch.abs(expected - n_dep)
    expected_diff = torch.abs(expected - depth)
    w_depth = depth_err / torch.clamp((0.5 + phase * 0.5) * expected_diff,
                                      min=1e-5)
    w_normal = w_normal * (albedo * n_alb).sum(-1)
    w_d = w_normal * torch.exp(
        torch.abs(lum_dir - _luminance(n_dir)) * reci_dir + w_dist - w_depth)
    w_i = w_normal * torch.exp(
        torch.abs(lum_ind - _luminance(n_ind)) * reci_ind + w_dist - w_depth)
    w_d = torch.where(torch.isfinite(w_d), w_d, 0.0)
    w_i = torch.where(torch.isfinite(w_i), w_i, 0.0)
    dir_sum = direct + (n_dir * w_d[..., None]).sum(0)
    ind_sum = indirect + (n_ind * w_i[..., None]).sum(0)
    w_dir_sum = 1.0 + w_d.sum(0)
    w_ind_sum = 1.0 + w_i.sum(0)
    return (dir_sum / torch.clamp(w_dir_sum, min=1e-4)[..., None],
            ind_sum / torch.clamp(w_ind_sum, min=1e-4)[..., None])


def _ring_stats(img, k):
    """YCoCg mean -/+ k sigma over the 3x3 neighbourhood of img [H,W,3]."""
    acc = _rgb_to_ycocg(img)
    n = _rgb_to_ycocg(_neighbours(img, _RING))
    s = acc + n.sum(0)
    s2 = acc * acc + (n * n).sum(0)
    avg = s / 9.0
    sig = torch.sqrt(torch.clamp(s2 / 9.0 - avg * avg, min=0.0))
    return avg - k * sig, avg + k * sig


def _neighborhood_clamp(img_ycocg_center, a_direct, a_indirect, prev_d,
                        prev_i):
    """YCoCg 3x3 neighbourhood clamping of the history
    (finalize_shared.h:305-345)."""
    lo_d, hi_d = _ring_stats(a_direct, 0.75)
    lo_i, hi_i = _ring_stats(a_indirect, 0.75)
    pd = torch.clamp(_rgb_to_ycocg(prev_d), lo_d, hi_d)
    pi = torch.clamp(_rgb_to_ycocg(prev_i), lo_i, hi_i)
    return _ycocg_to_rgb(pd), _ycocg_to_rgb(pi)


def svgf_filter(direct, indirect, albedo, normal, depth, world_pos,
                state: FilterState, direct_clamp=15.0, indirect_clamp=2.5,
                n_phases=3, prev_view=None):
    """A full SVGF frame.

    Inputs are per-pixel [H,W,3|1] images: raw direct / indirect radiance
    (not albedo-demodulated) and the primary-hit features. `prev_view` is
    the previous frame's ViewPyramid: given, history is reprojected through
    it (moving camera); None assumes a static camera.
    Returns (filtered colour [H,W,3], new FilterState)."""
    # prepare (finalize_shared.h:102-199)
    reci_albedo = 1.0 / torch.clamp(albedo, min=1e-4)
    d_l = torch.clamp(direct * reci_albedo, max=direct_clamp)
    i_l = torch.clamp(indirect * reci_albedo, max=indirect_clamp)
    lum = torch.stack([_luminance(d_l), _luminance(d_l) ** 2,
                       _luminance(i_l), _luminance(i_l) ** 2], -1)
    # history consistency: the same surface within the allowed distance
    ddx = torch.abs(depth - _shift(depth, 0, 1))
    ddy = torch.abs(depth - _shift(depth, 1, 0))
    ddxy = torch.stack([ddx, ddy], -1)
    allowed = torch.clamp(ddx + ddy, min=0.05)
    if prev_view is not None:
        prev_moments, prev_shading, prev_hist, consistent = reproject_history(
            state, world_pos, normal, allowed, prev_view)
    else:
        prev_moments, prev_shading = state.moments, state.shading
        prev_hist = state.history
        wp_dist = _norm(world_pos - state.world_pos)
        consistent = wp_dist < allowed
    moments = torch.where(consistent[..., None],
                          0.2 * lum + 0.8 * prev_moments, lum)
    history = torch.where(consistent, torch.clamp(prev_hist + 1, max=15),
                          0).to(torch.int32)

    # a-trous phases (rendercore.cpp:838-842)
    d_f, i_f = d_l, i_l
    for phase in range(1, n_phases + 1):
        d_new, i_new = atrous_pass(d_f, i_f, albedo, normal, depth, ddxy,
                                   moments, history, phase)
        if phase == 1:
            # temporal blend with neighbourhood clamp
            # (finalize_shared.h:298-346)
            cd, ci = _neighborhood_clamp(None, d_f, i_f,
                                         prev_shading[..., :3],
                                         prev_shading[..., 3:])
            c3 = consistent[..., None]
            d_new = torch.where(c3, 0.1 * d_new + 0.9 * cd, d_new)
            i_new = torch.where(c3, 0.1 * i_new + 0.9 * ci, i_new)
        d_f, i_f = d_new, i_new

    color = (d_f + i_f) * albedo
    return color, FilterState(moments=moments,
                              shading=torch.cat([d_f, i_f], -1),
                              world_pos=world_pos, history=history)


# TAA (finalize_shared.h:383-432, Marco Salvi variance clipping) + unsharpen

@dataclasses.dataclass
class TAAState:
    prev: torch.Tensor   # [H,W,3] previous output (post-TAA)

    @staticmethod
    def make(h, w, device=None):
        return TAAState(prev=torch.zeros((h, w, 3), dtype=torch.float32,
                                         device=resolve_device(device)))


def _mitchell_weight(v):
    """Mitchell-Netravali B = C = 1/3 kernel (sampling_shared.h:22-28)."""
    x = torch.abs(v)
    x2 = x * x
    x3 = x2 * x
    b = c = 1.0 / 3.0
    inner = (1.0 / 6.0) * ((12 - 9 * b - 6 * c) * x3
                           + (-18 + 12 * b + 6 * c) * x2 + (6 - 2 * b))
    outer = (1.0 / 6.0) * ((-b - 6 * c) * x3 + (6 * b + 30 * c) * x2
                           + (-12 * b - 48 * c) * x + (8 * b + 24 * c))
    return torch.where(x < 1.0, inner, torch.where(x < 2.0, outer, 0.0))


def _mitchell_taps(px, py, w, h):
    """The 16 taps of the 4x4 Mitchell-Netravali window around (px, py),
    ReadTexelBmitchellNetravali (sampling_shared.h:102-119): (flat index
    [16, ...] int64, weight [16, ...]), row by row; out-of-bounds taps
    weigh 0 (the reference's test is y > 0 but x >= 0, kept as it is)."""
    col = lambda vals: torch.tensor(vals, dtype=px.dtype, device=px.device
                                    ).reshape(-1, *([1] * px.dim()))
    x = (torch.floor(px - 2.0) + 1.0) + col([0.0, 1.0, 2.0, 3.0] * 4)
    y = (torch.floor(py - 2.0) + 1.0) + col(
        [float(o) for o in range(4) for _ in range(4)])
    inside = (x >= 0) & (y > 0) & (x < w) & (y < h)
    wgt = torch.where(inside,
                      _mitchell_weight(x - px) * _mitchell_weight(y - py), 0.0)
    xi = _to_index(x, w + 1).clamp(0, w - 1)
    yi = _to_index(y, h + 1).clamp(0, h - 1)
    return yi * w + xi, wgt


def taa(color, state: TAAState, blend=0.9, world_pos=None, prev_view=None,
        mitchell=True):
    """Variance-clipped temporal AA. With `world_pos` + `prev_view` the
    history is reprojected through a 4x4 Mitchell-Netravali resample (the
    reference's TAA history read, finalize_shared.h:399; mitchell=False
    reads it bilinearly); the YCoCg variance clip absorbs the residual."""
    lo, hi = _ring_stats(color, 1.0)
    hist = state.prev
    if prev_view is not None and world_pos is not None:
        h, w = color.shape[:2]
        px, py, valid = project_to_view(world_pos, prev_view, w, h)
        pf = state.prev.reshape(h * w, 3)
        idx, wgt = (_mitchell_taps(px, py, w, h) if mitchell
                    else _bilinear_taps(px, py, w, h))
        tw = wgt * valid
        acc = (pf[idx] * tw[..., None]).sum(0)
        wa = tw.sum(0)
        hist = torch.where((wa > 1e-4)[..., None],
                           acc / torch.clamp(wa, min=1e-6)[..., None], color)
    prev = torch.clamp(_rgb_to_ycocg(hist), lo, hi)
    out = _ycocg_to_rgb((1.0 - blend) * _rgb_to_ycocg(color) + blend * prev)
    return out, TAAState(prev=out)


_UNSHARP = ((0, 1, 0.125), (0, -1, 0.125), (1, 0, 0.125), (-1, 0, 0.125),
            (1, 1, 0.0625), (1, -1, 0.0625), (-1, 1, 0.0625),
            (-1, -1, 0.0625))


def unsharpen(color, amount=0.3):
    """unsharpenTAA (finalize_shared.h:438-466): a 3x3 unsharp mask."""
    nb = _neighbours(color, [(dy, dx) for dy, dx, _ in _UNSHARP])
    wts = torch.tensor([w for _, _, w in _UNSHARP], dtype=torch.float32,
                       device=color.device)[:, None, None, None]
    blur = color * 0.25 + (nb * wts).sum(0)
    return torch.clamp(color + (color - blur) * amount, min=0.0)
