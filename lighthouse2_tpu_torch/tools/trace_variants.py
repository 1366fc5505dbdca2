"""Time alternatives to the trace kernels beside the shipped ones, on one card.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 -m lighthouse2_tpu_torch.tools.trace_variants [--parent DIR]

It builds csrc/trace.cu (the shipped kernels) and csrc/trace_variants.cu
(the alternatives, see its header) with the shipped flags. With --parent it
also builds the csrc/trace.cu of an earlier checkout, unpacked with
`git archive <commit> | tar -x -C DIR`, and binds it through the BVH2 C
interface of the first CUDA port (the kernels that walked DeviceBVH's BVH2
arrays). Then it loads the bathroom 512x512, path 16, regen, as
chip_smoke.py does, and times in one process on one card:
  - on chip_smoke's three fixed batches (primary, bounce-1, shadow): every
    alternative beside the shipped kernels, in the order parent, shipped,
    alternatives, alternatives reversed, shipped, parent, each time the mean
    of WARM_ITERS back-to-back launches; each alternative's results must
    equal the shipped kernel's (the BVH2 walks: the plain BVH2 walk's);
  - on the 16 closest-hit and 16 shadow batches that one main-path pass
    hands the kernels: each variant warm, and the shipped kernels, the
    L2-window launch and the parent cold, i.e. each launch right after a
    100 MB buffer was written (more than the 50 MB L2); per batch the
    variants run in one order and then in the reverse order.
It prints one line per measurement and writes all of them, with the card's
name and power limit, to chiprun_out/trace_variants.json.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

WARM_ITERS = 20            # back-to-back launches per fixed-batch time
MAIN_WARM_ITERS = 10       # per main-path batch and pass over the names
COLD_REPS = 5              # flushed launches per main-path batch
FLUSH_BYTES = 100 << 20
SLEEP_CYCLES = 50_000_000   # device spin that lets the host queue a sequence
# lh2v_walk variant ids (csrc/trace_variants.cu); 0 is the shipped walk
WALKS = {"if_if": 1, "shared_stack": 2, "if_if_shared_stack": 3,
         "regs40": 4, "rank_order": 5, "block256": 6, "block64": 7,
         "regs48": 8, "leaf_prefetch_next": 9, "leaf_prefetch_all": 10,
         "leaf_prefetch_all_regs80": 11, "leaf_prefetch_all_regs64": 12}

_p, _i = ctypes.c_void_p, ctypes.c_int


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _check(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")


def _closest_out(n, dev):
    return (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev))


def load_variants():
    from lighthouse2_tpu_torch.render.kernels import trace as tk
    src = os.path.join(os.path.dirname(tk.SOURCE), "trace_variants.cu")
    so, log = tk.build_library(src, deps=(tk.SOURCE,))
    lib = ctypes.CDLL(so)
    sz, fl = ctypes.c_size_t, ctypes.c_float
    lib.lh2v_walk.argtypes = [_i, _i] + [_p] * 5 + [_i, _i] + [_p] * 6 + [_i, _p]
    lib.lh2v_closest_persistent.argtypes = [_p] * 5 + [_i, _i] + [_p] * 6
    lib.lh2v_occluded_persistent.argtypes = [_p] * 5 + [_i, _i] + [_p] * 3
    lib.lh2v_set_persisting_l2.argtypes = [sz, _p, _p]
    lib.lh2v_closest_l2window.argtypes = ([_p] * 5 + [_i, _i] + [_p] * 4
                                          + [_p, sz, fl, _p])
    lib.lh2v_occluded_l2window.argtypes = ([_p] * 5 + [_i, _i] + [_p]
                                           + [_p, sz, fl, _p])
    lib.lh2v_closest_aos2.argtypes = [_p] * 5 + [_i, _i, _i] + [_p] * 6
    lib.lh2v_occluded_aos2.argtypes = [_p] * 5 + [_i, _i, _i] + [_p] * 3
    for fn in ("lh2v_walk", "lh2v_closest_persistent",
               "lh2v_occluded_persistent", "lh2v_set_persisting_l2",
               "lh2v_closest_l2window", "lh2v_occluded_l2window",
               "lh2v_closest_aos2", "lh2v_occluded_aos2"):
        getattr(lib, fn).restype = _i
    return lib, so, log


def load_parent(root):
    """The first CUDA port's BVH2 kernels from a checkout at `root`."""
    from lighthouse2_tpu_torch.render.kernels import trace as tk
    src = os.path.join(root, "lighthouse2_tpu_torch", "csrc", "trace.cu")
    so, log = tk.build_library(src)
    lib = ctypes.CDLL(so)
    lib.lh2_trace_closest.argtypes = [_p] * 9 + [_i] * 4 + [_p] * 6
    lib.lh2_trace_occluded.argtypes = [_p] * 9 + [_i] * 4 + [_p] * 3
    lib.lh2_trace_closest.restype = lib.lh2_trace_occluded.restype = _i
    return lib, so, log


def pack_aos2(bvh):
    """BVH2 array of structs, [M, 16] f32: the left and right child boxes
    (lo.xyz, hi.xyz each), then int32 left, right, count, first slot."""
    nbox = bvh.nbox.cpu().numpy()
    left, right, count = (x.cpu().numpy() for x in (bvh.left, bvh.right,
                                                     bvh.count))
    inner = count == 0
    rec = np.zeros((left.shape[0], 16), np.float32)
    rec[:, 0:6] = np.where(inner[:, None], nbox[:, np.where(inner, left, 0)].T,
                           0)
    rec[:, 6:12] = np.where(inner[:, None],
                            nbox[:, np.where(inner, right, 0)].T, 0)
    ints = np.stack([np.where(inner, left, 0), np.where(inner, right, 0),
                     count, np.where(inner, 0, left)], 1).astype(np.int32)
    rec[:, 12:16] = ints.view(np.float32)
    return torch.from_numpy(rec).to(bvh.nbox.device)


def make_runners(bvh, vlib, parent):
    """{name: (closest(o, d, tmax, stats), occluded(o, d, tmax, stats))};
    stats=True also returns the int32 [3, N] counts where the kernel has
    them. "shipped" is the render path's wrapper."""
    from lighthouse2_tpu_torch.bvh.wide import check_depth4
    from lighthouse2_tpu_torch.render.kernels.trace import (
        trace_closest, trace_occluded)
    check_depth4(bvh.depth4)
    dev = bvh.node4.device
    cap = 3 * bvh.depth4 + 1
    node, tri, ml = bvh.node4.data_ptr(), bvh.tri4.data_ptr(), bvh.max_leaf
    runners = {"shipped": (lambda o, d, tm, stats=False:
                           trace_closest(o, d, tm, bvh, stats=stats),
                           lambda o, d, tm, stats=False:
                           trace_occluded(o, d, tm, bvh, stats=stats))}

    def walk(vid):
        def closest(o, d, tm, stats=False):
            n = o.shape[0]
            out = _closest_out(n, dev)
            st = torch.empty((3, n), dtype=torch.int32, device=dev) if stats \
                else None
            _check(vlib.lh2v_walk(vid, 0, o.data_ptr(), d.data_ptr(),
                                  tm.data_ptr(), node, tri, ml, n,
                                  *(x.data_ptr() for x in out), None,
                                  st.data_ptr() if stats else None, cap,
                                  _stream()), f"walk {vid}")
            return out + (st,) if stats else out

        def occluded(o, d, tm, stats=False):
            n = o.shape[0]
            occ = torch.empty(n, dtype=torch.bool, device=dev)
            st = torch.empty((3, n), dtype=torch.int32, device=dev) if stats \
                else None
            _check(vlib.lh2v_walk(vid, 1, o.data_ptr(), d.data_ptr(),
                                  tm.data_ptr(), node, tri, ml, n, None, None,
                                  None, None, occ.data_ptr(),
                                  st.data_ptr() if stats else None, cap,
                                  _stream()), f"walk {vid}")
            return (occ, st) if stats else occ
        return closest, occluded

    for name, vid in WALKS.items():
        runners[name] = walk(vid)

    counter = torch.zeros(1, dtype=torch.int32, device=dev)

    def pers_closest(o, d, tm, stats=False):
        out = _closest_out(o.shape[0], dev)
        _check(vlib.lh2v_closest_persistent(
            o.data_ptr(), d.data_ptr(), tm.data_ptr(), node, tri, ml,
            o.shape[0], *(x.data_ptr() for x in out), counter.data_ptr(),
            _stream()), "persistent closest")
        return out

    def pers_occluded(o, d, tm, stats=False):
        occ = torch.empty(o.shape[0], dtype=torch.bool, device=dev)
        _check(vlib.lh2v_occluded_persistent(
            o.data_ptr(), d.data_ptr(), tm.data_ptr(), node, tri, ml,
            o.shape[0], occ.data_ptr(), counter.data_ptr(), _stream()),
            "persistent occluded")
        return occ
    runners["persistent_warps"] = (pers_closest, pers_occluded)

    # the L2 window needs one range: the nodes and triangles in one buffer
    scene = torch.cat([bvh.node4.reshape(-1), bvh.tri4.reshape(-1)])
    wnode = scene.data_ptr()
    wtri = wnode + bvh.node4.numel() * 4
    wbytes = scene.numel() * 4
    max_persist, max_window = ctypes.c_int(0), ctypes.c_int(0)
    _check(vlib.lh2v_set_persisting_l2(0, ctypes.byref(max_persist),
                                       ctypes.byref(max_window)), "L2 limit")
    reserve = min(max_persist.value, wbytes)
    wbytes = min(wbytes, max_window.value)
    hit_ratio = min(1.0, reserve / wbytes)
    _check(vlib.lh2v_set_persisting_l2(reserve, ctypes.byref(max_persist),
                                       ctypes.byref(max_window)), "L2 limit")
    l2 = dict(scene_bytes=scene.numel() * 4, reserved=reserve,
              window_bytes=wbytes, hit_ratio=hit_ratio,
              max_persisting=max_persist.value, max_window=max_window.value)

    def l2_closest(o, d, tm, stats=False):
        out = _closest_out(o.shape[0], dev)
        _check(vlib.lh2v_closest_l2window(
            o.data_ptr(), d.data_ptr(), tm.data_ptr(), wnode, wtri, ml,
            o.shape[0], *(x.data_ptr() for x in out), wnode, wbytes,
            hit_ratio, _stream()), "l2window closest")
        return out

    def l2_occluded(o, d, tm, stats=False):
        occ = torch.empty(o.shape[0], dtype=torch.bool, device=dev)
        _check(vlib.lh2v_occluded_l2window(
            o.data_ptr(), d.data_ptr(), tm.data_ptr(), wnode, wtri, ml,
            o.shape[0], occ.data_ptr(), wnode, wbytes, hit_ratio, _stream()),
            "l2window occluded")
        return occ
    runners["l2_window"] = (l2_closest, l2_occluded)
    runners["_keep"] = (scene, counter)

    node2 = pack_aos2(bvh)

    def aos2(ww):
        def closest(o, d, tm, stats=False):
            n = o.shape[0]
            out = _closest_out(n, dev)
            st = torch.empty((3, n), dtype=torch.int32, device=dev) if stats \
                else None
            _check(vlib.lh2v_closest_aos2(
                o.data_ptr(), d.data_ptr(), tm.data_ptr(), node2.data_ptr(),
                tri, ml, n, ww, *(x.data_ptr() for x in out),
                st.data_ptr() if stats else None, _stream()), "aos2 closest")
            return out + (st,) if stats else out

        def occluded(o, d, tm, stats=False):
            occ = torch.empty(o.shape[0], dtype=torch.bool, device=dev)
            _check(vlib.lh2v_occluded_aos2(
                o.data_ptr(), d.data_ptr(), tm.data_ptr(), node2.data_ptr(),
                tri, ml, o.shape[0], ww, occ.data_ptr(), None, _stream()),
                "aos2 occluded")
            return occ
        return closest, occluded
    runners["bvh2_aos_if_if"] = aos2(0)
    runners["bvh2_aos"] = aos2(1)
    runners["_keep"] += (node2,)

    if parent is not None:
        b2 = [bvh.nbox.data_ptr(), bvh.left.data_ptr(), bvh.right.data_ptr(),
              bvh.count.data_ptr(), bvh.prim.data_ptr(), bvh.tri9.data_ptr(),
              bvh.nbox.shape[1], bvh.prim.shape[0], ml]

        def par_closest(o, d, tm, stats=False):
            n = o.shape[0]
            out = _closest_out(n, dev)
            st = torch.empty((3, n), dtype=torch.int32, device=dev) if stats \
                else None
            _check(parent.lh2_trace_closest(
                o.data_ptr(), d.data_ptr(), tm.data_ptr(), *b2, n,
                *(x.data_ptr() for x in out),
                st.data_ptr() if stats else None, _stream()), "parent closest")
            return out + (st,) if stats else out

        def par_occluded(o, d, tm, stats=False):
            occ = torch.empty(o.shape[0], dtype=torch.bool, device=dev)
            _check(parent.lh2_trace_occluded(
                o.data_ptr(), d.data_ptr(), tm.data_ptr(), *b2, o.shape[0],
                occ.data_ptr(), None, _stream()), "parent occluded")
            return occ
        runners["parent_bvh2"] = (par_closest, par_occluded)
    return runners, l2


def time_launches(fn, reps, flush=None):
    """Mean device ms of one launch of fn over `reps` launches queued behind
    a device spin, each between its own pair of events; with `flush`, a
    write of that buffer precedes each launch."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(SLEEP_CYCLES)
    for r, (a, b) in enumerate(ev):
        if flush is not None:
            flush.fill_(float(r))
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / reps


def check_equal(name, kind, got, want):
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if g is not None and w is not None and not torch.equal(g, w):
            frac = (g == w).float().mean().item()
            raise AssertionError(f"{name} {kind} differs from its reference "
                                 f"on {1 - frac:.2e} of the elements")


def capture_main_path(scene, view, cfg, dev):
    """The (o, d, tmax) of every kernel launch of one main-path pass (after
    two warm-up passes)."""
    from lighthouse2_tpu_torch.render import wavefront as wf
    state = wf.AccumState.make(cfg, dev)
    for _ in range(2):
        state, _ = wf.render_pass_auto(scene, view, state, cfg)
    rec = {"closest": [], "occluded": []}
    orig = wf.trace_closest, wf.trace_occluded

    def capturing(kind, fn):
        def call(o, d, tmax, bvh, stats=False):
            tm = torch.broadcast_to(torch.as_tensor(tmax, dtype=torch.float32,
                                                    device=o.device),
                                    (o.shape[0],))
            rec[kind].append(tuple(x.contiguous().clone() for x in (o, d, tm)))
            return fn(o, d, tmax, bvh, stats)
        return call
    wf.trace_closest = capturing("closest", orig[0])
    wf.trace_occluded = capturing("occluded", orig[1])
    try:
        wf.render_pass_auto(scene, view, state, cfg)
    finally:
        wf.trace_closest, wf.trace_occluded = orig
    torch.cuda.synchronize()
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="checkout of an earlier commit whose "
                    "csrc/trace.cu has the BVH2 C interface")
    ap.add_argument("--out", default="chiprun_out/trace_variants.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from lighthouse2_tpu_torch.bvh.traverse import bvh_intersect, bvh_occluded
    from lighthouse2_tpu_torch.core.types import RenderConfig
    from lighthouse2_tpu_torch.render.kernels.trace import build_library
    from lighthouse2_tpu_torch.scene.bench_scene import bathroom

    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[env] {card}; torch {torch.__version__}", flush=True)
    so, log = build_library()
    vlib, vso, vlog = load_variants()
    print(f"[build] {vso}\n{vlog.strip()}", flush=True)
    parent = None
    if args.parent:
        parent, pso, plog = load_parent(args.parent)
        print(f"[build] parent {pso}\n{plog.strip()}", flush=True)

    cfg = RenderConfig(width=512, height=512, spp_per_pass=1,
                       max_path_length=16, use_bvh=True, path_regen=True)
    host, cam = bathroom(512, 512)
    scene, view = host.sync(dev), cam.get_view(dev)
    bvh = scene.bvh
    runners, l2 = make_runners(bvh, vlib, parent)
    print(f"[l2] {json.dumps(l2)}", flush=True)
    names = [k for k in runners if not k.startswith("_")]
    alts = [k for k in names if k not in ("shipped", "parent_bvh2")]
    bvh2 = {"bvh2_aos", "bvh2_aos_if_if", "parent_bvh2"}

    batches = chip_smoke.trace_batches(scene, view, cfg, dev)
    res = dict(card=card, l2=l2, fixed={}, main_path={})
    for bname, (o, d, tm) in batches.items():
        ref_c = runners["shipped"][0](o, d, tm, stats=True)
        ref_o = runners["shipped"][1](o, d, tm, stats=True)
        ref2_c = bvh_intersect(o, d, bvh, t_max=tm, stats=True)
        ref2_o = bvh_occluded(o, d, tm, bvh)
        for name in names:
            c_fn, o_fn = runners[name]
            stats = name in bvh2 or name in WALKS
            want_c = ref2_c if name in bvh2 else ref_c
            want_o = ref2_o if name in bvh2 else ref_o[0]
            got_c = c_fn(o, d, tm, stats=stats) if stats else c_fn(o, d, tm)
            check_equal(name, f"closest on {bname}", got_c,
                        want_c if stats else want_c[:4])
            got_o = o_fn(o, d, tm)
            check_equal(name, f"occluded on {bname}", got_o, want_o)
        order = (["parent_bvh2"] if parent else []) + ["shipped"] + alts
        order = order + order[::-1]
        times = {}
        for kind, k in (("closest", 0), ("occluded", 1)):
            for name in order:
                fn = runners[name][k]
                ms = time_launches(lambda: fn(o, d, tm), WARM_ITERS)
                times.setdefault(kind, {}).setdefault(name, []).append(ms)
        res["fixed"][bname] = times
        for kind in times:
            line = ", ".join(f"{n} {np.mean(v):.4f}" for n, v in
                             times[kind].items())
            print(f"[fixed] {bname} {kind} ms: {line}", flush=True)

    rec = capture_main_path(scene, view, cfg, dev)
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for kind, k in (("closest", 0), ("occluded", 1)):
        out = {}
        for o, d, tm in rec[kind]:
            for name in names + names[::-1]:
                fn = runners[name][k]
                out.setdefault(f"{name} warm", []).append(
                    time_launches(lambda: fn(o, d, tm), MAIN_WARM_ITERS))
                if name in ("shipped", "l2_window", "parent_bvh2"):
                    out.setdefault(f"{name} cold", []).append(time_launches(
                        lambda: fn(o, d, tm), COLD_REPS, flush=flush))
        res["main_path"][kind] = dict(launches=len(rec[kind]), per_batch=out)
        line = ", ".join(f"{n} {np.mean(v):.4f}" for n, v in out.items())
        print(f"[main] {kind}, mean over {len(rec[kind])} launches, ms: {line}",
              flush=True)
    vlib.lh2v_set_persisting_l2(0, ctypes.byref(ctypes.c_int()),
                                ctypes.byref(ctypes.c_int()))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)
    print(f"[done] {args.out}; {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
