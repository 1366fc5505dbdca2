"""The window arithmetic, the profiler reading, the roofline count and the
forbidden-module check, on synthetic inputs."""
import os
import subprocess
import sys

import pytest

from benchmark import harness, profiling, roofline


def _rec(**kw):
    rec = dict(kind="progressive", spans=dict(setup_s=12.5, sync_s=3.0,
                                              warmup_s=2.0),
               window=dict(seconds=10.0, passes=80, rays=600_000_000),
               trace=None, peak_bytes=1_500_000_000, n_tris=129252)
    rec.update(kw)
    return rec


def test_rate_over_all_work_and_time():
    read = harness.metric_reader("fwd_mrays").read
    assert read(_rec()) == pytest.approx(60.0)
    # the same work over twice the time is half the rate
    assert read(_rec(window=dict(seconds=20.0, passes=80,
                                 rays=600_000_000))) == pytest.approx(30.0)
    assert read(_rec(kind="step")) is None


def test_setup_and_memory_readers():
    assert harness.metric_reader("setup_s").read(_rec()) == 12.5
    assert harness.metric_reader("sync_s").read(_rec()) == 3.0
    assert harness.metric_reader("warmup_s").read(_rec()) == 2.0
    assert harness.metric_reader("peak_mem_gb").read(_rec()) == pytest.approx(1.5)


def test_pace_readers_split_the_two_device_states():
    fast = harness.metric_reader("fast_pass_ms.fwd").read
    slow = harness.metric_reader("slow_share.fwd").read
    ms = [122.5] * 30 + [105.2, 105.0, 105.1] * 30
    w = dict(seconds=10.0, passes=121, rays=1, pass_ms=ms)
    assert fast(_rec(window=w)) == pytest.approx(105.1)
    assert slow(_rec(window=w)) == pytest.approx(25.0)
    # a run in one state reads that state's pace and no slow passes
    one = dict(w, pass_ms=[122.5, 122.4, 122.6])
    assert fast(_rec(window=one)) == pytest.approx(122.5)
    assert slow(_rec(window=one)) == 0.0
    # nothing to read: no timed passes, or another kind of run
    assert fast(_rec()) is None and slow(_rec()) is None
    assert fast(_rec(kind="step", window=w)) is None


def _trace():
    # device ops (name, start us, end us) in a window 0..1000 us: two
    # overlapping kernels, a gap, a trace kernel, a copy
    dev = [("void shade_a()", 0.0, 300.0), ("void shade_b()", 200.0, 400.0),
           ("closest_kernel(Ray const*, float*)", 600.0, 700.0),
           ("Memcpy DtoD (Device -> Device)", 700.0, 800.0)]
    host = [("cudaGraphLaunch", 350.0, 650.0), ("aten::clone", 390.0, 420.0)]
    return dict(dev=dev, host=host, span=(0.0, 1000.0), passes=2,
                live_closest=1000, live_shadow=500, lanes=1024, launches=4)


def test_idle_share_from_a_timeline():
    tr = _trace()
    assert profiling.busy_seconds(tr["dev"], tr["span"]) == pytest.approx(600e-6)
    idle = harness.metric_reader("device_idle.fwd").read(_rec(trace=tr))
    assert idle == pytest.approx(40.0)
    gaps = profiling.idle_gaps(tr["dev"], tr["host"], tr["span"])
    assert gaps[0] == ("aten::clone", pytest.approx(200e-6))
    assert gaps[1] == ("host", pytest.approx(200e-6))


def test_profiler_buffer_gaps_are_left_out_of_the_idle_share():
    # the gap at 400..600 us falls while the host flushes the profiler's
    # buffers: the window counts 800 us, of which 200 idle
    tr = dict(_trace(), host=[("Buffer Flush", 390.0, 620.0)])
    assert profiling.idle_gaps(tr["dev"], tr["host"], tr["span"])[0] \
        == ("Buffer Flush", pytest.approx(200e-6))
    idle = harness.metric_reader("device_idle.fwd").read(_rec(trace=tr))
    assert idle == pytest.approx(25.0)


def test_launches_and_shading_time_per_pass():
    tr = _trace()
    assert harness.metric_reader("launches.fwd").read(_rec(trace=tr)) == 2.0
    # every op but the trace kernel: 300 + 200 + 100 us over 2 passes
    assert harness.metric_reader("shade_ms.fwd").read(_rec(trace=tr)) \
        == pytest.approx(0.3)


def test_kernel_name_is_matched_whole():
    assert profiling.kernel_name("cluster_closest_kernel(float4 const*)") \
        == "cluster_closest_kernel"
    assert profiling.kernel_name("void closest_kernel<4>(Ray)") \
        == "closest_kernel<4>"


def test_roofline_count_on_a_tiny_scene():
    # 8 triangles: a walk is 3 box pairs and a triangle test
    assert roofline.walk_ops(8) == 3 * 50 + 54
    n_bytes, n_ops = roofline.trace_work(8, 4, 2, 3, 1)
    assert n_bytes == 2 * (2 * 8 * 36 + 4 * (2 * 28 + 16 + 1))
    assert n_ops == 4 * (3 * 50 + 54)
    t, bound = roofline.least_seconds(n_bytes, n_ops)
    assert bound == "bytes" and t == pytest.approx(n_bytes / 3.35e12)
    tr = _trace()
    share = harness.metric_reader("trace_roofline.fwd").read(
        _rec(trace=tr, n_tris=8))
    nb, no = roofline.trace_work(8, 1024, 4, 1000, 500)
    least = max(nb / 3.35e12, no / 67e12)
    assert share == pytest.approx(100 * least / 100e-6)
    assert 0 < share <= 100


def test_roofline_is_silent_without_trace_kernels():
    tr = dict(_trace(), dev=[("void shade_a()", 0.0, 300.0)])
    assert harness.metric_reader("trace_roofline.fwd").read(_rec(trace=tr)) \
        is None
    assert harness.metric_reader("launches.fwd").read(_rec()) is None


def test_seed_mix_fits_32_bits():
    for s in (0, 1, 2**31 + 5, 2**33 + 7):
        assert 0 <= harness.mix32(s) <= 0xFFFFFFFF
    assert harness.mix32(5) != harness.mix32(6)


def test_forbidden_modules_in_a_subprocess():
    code = (
        "import sys, types\n"
        "from benchmark import harness\n"
        "for n in ('lighthouse2_tpu_torch', 'lighthouse2_tpu_torch.render',"
        " 'jaxfoo', 'flaxen'):\n"
        "    sys.modules.setdefault(n, types.ModuleType(n))\n"
        "assert harness.forbidden_modules(sys.modules) == [], "
        "harness.forbidden_modules(sys.modules)\n"
        "for n in ('jax', 'jax.numpy', 'jaxlib', 'flax', 'lighthouse2_tpu',"
        " 'lighthouse2_tpu.render'):\n"
        "    sys.modules[n] = types.ModuleType(n)\n"
        "print(','.join(harness.forbidden_modules(sys.modules)))\n")
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=harness.ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().split(",") == [
        "flax", "jax", "jax.numpy", "jaxlib", "lighthouse2_tpu",
        "lighthouse2_tpu.render"]


def test_run_without_a_card_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "bathroom_auto_fwd", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], capture_output=True,
                         text=True, env=env, cwd=harness.ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
