"""The port's public surface against the JAX package's, by name and
signature, and the port's independence from JAX.

  - every public function and class defined at the top of a JAX module,
    the names a JAX package __init__ exports and the staged and regen
    executors' private entry points have a counterpart of the same name in
    the port's module at the same path, but for the moves in MOVED (each
    with its reason); OMITTED lists deliberate omissions (none);
  - each such function's leading positional parameters are JAX's, with
    the same names in the same order; the port's extra parameters come
    after them, with a default or keyword-only;
  - no .py file of the port, no card test (tests/test_torch_*_card.py),
    not their helper module tests/card_support.py and not chip_smoke.py
    imports jax, flax, optax or lighthouse2_tpu (an ast scan, so nothing is
    imported): these run on the card's machine, which has no JAX;
  - the key under which render/graphs.py caches a captured pass (the
    counterpart of jax.jit's cache): equal for calls whose tensors have
    the same shapes, whatever their values; another for another shape,
    dtype, config, baked scalar or entry point.
The JAX side is read with ast and never imported; no JAX compile.
"""
import ast
import importlib
import inspect
import pathlib

import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "lighthouse2_tpu"
PORT_PKG = ROOT / "lighthouse2_tpu_torch"

# private names of the JAX executors that code calls by name (the staged
# executor's stages, the regen pass, the shared finish)
PRIVATE = {"render/wavefront.py": (
    "_stage_generate", "_stage_prepare", "_stage_trace", "_stage_shade",
    "_stage_occlude", "_stage_apply", "_stage_finish", "_finish_pass",
    "_render_pass_regen_jit")}

# (JAX module, name) -> (port module, reason)
_CLUSTER = ("render/kernels/cluster.py",
            "the Pallas kernels' wrappers live beside the cluster kernels' "
            "bindings; render/kernels/trace.py binds the BVH4 kernels")
MOVED = {
    ("render/kernels/trace.py", "trace_cluster_bvh"): _CLUSTER,
    ("render/kernels/trace.py", "ray_sort_perm"): _CLUSTER,
    ("render/kernels/trace.py", "prepare_pay_tiles"): _CLUSTER,
    ("render/kernels/trace.py", "bake_material_rows"): _CLUSTER,
    ("parallel/scene_shard.py", "make_mesh2d"): (
        "parallel/mesh.py", "Mesh2D and its subgroups sit with the 1-D "
        "Mesh, both handles on torch.distributed groups"),
}
# (JAX module, name) -> reason
OMITTED = {}


def _module_name(rel: pathlib.PurePath, pkg: str) -> str:
    parts = list(rel.with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join([pkg, *parts])


def _jax_surface():
    """{(module path, name): ast node or None (an __init__ export)}."""
    out = {}
    for path in sorted(JAX_PKG.rglob("*.py")):
        rel = path.relative_to(JAX_PKG).as_posix()
        tree = ast.parse(path.read_text())
        keep = PRIVATE.get(rel, ())
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and (
                    not node.name.startswith("_") or node.name in keep):
                out[(rel, node.name)] = node
            elif (path.name == "__init__.py"
                  and isinstance(node, ast.ImportFrom)
                  and (node.module or "").startswith(JAX_PKG.name)):
                for a in node.names:
                    out[(rel, a.asname or a.name)] = None
    return out


def _port(rel: str, name: str):
    mod_rel = MOVED.get((rel, name), (rel,))[0]
    mod = importlib.import_module(
        _module_name(pathlib.PurePosixPath(mod_rel), PORT_PKG.name))
    return getattr(mod, name, None)


def test_every_jax_name_has_a_port_counterpart():
    surface = _jax_surface()
    assert len(surface) > 250
    for key, (mod, reason) in MOVED.items():
        assert key in surface and reason, key
    missing = [f"{rel}:{name}" for rel, name in surface
               if (rel, name) not in OMITTED and _port(rel, name) is None]
    assert not missing, missing


def _positional(sig):
    return [p for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def test_signatures_lead_with_jax_parameters():
    bad = []
    for (rel, name), node in _jax_surface().items():
        if not isinstance(node, ast.FunctionDef) or (rel, name) in OMITTED:
            continue
        want = [a.arg for a in node.args.posonlyargs + node.args.args]
        sig = inspect.signature(_port(rel, name))
        pos = _positional(sig)
        got = [p.name for p in pos]
        extra = pos[len(want):]
        if got[:len(want)] != want or any(
                p.default is p.empty for p in extra):
            bad.append(f"{rel}:{name} JAX {want}, port {got}")
    assert not bad, "\n".join(bad)


BANNED = ("jax", "jaxlib", "flax", "optax", "lighthouse2_tpu")


def test_port_imports_nothing_of_jax():
    cards = sorted((ROOT / "tests").glob("test_torch_*_card.py"))
    assert len(cards) >= 7
    files = (sorted(PORT_PKG.rglob("*.py")) + cards
             + [ROOT / "tests" / "card_support.py", ROOT / "chip_smoke.py"])
    assert len(files) > 60
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                if m.split(".")[0] in BANNED:
                    bad.append(f"{path.relative_to(ROOT)}:{node.lineno} {m}")
    assert not bad, bad


def test_graph_cache_key():
    import dataclasses

    from lighthouse2_tpu_torch.core.types import RenderConfig, ViewPyramid
    from lighthouse2_tpu_torch.render.graphs import cache_key
    from lighthouse2_tpu_torch.render.wavefront import AccumState

    cfg = RenderConfig(width=8, height=8, max_path_length=2, path_regen=True)

    def view(x):
        v3 = torch.full((3,), x)
        v0 = torch.tensor(x)
        return ViewPyramid(v3, v3, v3, v3, v0, v0, v0, v0, v0)

    def key(name="_render_pass_regen_jit", v=0.0, state=None, config=cfg,
            extra=4):
        state = state or AccumState.make(config, "cpu")
        return cache_key(name, view(v), state, config, extra)

    a = key()
    assert a == key(v=1.5)                       # other values, same shapes
    moved = AccumState.make(cfg, "cpu")
    moved.cam_seed = moved.cam_seed + 7
    assert a == key(state=moved)
    assert hash(a) == hash(key(v=2.0))
    wide = dataclasses.replace(cfg, width=16)
    others = dict(
        entry=key(name="render_pass_unrolled"),
        config=key(config=dataclasses.replace(cfg, remat=True)),
        shape=key(state=AccumState.make(wide, "cpu")),
        dtype=key(state=dataclasses.replace(
            AccumState.make(cfg, "cpu"),
            sample_count=torch.zeros((), dtype=torch.int64))),
        scalar=key(extra=5),
        structure=key(state=dataclasses.replace(
            AccumState.make(cfg, "cpu"),
            pixel_count=torch.zeros(64))))
    assert all(k != a for k in others.values()), [
        n for n, k in others.items() if k == a]


def test_captured_call_bookkeeping():
    """CapturedCall's copies into its static inputs and out of its pool,
    with a stub in place of the CUDA graph (the CPU cannot run one): the
    stub's replay recomputes the call on the static inputs into the
    captured outputs' storage, as a graph's replay writes its pool."""
    from lighthouse2_tpu_torch.render import graphs

    def fn(scene, params):
        y = scene["verts"] * params["color"].sum() + params["offset"]
        return y, {"y": y, "total": params["offset"].sum()}

    def tensors_of(x):
        ts = []
        graphs._walk(x, ts)
        return ts

    scene = {"verts": torch.arange(6.0).reshape(2, 3)}
    leaf = torch.ones(3, requires_grad=True)
    offset = torch.zeros(2, 3)
    params = lambda: {"color": leaf.detach(), "offset": offset}

    cc = graphs.CapturedCall("f", fn)
    args = (scene, params())
    cc.entry = graphs._Entry(graphs.cache_key("f", *args))
    static_args = cc._stage(args, tensors_of(args))
    out = fn(*static_args)

    class StubGraph:
        def replay(self):
            for o, n in zip(tensors_of(out), tensors_of(fn(*static_args))):
                o.copy_(n)

    cc.entry.graph, cc.entry.out = StubGraph(), out

    def call(*a):
        cc._load(tensors_of(a))
        return cc._replay()

    def check(got, *a):
        want = fn(*a)
        assert graphs._walk(got, []) == graphs._walk(want, [])
        for g, w in zip(tensors_of(got), tensors_of(want)):
            assert torch.equal(g, w)

    # an untouched tensor already copied in is read in place, not copied
    verts_static = cc.entry.static[0]
    verts_static.fill_(-1.0)
    r1 = call(scene, params())
    assert torch.equal(verts_static, torch.full((2, 3), -1.0))
    verts_static.copy_(scene["verts"])
    r1 = call(scene, params())
    check(r1, scene, params())
    # results are the caller's: clones out of the pool, aliases kept
    assert r1[0] is r1[1]["y"]
    assert r1[0].data_ptr() != out[0].data_ptr()
    kept = [t.clone() for t in tensors_of(r1)]

    # an optimizer's in-place step on the leaf (same storage, a new
    # version) is copied in
    opt = torch.optim.SGD([leaf], lr=0.25)
    leaf.grad = torch.tensor([1.0, 2.0, 3.0])
    opt.step()
    r2 = call(scene, params())
    check(r2, scene, params())
    assert not torch.equal(r2[0], kept[0])
    # so are a scene tensor changed in place and a tensor at a new address
    with torch.no_grad():
        scene["verts"].mul_(2.0)
    offset = torch.full((2, 3), 0.5)
    r3 = call(scene, params())
    check(r3, scene, params())
    # a later replay leaves the results the caller holds as they were
    for t, k in zip(tensors_of(r1), kept):
        assert torch.equal(t, k)
    assert cc.replays == 4
