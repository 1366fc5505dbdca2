"""BENCHMARK.json against its format and limits, and every file a cell
needs found by the names it gives."""
import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
MAN = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(MAN["paths"]) <= 16
    for p in MAN["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    cmd = MAN["command"]
    assert len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_fields(entry):
    assert NAME.match(entry["name"])
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    for k in ("why", "layer", "source"):
        if k in entry:
            assert _line(entry[k])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")


def test_unique_names_and_allowed_keys():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_cell_files_found_by_name(cell):
    spec = harness.cell_spec(cell["name"])
    assert spec["config"]["name"] == cell["config"]
    drv = harness.load("drivers", spec["traffic"]["kind"])
    assert all(callable(getattr(drv, f)) for f in ("inputs", "drive", "check"))
    assert callable(harness.load("scenes", spec["config"]["scene"]).build)
    assert set(spec["checks"]) >= {"passes_missing", "nonfinite"}
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and spec["per_layer"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)
    for m in spec["per_layer"]:
        assert m["moves"] in e2e


@pytest.mark.parametrize("conf", MAN["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    path = os.path.join(ROOT, conf["file"])
    assert any(conf["file"].startswith(p + "/") for p in MAN["paths"])
    data = json.load(open(path))
    assert data["name"] == conf["name"]
    assert data["source"] == conf["source"]
    assert data["reduced"] == conf["reduced"]
    files = [c["file"] for c in MAN["configs"]]
    assert files.count(conf["file"]) == 1


def test_manifest_small():
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_new_cell_is_found_by_name_alone(tmp_path):
    """A cell of a new configuration, scene, mix, driver and metric is read
    from files alone: nothing of the harness names them."""
    bench = tmp_path / "benchmark"
    for d in ("configs", "scenes", "traffic", "drivers", "metrics", "checks"):
        (bench / d).mkdir(parents=True)
    man = dict(MAN, configs=[dict(name="toy-1", source="a paper",
                                  file="benchmark/configs/toy-1.json",
                                  reduced=[], why="a toy")],
               workloads=[dict(name="toy_cell", config="toy-1",
                               traffic="toy_mix", chips=1, why="a toy")],
               end_to_end=[dict(name="toy_rate", unit="1/s", better="higher",
                                bound=0.01, source="host_clock")],
               per_layer=[dict(name="toy.layer", unit="ms", better="lower",
                               source="device_trace", layer="toy",
                               moves="toy_rate")])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    (bench / "configs" / "toy-1.json").write_text(json.dumps(
        dict(name="toy-1", scene="toy", width=4)))
    (bench / "traffic" / "toy_mix.json").write_text(json.dumps(
        dict(kind="toy", n=3)))
    (bench / "checks" / "toy_cell.json").write_text(json.dumps(dict(gap=0)))
    (bench / "scenes" / "toy.py").write_text(
        "def build(conf):\n    return dict(w=conf['width'])\n")
    (bench / "drivers" / "toy.py").write_text(
        "def inputs(ctx, seed): pass\n"
        "def drive(ctx): return dict(kind='toy')\n"
        "def check(ctx, out, dtype=None): return dict(gap=0)\n")
    (bench / "metrics" / "toy.layer.py").write_text(
        "def read(rec):\n    return 1.0\n")
    root = str(tmp_path)
    spec = harness.cell_spec("toy_cell", root=root)
    assert spec["config"]["scene"] == "toy" and spec["traffic"]["n"] == 3
    assert spec["checks"] == dict(gap=0)
    assert [m["name"] for m in spec["per_layer"]] == ["toy.layer"]
    assert harness.load("scenes", "toy", root).build(spec["config"]) \
        == dict(w=4)
    assert harness.load("drivers", "toy", root).drive({}) == dict(kind="toy")
    assert harness.metric_reader("toy.layer", root).read({}) == 1.0
