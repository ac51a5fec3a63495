"""``BENCHMARK.json`` against the benchmark's contract, and the lookup of
configurations, mixes and metric readers by name."""

import json
import os
import re
import shutil

from fsbench import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "fsbench/run.py"]
    assert BENCH["paths"] == ["fsbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits: 2 + 14 runs a cell, run + 60 s each,
    # 2 x 90 s of compile a cell, 1200 s spare
    n = 24
    assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in metrics + BENCH["workloads"] + BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must():
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:
        e2e = {m["name"] for m in manifest.end_to_end(BENCH, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(BENCH, cell)
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert m["moves"] in {x["name"] for x in manifest.end_to_end(BENCH, cell)}
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_every_configuration_keeps_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("fsbench/") and LINE.match(c["source"])
        cfg = manifest.config(BENCH, c["name"])
        assert cfg["source"] == c["source"]
        assert set(c["reduced"]) == set(cfg["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_every_name_has_its_file():
    for w in BENCH["workloads"]:
        mix = manifest.traffic(w["traffic"])
        kind = manifest.kind(mix["kind"])
        assert all(callable(getattr(kind, hook)) for hook in ("setup", "drive", "check"))
        if "kill" in mix:
            kill = manifest.kill(mix["kill"])
            assert callable(kill.apply) and callable(kill.check)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        if m["name"] != "setup_s":
            assert callable(manifest.reader(m["name"]))


def test_a_new_file_is_found_by_name(tmp_path):
    """A later change adds a configuration, a mix, a kind of load, a failure
    and a metric as files and entries, and edits no file that is there."""
    root = tmp_path / "checkout"
    shutil.copytree(manifest.ROOT + "/fsbench", root / "fsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.loads(open(os.path.join(manifest.ROOT, bench["configs"][0]["file"])).read())
    cfg["name"] = "ec4_2_7cs"
    (root / "fsbench/configs/ec4_2_7cs.json").write_text(json.dumps(cfg))
    (root / "fsbench/traffic/tiny_write.json").write_text(
        json.dumps({"kind": "open_write", "kill": "master"}))
    (root / "fsbench/kinds/open_write.py").write_text(
        "async def setup(cell):\n    pass\n\n\nasync def drive(cell, t0):\n    pass\n\n\n"
        "async def check(cell):\n    cell.check('x', 0, 0)\n")
    (root / "fsbench/kills/master.py").write_text(
        "async def apply(cell):\n    pass\n\n\nasync def check(cell):\n    pass\n")
    (root / "fsbench/metrics/new.metric.py").write_text("def read(w):\n    return 42.0\n")
    bench["configs"].append({**bench["configs"][0], "name": "ec4_2_7cs",
                             "file": "fsbench/configs/ec4_2_7cs.json"})
    bench["workloads"].append({"name": "ec4_2-tiny", "config": "ec4_2_7cs",
                               "traffic": "tiny_write", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "new.metric", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "client",
                               "moves": "setup_s", "workloads": ["ec4_2-tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    loaded = manifest.load(str(root))
    assert manifest.config(loaded, "ec4_2_7cs", str(root))["name"] == "ec4_2_7cs"
    mix = manifest.traffic("tiny_write", str(root / "fsbench"))
    assert mix == {"kind": "open_write", "kill": "master"}
    assert callable(manifest.kind(mix["kind"], str(root / "fsbench")).drive)
    assert callable(manifest.kill(mix["kill"], str(root / "fsbench")).apply)
    assert manifest.reader("new.metric", str(root / "fsbench"))(None) == 42.0
    assert [m["name"] for m in manifest.per_layer(loaded, "ec4_2-tiny")] == ["new.metric"]
    assert {m["name"] for m in manifest.end_to_end(loaded, "ec4_2-tiny")} == {"setup_s"}
