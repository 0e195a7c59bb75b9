"""BENCHMARK.json against the benchmark's contract, and the harness's
promise that a cell, a configuration or a per-layer metric is added by new
files and new manifest entries alone."""

import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
HERE = os.path.join(ROOT, "portbench")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line_ok(text: str) -> bool:
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert isinstance(bench["command"], list) and 1 <= len(bench["command"]) <= 32
    assert all(line_ok(w) for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and os.path.isdir(os.path.join(ROOT, p))
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_entries_have_exactly_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_lines(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end" and not (group == "per_layer" and key == "source"):
                    assert line_ok(e[key]), (e["name"], key)
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in bench["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    metrics = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metrics) == len(set(metrics))
    for group in ("configs", "workloads"):
        got = [n for g, n in names if g == group]
        assert len(got) == len(set(got))
    assert len({(w["config"], w["traffic"]) for w in bench["workloads"]}) == len(bench["workloads"])


def test_counts_and_bounds(bench):
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_found_by_name(bench):
    """Every cell's file, driver and configuration, and every per-layer
    metric's reader, by the name the manifest gives."""
    from portbench import harness

    configs = {c["name"]: c for c in bench["configs"]}
    used = set()
    for w in bench["workloads"]:
        spec = harness.cell_spec(w["name"])
        assert spec["config"] == w["config"]
        assert os.path.exists(os.path.join(HERE, "drivers", f"{spec['driver']}.py"))
        assert hasattr(harness.driver_module(spec["driver"]), "run")
        c = configs[w["config"]]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = harness.config_file(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        used.add(c["name"])
    assert used == set(configs)
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)


def test_every_cell_reports_what_it_must(bench):
    from portbench import harness

    e2e = {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        mine = {m["name"] for m in harness.end_to_end_for(bench, w["name"])}
        assert "setup_s" in mine and len(mine) >= 2
        assert harness.per_layer_for(bench, w["name"])
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in harness.end_to_end_for(bench, cell)}
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    assert all(line_ok(k) for k in layers)


def _digest(root: str) -> dict:
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_config_and_metric_added_by_files_alone(tmp_path):
    """A throwaway configuration, cell and per-layer metric in a copy of
    the benchmark: new files and new manifest entries, no edited file; the
    harness finds each by its name."""
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = _digest(str(tmp_path / "portbench"))
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "vacnic_full.json").read_text())
    cfg["name"] = "vacnic_extra"
    (pb / "configs" / "vacnic_extra.json").write_text(json.dumps(cfg))
    spec = json.loads((pb / "workloads" / "vacnic_full.caption_b256.json").read_text())
    spec.update(config="vacnic_extra", batch=128)
    (pb / "workloads" / "vacnic_extra.caption_b128.json").write_text(json.dumps(spec))
    (pb / "metrics" / "extra_probe.caption.py").write_text("def read(rec):\n    return 1.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "vacnic_extra", "source": "https://example.org/x",
                             "file": "portbench/configs/vacnic_extra.json", "reduced": [],
                             "why": "throwaway"})
    bench["workloads"].append({"name": "vacnic_extra.caption_b128", "config": "vacnic_extra",
                               "traffic": "caption_b128", "chips": 1, "why": "throwaway"})
    bench["end_to_end"][0]["workloads"].append("vacnic_extra.caption_b128")
    bench["per_layer"].append({"name": "extra_probe.caption", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "captions_per_s", "workloads": ["vacnic_extra.caption_b128"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json; from portbench import harness\n"
        "b = harness.load_manifest('.')\n"
        "c = harness.find_cell(b, 'vacnic_extra.caption_b128')\n"
        "s = harness.cell_spec(c['name']); k = harness.config_file(c['config'])\n"
        "d = harness.driver_module(s['driver'])\n"
        "m = [x['name'] for x in harness.per_layer_for(b, c['name'])]\n"
        "print(json.dumps([s['batch'], k['name'], d.__name__, m,"
        " harness.metric_reader('extra_probe.caption').read(None)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    batch, cfg_name, driver, metrics, probe = json.loads(out.stdout.strip().splitlines()[-1])
    assert (batch, cfg_name, probe) == (128, "vacnic_extra", 1.0)
    assert driver.endswith("caption_closed") and "extra_probe.caption" in metrics
    after = _digest(str(pb))
    changed = {k for k in before if before[k] != after.get(k)}
    assert not changed
