"""The benchmark's files, found by name, and ``BENCHMARK.json`` against its contract."""

import json
import re

import pytest

from stereobench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "stereobench/run.py"]
    assert BENCH["paths"] == ["stereobench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_names_units_and_keys():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("stereobench/")
        assert (ROOT / c["file"]).exists()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                 "higher")
        assert m["name"] not in names
        names.add(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_every_config_is_used_and_names_its_sizes():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == [] and cfg["source"] == c["source"]
        for a in cfg["assumed"]:        # each departure from the paper is what is run
            assert cfg["model"][a["key"]] == a["run"] != a["paper"]
        assert (ROOT / cfg["weights"]).exists()
        assert cfg["model"]["compute_dtype"] == cfg["precision"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.find_cell(cell)
    assert (harness.HERE / "traffic" / f"{c.traffic['kind']}.py").exists()
    assert (harness.HERE / "reference" / f"{c.config['network']}.py").exists()
    assert (harness.HERE / "counts" / f"{c.config['network']}.py").exists()
    assert c.limits, "every cell's check has limits"
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e, f"{m['name']} moves a metric {cell} does not report"


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    mod = harness.load_module(harness.HERE / "metrics" / f"{metric}.py")
    assert callable(mod.read)


@pytest.mark.parametrize("path", sorted((harness.HERE / "metrics").glob("*.py")),
                         ids=lambda p: p.name)
def test_every_reader_returns_nothing_without_a_trace(path):
    ctx = harness.LayerContext(trace=None, frames_in_slice=0, census=None, ingest_bytes=0,
                               peaks=None, counters={})
    assert harness.load_module(path).read(ctx) is None


def test_per_layer_metric_without_cells_follows_its_moved_metric(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"].append({"name": "x.any", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device", "moves": "fps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for c in BENCH["configs"]:
        dst = tmp_path / c["file"]
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text((ROOT / c["file"]).read_text())
    bench["end_to_end"].append({"name": "other", "unit": "ms", "better": "lower", "bound": 0.1,
                                "source": "host_clock", "workloads": ["classic-bf16-offline-b32"]})
    bench["per_layer"].append({"name": "x.other", "unit": "ms", "better": "lower",
                               "source": "device_trace", "layer": "device", "moves": "other"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    fast = harness.find_cell("fast-bf16-offline-b32", root=tmp_path)
    classic = harness.find_cell("classic-bf16-offline-b32", root=tmp_path)
    assert "x.any" in {m["name"] for m in fast.per_layer}
    assert "x.other" not in {m["name"] for m in fast.per_layer}
    assert {"x.any", "x.other"} <= {m["name"] for m in classic.per_layer}


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.find_cell("no-such-cell")


def test_check_time_fits_with_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
