"""BENCHMARK.json against the benchmark's files: every cell names a
configuration and a traffic mix that exist, every metric has its reader,
and every name and unit keeps to the characters allowed."""
import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (ROOT / p).is_dir() and not p.startswith("/") and ".." not in p


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files_exist(cell):
    configs = {c["name"]: c for c in BENCH["configs"]}
    assert cell["config"] in configs
    cfg_file = ROOT / configs[cell["config"]]["file"]
    config = json.loads(cfg_file.read_text())
    assert config["name"] == cell["config"]
    assert (ROOT / "lpbench" / "traffic" / f"{cell['traffic']}.json").is_file()
    assert cell["chips"] in (1, 4) and len(cell["why"]) <= 200
    assert set(config["checks"]) == {"dual_rel", "grad_rel", "kkt_rel"}
    assert set(config["reduced"]) == set(configs[cell["config"]]["reduced"])


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in METRICS]
             + [w[k] for w in BENCH["workloads"] for k in ("config",
                                                          "traffic")]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[kind]}) == len(BENCH[kind])
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_bounds_and_layers():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_every_metric_has_a_reader(metric):
    path = ROOT / "lpbench" / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    # a reader that finds nothing to read returns nothing, never 0
    empty = {"solves": [], "records": [], "trace": {}, "setup_s": 1.0,
             "build_s": 1.0, "evaluation_bytes": 1, "hbm_bytes_per_s": 1.0}
    value = mod.read(empty)
    assert value is None or value > 0
