"""A run of each cell rehearsed on the CPU at a tiny size: the window, the
reference's check and the result line, with the program's plain versions
in place of its kernels (no device trace)."""
import json

import pytest
import torch

from lpbench import run
from lpbench.tests.tiny import one_thread, tiny  # noqa: F401

CHECK_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def rehearse(cell_name, trace=False, seed=2**31 + 7):
    bench, cell, config, traffic = tiny(cell_name)
    return run.run_cell(bench, cell, config, traffic, seed, 0.2, trace,
                        "cpu")


@pytest.mark.parametrize("cell", ["matching-2m.cold", "multi_budget-2m.cold"])
def test_rehearsal_line(cell):
    result = rehearse(cell, trace=True)
    line = json.loads(json.dumps(result))
    assert CHECK_KEYS <= set(line) and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for name, m in line["metrics"].items():
        assert m["value"] > 0 and m["unit"], name
    # the per-layer metrics that need no device trace are read
    assert {"setup.build_s", "engine.iters", "engine.host_ms"} <= set(
        line["metrics"])
    for v in line["checks"].values():
        assert v["value"] <= v["limit"]
    plain = rehearse(cell, trace=False)
    assert set(plain["metrics"]) == {"setup_s", "solve_s"}


@pytest.mark.cuda
def test_run_on_the_card(tmp_path):
    """The command itself, on a card, at the tiny size (skips without
    one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    bench, cell, config, traffic = tiny("matching-2m.cold")
    result = run.run_cell(bench, cell, config, traffic, 5, 0.2, True,
                          "cuda:0")
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
