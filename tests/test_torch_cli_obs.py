"""The port CLI's observability flags on the CPU (`python -m
repro_torch.launch.solve --device cpu`), run in process through `main`
at 600 × 60 unless a test says otherwise:

  --log-jsonl           a run log that validates, renders with
                        `repro_torch.launch.report`, and carries the
                        manifest (argv, census as `byte_census`), the
                        generate / execute / host / census / certify /
                        export_primal spans, the objective build's
                        row_norm / ax_plan spans, one check a chunk, the
                        `metrics` digest;
  --log-level           the console's threshold; the run log keeps every
                        line;
  --profile-dir         forces a chunked solve (same result as the plain
                        run) and writes one trace of the chunk window;
  --metrics-port 0      serves /metrics during the run, closed after it;
  --max-host-rss-mb     the guard fires once;
  --json                stdout stays exactly one object, with
                        `peak_rss_bytes` / `peak_hbm_bytes` when the
                        sampler rode along.

The flags' names and defaults are the reference CLI's.  Under two gloo
ranks (torchrun) rank 0 alone writes the log.
"""
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import pytest

from repro.obs import LEVELS as RLEVELS
from repro_torch.launch import census, report, solve
from repro_torch.obs import LEVELS, load_run, validate_run

ROOT = Path(__file__).resolve().parents[1]
BASE = ["--device", "cpu", "--sources", "600", "--destinations", "60",
        "--iterations", "50", "--check-every", "10"]


def _main(capsys, *extra):
    """main() in process; returns (result, stdout, stderr)."""
    result = solve.main([*BASE, *extra])
    out = capsys.readouterr()
    return result, out.out, out.err


def _one_object(stdout):
    lines = stdout.strip().splitlines()
    assert len(lines) == 1, stdout
    return json.loads(lines[0])


@pytest.fixture(scope="module")
def logged(tmp_path_factory):
    """One run with every observability flag; its JSON, stderr and log."""
    d = tmp_path_factory.mktemp("obs")
    log = str(d / "run.jsonl")
    argv = [*BASE, "--json", "--certify", "--log-jsonl", log,
            "--profile-dir", str(d / "prof"), "--profile-start-chunk", "1",
            "--profile-num-chunks", "2", "--metrics-port", "0",
            "--max-host-rss-mb", "1", "--export-primal", str(d / "shards")]
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.solve",
                           *argv], cwd=ROOT, capture_output=True, text=True,
                          timeout=300,
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout, proc.stderr, log, d, argv


def test_flags_and_defaults_are_the_reference_clis():
    args = solve.build_parser().parse_args([])
    assert (args.log_jsonl, args.log_level, args.profile_dir,
            args.profile_start_chunk, args.profile_num_chunks,
            args.metrics_port, args.max_host_rss_mb) == (
        None, "info", None, 0, 1, None, None)
    assert sorted(LEVELS) == sorted(RLEVELS)


def test_json_stdout_is_one_object(logged):
    stdout, _, _, _, _ = logged
    result = _one_object(stdout)
    assert result["peak_rss_bytes"] > 0
    assert "peak_hbm_bytes" in result and result["peak_hbm_bytes"] is None
    assert result["certificate_valid"] is True


def test_rss_guard_fires_once(logged):
    _, stderr, log, _, _ = logged
    assert stderr.count("exceeds --max-host-rss-mb") == 1
    guard = [e for e in load_run(log).by_type("memory")
             if e.get("reason") == "rss_guard"]
    assert len(guard) == 1


def test_run_log_validates_and_carries_the_manifest(logged):
    stdout, _, log, _, argv = logged
    run = validate_run(log)
    man = run.manifest
    assert man["argv"] == argv
    assert man["device"] == "cpu" and man["device_name"] is None
    assert man["run_id"] == _one_object(stdout)["run_id"]
    assert man["peak_rss_bytes"] > 0 and man["compiled_peak_bytes"] > 0
    assert man["memory_samples"] > 5          # chunks + extraction chunks
    bc = man["byte_census"]
    assert bc["bytes_per_iteration"] == sum(
        k["bytes"] for k in bc["kernels"].values())
    assert list(bc["kernels"])[:2] == ["dual_x_slab", "ax_reduce_plan_x"]


def test_census_is_the_solving_objectives(logged):
    _, _, log, _, _ = logged
    args = solve.build_parser().parse_args(BASE)
    out = solve.run(args, log=lambda msg: None)
    assert census.evaluation_census(out.objective) == \
        load_run(log).manifest["byte_census"]


def test_run_log_spans_and_events(logged):
    _, _, log, _, _ = logged
    run = load_run(log)
    names = [s["name"] for s in run.by_type("span")]
    for name in ("generate", "census", "export_primal", "certify"):
        assert names.count(name) == 1, name
    assert names.count("execute") == names.count("host") == 5
    end = run.by_type("solve_end")[0]
    assert len(run.by_type("check")) == end["checks"] == 5
    assert run.by_type("solve_start")[0]["chunked"] is True
    series = run.by_type("metrics")[-1]["series"]
    assert "repro_memory_host_rss_bytes" in series
    assert "repro_memory_device_peak_bytes" in series
    acts = [(e["action"], e["chunk"]) for e in run.by_type("profile")]
    assert acts == [("start", 1), ("stop", 2)]


def test_run_log_carries_the_build_spans(logged, capsys):
    """The objective's build runs under the run log's recorder: its
    `row_norm` and `ax_plan` spans, and the solve's spans and counters,
    reach the log and the report."""
    _, _, log, _, _ = logged
    run = load_run(log)
    spans = run.by_type("span")
    names = [s["name"] for s in spans]
    assert names.count("row_norm") == names.count("ax_plan") == 1
    assert names.count("solve") == 1
    assert names.count("step") == names.count("calculate") == 50
    counters = run.by_type("counters")[-1]["counters"]
    assert counters["solve.evaluations"] == 50
    assert report.main([log]) == 0
    text = capsys.readouterr().out
    section = text.split("== spans by name ==")[1].split("==")[0]
    for name in ("row_norm", "ax_plan", "step", "calculate", "launch"):
        assert name in section, name


def test_report_renders_the_cli_log(logged, capsys):
    _, _, log, _, _ = logged
    assert report.main([log]) == 0
    text = capsys.readouterr().out
    for section in ("per-chunk wall-clock split", "trajectory (5",
                    "memory timeline", "byte census", "profiler (2)"):
        assert section in text, section
    assert report.main([log, "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)
    assert set(summary["chunks"]) == {"0", "1", "2", "3", "4"}
    assert summary["memory"]["rss_guard_trips"] == 1


def test_profile_window_trace(logged):
    _, _, _, d, _ = logged
    assert os.listdir(d / "prof") == ["trace_rank0_chunks1-2.json"]
    with open(d / "prof" / "trace_rank0_chunks1-2.json") as f:
        assert json.load(f)["traceEvents"]


def test_profile_dir_forces_chunked_with_the_same_result(capsys, tmp_path):
    plain, _, _ = _main(capsys, "--json")
    prof, _, _ = _main(capsys, "--json", "--profile-dir",
                       str(tmp_path / "p"))
    for k in ("iterations_run", "dual_obj_final", "infeas_final",
              "stop_reason"):
        assert plain[k] == prof[k], k
    assert os.listdir(tmp_path / "p") == ["trace_rank0_chunks0-0.json"]


def test_no_observability_flag_no_sampler(capsys):
    result, stdout, _ = _main(capsys, "--json")
    assert _one_object(stdout) == result
    assert "peak_rss_bytes" not in result


def test_log_level_quiets_the_console_not_the_log(capsys, tmp_path):
    log = str(tmp_path / "run.jsonl")
    _, stdout, stderr = _main(capsys, "--log-level", "warning",
                              "--log-jsonl", log)
    assert "iterations (agd" not in stdout + stderr
    msgs = [e["msg"] for e in load_run(log).by_type("log")]
    assert any("iterations (agd" in m for m in msgs)


def test_console_without_json_goes_to_stdout(capsys):
    _, stdout, stderr = _main(capsys)
    assert "iterations (agd" in stdout
    assert "iterations (agd" not in stderr


def test_metrics_port_serves_then_closes(capsys):
    _, _, stderr = _main(capsys, "--json", "--metrics-port", "0")
    line = [ln for ln in stderr.splitlines() if "serving /metrics on" in ln]
    assert len(line) == 1
    url = line[0].split("serving /metrics on ")[1].strip()
    assert url.startswith("http://127.0.0.1:")
    with pytest.raises(OSError):
        urllib.request.urlopen(url, timeout=2.0)


@pytest.mark.parametrize("first, outcome", [
    ((), "accept"),                   # the dump reached the target γ
    (("--continuation",), "reject")])  # it stopped at γ = 0.04 > 0.01
def test_warm_start_resolve_event(capsys, tmp_path, first, outcome):
    duals, log = str(tmp_path / "lam.npz"), str(tmp_path / "run.jsonl")
    _main(capsys, "--save-duals", duals, *first)
    _main(capsys, "--warm-start", duals, "--continuation", "--log-jsonl", log)
    resolves = load_run(log).by_type("resolve")
    assert [r["outcome"] for r in resolves] == [outcome]


def test_two_ranks_lead_alone_records(tmp_path):
    """With no tolerance the profiler alone makes the loop chunked: every
    rank must chunk alike (rank 1's profiler records nothing), or the
    chunk-boundary collectives would not pair up."""
    log = str(tmp_path / "run.jsonl")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.solve", *BASE,
         "--json", "--log-jsonl", log, "--max-host-rss-mb", "1",
         "--profile-dir", str(tmp_path / "prof")],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert len(out.stdout.strip().splitlines()) == 1
    run = validate_run(log)
    assert len(run.by_type("solve_start")) == 1
    assert run.manifest["ranks"] == 2
    assert run.manifest["byte_census"]["collective_bytes_per_iteration"] \
        == (1 * 60 + 2) * 4
    assert out.stderr.count("exceeds --max-host-rss-mb") == 1
    assert os.listdir(tmp_path / "prof") == ["trace_rank0_chunks0-0.json"]
    assert run.by_type("solve_start")[0]["chunked"] is True
