"""Smoke-test bench.py, the benchmark script.

The card tests run both of its stepping paths (one whole-ensemble chunk
and host-dispatched chunks) at smoke size in this process; the CPU test
checks that it refuses to run without a GPU.
"""

import json
import os
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402


def run_bench(monkeypatch, capsys, extra_env):
    for k, v in {"PAM_BENCH_MICRO": "kessler", "PAM_BENCH_SGS": "none",
                 "PAM_BENCH_NENS": "4", "PAM_BENCH_STEPS": "2",
                 "PAM_BENCH_REPS": "1", "PAM_BENCH_TRACE_STEPS": "1",
                 **extra_env}.items():
        monkeypatch.setenv(k, v)
    assert bench.main() == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln]
    rec = json.loads(lines[-1])
    assert rec["unit"] == "gridpoint-steps/s"
    assert rec["value"] > 0 and rec["ms_per_step"] > 0
    assert rec["reps"] == 1
    assert rec["platform"] == "gpu" and rec["device_count"] >= 1
    assert rec["device_kind"] and rec["card"]
    return rec


@pytest.mark.card
def test_bench_single_config(gpu, monkeypatch, capsys):
    rec = run_bench(monkeypatch, capsys, {})
    assert rec["config"].endswith("nens=4,ens_chunk=4")


@pytest.mark.card
def test_bench_hostchunked_branch(gpu, monkeypatch, capsys):
    rec = run_bench(monkeypatch, capsys, {"PAM_BENCH_CHUNK": "2"})
    assert rec["config"].endswith("nens=4,ens_chunk=2")


def test_bench_refuses_cpu(capsys):
    import jax
    if jax.devices()[0].platform == "gpu":
        pytest.skip("checks the refusal on a CPU")
    assert bench.main() == 2
    assert capsys.readouterr().out == ""
