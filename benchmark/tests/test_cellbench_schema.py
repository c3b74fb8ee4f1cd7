"""The result line's schema, and a run that refuses to print one."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import cellbench_tiny

REPO = cellbench_tiny.REPO


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    return cellbench_tiny.tiny_root(tmp_path_factory.mktemp("bench"))


def test_result_line_schema(registry):
    out = harness.run_cell("tiny-forecast", cellbench_tiny.SEED, 0.2, False, registry, "cpu")
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"forecast_rate", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())
    json.dumps(out)

    traced = harness.run_cell("tiny-forecast", cellbench_tiny.SEED, 0.2, True, registry, "cpu")
    assert list(traced)[-2:] == ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in traced["breakdown"].values())
    assert "forecast_rate" not in traced["metrics"] and "mfu.forecast" in traced["metrics"]


def test_without_the_cells_cards_no_result_is_printed(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "forecast-375m-heun20", "--seed", str(2**32 + 5), "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, BENCH_RUN="1"))
    assert r.returncode != 0 and r.stdout.strip() == ""
