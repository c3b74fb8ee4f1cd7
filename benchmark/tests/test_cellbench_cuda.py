"""Each cell as its command runs it, on the card: one short run and one
traced run, correct. Skips without CUDA."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests import cellbench_tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in harness.Registry().benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell):
    for trace in ("0", "1"):
        r = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                            "--seed", str(2**31 + 99), "--seconds", "3", "--trace", trace],
                           cwd=cellbench_tiny.REPO, capture_output=True, text=True, timeout=1200)
        assert r.returncode == 0, r.stderr[-2000:]
        line = json.loads(r.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["metrics"], line
