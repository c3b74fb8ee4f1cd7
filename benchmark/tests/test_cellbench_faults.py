"""A whole run with the timed path broken underneath (the harness's look
for a card skipped, tiny sizes on the CPU) comes out not correct: for each
fault that the cell can have. One chip: no exchange between chips."""

import json

import pytest

from benchmark import harness
from benchmark.tests import cellbench_tiny
from ladcast_torch.rollout.pipeline import ForecastPipeline


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    return cellbench_tiny.tiny_root(tmp_path_factory.mktemp("bench"))


def run(registry, cell):
    return harness.run_cell(cell, cellbench_tiny.SEED, 0.1, False, registry, "cpu")


def test_forecast_that_returns_its_state_unchanged(registry, monkeypatch):
    def unchanged(self, known, year_progress, seed, **noise):
        return known[:, -1:].repeat(1, self.rollout_cfg.total_num_steps, 1, 1, 1)

    monkeypatch.setattr(ForecastPipeline, "forecast_latents", unchanged)
    out = run(registry, "tiny-forecast")
    assert not out["correct"]
    assert out["checks"]["rollout_rel_l2"]["value"] > out["checks"]["rollout_rel_l2"]["limit"]


def test_forecast_with_a_token_altered_where_it_is_produced(registry, monkeypatch):
    real = ForecastPipeline.forecast_latents

    def altered(self, *args, **kwargs):
        out = real(self, *args, **kwargs).clone()
        out[:, :, 7, 11] = 0.0  # one latent token of every frame and member
        return out

    monkeypatch.setattr(ForecastPipeline, "forecast_latents", altered)
    out = run(registry, "tiny-forecast")
    assert not out["correct"]
    assert out["checks"]["rollout_max_gap"]["value"] > out["checks"]["rollout_max_gap"]["limit"]


def test_forecast_that_leaves_half_the_ensemble_out(registry, monkeypatch):
    """The second half of the members a copy of the first half's forecast.
    The tiny cell checks one of its two members, drawn from the seed, so
    this fault runs on a cell of its own that checks both (a new mix and
    cell as files, as a later change would add them)."""
    root = registry.root
    mix = json.loads((root / "traffic" / "tiny-forecast.json").read_text())
    cellbench_tiny.write(root / "traffic" / "tiny-forecast-all.json",
                         dict(mix, check_members=mix["members"]))
    cell = json.loads((root / "workloads" / "tiny-forecast.json").read_text())
    cellbench_tiny.write(root / "workloads" / "tiny-forecast-all.json",
                         dict(cell, traffic="tiny-forecast-all"))
    real = ForecastPipeline.forecast_latents

    def halved(self, *args, **kwargs):
        out = real(self, *args, **kwargs).clone()
        half = out.shape[0] // 2
        out[half:2 * half] = out[:half]
        return out

    assert run(registry, "tiny-forecast-all")["correct"]
    monkeypatch.setattr(ForecastPipeline, "forecast_latents", halved)
    out = run(registry, "tiny-forecast-all")
    assert not out["correct"]
    assert out["checks"]["rollout_rel_l2"]["value"] > out["checks"]["rollout_rel_l2"]["limit"]
