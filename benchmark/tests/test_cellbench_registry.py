"""The harness finds a new configuration, traffic mix, cell and per-layer
metric by name from new files alone, and BENCHMARK.json's entries each
have their files and keep to the benchmark's formats."""

import json
import re

import pytest

from benchmark import harness
from benchmark.tests import cellbench_tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
NEW_METRIC = '''"""A metric added as a new file: the traced DiT calls."""

UNIT = "calls"


def read(r):
    return r.counts.get("dit_calls")
'''


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    return cellbench_tiny.tiny_root(tmp_path_factory.mktemp("bench"))


def test_new_cell_config_mix_and_metric_need_only_new_files(registry):
    (registry.root / "metrics" / "traced_calls.forecast.py").write_text(NEW_METRIC)
    path = registry.root.parent / "BENCHMARK.json"
    bench = json.loads(path.read_text())
    bench["per_layer"].append({"name": "traced_calls.forecast", "unit": "calls",
                               "better": "higher", "source": "program_counter",
                               "layer": "harness", "moves": "forecast_rate",
                               "workloads": [cellbench_tiny.CELL]})
    path.write_text(json.dumps(bench))
    out = harness.run_cell(cellbench_tiny.CELL, cellbench_tiny.SEED, 0.2, True, registry, "cpu")
    assert out["metrics"]["traced_calls.forecast"] == {"value": 3.0, "unit": "calls"}
    assert "mfu.forecast" in out["metrics"]
    assert "idle_share.forecast" not in out["metrics"]  # no device events on the CPU


def test_a_missing_name_is_refused(registry):
    for lookup in (registry.workload, registry.config, registry.mix):
        with pytest.raises(FileNotFoundError):
            lookup("no-such-name")


def test_benchmark_json_entries_have_their_files():
    reg = harness.Registry()
    bench = reg.benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert reg.config(c["name"])["reduced"] == c["reduced"]
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        data = reg.workload(w["name"])
        assert (data["config"], data["traffic"], data["chips"], data["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert (reg.root / "traffic" / f"{reg.mix(w['traffic'])['kind']}.py").is_file()
        reported = [m for m in bench["end_to_end"]
                    if "workloads" not in m or w["name"] in m["workloads"]]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert reg.metrics_for(w["name"], "per_layer")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert reg.metric(m["name"]).UNIT == m["unit"]
        for cell in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or cell in moved["workloads"]
