"""A tiny cell for the benchmark's CPU tests: a copy of the benchmark's
files in a temporary directory, with a configuration, a traffic mix and a
cell added as new files (nothing edited), at widths the CPU runs in
seconds. Its limits sit between the tiny program's readings and the tiny
control's on the seeds the tests use."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from benchmark import harness

REPO = harness.BENCH_DIR.parent
SEED = 2**31 + 7  # more than 32 signed bits hold
TINY_DIT = dict(num_attention_heads=1, num_layers=1, num_single_layers=1,
                num_refiner_layers=1, mlp_ratio=1.0)
TINY_DCAE = dict(encoder_block_out_channels=[42, 84, 84, 168],
                 decoder_block_out_channels=[42, 84, 84, 168],
                 encoder_layers_per_block=[1, 1, 1, 1], decoder_layers_per_block=[1, 1, 1, 1],
                 attention_head_dim=28)
CELL, LIKE = "tiny-forecast", "forecast-375m-heun20"
LIMITS = {"encode_rel_l2": 0.04, "encode_max_gap": 0.18, "rollout_rel_l2": 0.05,
          "rollout_max_gap": 0.2, "decode_rel_l2": 0.03, "decode_max_gap": 0.15}


def write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj, indent=1) + "\n")


def tiny_root(tmp: Path) -> harness.Registry:
    """A registry over a copy of the benchmark with the tiny cell added."""
    tmp = Path(tmp)
    root = tmp / "benchmark"
    shutil.copytree(harness.BENCH_DIR, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cfg = json.loads((root / "configs" / "ladcast-375m.json").read_text())
    cfg["name"] = "tiny"
    cfg["dit"].update(TINY_DIT)
    cfg["dcae"].update(TINY_DCAE)
    write(root / "configs" / "tiny.json", cfg)
    mix = json.loads((root / "traffic" / "heun20-e20.json").read_text())
    mix.update(members=2, steps=2, return_seq_len=1, repetitions=2, decode_chunk=1,
               check_members=1)
    write(root / "traffic" / f"{CELL}.json", mix)
    w = json.loads((root / "workloads" / f"{LIKE}.json").read_text())
    w.update(config="tiny", traffic=CELL, limits=LIMITS)
    write(root / "workloads" / f"{CELL}.json", w)
    bench["workloads"].append(dict(next(e for e in bench["workloads"] if e["name"] == LIKE),
                                   name=CELL, config="tiny", traffic=CELL))
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if LIKE in m.get("workloads", []):
                m["workloads"].append(CELL)
    write(tmp / "BENCHMARK.json", bench)
    return harness.Registry(root)
