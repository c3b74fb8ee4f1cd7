"""The benchmark's one command:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell (``workloads/<cell>.json``) on the card it starts on.
It makes the cell's weights and inputs on the card from ``--seed``, warms
up the cell's own shapes, measures for ``--seconds`` (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: the same window, then a profiled
slice for the per-layer metrics), compares what the timed path produced
with the plain reference, and prints one JSON line last on standard
output; the numbers compared, each with its limit, are the last lines of
standard error and the line's last key.

It exits with a code other than 0, and prints no result, without CUDA or
with fewer cards than the cell asks for, or when a module of JAX or of the
JAX package is loaded once the run is over.
"""

from __future__ import annotations

from benchmark import harness  # first: it reads the process's start time

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seconds <= 0:
        ap.error("--seconds must be positive")

    import torch

    registry = harness.Registry()
    chips = registry.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              registry)
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {bad}",
              file=sys.stderr)
        return 4
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
