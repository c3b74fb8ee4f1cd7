"""The correctness control of a cell, which the benchmark's own runs never
run: the cell's traffic module's ``control(run)`` puts the reference with
float8 products in the program's place, the precision below the
configuration's bfloat16, and returns the numbers that decide ``correct``,
each beside its limit. Every limit has to fail the control on some number.

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

Prints one JSON line per seed: the seed, the numbers and whether the
control came out not correct, as it has to."""

from __future__ import annotations

import argparse
import json
import math

from benchmark import harness


def control_checks(cell: str, seed: int, registry=None, device: str = "cuda") -> dict:
    run, traffic = harness.make_run(cell, seed, 0, False, registry, device)
    checks = traffic.control(run)
    return {"seed": seed, "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks},
            "failed_as_it_must": any(not math.isfinite(v) or v > lim for _, v, lim in checks)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload,
                          **control_checks(args.workload, seed)}), flush=True)


if __name__ == "__main__":
    main()
