"""The harness of the benchmark: finds a cell's configuration, traffic kind
and per-layer metrics by the names ``BENCHMARK.json`` gives, hands a
traffic module the services it times and traces with, and builds the
result line.

A cell is ``workloads/<cell>.json``; it names a configuration,
``configs/<config>.json``, and a traffic mix, ``traffic/<mix>.json``: the
parameters that the general generator of its ``kind``, ``traffic/<kind>.py``,
reads. The generator's ``run(run: Run) -> dict`` sets up the program, calls
:meth:`Run.start_window`
when set-up ends, runs the window, optionally a traced slice
(:meth:`Run.traced`), and then the correctness comparison. A per-layer
metric is ``metrics/<metric>.py`` with ``UNIT`` and ``read(reading)``,
which returns a number or None when its cell gives it nothing to read.
New cells, configurations, traffic kinds and metrics are new files."""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional, Tuple

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ladcast_tpu"})


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    try:
        start_ticks = float(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


# the process's start on the perf_counter clock
PROCESS_START = time.perf_counter() - process_age_s()


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def load_module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Registry:
    """The benchmark's files under ``root`` (``BENCHMARK.json`` beside it)."""

    root: Path = BENCH_DIR

    def _json(self, path: Path) -> dict:
        if not path.is_file():
            raise FileNotFoundError(f"{path} does not exist")
        return json.loads(path.read_text())

    def benchmark(self) -> dict:
        return self._json(self.root.parent / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        return self._json(self.root / "workloads" / f"{name}.json")

    def config(self, name: str) -> dict:
        return self._json(self.root / "configs" / f"{name}.json")

    def mix(self, name: str) -> dict:
        return self._json(self.root / "traffic" / f"{name}.json")

    def traffic(self, kind: str) -> ModuleType:
        return load_module(self.root / "traffic" / f"{kind}.py", f"benchmark_traffic_{kind}")

    def metric(self, name: str) -> ModuleType:
        return load_module(self.root / "metrics" / f"{name}.py",
                           "benchmark_metric_" + name.replace(".", "_"))

    def metrics_for(self, cell: str, section: str) -> List[dict]:
        """The entries of ``section`` that ``cell`` reports."""
        return [m for m in self.benchmark()[section]
                if "workloads" not in m or cell in m["workloads"]]


@dataclass
class Reading:
    """What a per-layer metric reads: the traced slice (``trace``, a
    ``trace.Trace``), the traffic's counts of the slice and of the window,
    its host timings, the cell's configuration and traffic parameters, and
    the FLOPs of the cell's units of work (``flops(key)``, counted on the
    reference when asked for)."""

    trace: object
    counts: Dict[str, float]
    config: dict
    traffic: dict
    flop_fns: Dict[str, Callable[[], float]] = field(default_factory=dict)

    def flops(self, key: str) -> float:
        return self.flop_fns[key]()


class Run:
    """One run of a cell, as the traffic module sees it."""

    def __init__(self, cell: str, workload: dict, config: dict, traffic: dict, seed: int,
                 seconds: float, trace: bool, device: str):
        self.cell, self.workload, self.config, self.traffic = cell, workload, config, traffic
        self.seed, self.seconds, self.trace, self.device = seed, seconds, trace, device
        self.setup_s: Optional[float] = None
        self.memory_peak_bytes = 0
        self.traced_slice = None  # a trace.Trace, after traced()

    def span(self, name: str):
        """A harness span around a call into a layer: ``bench.<name>``."""
        import torch

        return torch.profiler.record_function(f"bench.{name}")

    def sync(self) -> None:
        import torch

        if self.device.startswith("cuda"):
            torch.cuda.synchronize()

    def start_window(self) -> None:
        """Set-up has ended: the device is idle and the window begins."""
        self.sync()
        self.setup_s = time.perf_counter() - PROCESS_START

    @contextlib.contextmanager
    def traced(self):
        """Profile the block (host ops and device kernels) and keep its
        reduction; the block ends in a synchronise inside the trace."""
        from torch.profiler import ProfilerActivity, profile

        from benchmark import trace

        acts = [ProfilerActivity.CPU]
        if self.device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        self.sync()
        with profile(activities=acts) as prof:
            with self.span("trace"):
                yield
                self.sync()
        self.traced_slice = trace.from_profiler(prof)

    def read_memory_peak(self) -> None:
        """The device's peak allocation so far; read before the reference
        runs, whose own peak would otherwise count."""
        import torch

        if self.device.startswith("cuda"):
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())


def rel_l2(a, b) -> float:
    """||a - b|| / ||b||, in float64."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def max_gap(a, b) -> float:
    """max |a - b| over the root mean square of b: the widest gap of one
    element, on the scale of the reference."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.square().mean().sqrt().clamp_min(1e-300))


def check(name: str, value: float, limit: float) -> Tuple[str, float, float]:
    return (name, float(value), float(limit))


def make_run(cell: str, seed: int, seconds: float, trace: bool,
             registry: Optional[Registry] = None, device: str = "cuda"):
    """The :class:`Run` of ``cell`` and its traffic kind's module."""
    registry = registry or Registry()
    workload = registry.workload(cell)
    mix = registry.mix(workload["traffic"])
    run = Run(cell, workload, registry.config(workload["config"]), mix, seed, seconds,
              trace, device)
    return run, registry.traffic(mix["kind"])


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             registry: Optional[Registry] = None, device: str = "cuda") -> dict:
    """Run ``cell`` once and return the result line's dict (without the
    import check, which :mod:`benchmark.run` makes as the process ends)."""
    registry = registry or Registry()
    run, traffic = make_run(cell, seed, seconds, trace, registry, device)
    out = traffic.run(run)
    checks = out["checks"]
    metrics = {}
    if not trace:
        values = dict(out["end_to_end"], setup_s=run.setup_s)
        for m in registry.metrics_for(cell, "end_to_end"):
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        reading = Reading(run.traced_slice, out.get("counts", {}),
                          run.config, run.traffic, out.get("flop_fns", {}))
        for m in registry.metrics_for(cell, "per_layer"):
            mod = registry.metric(m["name"])
            v = mod.read(reading)
            if v is not None and math.isfinite(v):
                metrics[m["name"]] = {"value": float(v), "unit": mod.UNIT}
    result = {
        "correct": bool(checks) and out["failed"] == 0
        and all(math.isfinite(v) and v <= lim for _, v, lim in checks),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": device_info(run, run.workload["chips"]),
    }
    tr = run.traced_slice
    if trace and tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def device_info(run: Run, chips: int) -> dict:
    import torch

    if not run.device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": run.memory_peak_bytes}
