#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # one repetition of the bench workload
    python3 chip_smoke.py --reps 10  # the whole 240 h bench workload

Phases, each printed as JSON lines; any failure raises, so the script exits
non-zero and never prints the last line:

  1. environment: the card (nvidia-smi), torch and CUDA versions, and the
     build of the CUDA kernels from ``ladcast_torch/csrc`` (one nvcc per
     source, in parallel);
  2. kernels: each kernel against its plain PyTorch version on the card, in
     bf16 and fp32, at the main path's shapes (B=20, S=2250 dual- and
     single-stream tables, S=450 refiner tables) and a ragged small case,
     with median times over 20 timed runs, the plain version's time, the
     roofline bound and, for the attention, the time of PyTorch's
     ``scaled_dot_product_attention`` on the pre-normed inputs (a
     yardstick only; the port never calls it);
  3. model parity: one 375M DiT forward at B=2 through the kernels and
     through the plain composite, same seeded weights and inputs;
  4. main path: ``ladcast_torch.bench.make_bench`` with the 375M DiT and
     the shipped DCAE, seeded bf16 weights: encode, 20 members, Heun-20
     repetitions (39 DiT calls each), decode of every repetition's 80
     frames. Outputs must be finite and each kernel must have launched
     7 x 39 times per repetition;
  5. the kernel summary line, the card line and, last, the ok line.

With ``--profile``, one more repetition of the main path runs under
``torch.profiler`` after phase 4, and a ``profile`` line gives the
device's busy share of that run and its kernel time by category.
"""

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Dense peaks (NVIDIA data sheets): bf16 tensor-core and fp32 CUDA-core
# FLOP/s, and HBM bytes/s. Matched on the card's name; the H100 SXM is the
# default.
PEAKS = [("H100 PCIe", 756e12, 51e12, 2.0e12),
         ("H100 NVL", 835e12, 60e12, 3.9e12),
         ("H200", 989e12, 67e12, 4.8e12),
         ("", 989e12, 67e12, 3.35e12)]

# A kernel passes when |kernel - plain| <= atol + rtol * |plain| for every
# element and the relative L2 error is at most rel_l2. In bf16, fp32 results
# that differ in their last bits may round to neighbouring bf16 values: one
# ulp, 2**-7 relative, is allowed on top of atol. norm_rope's outputs are
# O(1) and take a fixed atol. The attention's outputs are averages of V over
# Sk keys, of scale sqrt(e / Sk) for these inputs (0.036 at Sk=2250), so its
# bf16 atol is ATTN_BF16_ULPS bf16 ulps of max |plain|: a fixed 2e-2 would
# pass a kernel that leaves the ragged last key tile unmasked.
ATTN_BF16_ULPS = 2
REL_L2 = {"bfloat16": 5e-3, "float32": 1e-4}
MODEL_TOL = {"bfloat16": 2e-2, "float32": 1e-3}  # relative L2, 375M forward


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def bf16_ulp(x):
    """The spacing of bf16 values (8 significant bits) at magnitude x > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def kernel_tolerance(kernel, dtype_name, ref):
    """{"atol", "rtol", "rel_l2"} for comparing ``kernel`` with its plain
    version's output ``ref``."""
    if dtype_name == "float32":
        return {"atol": 1e-4, "rtol": 0.0, "rel_l2": REL_L2[dtype_name]}
    atol = (2e-2 if kernel == "norm_rope" else
            ATTN_BF16_ULPS * bf16_ulp(ref.float().abs().max().item()))
    return {"atol": atol, "rtol": 2**-7, "rel_l2": REL_L2[dtype_name]}


def compare(out, ref, tol):
    """The readings of ``out`` against ``ref`` and whether they are within
    ``tol`` (see :func:`kernel_tolerance`)."""
    o, r = out.float(), ref.float()
    d = (o - r).abs()
    rec = {"max_abs_err": d.max().item(),
           "rel_l2": ((o - r).norm() / r.norm()).item(),
           "ref_rms": r.square().mean().sqrt().item(),
           "ref_absmax": r.abs().max().item(), "tol": tol}
    rec["ok"] = bool((d <= tol["atol"] + tol["rtol"] * r.abs()).all()
                     and rec["rel_l2"] <= tol["rel_l2"])
    return rec


def time_ms(fn, rounds=20, inner=5, warmup=2):
    """Median over ``rounds`` of the mean time of ``inner`` back-to-back
    calls, from CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    events = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / inner for s, e in events)


def kernel_phase(peaks):
    import torch
    import torch.nn.functional as F

    from ladcast_torch.config import ladcast_375m_config
    from ladcast_torch.models.ladcast_dit import (
        LaDCastTransformer3D,
        segment_tables,
    )
    from ladcast_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    peak_bf16, peak_f32, bw = peaks
    cfg = ladcast_375m_config()
    H, D = cfg.num_attention_heads, cfg.attention_head_dim
    with torch.device("meta"):
        tables_of = LaDCastTransformer3D(cfg)
    rope = tables_of._rope_tables(4, 15, 30, False, dev)      # 1800 rows
    cond_rope = tables_of._rope_tables(1, 15, 30, True, dev)  # 450 rows
    g = torch.Generator(device=dev).manual_seed(0)
    w_a = 1 + 0.1 * torch.randn(D, generator=g, device=dev)
    w_b = 1 + 0.1 * torch.randn(D, generator=g, device=dev)
    cases = [  # name, B, table segments (q side, k side), timed
        ("dual_2250", 20, [(1800, rope, w_a), (450, None, w_b)], True),
        ("single_2250", 20, [(1800, rope, w_a), (450, cond_rope, w_a)], False),
        ("refiner_450", 20, [(450, cond_rope, w_a)], True),
        ("ragged_130", 2, [(110, rope, w_a), (20, None, w_b)], False),
    ]
    results = {"norm_rope": [], "fused_attention": []}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for name, B, segs, timed in cases:
            S = sum(n for n, _, _ in segs)
            cos, sin, w = segment_tables(segs)
            q, k, v = (torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
                       for _ in range(3))
            es = q.element_size()
            # K2
            out = fa.norm_rope(k, w, cos, sin)
            ref = fa.norm_rope_plain(k, w, cos, sin)
            rec = {"phase": "kernel", "kernel": "norm_rope", "case": name,
                   "dtype": dname, "B": B, "S": S, "H": H, "D": D,
                   **compare(out, ref, kernel_tolerance("norm_rope", dname, ref))}
            nbytes = 2 * k.numel() * es + 3 * S * D * 4
            t_bytes, t_ops = nbytes / bw * 1e3, 10 * k.numel() / peak_f32 * 1e3
            rec.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            if timed:
                rec["ms"] = time_ms(lambda: fa.norm_rope(k, w, cos, sin))
                rec["plain_ms"] = time_ms(lambda: fa.norm_rope_plain(k, w, cos, sin),
                                          inner=1)
                rec["library_ms"] = None
            emit(rec)
            results["norm_rope"].append(rec)
            if not rec["ok"]:
                raise AssertionError(f"norm_rope {name} {dname}: {rec}")
            # K1
            kn = ref
            out = fa.fused_attention(q, kn, v, cos, sin, w)
            ref = fa.fused_attention_plain(q, kn, v, cos, sin, w)
            rec = {"phase": "kernel", "kernel": "fused_attention", "case": name,
                   "dtype": dname, "B": B, "S": S, "H": H, "D": D,
                   **compare(out, ref, kernel_tolerance("fused_attention", dname, ref)),
                   "finite": bool(torch.isfinite(out).all())}
            flops = 4 * B * H * S * S * D
            nbytes = 4 * q.numel() * es + 3 * S * D * 4
            peak = peak_bf16 if dtype == torch.bfloat16 else peak_f32
            t_bytes, t_ops = nbytes / bw * 1e3, flops / peak * 1e3
            rec.update(bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            if timed:
                rec["ms"] = time_ms(lambda: fa.fused_attention(q, kn, v, cos, sin, w))
                rec["plain_ms"] = time_ms(
                    lambda: fa.fused_attention_plain(q, kn, v, cos, sin, w), inner=1)
                qh = fa.norm_rope_plain(q, w, cos, sin).transpose(1, 2).contiguous()
                kh, vh = (t.transpose(1, 2).contiguous() for t in (kn, v))
                rec["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(qh, kh, vh), inner=1)
                del qh, kh, vh
            emit(rec)
            results["fused_attention"].append(rec)
            if not (rec["finite"] and rec["ok"]):
                raise AssertionError(f"fused_attention {name} {dname}: {rec}")
            del q, k, v, kn, out, ref
        torch.cuda.empty_cache()
    return results


def model_parity_phase():
    import torch

    from ladcast_torch.config import ladcast_375m_config
    from ladcast_torch.models.ladcast_dit import LaDCastTransformer3D, build_dit

    dev = torch.device("cuda")
    cfg = ladcast_375m_config()
    g = torch.Generator(device=dev).manual_seed(1)
    lat = torch.randn(2, 4, 15, 30, 84, generator=g, device=dev)
    cond = torch.randn(2, 1, 15, 30, 84, generator=g, device=dev)
    cn = torch.randn(2, generator=g, device=dev)
    yp = torch.rand(2, generator=g, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        kernels = build_dit(cfg, dev, dtype, seed=7)
        with torch.device("meta"):
            plain = LaDCastTransformer3D(dataclasses.replace(cfg, attention_impl="plain"))
        plain.load_state_dict(kernels.state_dict(), strict=True, assign=True)
        plain.eval()
        with torch.inference_mode():
            a = kernels(lat.to(dtype), cn, cond.to(dtype), yp).float()
            p = plain(lat.to(dtype), cn, cond.to(dtype), yp).float()
        rel = ((a - p).norm() / p.norm()).item()
        finite = bool(torch.isfinite(a).all())
        emit({"phase": "model_parity", "dtype": dname, "B": 2,
              "rel_l2": rel, "tol": MODEL_TOL[dname], "finite": finite})
        if not (finite and rel <= MODEL_TOL[dname]):
            raise AssertionError(f"375M forward parity {dname}: {rel}")
        del kernels, plain, a, p
        torch.cuda.empty_cache()


def main_path_phase(reps):
    import torch

    from ladcast_torch.bench import make_bench
    from ladcast_torch.config import (
        DCAEConfig,
        EDMSchedulerConfig,
        RolloutConfig,
        ladcast_375m_config,
    )
    from ladcast_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    rcfg = RolloutConfig(ensemble_size=20, num_inference_steps=20,
                         total_lead_time_hour=24 * reps)
    t0 = time.perf_counter()
    bench = make_bench(ladcast_375m_config(), DCAEConfig(), EDMSchedulerConfig(),
                       rcfg, device=dev, compute_dtype=torch.bfloat16, seed=0)
    setup_s = time.perf_counter() - t0
    # warm-up outside the measured run: library handles and first calls
    with torch.inference_mode():
        z = torch.zeros(20, 1, 15, 30, 84, device=dev, dtype=torch.bfloat16)
        bench["dit"](z.expand(20, 4, 15, 30, 84), torch.zeros(20, device=dev), z,
                     torch.zeros(20, device=dev))
        bench["dcae"].decode(z.expand(20, 4, 15, 30, 84).reshape(80, 15, 30, 84))
        bench["dcae"].encode(
            torch.zeros(1, 120, 240, 84, device=dev, dtype=torch.bfloat16),
            torch.zeros(120, 240, 5, device=dev, dtype=torch.bfloat16))
    torch.cuda.synchronize()

    fa.norm_rope.launches = 0
    fa.fused_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    acc, mean = bench["full_forecast"](4, stats)
    total_s = time.perf_counter() - t0
    launches = {"norm_rope": fa.norm_rope.launches,
                "fused_attention": fa.fused_attention.launches}
    expected = 7 * (2 * rcfg.num_inference_steps - 1) * rcfg.num_repetitions
    emit({"phase": "main_path", "repetitions": rcfg.num_repetitions,
          "members": rcfg.ensemble_size, "setup_s": setup_s,
          "encode_s": stats["encode_s"][0],
          "repetition_s": stats["repetition_s"], "decode_s": stats["decode_s"],
          "forecast_s": total_s, "acc": acc, "mean": mean,
          "traj_shape": stats["traj_shape"], "decode_shape": stats["decode_shape"],
          "launches": launches, "expected_launches": expected,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    if stats["traj_shape"] != (20, 4 * reps, 15, 30, 84):
        raise AssertionError(f"trajectory shape {stats['traj_shape']}")
    if stats["decode_shape"] != (80, 120, 240, 84):
        raise AssertionError(f"decode shape {stats['decode_shape']}")
    for name, n in launches.items():
        if n != expected:
            raise AssertionError(f"{name}: {n} launches, expected {expected}")
    return launches, bench


# kernel-name fragments -> category, first match wins
CATEGORIES = [("fused_attention", ("fa_bf16_kernel", "fa_f32_kernel")),
              ("norm_rope", ("norm_rope_kernel",)),
              ("conv", ("fprop", "dgrad", "conv", "winograd", "nchwToNhwc",
                        "nhwcToNchw")),
              ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "s16816", "wgmma")),
              ("reduction", ("reduce", "norm", "softmax")),
              ("copy_cat", ("CatArray", "Copy", "copy", "flip", "roll",
                            "index")),
              ("elementwise", ("elementwise", "vectorized", "fill"))]


def profile_phase(bench):
    """One repetition under torch.profiler: wall time, the union of kernel
    intervals (device busy time) and kernel time by category."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bench["full_forecast"](6)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        raise AssertionError("the profiler recorded no device kernel")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s0, e0 in spans[1:]:
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    by_cat, top = {}, {}
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        cat = next((c for c, frags in CATEGORIES
                    if any(f in e.name for f in frags)), "other")
        by_cat[cat] = by_cat.get(cat, 0.0) + dur / 1e3
        top[e.name[:80]] = top.get(e.name[:80], 0.0) + dur / 1e3
    emit({"phase": "profile", "wall_s": wall_s, "n_kernels": len(kernels),
          "device_span_ms": (spans[-1][1] - spans[0][0]) / 1e3,
          "device_busy_ms": busy / 1e3,
          "busy_share_of_wall": busy / 1e6 / wall_s,
          "kernel_ms_by_category": dict(sorted(by_cat.items(),
                                               key=lambda kv: -kv[1])),
          "top_kernels_ms": dict(sorted(top.items(), key=lambda kv: -kv[1])[:12])})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=1,
                    help="AR repetitions of the main path (10 = 240 h)")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more repetition of the main path")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from ladcast_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the ladcast_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    peaks = next(p[1:] for p in PEAKS if p[0] in name)
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "environment", "nvidia_smi": card, "device": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": time.perf_counter() - t0,
          "libraries": sorted(p.name for p in libs.values()),
          "peaks": {"bf16_flops": peaks[0], "fp32_flops": peaks[1],
                    "bytes_per_s": peaks[2]}})

    t0 = time.perf_counter()
    results = kernel_phase(peaks)
    emit({"phase": "kernel_done", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    model_parity_phase()
    emit({"phase": "model_parity_done", "wall_s": time.perf_counter() - t0})
    launches, bench = main_path_phase(args.reps)
    if args.profile:
        profile_phase(bench)
    del bench

    meta = {"norm_rope": ("ladcast_torch/csrc/norm_rope.cu",
                          "ladcast_tpu/ops/pallas/flash_attention.py:70"),
            "fused_attention": ("ladcast_torch/csrc/fused_attention.cu",
                                "ladcast_tpu/ops/pallas/flash_attention.py:113")}
    summary = []
    for kname, recs in results.items():
        main = next(r for r in recs if r["case"] == "dual_2250"
                    and r["dtype"] == "bfloat16")
        summary.append({
            "name": kname, "route": "cuda", "source": meta[kname][0],
            "replaces": meta[kname][1], "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in recs),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"]})
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
