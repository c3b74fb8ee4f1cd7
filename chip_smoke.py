#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # one repetition of the bench workload
    python3 chip_smoke.py --reps 10  # the whole 240 h bench workload

Phases, each printed as JSON lines; any failure raises, so the script exits
non-zero and never prints the last line. Two paths of the port run: the
ensemble rollout (inference) and the AR trainer of the 375M DiT.

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
  2b. backward kernels: the lse variant of the attention kernel and the
     flash backward (dq, dk/dv) against their plain versions, bf16 and
     fp32, at the training shapes (B=4, S=2250 dual- and single-stream
     tables, S=450 refiner tables) and a ragged small case, with times,
     bounds and, for the backward, the time of PyTorch's SDPA backward
     on the same pre-normed inputs (a yardstick only), per kernel and for
     the dq + dk/dv pair against the whole plain and SDPA backward;
  3. model parity: one 375M DiT forward at B=2 through the kernels and
     through the plain composite, same seeded weights and inputs;
  3b. gradient parity: the 375M training loss at B=2 (injected sigma
     indices and noise) and every parameter's gradient, with the
     attention backward on the kernels and on the composite, fp32 and
     bf16; every attention projection and qk-norm weight must get a
     finite, non-zero gradient, and a raw kernel entry given a tensor
     that requires grad must refuse it;
  4. main path: ``ladcast_torch.bench.make_bench`` with the 375M DiT and
     the shipped DCAE, seeded bf16 weights: encode, 20 members, Heun-20
     repetitions (39 DiT calls each), decode of every repetition's 80
     frames. Outputs must be finite and each kernel must have launched
     7 x 39 times per repetition;
  5. training: ``ladcast_torch.cli.train_ar.run`` with the
     configs/ladcast_375m.yaml settings (batch 4, 4 target frames, bf16
     compute on fp32 masters, AdamW, clip, cosine warmup, EMA) on a
     synthetic 64-frame latent file, 12 steps with the kernel backward (the
     default) and 12 with the composite one (asked for): ms per step,
     losses, grad norms, peak
     memory, launches (7 per step of each attention kernel under the
     kernel backward, none of the backward kernels under the composite);
     the last step's checkpoint must restore into a fresh trainer (the
     whole state: parameters, both moments, count, EMA, step);
  6. the kernel summary line, the card line and, last, the ok line.

With ``--profile``, one more repetition of the main path runs under
``torch.profiler`` after phase 4, and 4 more training steps (kernel
backward) after the training run of phase 5; a ``profile`` line per path
gives the
device's busy share of that run and its kernel time by category.
"""

import argparse
import dataclasses
import datetime
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# The lse rows are fp32 in either dtype. From bf16 inputs, the kernel may
# round an element of the scaled Q to the bf16 value next to the plain
# version's (as the output check allows), which moves that row's lse by
# up to |scale * q| * 2**-8 * |kn| (about 1e-3 for these inputs).
LSE_ATOL = {"bfloat16": 1e-3, "float32": 1e-4}
REL_L2 = {"bfloat16": 5e-3, "float32": 1e-4}
MODEL_TOL = {"bfloat16": 2e-2, "float32": 1e-3}  # relative L2, 375M forward
GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-3}  # relative L2, 375M gradients
TRAIN_STEPS = 12

# configs/ladcast_375m.yaml as PyYAML reads it (PyYAML is not needed here;
# tests/test_torch_train.py holds this copy to the file).
LADCAST_375M_YAML = {
    "ar_model": {
        "in_channels": 84, "out_channels": 84, "num_attention_heads": 12,
        "attention_head_dim": 128, "num_layers": 2, "num_single_layers": 4,
        "num_refiner_layers": 1, "mlp_ratio": 4, "patch_size": 1,
        "patch_size_t": 1, "qk_norm": "rms_norm", "rope_theta": 256.0,
        "rope_axes_dim": [16, 56, 56],
        "rope_spatial_grid_start_pos": [-499.5, 5.25],
        "rope_spatial_grid_end_pos": [508.5, 353.25], "spatial_deg2rad": True,
        "conditioning_tensor_in_channels": 84,
        "conditioning_tensor_rope_axes_dim": [16, 56, 56],
        "incl_time_elapsed": True},
    "noise_scheduler": {"target": "ladcast_tpu.config.EDMSchedulerConfig",
                        "params": {"num_train_timesteps": 1000,
                                   "sigma_data": 0.5}},
    "noise_sampler": {"P_mean_start": -1.2, "P_std_start": 1.2,
                      "P_mean_end": -1.2, "P_std_end": 1.2},
    "optimizer": {"betas": [0.9, 0.999], "eps": "1e-08", "lr": "1e-4",
                  "weight_decay": "1e-2"},
    "lr_scheduler": {"name": "cosine", "num_warmup_steps": 1000},
    "train_dataloader": {
        "ds_path": None, "batch_size": 4, "start_date": "1979-01-01T05",
        "end_date": datetime.date(2017, 12, 31), "input_seq_len": 1,
        "return_seq_len": 4, "sampling_interval": 1,
        "interval_between_pred": 6, "shuffle": True, "load_in_memory": True},
    "accelerator": {"log_with": "jsonl"},
    "ema": {"use_ema": True, "ema_max_decay": 0.9999, "ema_inv_gamma": 1.0,
            "ema_power": 0.6666667, "ema_update_after_step": 1000},
    "general": {"seed": 42, "num_training_steps": 100000,
                "output_dir": "runs/ladcast_375m", "checkpointing_steps": 50000,
                "checkpoints_total_limit": 3},
}


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
    if kernel == "fused_attention_lse":  # fp32 logsumexp rows, |lse| ~ 8
        return {"atol": LSE_ATOL[dtype_name], "rtol": 0.0,
                "rel_l2": REL_L2["float32"]}
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


def bound(flops, nbytes, peak, bw):
    """{"bound_ms", "bound_by"}: the larger of the operations over the peak
    rate and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / bw * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def backward_kernel_phase(peaks):
    """K1's lse variant and K3 (dq, dk/dv) against their plain versions
    at the training shapes."""
    import torch
    import torch.nn.functional as F

    from ladcast_torch.config import ladcast_375m_config
    from ladcast_torch.models.ladcast_dit import (
        LaDCastTransformer3D,
        segment_tables,
    )
    from ladcast_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    peak_bf16, peak_f32, bw = peaks
    cfg = ladcast_375m_config()
    H, D = cfg.num_attention_heads, cfg.attention_head_dim
    scale = 1.0 / D ** 0.5
    with torch.device("meta"):
        tables_of = LaDCastTransformer3D(cfg)
    rope = tables_of._rope_tables(4, 15, 30, False, dev)
    cond_rope = tables_of._rope_tables(1, 15, 30, True, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    w_a = 1 + 0.1 * torch.randn(D, generator=g, device=dev)
    w_b = 1 + 0.1 * torch.randn(D, generator=g, device=dev)
    cases = [  # name, B, table segments, timed
        ("dual_2250", 4, [(1800, rope, w_a), (450, None, w_b)], True),
        ("single_2250", 4, [(1800, rope, w_a), (450, cond_rope, w_a)], False),
        ("refiner_450", 4, [(450, cond_rope, w_a)], True),
        ("ragged_130", 2, [(110, rope, w_a), (20, None, w_b)], False),
    ]
    results = {"fused_attention_lse": [], "flash_bwd_dq": [], "flash_bwd_dkv": [],
               "flash_bwd_pair": []}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        peak = peak_bf16 if dtype == torch.bfloat16 else peak_f32
        for name, B, segs, timed in cases:
            S = sum(n for n, _, _ in segs)
            cos, sin, w = segment_tables(segs)
            q, k, v, go = (torch.randn(B, S, H, D, generator=g, device=dev).to(dtype)
                           for _ in range(4))
            es, n = q.element_size(), q.numel()
            stats_bytes = B * H * S * 4
            head = {"phase": "backward_kernel", "case": name, "dtype": dname,
                    "B": B, "S": S, "H": H, "D": D}
            qn = fa.norm_rope_plain(q, w, cos, sin)
            kn = fa.norm_rope_plain(k, w, cos, sin)
            # K1, lse variant: out with K1's tolerance, lse with fp32's
            out, lse = fa.fused_attention(q, kn, v, cos, sin, w, return_lse=True)
            ref, ref_lse = fa.fused_attention_plain(q, kn, v, cos, sin, w,
                                                    return_lse=True)
            rec = {**head, "kernel": "fused_attention_lse",
                   **compare(lse, ref_lse, kernel_tolerance(
                       "fused_attention_lse", dname, ref_lse)),
                   "out": compare(out, ref, kernel_tolerance(
                       "fused_attention", dname, ref)),
                   **bound(4 * B * H * S * S * D, 4 * n * es + 3 * S * D * 4
                           + stats_bytes, peak, bw)}
            if timed:
                rec["ms"] = time_ms(lambda: fa.fused_attention(
                    q, kn, v, cos, sin, w, return_lse=True))
                rec["plain_ms"] = time_ms(lambda: fa.fused_attention_plain(
                    q, kn, v, cos, sin, w, return_lse=True), inner=1)
                rec["library_ms"] = None
            emit(rec)
            results["fused_attention_lse"].append(rec)
            if not (rec["ok"] and rec["out"]["ok"]):
                raise AssertionError(f"fused_attention lse {name} {dname}: {rec}")
            # K3 over the forward's statistics
            delta = torch.einsum("bqhd,bqhd->bhq", go.float(), ref.float()).contiguous()
            ref_lse = ref_lse.contiguous()
            bwd_args = (qn, kn, v, go, ref_lse, delta, scale)
            dq = fa.flash_bwd_dq(*bwd_args)
            dk, dv = fa.flash_bwd_dkv(*bwd_args)
            torch.cuda.synchronize()
            refs = dict(zip(("dq", "dk", "dv"), fa.flash_bwd_plain(*bwd_args)))
            if timed:
                qh, kh, vh = (t.transpose(1, 2).contiguous().requires_grad_(True)
                              for t in (qn, kn, v))
                oh = F.scaled_dot_product_attention(qh, kh, vh)
                gh = go.transpose(1, 2).contiguous()
                lib = {"flash_bwd_dq": (qh,), "flash_bwd_dkv": (kh, vh)}
                # the pair against the whole plain backward and SDPA's
                pair = {"phase": "backward_kernel", "kernel": "flash_bwd_pair",
                        **head, "plain_ms": time_ms(
                            lambda: fa.flash_bwd_plain(*bwd_args), rounds=10, inner=1),
                        "library_ms": time_ms(lambda: torch.autograd.grad(
                            oh, (qh, kh, vh), gh, retain_graph=True),
                            rounds=10, inner=1),
                        **bound(14 * B * H * S * S * D,
                                7 * n * es + 2 * stats_bytes, peak, bw)}
            # one record per output; both of dk/dv's carry its one time.
            # Each kernel's plain_ms is its own plain version's; its
            # library_ms is SDPA's backward asked for that kernel's outputs
            # only (SDPA's backward computes all three either way).
            for kname, fn, plain_fn, outs, n_ops, n_io in (
                    ("flash_bwd_dq", fa.flash_bwd_dq, fa.flash_bwd_dq_plain,
                     {"dq": dq}, 6, 5),
                    ("flash_bwd_dkv", fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain,
                     {"dk": dk, "dv": dv}, 8, 6)):
                timing = {}
                if timed:
                    timing["ms"] = time_ms(lambda: fn(*bwd_args))
                    timing["plain_ms"] = time_ms(lambda: plain_fn(*bwd_args),
                                                 rounds=10, inner=1)
                    timing["library_ms"] = time_ms(lambda: torch.autograd.grad(
                        oh, lib[kname], gh, retain_graph=True), rounds=10, inner=1)
                    pair.setdefault("ms", 0.0)
                    pair["ms"] += timing["ms"]
                for oname, o in outs.items():
                    rec = {**head, "kernel": kname, "output": oname,
                           **compare(o, refs[oname], kernel_tolerance(
                               kname, dname, refs[oname])),
                           "finite": bool(torch.isfinite(o).all()),
                           **bound(n_ops * B * H * S * S * D,
                                   n_io * n * es + 2 * stats_bytes, peak, bw),
                           **timing}
                    emit(rec)
                    results[kname].append(rec)
                    if not (rec["ok"] and rec["finite"]):
                        raise AssertionError(f"{kname} {oname} {name} {dname}: {rec}")
            if timed:
                emit(pair)
                results["flash_bwd_pair"].append(pair)
                del qh, kh, vh, oh, gh, lib
            del q, k, v, go, qn, kn, out, ref, lse, ref_lse, delta, dq, dk, dv, refs
        torch.cuda.empty_cache()
    return results


def _train_batch(B, dev, seed):
    """A seeded (initial_profile, clean, year_progress) batch of 375M
    latents, with sigma indices and noise."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    batch = [0.5 * torch.randn(B, 1, 15, 30, 84, generator=g, device=dev),
             0.5 * torch.randn(B, 4, 15, 30, 84, generator=g, device=dev),
             torch.rand(B, 1, generator=g, device=dev)]
    indices = torch.randint(0, 1000, (B,), generator=g, device=dev)
    noise = torch.randn(batch[1].shape, generator=g, device=dev)
    return batch, indices, noise


def _reset_launches(fa):
    for fn in (fa.norm_rope, fa.fused_attention, fa.flash_bwd_dq, fa.flash_bwd_dkv):
        fn.launches = 0
    fa.fused_attention.lse_launches = 0


def _launches(fa):
    return {"norm_rope": fa.norm_rope.launches,
            "fused_attention": fa.fused_attention.launches,
            "fused_attention_lse": fa.fused_attention.lse_launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


ATTN_PARAM_LEAVES = ("to_q.", "to_k.", "to_v.", "add_q_proj.", "add_k_proj.",
                     "add_v_proj.", "norm_q.", "norm_k.", "norm_added_q.",
                     "norm_added_k.")


def grad_parity_phase():
    """The 375M loss_given_noise at B=2 with grad, the attention backward
    on the kernels and on the composite."""
    import torch

    from ladcast_torch.config import (
        EDMSchedulerConfig,
        NoiseSamplerConfig,
        ladcast_375m_config,
    )
    from ladcast_torch.models.ladcast_dit import build_dit
    from ladcast_torch.ops import flash_attention as fa
    from ladcast_torch.train.optim import make_optimizer
    from ladcast_torch.train.trainer_ar import ARTrainConfig, make_ar_train_step

    dev = torch.device("cuda")
    cfg = ladcast_375m_config()
    batch, indices, noise = _train_batch(2, dev, 3)
    # the repair: a raw kernel entry refuses a tensor that requires grad
    x = torch.randn(1, 8, 1, 128, device=dev, requires_grad=True)
    tbl = torch.ones(8, 128, device=dev)
    try:
        fa.norm_rope(x, tbl, tbl, tbl * 0)
    except RuntimeError as e:
        if "would carry no gradient" not in str(e):
            raise
    else:
        raise AssertionError("norm_rope accepted a CUDA input that requires grad")
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        _, step = make_ar_train_step(cfg, EDMSchedulerConfig(), NoiseSamplerConfig(),
                                     ARTrainConfig(compute_dtype=dname),
                                     make_optimizer(), dev)
        model = build_dit(cfg, dev, torch.float32, seed=11)
        names, params = zip(*model.named_parameters())
        losses, grads, launches = {}, {}, {}
        for mode in ("kernel", "composite"):
            prev, fa.BWD_MODE = fa.BWD_MODE, mode
            _reset_launches(fa)
            try:
                loss, _ = step.loss_given_noise(model, batch, indices, noise)
                grads[mode] = torch.autograd.grad(loss, params)
            finally:
                fa.BWD_MODE = prev
            torch.cuda.synchronize()
            losses[mode] = loss.item()
            launches[mode] = _launches(fa)

        def rel(parts_k, parts_c):
            a = torch.cat([t.flatten().float() for t in parts_k])
            b = torch.cat([t.flatten().float() for t in parts_c])
            return ((a - b).norm() / b.norm()).item()

        blocks = {}
        for i, name in enumerate(names):
            key = ".".join(name.split(".")[:2]) if "blocks" in name else name.split(".")[0]
            blocks.setdefault(key, []).append(i)
        per_block = {key: rel([grads["kernel"][i] for i in ix],
                              [grads["composite"][i] for i in ix])
                     for key, ix in blocks.items()}
        attn = [i for i, name in enumerate(names) if ".attn." in name
                and any(leaf in name for leaf in ATTN_PARAM_LEAVES)]
        dead = [names[i] for i in attn
                if not (torch.isfinite(grads["kernel"][i]).all()
                        and grads["kernel"][i].abs().max() > 0)]
        rec = {"phase": "grad_parity", "dtype": dname, "B": 2,
               "loss": losses, "rel_l2": rel(grads["kernel"], grads["composite"]),
               "rel_l2_worst_block": max(per_block.values()),
               "per_block": per_block, "tol": GRAD_TOL[dname],
               "attention_params_checked": len(attn), "dead": dead,
               "launches": launches}
        emit(rec)
        expected = {"kernel": 7, "composite": 0}
        if (dead or not attn or rec["rel_l2_worst_block"] > GRAD_TOL[dname]
                or rec["rel_l2"] > GRAD_TOL[dname]
                or abs(losses["kernel"] - losses["composite"])
                > GRAD_TOL[dname] * abs(losses["composite"])
                or any(launches[m][k] != expected[m] for m in expected
                       for k in ("flash_bwd_dq", "flash_bwd_dkv",
                                 "fused_attention_lse"))):
            raise AssertionError(f"375M gradient parity {dname}: {rec}")
        del model, params, grads
        torch.cuda.empty_cache()


def same_tree(a, b):
    """Whether two state trees (dicts, lists, tensors, numbers) hold the
    same keys, lengths and bit-equal values."""
    import torch

    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same_tree(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(same_tree(x, y) for x, y in zip(a, b)))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    return a == b


def training_phase(tmp, profile=False):
    """12 steps of ``cli.train_ar.run`` per backward mode on synthetic
    latents; the checkpoint of the kernel run restores. With ``profile``,
    4 more steps of the kernel run's trainer run under the profiler."""
    import numpy as np
    import torch

    from ladcast_torch.cli import train_ar
    from ladcast_torch.data.time_utils import add_hours_int
    from ladcast_torch.ops import flash_attention as fa
    from ladcast_torch.train import checkpoint as ckpt

    rng = np.random.RandomState(0)
    latents = os.path.join(tmp, "latents.npz")
    np.savez(latents, latents=rng.randn(64, 15, 30, 84).astype(np.float32),
             timestamps=np.asarray([add_hours_int(2018010100, i) for i in range(64)]))
    results = {}
    if fa.BWD_MODE != "kernel":
        raise AssertionError(f"the default BWD_MODE is {fa.BWD_MODE!r}, not 'kernel'")
    # the kernel run is the trainer as a user runs it; the composite is
    # asked for explicitly
    for mode in ("kernel", "composite"):
        out_dir = os.path.join(tmp, mode)
        args = train_ar.build_parser().parse_args(
            ["--latents", latents, "--num_steps", str(TRAIN_STEPS), "--output_dir",
             out_dir, "--log_every", "1", "--seed", "0"])
        prev, fa.BWD_MODE = fa.BWD_MODE, mode
        _reset_launches(fa)
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            res = train_ar.run(LADCAST_375M_YAML, args)
            wall_s = time.perf_counter() - t0
        finally:
            fa.BWD_MODE = prev
        launches = _launches(fa)
        hist = res["history"]
        step_ms = [r["step_s"] * 1e3 for r in hist]
        rec = {"phase": "training", "bwd_mode": mode, "steps": len(hist),
               "batch": 4, "compute_dtype": "bfloat16",
               "median_step_ms": statistics.median(step_ms[2:]),
               "step_ms": step_ms, "loss": [r["loss"] for r in hist],
               "grad_norm": [r["grad_norm"] for r in hist],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
               "run_wall_s": wall_s, "launches": launches}
        n = 7 * TRAIN_STEPS
        expected = {"norm_rope": n, "fused_attention": n,
                    "fused_attention_lse": n if mode == "kernel" else 0,
                    "flash_bwd_dq": n if mode == "kernel" else 0,
                    "flash_bwd_dkv": n if mode == "kernel" else 0}
        finite = all(math.isfinite(x) for x in rec["loss"] + rec["grad_norm"])
        if mode == "kernel":
            # the last step's checkpoint into a fresh trainer
            fresh = train_ar.run(LADCAST_375M_YAML, train_ar.build_parser().parse_args(
                ["--latents", latents, "--num_steps", "0", "--output_dir",
                 os.path.join(tmp, "fresh")]))["state"]
            mgr = ckpt.make_manager(os.path.join(out_dir, "ckpts"))
            ckpt.restore_state(mgr, fresh, TRAIN_STEPS)
            state = res["state"]
            rec["checkpoint_restores"] = bool(
                fresh.step == state.step == TRAIN_STEPS
                and same_tree(fresh.state_dict(), state.state_dict()))
            del fresh, mgr
            shutil.rmtree(out_dir)  # the 6 GB checkpoint
            if profile:
                batch = _train_batch(4, torch.device("cuda"), 5)[0]
                profile_phase("training", lambda: [
                    res["train_step"](state, batch, 0) for _ in range(4)])
            del state
        emit(rec)
        results[mode] = rec
        if (len(hist) != TRAIN_STEPS or not finite or launches != expected
                or not rec.get("checkpoint_restores", True)):
            raise AssertionError(f"training, {mode} backward: {rec}, "
                                 f"expected launches {expected}")
        del res, hist
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
              ("flash_bwd", ("bwd_dq_", "bwd_dkv_")),
              ("norm_rope", ("norm_rope_kernel",)),
              ("foreach (AdamW, EMA, norms)", ("multi_tensor_apply",)),
              ("conv", ("fprop", "dgrad", "conv", "winograd", "nchwToNhwc",
                        "nhwcToNchw")),
              ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "s16816", "wgmma")),
              ("reduction", ("reduce", "norm", "softmax")),
              ("copy_cat", ("CatArray", "Copy", "copy", "flip", "roll",
                            "index")),
              ("elementwise", ("elementwise", "vectorized", "fill"))]


def profile_phase(path, fn):
    """``fn()`` under torch.profiler: wall time, the union of kernel
    intervals (device busy time) and kernel time by category."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    emit({"phase": "profile", "path": path, "wall_s": wall_s,
          "n_kernels": len(kernels),
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
                    help="profile one more repetition of the main path "
                         "and 4 more training steps")
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
    results.update(backward_kernel_phase(peaks))
    emit({"phase": "backward_kernel_done", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    model_parity_phase()
    emit({"phase": "model_parity_done", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    grad_parity_phase()
    emit({"phase": "grad_parity_done", "wall_s": time.perf_counter() - t0})
    launches, bench = main_path_phase(args.reps)
    if args.profile:
        profile_phase("inference", lambda: bench["full_forecast"](6))
    del bench
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        training = training_phase(tmp, args.profile)
    emit({"phase": "training_done", "wall_s": time.perf_counter() - t0})
    train_launches = training["kernel"]["launches"]

    src = "ladcast_tpu/ops/pallas/flash_attention.py"
    meta = {"norm_rope": ("ladcast_torch/csrc/norm_rope.cu", f"{src}:70"),
            "fused_attention": ("ladcast_torch/csrc/fused_attention.cu", f"{src}:113"),
            "flash_bwd_dq": ("ladcast_torch/csrc/flash_bwd.cu", f"{src}:279"),
            "flash_bwd_dkv": ("ladcast_torch/csrc/flash_bwd.cu", f"{src}:318")}

    def entry(kname, recs, path_launches):
        main = next(r for r in recs if r["case"] == "dual_2250"
                    and r["dtype"] == "bfloat16")
        return {"name": kname, "route": "cuda", "source": meta[kname][0],
                "replaces": meta[kname][1], "launches": path_launches,
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": main["library_ms"]}

    # launches: the inference path's for K1 and K2, the training path's
    # (kernel backward) for K3; each entry also names its training launches
    summary = []
    for kname in ("norm_rope", "fused_attention"):
        e = entry(kname, results[kname], launches[kname])
        e["training_launches"] = train_launches[kname]
        summary.append(e)
    lse = entry("fused_attention", results["fused_attention_lse"],
                train_launches["fused_attention_lse"])
    summary[1]["lse_variant"] = {k: lse[k] for k in (
        "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")}
    pair = next(r for r in results["flash_bwd_pair"] if r["case"] == "dual_2250"
                and r["dtype"] == "bfloat16")
    for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
        e = entry(kname, results[kname], train_launches[kname])
        e["batch"] = 4
        # dq and dk/dv together against the whole plain and SDPA backward
        e["pair"] = {k: pair[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")}
        summary.append(e)
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
