#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py            # one repetition of the bench workload
    python3 chip_smoke.py --reps 10  # the whole 240 h bench workload
    python3 chip_smoke.py --records out/records.jsonl  # keep every record
    python3 chip_smoke.py --fp32-ab PARENT  # only the fp32 K1 / K3 A/B

Phases, each printed as JSON lines; any failure raises, so the script exits
non-zero and never prints the last line. Four paths of the port run: the
ensemble rollout of the bench workload (inference), the AR trainer of the
375M and the 1.6B DiT, the forecast CLI (hub checkpoints in, latent and
field files out), and the rest of the user's chain around it (DCAE
training, latent encoding, statistics and climatology, ensemble scoring,
the baseline comparison, cyclone tracking, AR training with validation);
then the forecast with int8 matmuls, the trainers fed from monthly tars and
latent shards, and the DCAE with timestep conditioning.

  1. environment: the card (nvidia-smi), torch and CUDA versions, and the
     build of the CUDA kernels from ``ladcast_torch/csrc`` (one nvcc per
     source, in parallel); for the attention's, the flash backward's, the
     two convs' and the plain attention's libraries, each kernel's (each
     template instance's) registers, shared memory and spills (``-Xptxas
     -v``) and its count of wgmma (HGMMA), TMA-load (UTMALDG), mma.sync
     (HMMA) and fp32 FMA (FFMA) instructions (``cuobjdump -sass``): K1
     and the K3 pair in both dtypes (``fa_bf16_wgmma_kernel``,
     ``fa_f32_wgmma_kernel``, ``bwd_dq_bf16_wgmma_kernel``,
     ``bwd_dkv_bf16_wgmma_kernel``, ``bwd_dq_f32_wgmma_kernel``,
     ``bwd_dkv_f32_wgmma_kernel``) and all six instances of K6
     (``fa_plain_wgmma_kernel``, three head sizes, one or three bf16 planes)
     must have the first two, not the third, and every instance of the bf16
     and the fp32 K4 (``conv_bf16_wgmma_kernel``, ``conv_f32_wgmma_kernel``)
     wgmma and no mma.sync; all of them spill nothing and draw no note from
     ptxas (a serialised wgmma); the split passes are reported only;
  2. kernels: each kernel against its plain PyTorch version on the card, in
     bf16 and fp32, at the main path's shapes (B=20, S=2250 dual- and
     single-stream tables, S=450 refiner tables) and a ragged small case,
     with median times over 20 timed runs, the plain version's time, the
     roofline bound and, for the attention, the time of PyTorch's
     ``scaled_dot_product_attention`` on the pre-normed inputs (a
     yardstick only; the port never calls it; in fp32 with TF32 off, with
     its output's relative L2 to the plain version, ``library_rel_l2``),
     its rate and the bound's share of its time; the fp32 K1's bound is
     its products as six bf16 plane products (``bound_passes`` 6), with the
     CUDA cores' fp32 bound beside it (``cuda_core_bound_ms``);
     the plain flash attention (K6) follows at ``K6_CASES``, bf16 and fp32
     inputs: timed at (2, 2250 / 450, 12, 128), with its bound in
     tensor-core passes (``flash_plain_bound``), SDPA on fp32 copies (the
     same function, ``library_ms``, and its relative L2 to the plain
     version) and, for bf16 inputs, SDPA on the inputs, which rounds P to
     bf16 (``library_bf16p_ms``); checked only at a ragged (1, 130, 3, 64),
     Sq != Sk (75 over 150 keys), D = 256 and D = 36 (rows TMA cannot load);
     all against K6's own limits (``K6_REL_L2``); then driven once through
     ``ops.attention.dot_product_attention``;
  2a. conv kernels: the dense (K4) and depthwise (K5) convolutions against
     their plain versions, zero-padded and circular, at every distinct
     shape of the shipped DCAE and at small ragged shapes: in bf16 at the
     batches the paths give them (the decoder's shapes at B=80, the bench
     path's decode, and B=40, the forecast path's chunk; the encoder's at
     B=1), in fp32 at B=2; each timed, K4 on its packed weight as the path
     runs it (one bf16 plane, or three of an fp32 weight; the packing timed
     on its own, ``pack_ms``), the fp32 K4's bound in bf16 passes, with
     cuDNN's ``F.conv2d`` on channels-last tensors as the yardstick (the
     port calls it only under ``CONV_MODE = "library"``), the rate and the
     bound's share of the time;
  2c. conv scoring: K4 and K5 in fp32 at the scorer's batch (B=20, one
     lead's members; ``cli.evaluate_ens`` decodes in the fp32 of the
     parameters it loads) at every decoder shape, circular, against their
     plain versions, timed beside cuDNN's fp32 ``F.conv2d`` with TF32 off;
     K4 on the fp32 kernel (one launch each), its bound in six bf16 passes
     beside the CUDA cores' fp32 bound;
  2b. backward kernels: the lse variant of the attention kernel and the
     flash backward (dq, dk/dv) against their plain versions, bf16 and
     fp32, at the training shapes (B=4, S=2250 dual- and single-stream
     tables, S=450 refiner tables, and the 1.6B's 16 heads at S=2250) and a
     ragged small case, each backward run twice and required to give the
     same bits (no atomics), with times, rates,
     bounds and, as yardsticks only, the time of the aten op of SDPA's own
     backend asked for its logsumexp beside the lse variant, and of
     PyTorch's SDPA backward on the same pre-normed inputs beside the
     backward, per kernel and for the dq + dk/dv pair against the whole
     plain and SDPA backward; the fp32 kernels' bounds as six bf16 plane
     products beside the CUDA cores' (as the fp32 K1), and SDPA's fp32
     output and gradients against the plain versions (``library_rel_l2``);
  3. model parity: one 375M DiT forward at B=2 through the kernels and
     through the plain composite, same seeded weights and inputs;
  3b. gradient parity: the 375M training loss at B=2 (injected sigma
     indices and noise) and every parameter's gradient, with the
     attention backward on the kernels and on the composite, fp32 and
     bf16; every attention projection and qk-norm weight must get a
     finite, non-zero gradient, and a raw kernel entry given a tensor
     that requires grad must refuse it;
  3c. DCAE parity: one encode and one decode of the shipped DCAE at B=2
     under ``CONV_MODE = "kernel"`` (the default) against ``"library"``,
     fp32 and bf16, with the launches of K4 and K5 per call (in fp32 every
     dense conv on the fp32 kernel);
  3d. DCAE with timestep conditioning: the shipped widths with
     ``temb_channels`` = DCAE_TEMB_CHANNELS at B=4, encode and decode with
     ``time_elapsed`` under both conv modes, fp32 and bf16, to DCAE_TOL,
     with the launches of K4 and K5 (the decode without ``time_elapsed``
     must differ);
  4. main path: ``ladcast_torch.bench.make_bench`` with the 375M DiT and
     the shipped DCAE, seeded bf16 weights: encode, 20 members, Heun-20
     repetitions (39 DiT calls each), decode of every repetition's 80
     frames. Outputs must be finite and each kernel must have launched
     7 x 39 times per repetition (the conv kernels once per sphere conv of
     the encode and of each decode); the decode of 80 frames is then timed
     under both conv modes and its two results compared;
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
  5a. fp32 training: TRAIN_STEPS_F32 steps of the same run under
     ``--compute_dtype float32``: ms per step, peak memory, losses, and 7
     launches a step of the fp32 K1-lse and K3 pair;
  5b. the 1.6B: ``config.ladcast_1p6b_config`` at full width on seeded
     weights: its bf16 forward at B=20 (1800 + 450 tokens), finite and
     launching K1 and K2 once per attention, after a parity check against
     the plain composite at B=2; ``cli.train_ar.run`` in one process must
     refuse configs/ladcast_1p6b.yaml as shipped with the mesh-size error
     (its parallel: section asks for model groups of 8 ranks), then trains
     TRAIN_STEPS_1P6B steps with the section dropped, as a one-card user
     must (remat as the yaml sets
     it, on the training phase's latents): ms per step, peak memory,
     losses, and the launches of K1-lse and K3 at 16 heads; the 26 GB
     checkpoint is not written;
  6. forecast: a seeded 375M DiT (index-sharded) and the shipped DCAE
     (one file) written as hub directories by the port's
     ``save_pretrained``, synthetic ``.npz`` fields with SST NaNs, then
     ``ladcast_torch.cli.pred_rollout`` twice, 20 members, 20 steps, 24 h:
     ``--sampler edm --decode`` for one init time and ``--sampler dpm`` for
     two. File layouts, finiteness, the t=0 frame against the encoder, the
     launches of K1, K2, K4 and K5 per init time, and the seconds of load,
     encode, rollout and decode (the decode under both conv modes);
  6b. chain: on seeded raw fields at the 120 x 240 x 84 grid with SST NaN
     over land (12 frames of 2018 to train on and to score against, 4 for
     validation, 12 of 2017 for the climatology), each CLI's ``run`` or
     ``main``: ``train_dcae`` on configs/dcae_84.yaml (CHAIN_DCAE_STEPS
     steps, both the unrolled and the rolled step, one validation; ms per
     step, peak memory, losses, grad norms, K4 and K5 launches per step,
     the grad-mode packing's ms and share), the DCAE's gradients under the
     kernels against cuDNN (fp32 and bf16, DCAE_TOL), a decoder finetune on
     configs/dcae_84_ft_decoder.yaml from the best weights (no encoder
     parameter may move), ``encode_latents``, ``compute_stats``,
     ``compute_climatology``, ``evaluate_ens --diagnostics`` on two of the
     forecast phase's latent files (20 members, 4 leads, fp32 decode;
     seconds per init time split into decode and scores beside the card's
     name and power limit, launches, every dense conv on the fp32 K4,
     finite metrics), ``compare_baseline``'s ``compare``, ``track`` on the Heun
     forecast's decoded bundle, and ``train_ar`` for CHAIN_AR_STEPS steps
     with a validation rollout every CHAIN_AR_VAL_EVERY (K1 and K2 in the
     rollouts, K1-lse and K3 in the steps);
  6c. int8 forecast: ``pred_rollout --int8_matmuls`` as the Heun run of
     phase 6 without the decode (20 members, Heun-20, 24 h, the same seed):
     the rollout's seconds against the bf16 run's, the relative L2 of its
     latents from that run (``INT8_REL_L2``), K1 and K2 launches equal to
     that run's, one int8 GEMM per quantised projection; then
     ``torch._int_mm`` at the 375M's four (K, N) pairs at M = 20 x 2250:
     its int32 product equal to the fp64 product of the same int8 values,
     timed against bf16 ``torch.matmul`` and its bound at the card's int8
     rate (``INT8_PEAKS``), and the whole w8a8 function against
     ``F.linear``;
  6d. data sources: the chain's 16 raw frames written as monthly tars in
     the archive's layout ((85, 121, 240) members, a pole row and a
     surface-pressure channel added), read back bit-equal to the ``.npz``
     through the C++ reader and through tarfile; the training phases'
     latents cut into DATA_SHARDS shards plus ``timestamps.npy`` and read
     back by both readers; host read rates in frames per second beside the
     host's CPU; ``train_dcae`` from the tar directory (validation split of
     the same archive) and ``train_ar`` from the shards (``--reader
     native`` and ``mmap``) against the same runs on the ``.npz``: equal
     losses, gradient norms and validation losses;
  6e. parallel (``ladcast_torch.parallel``): a one-rank NCCL group in this
     process trains the 375M yaml under ``--mesh data=-1`` (DDP), the 1.6B
     yaml as shipped under ``--mesh data=-1 --zero`` (FSDP) and the chain's
     DCAE (DDP), each held to its single-device run's losses per step
     (PARALLEL_LOSS_RTOL) and launches, with ms per step and peak memory
     beside that run's; then two processes on the one card over a gloo
     group (NCCL refuses two ranks on one GPU): ``pred_rollout
     --shard_ensemble`` as the Heun run of phase 6 (10 members a rank, with
     the decode), its latents held per member to that run's (the 375M bf16
     limit) and its fields to that run's, and ``evaluate_ens`` over the DPM
     run's two files (one a rank) against a one-process run's merged
     tables (PARALLEL_SCORE_RTOL); wall time and each rank's peak memory;
  7. the kernel summary line (the fp32 K4 an entry of its own, its
     launches the scorer's; the fp32 K1, K1-lse and K3 entries of their
     own, their launches phase 5a's, with their other timed cases), the
     card line and, last, the ok line.

With ``--fp32-ab PARENT``, only the fp32 K1 and K3 at dual_2250 and phase
5a run, on the checkout at PARENT and on this one in turns (parent, this,
this, parent), each in a process of its own, and no ok line is printed.

With ``--profile``, one more repetition of the main path runs under
``torch.profiler`` after phase 4, and 4 more training steps (kernel
backward) after the training run of phase 5; a ``profile`` line per path
gives the
device's busy share of that run and its kernel time by category.
"""

import argparse
import contextlib
import dataclasses
import datetime
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Dense peaks (NVIDIA data sheets): bf16 tensor-core and fp32 CUDA-core
# FLOP/s, HBM bytes/s, and TF32 tensor-core FLOP/s (half the bf16 rate).
# Matched on the card's name; the H100 SXM is the default.
PEAKS = [("H100 PCIe", 756e12, 51e12, 2.0e12, 378e12),
         ("H100 NVL", 835e12, 60e12, 3.9e12, 417.5e12),
         ("H200", 989e12, 67e12, 4.8e12, 494.5e12),
         ("", 989e12, 67e12, 3.35e12, 494.5e12)]

# A kernel passes when |kernel - plain| <= atol + rtol * |plain| for every
# element and the relative L2 error is at most rel_l2. In bf16, fp32 results
# that differ in their last bits may round to neighbouring bf16 values: one
# ulp, 2**-7 relative, is allowed on top of atol. norm_rope's outputs are
# O(1) and take a fixed atol. The attention's outputs are averages of V over
# Sk keys, of scale sqrt(e / Sk) for these inputs (0.036 at Sk=2250), so its
# bf16 atol is ATTN_BF16_ULPS bf16 ulps of max |plain|: a fixed 2e-2 would
# pass a kernel that leaves the ragged last key tile unmasked.
ATTN_BF16_ULPS = 2
# The conv kernels and their plain versions both sum the exact products of
# bf16 inputs in fp32, in different orders, and round once to bf16: a pair of
# results differs by at most one bf16 ulp of that element (within the 2**-7
# relative term) wherever the fp32 sums straddle a rounding boundary. The
# outputs have the magnitude of sqrt(kh kw Cin) products, so near an
# element's zero the atol is CONV_BF16_ULPS bf16 ulps at the output's RMS. A
# dropped tap, an unmasked halo row or a missing wrap column moves the
# elements it touches by about a third of that RMS, some forty times more.
CONV_BF16_ULPS = 2
# The lse rows are fp32 in either dtype. From bf16 inputs, the kernel may
# round an element of the scaled Q to the bf16 value next to the plain
# version's (as the output check allows), which moves that row's lse by
# up to |scale * q| * 2**-8 * |kn| (about 1e-3 for these inputs).
LSE_ATOL = {"bfloat16": 1e-3, "float32": 1e-4}
REL_L2 = {"bfloat16": 5e-3, "float32": 1e-4}
# K6 promises fp32 logits, P and products whatever the input dtype, so its
# relative L2 limits are its own. In the emulation of its loop at Sk = 2250
# (tests/test_torch_flash_plain.py) a P rounded once to bf16, as SDPA and
# the composite round it, reads 2.4e-3 (bf16) and 1.5e-3 (fp32), fp32
# products from two bf16 terms 6.2e-6, the faithful loop 1.3e-5 and 5.9e-7.
K6_REL_L2 = {"bfloat16": 5e-4, "float32": 2e-6}
# The fp32 K1 and K3 carry fp32 products as six plane products of bf16
# terms (K6's design), so their fp32 relative L2 limits are their own, set
# between the emulations of their loops at S = 2250
# (tests/test_torch_flash_f32.py): the faithful loops read 6.8e-7 (K1's
# output) and 7.8e-7, 7.7e-7, 7.2e-7 (dq, dk, dv); the same loops on two
# bf16 planes (hi.hi, hi.mid, mid.hi) 6.9e-6 and 8.7e-6, 8.5e-6, 7.1e-6,
# which the general 1e-4 passes. On the card wgmma's coarser accumulation
# adds to the faithful error (K6: 1.0e-6 against its emulation's 5.9e-7).
F32_REL_L2 = {"fused_attention": 3e-6, "flash_bwd_dq": 3e-6, "flash_bwd_dkv": 3e-6}
MODEL_TOL = {"bfloat16": 2e-2, "float32": 1e-3}  # relative L2, 375M forward
GRAD_TOL = {"bfloat16": 2e-2, "float32": 1e-3}  # relative L2, 375M gradients
DCAE_TOL = {"bfloat16": 2e-2, "float32": 1e-3}  # relative L2, kernel vs library convs
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

# configs/ladcast_1p6b.yaml as PyYAML reads it: the 375M's settings with the
# 1.6B's heads and depth, remat, and its parallel: section (a TP + ZeRO mesh,
# which the port refuses; tests/test_torch_train.py holds this copy to the
# file too).
LADCAST_1P6B_YAML = {
    **LADCAST_375M_YAML,
    "ar_model": {**LADCAST_375M_YAML["ar_model"], "num_attention_heads": 16,
                 "num_layers": 5, "num_single_layers": 10, "num_refiner_layers": 3},
    "general": {**LADCAST_375M_YAML["general"], "remat": True,
                "compute_dtype": "bfloat16", "snr_gamma": None,
                "output_dir": "runs/ladcast_1p6b"},
    "parallel": {"mesh": {"data": -1, "model": 8}, "zero": True},
}
TRAIN_STEPS_1P6B = 6
TRAIN_STEPS_F32 = 6  # the 375M under --compute_dtype float32

# configs/dcae_84.yaml and configs/dcae_84_ft_decoder.yaml as PyYAML reads
# them (tests/test_torch_train_dcae.py holds these copies to the files).
_DCAE_84_ENCDEC = {
    "in_channels": 89, "out_channels": 89, "latent_channels": 84,
    "attention_head_dim": 32,
    "encoder_block_types": ["ResBlock", "ResBlock", "EfficientViTBlock",
                            "EfficientViTBlock"],
    "decoder_block_types": ["ResBlock", "ResBlock", "EfficientViTBlock",
                            "EfficientViTBlock"],
    "encoder_block_out_channels": [252, 504, 504, 1008],
    "decoder_block_out_channels": [252, 504, 504, 1008],
    "encoder_layers_per_block": [4, 4, 4, 4],
    "decoder_layers_per_block": [4, 4, 4, 4],
    "encoder_qkv_multiscales": [[], [], [5], [5]],
    "decoder_qkv_multiscales": [[], [], [5], [5]],
    "upsample_block_type": "pixel_shuffle",
    "downsample_block_type": "pixel_unshuffle", "static_channels": 5}
DCAE_84_YAML = {
    "encdec": _DCAE_84_ENCDEC,
    "optimizer": {"betas": [0.9, 0.999], "eps": "1e-08", "lr": "1e-4",
                  "weight_decay": "1e-2"},
    "lr_scheduler": {"name": "cosine", "num_warmup_steps": 1000},
    "train": {"batch_size": 4, "subbatch_steps": 3, "lat_weighted_loss": True,
              "num_train_epochs": 30, "epoch_length": 341875},
    "accelerator": {"log_with": "jsonl"},
    "ema": {"use_ema": True, "ema_max_decay": 0.9999, "ema_inv_gamma": 1.0,
            "ema_power": 0.66667, "ema_update_after_step": 1000},
    "general": {"seed": 42, "output_dir": "runs/dcae_84",
                "checkpointing_steps": 40000},
}
DCAE_84_FT_YAML = {
    "encdec": _DCAE_84_ENCDEC,
    "optimizer": {"betas": [0.9, 0.999], "eps": "1e-08", "lr": "2e-5",
                  "weight_decay": "1e-2"},
    "lr_scheduler": {"name": "cosine", "num_warmup_steps": 500},
    "train": {"batch_size": 4, "subbatch_steps": 3, "lat_weighted_loss": True,
              "ft_decoder_only": True, "num_train_epochs": 5,
              "epoch_length": 341875},
    "ema": {"use_ema": True, "ema_max_decay": 0.9999, "ema_inv_gamma": 1.0,
            "ema_power": 0.66667, "ema_update_after_step": 500},
    "general": {"seed": 42, "output_dir": "runs/dcae_84_ft",
                "checkpointing_steps": 20000},
}
# The chain phase's cuts: DCAE training steps (two batches: the unrolled and
# the rolled steps), finetune steps, AR training steps with a validation
# every CHAIN_AR_VAL_EVERY, the validation's init times, members and hours.
CHAIN_DCAE_STEPS = 6
CHAIN_FT_STEPS = 3
CHAIN_AR_STEPS = 4
CHAIN_AR_VAL_EVERY = 2
CHAIN_VAL = {"init_times": 2, "members": 10, "hours": 24, "steps": 20}
# The scorer decodes one lead's members at once: B = 20, in fp32.
SCORE_BATCH = 20


RECORDS = None  # --records: a file that also gets every record


def emit(obj):
    """Print one record and, with ``--records``, append it to that file: a
    caller that sees only the end of a long output finds every line there."""
    line = json.dumps(obj)
    print(line, flush=True)
    if RECORDS is not None:
        with open(RECORDS, "a") as f:
            f.write(line + "\n")


def host_peak_rss_gb():
    """This process's peak resident host memory so far, in GB."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def dir_gb(path):
    """The bytes of the files under ``path``, in GB."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files) / 1e9


def nvidia_smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def csrc_kernels():
    """{source stem: [names of its __global__ kernels]} of
    ``ladcast_torch/csrc/*.cu``, read from the sources."""
    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")
    return {p.stem: pat.findall(p.read_text())
            for p in sorted((ROOT / "ladcast_torch" / "csrc").glob("*.cu"))}


# SASS opcodes that show which path a kernel took: HGMMA is wgmma, UTMALDG a
# TMA tile load, HMMA mma.sync, FFMA an fp32 multiply-add on the CUDA cores
SASS_OPS = ("HGMMA", "UTMALDG", "HMMA", "FFMA")


_BUILTIN_TYPES = {"f": "float", "d": "double", "i": "int", "b": "bool"}


def kernel_instance(text, name):
    """``name``, or ``name<args>`` for a template instance, from the first
    mangled symbol of ``name`` in ``text`` (an Itanium template argument
    list: literals, length-prefixed names, builtin types)."""
    j = text.find(name) + len(name)
    if not text.startswith("I", j):
        return name
    args, j = [], j + 1
    while j < len(text) and text[j] != "E":
        lit = re.compile(r"L[a-z](n?\d+)E").match(text, j)
        num = re.compile(r"\d+").match(text, j)
        if lit:
            args.append(lit.group(1).replace("n", "-"))
            j = lit.end()
        elif num:
            n = int(num.group())
            args.append(text[num.end():num.end() + n])
            j = num.end() + n
        else:
            args.append(_BUILTIN_TYPES.get(text[j], text[j]))
            j += 1
    return f"{name}<{', '.join(args)}>"


def kernel_report(lib_name):
    """{kernel or template instance: {"ptxas": registers / barriers / shared
    memory line, "frame": stack and spill line, "warnings": ptxas's warnings
    and performance notes (such as wgmma serialised), "sass": {op: count}}}
    for the kernels of one built library, from nvcc's ``-Xptxas -v`` log and
    ``cuobjdump -sass``."""
    from ladcast_torch.ops import _build

    lib = _build.build_all()[lib_name]
    names = csrc_kernels()[lib_name]
    report = {}

    def which(text):
        """The kernel (instance) a line names, entered in the report."""
        name = next((n for n in names if n in text), None)
        if name is None:
            return None
        key = kernel_instance(text, name)
        report.setdefault(key, {"ptxas": None, "frame": None, "warnings": [], "sass": {}})
        return key

    cur = None
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            cur = which(line)
        elif cur and "registers" in line:
            report[cur]["ptxas"] = line.split(":", 1)[1].strip()
        elif cur and "spill stores" in line:
            report[cur]["frame"] = line.strip()
        if ("warning" in line.lower() or "Performance Loss" in line) and which(line):
            report[which(line)]["warnings"].append(line.strip())
    sass = subprocess.run([str(_build.nvcc_dir() / "cuobjdump"), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    op = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)")
    for section in sass.split("Function : ")[1:]:
        key = which(section.splitlines()[0])
        if key is None:
            continue
        ops = [m.group(1) for m in op.finditer(section)]
        report[key]["sass"] = {o: ops.count(o) for o in SASS_OPS}
    return report


def clean_build(rec):
    """Whether a kernel_report entry spills nothing and drew no warning or
    note from ptxas."""
    return (not rec["warnings"] and bool(rec["frame"])
            and "0 bytes spill stores, 0 bytes spill loads" in rec["frame"])


def bf16_ulp(x):
    """The spacing of bf16 values (8 significant bits) at magnitude x > 0."""
    return 2.0 ** (math.floor(math.log2(x)) - 7)


def kernel_tolerance(kernel, dtype_name, ref):
    """{"atol", "rtol", "rel_l2"} for comparing ``kernel`` with its plain
    version's output ``ref``."""
    if kernel == "fused_attention_lse":  # fp32 logsumexp rows, |lse| ~ 8
        return {"atol": LSE_ATOL[dtype_name], "rtol": 0.0,
                "rel_l2": REL_L2["float32"]}
    rel_l2 = (K6_REL_L2 if kernel == "flash_attention" else REL_L2)[dtype_name]
    if dtype_name == "float32":
        return {"atol": 1e-4, "rtol": 0.0, "rel_l2": F32_REL_L2.get(kernel, rel_l2)}
    if kernel == "norm_rope":
        atol = 2e-2
    elif kernel in ("dense_conv", "depthwise_conv"):
        atol = CONV_BF16_ULPS * bf16_ulp(ref.float().square().mean().sqrt().item())
    else:
        atol = ATTN_BF16_ULPS * bf16_ulp(ref.float().abs().max().item())
    return {"atol": atol, "rtol": 2**-7, "rel_l2": rel_l2}


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


def kernel_phase(peaks, dtypes=("bfloat16", "float32"), only=None):
    """K2 and K1 against their plain versions at the main path's shapes, in
    ``dtypes``, at every case or those named in ``only``."""
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
    peak_bf16, peak_f32, bw, _ = peaks
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
    for dtype in (getattr(torch, d) for d in dtypes):
        dname = str(dtype).split(".")[-1]
        for name, B, segs, timed in (c for c in cases if only is None or c[0] in only):
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
            if dtype == torch.float32:  # products as six bf16 plane products
                rec.update(f32_split_bound(flops, nbytes, peaks),
                           library_tf32=torch.backends.cuda.matmul.allow_tf32)
            else:
                rec.update(bound(flops, nbytes, peak_bf16, bw))
            if timed:
                rec["ms"] = time_ms(lambda: fa.fused_attention(q, kn, v, cos, sin, w))
                rec["plain_ms"] = time_ms(
                    lambda: fa.fused_attention_plain(q, kn, v, cos, sin, w), inner=1)
                qh = fa.norm_rope_plain(q, w, cos, sin).transpose(1, 2).contiguous()
                kh, vh = (t.transpose(1, 2).contiguous() for t in (kn, v))
                rec["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(qh, kh, vh), inner=1)
                rec["library_op"] = ("F.scaled_dot_product_attention, on "
                                     + sdpa_with_lse(qh, kh, vh)[0])
                if dtype == torch.float32:  # does the yardstick keep fp32 products?
                    rec["library_rel_l2"] = compare(
                        F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2),
                        ref, rec["tol"])["rel_l2"]
                rec.update(rates(flops, rec))
                del qh, kh, vh
            emit(rec)
            results["fused_attention"].append(rec)
            if not (rec["finite"] and rec["ok"]):
                raise AssertionError(f"fused_attention {name} {dname}: {rec}")
            del q, k, v, kn, out, ref
        torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def conv_mode(mode):
    """``ops.sphere.CONV_MODE`` set to ``mode`` for the block."""
    from ladcast_torch.ops import sphere

    prev, sphere.CONV_MODE = sphere.CONV_MODE, mode
    try:
        yield
    finally:
        sphere.CONV_MODE = prev


# The sphere convs of the shipped DCAE (DCAEConfig() defaults), by distinct
# shape: (H, W, Cin, Cout) of the dense 3x3 ones, (H, W, C, k) of the
# depthwise ones (both halves run all four). tests/test_torch_conv_kernels.py
# holds these tables to the model.
DECODER_DENSE = [
    (15, 30, 84, 1008), (15, 30, 1008, 2016), (30, 60, 504, 2016),
    (60, 120, 504, 1008), (60, 120, 504, 504), (120, 240, 252, 252),
    (120, 240, 252, 89)]
ENCODER_DENSE = [
    (120, 240, 89, 252), (120, 240, 252, 252), (120, 240, 252, 126),
    (60, 120, 504, 504), (60, 120, 504, 126), (30, 60, 504, 252),
    (15, 30, 1008, 84)]
DEPTHWISE_SHAPES = [(15, 30, 8064, 3), (30, 60, 4032, 3), (15, 30, 2976, 5),
                    (30, 60, 1440, 5)]
# The batches the paths give the kernels in bf16: the bench path decodes a
# repetition's 80 frames in one call, the forecast path decodes in chunks of
# 40, and both encode one frame. fp32 is not on a path: B = 2, for parity.
DECODE_BATCHES = (80, 40)
ENCODE_BATCH = 1
FP32_BATCH = 2
# The kernels line reads the forecast path's launches, so its times are those
# of that path's decode batch.
KERNEL_LINE_CASES = {"dense_conv": ("120x240x252->252", 40),
                     "depthwise_conv": ("30x60x4032 k3", 40)}


def conv_production_cases(dtype_name):
    """(B, dense shapes, depthwise shapes) to check and time in a dtype."""
    if dtype_name == "float32":
        both = DECODER_DENSE + [c for c in ENCODER_DENSE if c not in DECODER_DENSE]
        return [(FP32_BATCH, both, DEPTHWISE_SHAPES)]
    return ([(B, DECODER_DENSE, DEPTHWISE_SHAPES) for B in DECODE_BATCHES]
            + [(ENCODE_BATCH, ENCODER_DENSE, DEPTHWISE_SHAPES)])


def conv_kernel_phase(peaks):
    """K4 and K5 against their plain versions and cuDNN at the DCAE's
    shapes."""
    import torch
    import torch.nn.functional as F

    from ladcast_torch.ops import dense_conv as dc
    from ladcast_torch.ops import depthwise_conv as dw

    dev = torch.device("cuda")
    peak_bf16, peak_f32, bw, _ = peaks
    g = torch.Generator(device=dev).manual_seed(5)

    def rand(shape, scale, dtype):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def library(x, w_oihw, p, circular, groups):
        """One cuDNN call on the channels-last views; for the circular
        form the wrap columns are concatenated beforehand, outside the
        timed call."""
        if circular:
            x = torch.cat([x[:, :, x.shape[2] - p:], x, x[:, :, :p]], dim=2)
        xv = x.permute(0, 3, 1, 2)
        pad = (p, 0) if circular else p
        return lambda: F.conv2d(xv, w_oihw, padding=pad, groups=groups)

    results = {"dense_conv": [], "depthwise_conv": []}
    dense_small = [(2, 7, 6, 89, 21, 3), (1, 5, 6, 130, 130, 3)]
    dw_small = [(2, 7, 6, 89, 3), (2, 5, 6, 130, 5)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        tkw = (dict(rounds=10, inner=2) if dtype == torch.bfloat16
               else dict(rounds=5, inner=1, warmup=1))
        production = conv_production_cases(dname)
        cases = ([("small", *c) for c in dense_small]
                 + [("production", B, *c, 3) for B, dense, _ in production
                    for c in dense])
        for kind, B, H, W, Cin, Cout, k in cases:
            p = k // 2
            pads = ((p, p), (p, p))
            x = rand((B, H, W, Cin), 1.0, dtype)
            # lecun-normal scale, as the model's weights: outputs of O(1)
            w = rand((k, k, Cin, Cout), (k * k * Cin) ** -0.5, dtype)
            w_oihw = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            # what the path passes: the packed tiles (one bf16 plane, or three
            # of an fp32 weight)
            wk = dc.pack_dense_weight(w)
            flops = 2 * k * k * Cin * Cout * B * H * W
            nbytes = (x.numel() + w.numel() + B * H * W * Cout) * x.element_size()
            for circular in (True, False):
                out = dc.dense_conv_forward(x, wk, pads, circular)
                torch.cuda.synchronize()
                ref = dc.dense_conv_plain(x, w, pads, circular)
                rec = {"phase": "conv_kernel", "kernel": "dense_conv",
                       "case": f"{H}x{W}x{Cin}->{Cout}", "kind": kind,
                       "dtype": dname, "B": B, "k": k, "circular": circular,
                       **compare(out, ref, kernel_tolerance("dense_conv", dname, ref)),
                       "finite": bool(torch.isfinite(out).all()),
                       **(bound(flops, nbytes, peak_bf16, bw) if dtype == torch.bfloat16
                          else f32_split_bound(flops, nbytes, peaks))}
                if kind == "production":
                    rec["ms"] = time_ms(
                        lambda: dc.dense_conv_forward(x, wk, pads, circular), **tkw)
                    rec["plain_ms"] = time_ms(
                        lambda: dc.dense_conv_plain(x, w, pads, circular), **tkw)
                    rec["library_ms"] = time_ms(library(x, w_oihw, p, circular, 1),
                                                **tkw)
                    if circular:
                        rec["pack_ms"] = time_ms(lambda: dc.pack_dense_weight(w), **tkw)
                    rec.update(rates(flops, rec))
                emit(rec)
                results["dense_conv"].append(rec)
                if not (rec["ok"] and rec["finite"]):
                    raise AssertionError(f"dense_conv {rec}")
                del out, ref
            del x, w, wk, w_oihw
        cases = ([("small", *c) for c in dw_small]
                 + [("production", B, *c) for B, _, depthwise in production
                    for c in depthwise])
        for kind, B, H, W, C, k in cases:
            p = k // 2
            pads = ((p, p), (p, p))
            x = rand((B, H, W, C), 1.0, dtype)
            kk = rand((k, k, C), 1.0 / k, dtype)
            w_oihw = kk.permute(2, 0, 1)[:, None].contiguous()
            flops = 2 * k * k * C * B * H * W
            nbytes = (2 * x.numel() + kk.numel()) * x.element_size()
            for circular in (True, False):
                out = dw.depthwise_same_conv_forward(x, kk, pads, circular)
                torch.cuda.synchronize()
                ref = dw.depthwise_same_conv_plain(x, kk, pads, circular)
                rec = {"phase": "conv_kernel", "kernel": "depthwise_conv",
                       "case": f"{H}x{W}x{C} k{k}", "kind": kind, "dtype": dname,
                       "B": B, "k": k, "circular": circular,
                       **compare(out, ref, kernel_tolerance("depthwise_conv", dname, ref)),
                       "finite": bool(torch.isfinite(out).all()),
                       # multiply-adds on the CUDA cores in either dtype
                       **bound(flops, nbytes, peak_f32, bw)}
                if kind == "production":
                    rec["ms"] = time_ms(lambda: dw.depthwise_same_conv_forward(
                        x, kk, pads, circular), **tkw)
                    rec["plain_ms"] = time_ms(lambda: dw.depthwise_same_conv_plain(
                        x, kk, pads, circular), **tkw)
                    rec["library_ms"] = time_ms(library(x, w_oihw, p, circular, C),
                                                **tkw)
                    rec.update(rates(flops, rec))
                emit(rec)
                results["depthwise_conv"].append(rec)
                if not (rec["ok"] and rec["finite"]):
                    raise AssertionError(f"depthwise_conv {rec}")
                del out, ref
            del x, kk, w_oihw
        torch.cuda.empty_cache()
    return results


def conv_scoring_phase(peaks):
    """K4 and K5 in fp32 at the scorer's shapes: ``cli.evaluate_ens``
    decodes the 20 members of one lead at a time with the fp32 parameters
    it loads, so every decoder conv runs at B = SCORE_BATCH in fp32
    (circular, as the path runs them; the dense ones on the fp32 K4,
    ``conv_f32_wgmma_kernel``, reading the three-plane packed weight the
    model keeps, whose packing is timed apart as ``pack_ms``). Each against
    its plain version, timed beside cuDNN's fp32 ``F.conv2d`` with TF32
    off, the same function; the dense ones' bound in bf16 passes
    (``f32_split_bound``) beside the CUDA cores' fp32 bound."""
    import torch
    import torch.nn.functional as F

    from ladcast_torch.cli.evaluate_ens import _exact_fp32_convs
    from ladcast_torch.ops import dense_conv as dc
    from ladcast_torch.ops import depthwise_conv as dw

    dev = torch.device("cuda")
    _, peak_f32, bw, _ = peaks
    g = torch.Generator(device=dev).manual_seed(6)
    B, tkw = SCORE_BATCH, dict(rounds=5, inner=1, warmup=1)
    results = {"dense_conv": [], "depthwise_conv": []}
    with _exact_fp32_convs():
        for kname, shapes in (("dense_conv", DECODER_DENSE),
                              ("depthwise_conv", DEPTHWISE_SHAPES)):
            for shape in shapes:
                dense = kname == "dense_conv"
                if dense:
                    H, W, Cin, Cout = shape
                    k, groups, case = 3, 1, f"{H}x{W}x{Cin}->{Cout}"
                    w = torch.randn((k, k, Cin, Cout), generator=g, device=dev) * (
                        k * k * Cin) ** -0.5
                    w_oihw = w.permute(3, 2, 0, 1).contiguous(
                        memory_format=torch.channels_last)
                    fwd, plain_fn = dc.dense_conv_forward, dc.dense_conv_plain
                    wk = dc.pack_dense_weight(w)  # as the model keeps it
                else:
                    H, W, Cin, k = shape
                    Cout, groups, case = Cin, Cin, f"{H}x{W}x{Cin} k{k}"
                    w = torch.randn((k, k, Cin), generator=g, device=dev) / k
                    w_oihw = w.permute(2, 0, 1)[:, None].contiguous()
                    fwd = dw.depthwise_same_conv_forward
                    plain_fn = dw.depthwise_same_conv_plain
                    wk = w
                flops = 2 * k * k * (Cout if dense else 1) * Cin * B * H * W
                p = k // 2
                pads = ((p, p), (p, p))
                x = torch.randn((B, H, W, Cin), generator=g, device=dev)
                xw = torch.cat([x[:, :, W - p:], x, x[:, :, :p]], dim=2).permute(0, 3, 1, 2)

                def run(fn=fwd, wk=wk):
                    return fn(x, wk, pads, True)

                def plain(fn=plain_fn):
                    return fn(x, w, pads, True)

                f32_before = dc.dense_conv_forward.f32_launches
                out, ref = run(), plain()
                torch.cuda.synchronize()
                f32_launched = dc.dense_conv_forward.f32_launches - f32_before
                nbytes = (x.numel() + w.numel() + B * H * W * Cout) * 4
                rec = {"phase": "conv_scoring", "kernel": kname, "case": case,
                       "kind": "scoring", "dtype": "float32", "B": B, "k": k,
                       "circular": True,
                       **compare(out, ref, kernel_tolerance(kname, "float32", ref)),
                       "finite": bool(torch.isfinite(out).all()),
                       **(f32_split_bound(flops, nbytes, peaks) if dense
                          else bound(flops, nbytes, peak_f32, bw)),
                       "f32_kernel_launches": f32_launched,
                       "ms": time_ms(run, **tkw), "plain_ms": time_ms(plain, **tkw),
                       # the wrap columns concatenated outside the timed call
                       "library_ms": time_ms(lambda: F.conv2d(
                           xw, w_oihw, padding=(p, 0), groups=groups), **tkw),
                       "library_tf32": torch.backends.cudnn.allow_tf32}
                if dense:
                    rec["pack_ms"] = time_ms(lambda: dc.pack_dense_weight(w), **tkw)
                rec.update(rates(flops, rec))
                emit(rec)
                results[kname].append(rec)
                if not (rec["ok"] and rec["finite"]
                        and rec["f32_kernel_launches"] == int(dense)):
                    raise AssertionError(f"{kname} at the scorer's shape: {rec}")
                del x, xw, w, wk, w_oihw, out, ref
    torch.cuda.empty_cache()
    return results


# K6's cases: name, (B, Sq, Sk, H, D), timed. The untimed ones check a
# shape class each: ragged tails, Sq != Sk (both ragged), the widest head
# (both consumer warpgroups on one 64-row tile, half of O's columns each),
# and a head size whose rows TMA cannot load as they are (bf16 D = 36: the
# split pass pads it to 64 columns first).
K6_CASES = (("s2250", (2, 2250, 2250, 12, 128), True),
            ("s450", (2, 450, 450, 12, 128), True),
            ("ragged_130", (1, 130, 130, 3, 64), False),
            ("sq75_sk150", (1, 75, 150, 3, 64), False),
            ("d256", (1, 130, 130, 2, 256), False),
            ("d36", (1, 130, 130, 1, 36), False))


def flash_plain_bound(B, Sq, Sk, H, D, dtype_name, peaks):
    """K6's least time on the card for its contract's work: passes of 2 B H
    Sq Sk D flop on the tensor cores at the peak of the pass's operand type
    (bf16 inputs: 4 bf16 passes, Q.K^T and one P.V per bf16 term of P; fp32
    inputs: 6 TF32 passes, as many flop as 12 bf16 ones), against the bytes
    of q, k, v and o. {"bound_passes", "flops", "bound_ms", "bound_by"}."""
    peak_bf16, _, bw, peak_tf32 = peaks
    bf16 = dtype_name == "bfloat16"
    passes = 4 if bf16 else 6
    flops = passes * 2 * B * H * Sq * Sk * D
    nbytes = 2 * (Sq + Sk) * B * H * D * (2 if bf16 else 4)
    return {"bound_passes": passes, "flops": flops,
            **bound(flops, nbytes, peak_bf16 if bf16 else peak_tf32, bw)}


def flash_plain_phase(peaks):
    """K6 against its plain version at every case of ``K6_CASES``, bf16 and
    fp32. The timed cases also time two yardsticks: SDPA on fp32 copies of
    the inputs (``library_ms``, the PyTorch call that computes K6's function;
    its relative L2 to the plain version beside it) and, for bf16 inputs,
    SDPA on the inputs as they are (``library_bf16p_ms``, a cheaper function:
    it rounds P to bf16). Then K6 once through ``dot_product_attention``,
    the entry a caller uses."""
    import torch
    import torch.nn.functional as F

    from ladcast_torch.ops import attention, flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(6)
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        for name, (B, Sq, Sk, H, D), timed in K6_CASES:
            q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(dtype)
            k, v = (torch.randn(B, Sk, H, D, generator=g, device=dev).to(dtype)
                    for _ in range(2))
            out = fa.flash_attention_forward(q, k, v)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v)
            bnd = flash_plain_bound(B, Sq, Sk, H, D, dname, peaks)
            rec = {"phase": "kernel", "kernel": "flash_attention", "case": name,
                   "dtype": dname, "B": B, "Sq": Sq, "Sk": Sk, "H": H, "D": D,
                   "planes": fa.split_planes(dtype, D),
                   **compare(out, ref, kernel_tolerance("flash_attention", dname, ref)),
                   "finite": bool(torch.isfinite(out).all()),
                   **{key: bnd[key] for key in ("bound_passes", "bound_ms", "bound_by")}}
            if timed:
                rec["ms"] = time_ms(lambda: fa.flash_attention_forward(q, k, v),
                                    rounds=10, inner=2)
                rec["plain_ms"] = time_ms(lambda: fa.flash_attention_plain(q, k, v),
                                          rounds=10, inner=1)
                qh, kh, vh = (t.float().transpose(1, 2).contiguous() for t in (q, k, v))
                lib = F.scaled_dot_product_attention(qh, kh, vh).transpose(1, 2)
                rec["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(qh, kh, vh),
                    rounds=10, inner=1)
                rec["library_op"] = "F.scaled_dot_product_attention on fp32 copies"
                rec["library_rel_l2"] = compare(lib.to(dtype), ref,
                                                kernel_tolerance("flash_attention",
                                                                 dname, ref))["rel_l2"]
                rec["library_bf16p_ms"] = None
                if dtype == torch.bfloat16:
                    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                    rec["library_bf16p_ms"] = time_ms(
                        lambda: F.scaled_dot_product_attention(qh, kh, vh),
                        rounds=10, inner=1)
                rec.update(tflops=bnd["flops"] / rec["ms"] / 1e9,
                           bound_share=rec["bound_ms"] / rec["ms"])
                del qh, kh, vh, lib
            emit(rec)
            recs.append(rec)
            if not (rec["ok"] and rec["finite"]):
                raise AssertionError(f"flash_attention {rec}")
    # its path: no model calls it, a caller reaches it through the op; the
    # composite it is compared with rounds P to bf16, so the check is the
    # general attention one
    fa.flash_attention_forward.launches = 0
    q, k, v = (torch.randn(2, 2250, 12, 128, generator=g, device=dev).bfloat16()
               for _ in range(3))
    out = attention.dot_product_attention(q, k, v)
    launches = fa.flash_attention_forward.launches
    ref = attention.dot_product_attention(q, k, v, impl="plain")
    rec = {"phase": "op_path", "op": "dot_product_attention", "launches": launches,
           **compare(out, ref, kernel_tolerance("dot_product_attention", "bfloat16",
                                                ref))}
    emit(rec)
    if launches != 1 or not rec["ok"]:
        raise AssertionError(f"dot_product_attention {rec}")
    return recs, launches


def _conv_launches():
    from ladcast_torch.ops import dense_conv as dc
    from ladcast_torch.ops import depthwise_conv as dw

    return {"dense_conv": dc.dense_conv_forward.launches,
            "depthwise_conv": dw.depthwise_same_conv_forward.launches}


def _reset_conv_launches():
    from ladcast_torch.ops import dense_conv as dc
    from ladcast_torch.ops import depthwise_conv as dw

    dc.dense_conv_forward.launches = 0
    dc.dense_conv_forward.f32_launches = 0
    dw.depthwise_same_conv_forward.launches = 0


def sphere_conv_counts(module):
    """{"dense_conv", "depthwise_conv"}: the sphere convs under ``module``,
    which is what one call of it launches of K4 and K5."""
    from ladcast_torch.models.dcae import SphereConv

    convs = [m for m in module.modules() if isinstance(m, SphereConv)]
    return {"dense_conv": sum(m.groups == 1 for m in convs),
            "depthwise_conv": sum(m.groups > 1 for m in convs)}


def dcae_parity_phase():
    """The shipped DCAE at B=2 under the two conv modes."""
    import torch

    from ladcast_torch.config import DCAEConfig
    from ladcast_torch.models.dcae import build_dcae
    from ladcast_torch.ops import dense_conv as dc
    from ladcast_torch.ops import sphere

    if sphere.CONV_MODE != "kernel":
        raise AssertionError(f"the default CONV_MODE is {sphere.CONV_MODE!r}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    fields = torch.randn(2, 120, 240, 84, generator=g, device=dev)
    static = torch.randn(120, 240, 5, generator=g, device=dev)
    z = torch.randn(2, 15, 30, 84, generator=g, device=dev)
    counts = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        dcae = build_dcae(DCAEConfig(), dev, dtype, seed=9)
        expected = {"encode": sphere_conv_counts(dcae.encoder),
                    "decode": sphere_conv_counts(dcae.decoder)}
        outs, launches, f32 = {}, {}, {}
        with torch.inference_mode():
            for mode in ("kernel", "library"):
                with conv_mode(mode):
                    for stage, fn in (
                            ("encode", lambda: dcae.encode(fields.to(dtype),
                                                           static.to(dtype))),
                            ("decode", lambda: dcae.decode(z.to(dtype)))):
                        _reset_conv_launches()
                        outs[mode, stage] = fn().float()
                        launches[mode, stage] = _conv_launches()
                        f32[mode, stage] = dc.dense_conv_forward.f32_launches
        torch.cuda.synchronize()
        rec = {"phase": "dcae_parity", "dtype": dname, "B": 2, "tol": DCAE_TOL[dname],
               "expected_launches": expected}
        if dtype == torch.bfloat16:
            # which mode is nearer the truth: both against an fp32 run (the
            # fp32 kernels) of the same rounded weights and inputs
            dcae = dcae.float()
            with torch.inference_mode():
                truth = {"encode": dcae.encode(fields.to(dtype).float(),
                                               static.to(dtype).float()),
                         "decode": dcae.decode(z.to(dtype).float())}
            rec["rel_l2_to_fp32"] = {
                stage: {mode: ((outs[mode, stage] - t).norm() / t.norm()).item()
                        for mode in ("kernel", "library")}
                for stage, t in truth.items()}
            del truth
        ok = True
        for stage in ("encode", "decode"):
            a, b = outs["kernel", stage], outs["library", stage]
            rec[stage] = {"rel_l2": ((a - b).norm() / b.norm()).item(),
                          "max_abs_err": (a - b).abs().max().item(),
                          "finite": bool(torch.isfinite(a).all()),
                          "launches": launches["kernel", stage],
                          # the dense convs' launches of the fp32 kernel
                          "f32_kernel_launches": f32["kernel", stage]}
            ok &= (rec[stage]["finite"] and rec[stage]["rel_l2"] <= DCAE_TOL[dname]
                   and launches["kernel", stage] == expected[stage]
                   and f32["kernel", stage] == (expected[stage]["dense_conv"]
                                                if dtype == torch.float32 else 0)
                   and not any(launches["library", stage].values()))
        emit(rec)
        if not ok:
            raise AssertionError(f"DCAE parity {dname}: {rec}")
        counts = expected
        del dcae, outs
        torch.cuda.empty_cache()
    return counts


def decode_seconds(dcae, frames, mode):
    """(wall seconds, result) of one decode of ``frames`` under ``mode``,
    after one warm-up decode (library handles, algorithm choices)."""
    import torch

    with conv_mode(mode), torch.inference_mode():
        dcae.decode(frames)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = dcae.decode(frames)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out


def decode_both_modes(dcae, frames, chunk):
    """The decode of ``frames``, ``chunk`` at a time, under both conv modes:
    ({mode: seconds}, relative L2 of the kernel result to the library one)."""
    import torch

    seconds, num, den = {"kernel": 0.0, "library": 0.0}, 0.0, 0.0
    for i in range(0, frames.shape[0], chunk):
        outs = {}
        for mode in seconds:
            s, outs[mode] = decode_seconds(dcae, frames[i:i + chunk], mode)
            seconds[mode] += s
        a, b = outs["kernel"].float(), outs["library"].float()
        if not torch.isfinite(a).all():
            raise AssertionError("decode under the kernels is not finite")
        num += (a - b).square().sum().item()
        den += b.square().sum().item()
        del outs, a, b
    return seconds, math.sqrt(num / den)


def bound(flops, nbytes, peak, bw):
    """{"bound_ms", "bound_by"}: the larger of the operations over the peak
    rate and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peak * 1e3, nbytes / bw * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def f32_split_bound(flops, nbytes, peaks):
    """The bound of an fp32 kernel whose products run on the tensor cores
    as six bf16 plane products each (the fp32 K1, K3 and K4): those passes
    at the bf16 peak (``bound_passes`` 6) against the bytes; beside it, the
    bound on the CUDA cores' fp32 peak that the FMA kernels they replaced
    were held to (``cuda_core_bound_ms``)."""
    return {"bound_passes": 6, **bound(6 * flops, nbytes, peaks[0], peaks[2]),
            "cuda_core_bound_ms": bound(flops, nbytes, peaks[1], peaks[2])["bound_ms"]}


def rates(flops, rec):
    """{"tflops", "bound_share"} of a timed record: its rate, and how much
    of its time the bound is."""
    return {"tflops": flops / rec["ms"] / 1e9, "bound_share": rec["bound_ms"] / rec["ms"]}


def sdpa_with_lse(qh, kh, vh):
    """(name, call) of the aten op of the backend that
    ``F.scaled_dot_product_attention`` picks for these (B, H, S, D) inputs,
    called so that it also returns the rows' logsumexp. A yardstick only:
    the port never calls it."""
    import torch
    from torch.nn.attention import SDPBackend

    aten = torch.ops.aten
    choice = torch._fused_sdp_choice(qh, kh, vh)
    if choice == SDPBackend.FLASH_ATTENTION.value:  # always returns it
        return ("aten._scaled_dot_product_flash_attention",
                lambda: aten._scaled_dot_product_flash_attention(qh, kh, vh))
    if choice == SDPBackend.CUDNN_ATTENTION.value:
        return ("aten._scaled_dot_product_cudnn_attention",
                lambda: aten._scaled_dot_product_cudnn_attention(qh, kh, vh, None, True))
    if choice == SDPBackend.EFFICIENT_ATTENTION.value:
        return ("aten._scaled_dot_product_efficient_attention",
                lambda: aten._scaled_dot_product_efficient_attention(qh, kh, vh, None, True))
    raise AssertionError(f"SDPA picks backend {choice} for the attention yardstick")


def backward_kernel_phase(peaks, dtypes=("bfloat16", "float32"), only=None):
    """K1's lse variant and K3 (dq, dk/dv) against their plain versions
    at the training shapes, in ``dtypes``, at every case or those named in
    ``only``."""
    import torch
    import torch.nn.functional as F

    from ladcast_torch.config import ladcast_1p6b_config, ladcast_375m_config
    from ladcast_torch.models.ladcast_dit import (
        LaDCastTransformer3D,
        segment_tables,
    )
    from ladcast_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    peak_bf16, _, bw, _ = peaks
    cfg = ladcast_375m_config()
    H, D = cfg.num_attention_heads, cfg.attention_head_dim
    H_1P6B = ladcast_1p6b_config().num_attention_heads
    scale = 1.0 / D ** 0.5
    with torch.device("meta"):
        tables_of = LaDCastTransformer3D(cfg)
    rope = tables_of._rope_tables(4, 15, 30, False, dev)
    cond_rope = tables_of._rope_tables(1, 15, 30, True, dev)
    g = torch.Generator(device=dev).manual_seed(2)
    w_a = 1 + 0.1 * torch.randn(D, generator=g, device=dev)
    w_b = 1 + 0.1 * torch.randn(D, generator=g, device=dev)
    cases = [  # name, B, heads, table segments, timed
        ("dual_2250", 4, H, [(1800, rope, w_a), (450, None, w_b)], True),
        ("single_2250", 4, H, [(1800, rope, w_a), (450, cond_rope, w_a)], False),
        ("refiner_450", 4, H, [(450, cond_rope, w_a)], True),
        ("ragged_130", 2, H, [(110, rope, w_a), (20, None, w_b)], False),
        # the 1.6B's 16 heads, its training batch and tokens
        ("dual_2250_h16", 4, H_1P6B, [(1800, rope, w_a), (450, None, w_b)], True),
    ]
    results = {"fused_attention_lse": [], "flash_bwd_dq": [], "flash_bwd_dkv": [],
               "flash_bwd_pair": []}
    for dtype in (getattr(torch, d) for d in dtypes):
        dname = str(dtype).split(".")[-1]

        def bound_of(flops, nbytes):
            """fp32: the products as six bf16 plane products each."""
            if dtype == torch.float32:
                return {**f32_split_bound(flops, nbytes, peaks),
                        "library_tf32": torch.backends.cuda.matmul.allow_tf32}
            return bound(flops, nbytes, peak_bf16, bw)

        for name, B, H, segs, timed in (c for c in cases if only is None or c[0] in only):
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
                   **bound_of(4 * B * H * S * S * D,
                              4 * n * es + 3 * S * D * 4 + stats_bytes)}
            if timed:
                rec["ms"] = time_ms(lambda: fa.fused_attention(
                    q, kn, v, cos, sin, w, return_lse=True))
                rec["plain_ms"] = time_ms(lambda: fa.fused_attention_plain(
                    q, kn, v, cos, sin, w, return_lse=True), inner=1)
                # the yardstick: SDPA's own backend for these inputs, asked
                # for its logsumexp (the forward that its backward needs)
                qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (qn, kn, v))
                rec["library_op"], lib_call = sdpa_with_lse(qh, kh, vh)
                rec["library_ms"] = time_ms(lib_call, inner=1)
                if dtype == torch.float32:  # its output against the plain one
                    rec["library_rel_l2"] = compare(lib_call()[0].transpose(1, 2), ref,
                                                    rec["out"]["tol"])["rel_l2"]
                rec.update(rates(4 * B * H * S * S * D, rec))
                del qh, kh, vh, lib_call
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
            # no atomics: a second run gives the same bits
            again = (fa.flash_bwd_dq(*bwd_args), *fa.flash_bwd_dkv(*bwd_args))
            torch.cuda.synchronize()
            repeats = {"dq": torch.equal(dq, again[0]), "dk": torch.equal(dk, again[1]),
                       "dv": torch.equal(dv, again[2])}
            del again
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
                        **bound_of(14 * B * H * S * S * D, 7 * n * es + 2 * stats_bytes)}
                # fp32: does the yardstick keep fp32 products? Its gradients
                # against the plain backward's
                lib_grads = dict(zip(("dq", "dk", "dv"), (
                    x.transpose(1, 2) for x in torch.autograd.grad(
                        oh, (qh, kh, vh), gh, retain_graph=True))))
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
                           "same_bits_twice": repeats[oname],
                           **bound_of(n_ops * B * H * S * S * D,
                                      n_io * n * es + 2 * stats_bytes),
                           **timing}
                    if timed:
                        rec.update(rates(n_ops * B * H * S * S * D, rec))
                        if dtype == torch.float32:
                            rec["library_rel_l2"] = compare(lib_grads[oname], refs[oname],
                                                            rec["tol"])["rel_l2"]
                    emit(rec)
                    results[kname].append(rec)
                    if not (rec["ok"] and rec["finite"] and rec["same_bits_twice"]):
                        raise AssertionError(f"{kname} {oname} {name} {dname}: {rec}")
            if timed:
                emit(pair)
                results["flash_bwd_pair"].append(pair)
                del qh, kh, vh, oh, gh, lib, lib_grads
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


def synthetic_latents(tmp):
    """A seeded ``.npz`` of 64 latent frames (15 x 30 x 84) 6 h apart, the
    training phases' data; returns its path."""
    import numpy as np

    from ladcast_torch.data.time_utils import add_hours_int

    rng = np.random.RandomState(0)
    latents = os.path.join(tmp, "latents.npz")
    np.savez(latents, latents=rng.randn(64, 15, 30, 84).astype(np.float32),
             timestamps=np.asarray([add_hours_int(2018010100, i) for i in range(64)]))
    return latents


def training_phase(tmp, latents, profile=False):
    """12 steps of ``cli.train_ar.run`` per backward mode on the synthetic
    latents; the checkpoint of the kernel run restores. With ``profile``,
    4 more steps of the kernel run's trainer run under the profiler."""
    import torch

    from ladcast_torch.cli import train_ar
    from ladcast_torch.ops import flash_attention as fa
    from ladcast_torch.train import checkpoint as ckpt

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


def training_f32_phase(tmp, latents):
    """TRAIN_STEPS_F32 steps of ``cli.train_ar.run`` with the training
    phase's yaml and latents under ``--compute_dtype float32`` (the kernel
    backward): every attention of a step on the fp32 K1-lse and K3, 7
    launches of each a step. ms per step (median after 2), peak memory,
    losses, launches; no checkpoint is written."""
    import torch

    from ladcast_torch.cli import train_ar
    from ladcast_torch.ops import flash_attention as fa

    args = train_ar.build_parser().parse_args(
        ["--latents", latents, "--num_steps", str(TRAIN_STEPS_F32), "--output_dir",
         os.path.join(tmp, "f32"), "--log_every", "1", "--seed", "0",
         "--compute_dtype", "float32", "--skip_state_ckpt"])
    _reset_launches(fa)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_ar.run(LADCAST_375M_YAML, args)
    wall_s = time.perf_counter() - t0
    launches = _launches(fa)
    hist = res["history"]
    step_ms = [r["step_s"] * 1e3 for r in hist]
    rec = {"phase": "training_f32", "steps": len(hist), "batch": 4,
           "compute_dtype": "float32", "bwd_mode": fa.BWD_MODE,
           "median_step_ms": statistics.median(step_ms[2:]), "step_ms": step_ms,
           "loss": [r["loss"] for r in hist], "grad_norm": [r["grad_norm"] for r in hist],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "run_wall_s": wall_s, "launches": launches,
           "launches_per_step": {k: n / max(len(hist), 1) for k, n in launches.items()}}
    emit(rec)
    del res, hist
    torch.cuda.empty_cache()
    expected = {k: 7 * TRAIN_STEPS_F32 for k in launches}
    finite = all(math.isfinite(x) for x in rec["loss"] + rec["grad_norm"])
    if rec["steps"] != TRAIN_STEPS_F32 or not finite or launches != expected:
        raise AssertionError(f"fp32 training: {rec}, expected launches {expected}")
    return rec


def fp32_ab(parent, order=("parent", "change", "change", "parent")):
    """The fp32 K1 (B=20) and K1-lse and K3 (B=4) at dual_2250 and the fp32
    training step, on the checkout at ``parent`` and on this one in turns,
    each run in a process of its own (the two trees' packages share a name,
    and each builds its own kernels): every record of a run again, with its
    ``tree``."""
    for tree in order:
        root = Path(parent).resolve() if tree == "parent" else ROOT
        r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--fp32-only",
                            str(root)], capture_output=True, text=True, timeout=1500)
        for line in r.stdout.splitlines():
            if line.startswith("{"):
                emit({**json.loads(line), "tree": tree, "root": str(root)})
        if r.returncode != 0:
            raise AssertionError(f"the fp32 run on the {tree} tree failed:\n"
                                 f"{r.stderr[-4000:]}")


def fp32_only(peaks, card, root):
    """What :func:`fp32_ab` runs on one tree: the package at ``root``, on
    ``sys.path``. Another tree's kernels are held to the general fp32
    limits that tree's own checks held them to, not to F32_REL_L2."""
    import torch

    from ladcast_torch.ops import _build

    if Path(root).resolve() != ROOT:
        F32_REL_L2.clear()

    t0 = time.perf_counter()
    _build.build_all()
    emit({"phase": "environment", "nvidia_smi": card, "torch": torch.__version__,
          "build_s": time.perf_counter() - t0})
    kernel_phase(peaks, ("float32",), ("dual_2250",))
    backward_kernel_phase(peaks, ("float32",), ("dual_2250",))
    with tempfile.TemporaryDirectory() as tmp:
        training_f32_phase(tmp, synthetic_latents(tmp))


def dit_1p6b_phase(tmp, latents):
    """The 1.6B DiT (configs/ladcast_1p6b.yaml) at full width on seeded
    weights: its bf16 forward at the inference shape (B=20, 1800 + 450
    tokens) after a parity check against the plain composite at B=2, then
    ``cli.train_ar.run`` on the yaml: the shipped file must raise the mesh
    error of its parallel: section (8-rank model groups) in one process, and
    with the section dropped, as a one-card user must, TRAIN_STEPS_1P6B steps run
    through K1-lse and K3 at 16 heads, remat as the yaml sets it. The
    steps' 26 GB checkpoint is not written (``--skip_state_ckpt``; the 375M
    training phase checks the checkpoint path)."""
    import torch

    from ladcast_torch.cli import train_ar
    from ladcast_torch.config import ladcast_1p6b_config
    from ladcast_torch.models.ladcast_dit import LaDCastTransformer3D, build_dit
    from ladcast_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    cfg = ladcast_1p6b_config()
    g = torch.Generator(device=dev).manual_seed(4)

    def inputs(B):
        return (torch.randn(B, 4, 15, 30, 84, generator=g, device=dev).bfloat16(),
                torch.randn(B, generator=g, device=dev),
                torch.randn(B, 1, 15, 30, 84, generator=g, device=dev).bfloat16(),
                torch.rand(B, generator=g, device=dev))

    torch.cuda.reset_peak_memory_stats()
    model = build_dit(cfg, dev, torch.bfloat16, seed=13)
    with torch.device("meta"):
        plain = LaDCastTransformer3D(dataclasses.replace(cfg, attention_impl="plain"))
    plain.load_state_dict(model.state_dict(), strict=True, assign=True)
    plain.eval()
    x2, x20 = inputs(2), inputs(20)
    with torch.inference_mode():
        a, p = model(*x2).float(), plain(*x2).float()
        rel = ((a - p).norm() / p.norm()).item()
        _reset_launches(fa)
        out = model(*x20)
        torch.cuda.synchronize()
        fwd_launches = _launches(fa)
        finite = bool(torch.isfinite(out).all())
        fwd_ms = time_ms(lambda: model(*x20), rounds=5, inner=1, warmup=1)
    n_params = sum(t.numel() for t in model.parameters())
    fwd = {"B": 20, "tokens": [1800, 450], "ms": fwd_ms, "rel_l2_b2": rel,
           "tol": MODEL_TOL["bfloat16"], "finite": finite,
           "shape": list(out.shape), "launches": fwd_launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    del model, plain, a, p, out, x2, x20
    torch.cuda.empty_cache()
    n_attn = cfg.num_layers + cfg.num_single_layers + cfg.num_refiner_layers
    if not (finite and rel <= MODEL_TOL["bfloat16"]
            and fwd["shape"] == [20, 4, 15, 30, 84]
            and fwd_launches["fused_attention"] == fwd_launches["norm_rope"] == n_attn):
        raise AssertionError(f"1.6B forward: {fwd}")

    def args(steps, out):
        return train_ar.build_parser().parse_args(
            ["--latents", latents, "--num_steps", str(steps), "--output_dir",
             os.path.join(tmp, out), "--log_every", "1", "--seed", "0",
             "--skip_state_ckpt"])

    try:
        train_ar.run(LADCAST_1P6B_YAML, args(0, "1p6b_refused"))
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("train_ar.run took configs/ladcast_1p6b.yaml's "
                             "parallel: section in one process")
    if "does not divide 1 devices" not in refusal:
        raise AssertionError(f"1.6B parallel: section refused with {refusal!r}")
    one_card = {k: v for k, v in LADCAST_1P6B_YAML.items() if k != "parallel"}
    _reset_launches(fa)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_ar.run(one_card, args(TRAIN_STEPS_1P6B, "1p6b"))
    wall_s = time.perf_counter() - t0
    ckpt_dir = os.path.join(tmp, "1p6b", "ckpts")
    written = sorted(os.listdir(ckpt_dir)) if os.path.isdir(ckpt_dir) else []
    hist = res["history"]
    step_ms = [r["step_s"] * 1e3 for r in hist]
    launches = _launches(fa)
    # remat recomputes the dual- and single-stream blocks (not the refiner)
    # in the backward, the forward's K2 and K1-lse launches with them
    fwd_per_step = n_attn + cfg.num_layers + cfg.num_single_layers
    expected = {k: TRAIN_STEPS_1P6B * n for k, n in (
        ("norm_rope", fwd_per_step), ("fused_attention", fwd_per_step),
        ("fused_attention_lse", fwd_per_step), ("flash_bwd_dq", n_attn),
        ("flash_bwd_dkv", n_attn))}
    rec = {"phase": "dit_1p6b", "params": n_params, "heads": cfg.num_attention_heads,
           "layers": [cfg.num_layers, cfg.num_single_layers, cfg.num_refiner_layers],
           "forward": fwd, "refused_parallel_section": refusal,
           "training": {"steps": len(hist), "batch": 4, "compute_dtype": "bfloat16",
                        "remat": one_card["general"]["remat"], "parallel": "dropped",
                        "median_step_ms": statistics.median(step_ms[2:]),
                        "step_ms": step_ms, "loss": [r["loss"] for r in hist],
                        "grad_norm": [r["grad_norm"] for r in hist],
                        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
                        "run_wall_s": wall_s, "launches": launches,
                        "expected_launches": expected,
                        "skip_state_ckpt": True, "checkpoints_written": written}}
    emit(rec)
    del res, hist
    torch.cuda.empty_cache()
    finite = all(math.isfinite(x) for x in rec["training"]["loss"]
                 + rec["training"]["grad_norm"])
    if (rec["training"]["steps"] != TRAIN_STEPS_1P6B or not finite
            or launches != expected or written):
        raise AssertionError(f"1.6B training: {rec}")
    return rec


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
    _reset_conv_launches()
    torch.cuda.reset_peak_memory_stats()
    stats = {}
    t0 = time.perf_counter()
    acc, mean = bench["full_forecast"](4, stats)
    total_s = time.perf_counter() - t0
    launches = {"norm_rope": fa.norm_rope.launches,
                "fused_attention": fa.fused_attention.launches,
                **_conv_launches()}
    n_attn = 7 * (2 * rcfg.num_inference_steps - 1) * rcfg.num_repetitions
    enc = sphere_conv_counts(bench["dcae"].encoder)
    dec = sphere_conv_counts(bench["dcae"].decoder)
    expected = {"norm_rope": n_attn, "fused_attention": n_attn,
                **{k: enc[k] + rcfg.num_repetitions * dec[k] for k in enc}}
    # the decode of one repetition's 80 frames under both conv modes
    frames = torch.randn(80, 15, 30, 84, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1)
                         ).to(torch.bfloat16)
    decode_s, decode_rel_l2 = decode_both_modes(bench["dcae"], frames, 80)
    emit({"phase": "main_path", "repetitions": rcfg.num_repetitions,
          "members": rcfg.ensemble_size, "setup_s": setup_s,
          "encode_s": stats["encode_s"][0],
          "repetition_s": stats["repetition_s"], "decode_s": stats["decode_s"],
          "decode_80_frames_s": decode_s,
          "decode_80_frames_rel_l2": decode_rel_l2, "tol": DCAE_TOL["bfloat16"],
          "forecast_s": total_s, "acc": acc, "mean": mean,
          "traj_shape": stats["traj_shape"], "decode_shape": stats["decode_shape"],
          "launches": launches, "expected_launches": expected,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})
    if stats["traj_shape"] != (20, 4 * reps, 15, 30, 84):
        raise AssertionError(f"trajectory shape {stats['traj_shape']}")
    if stats["decode_shape"] != (80, 120, 240, 84):
        raise AssertionError(f"decode shape {stats['decode_shape']}")
    if launches != expected:
        raise AssertionError(f"launches {launches}, expected {expected}")
    if not decode_rel_l2 <= DCAE_TOL["bfloat16"]:
        raise AssertionError(f"decode of 80 frames, kernel against library: "
                             f"relative L2 {decode_rel_l2}")
    return launches, bench


def forecast_phase(tmp):
    """``cli.pred_rollout`` at full width from hub directories the port
    writes: the Heun sampler with decode, then the DPM sampler."""
    import numpy as np
    import torch

    from ladcast_torch import static_data
    from ladcast_torch.cli import pred_rollout
    from ladcast_torch.config import DCAEConfig, ladcast_375m_config
    from ladcast_torch.models import hub
    from ladcast_torch.models.dcae import build_dcae
    from ladcast_torch.models.ladcast_dit import build_dit
    from ladcast_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    dit_dir, dcae_dir = os.path.join(tmp, "dit"), os.path.join(tmp, "dcae")
    t0 = time.perf_counter()
    dit = build_dit(ladcast_375m_config(), dev, torch.float32, seed=21)
    hub.save_pretrained(dit_dir, "dit", ladcast_375m_config(), dit.state_dict(),
                        max_shard_bytes=512 * 2**20)
    n_dit = sum(p.numel() for p in dit.parameters())
    del dit
    dcae = build_dcae(DCAEConfig(), dev, torch.float32, seed=22)
    hub.save_pretrained(dcae_dir, "dcae", DCAEConfig(), dcae.state_dict())
    n_dcae = sum(p.numel() for p in dcae.parameters())
    dcae = dcae.to(torch.bfloat16)  # the pipeline's cast of the same weights
    fm, fs = static_data.era5_mean_std()
    rng = np.random.RandomState(23)
    raw = (rng.randn(3, 120, 240, 84) * fs + fm).astype(np.float32)
    raw[:, :40, :40, 82] = np.nan  # SST over land
    stamps = [2018010100, 2018010106, 2018010112]
    data = os.path.join(tmp, "era5.npz")
    np.savez(data, fields=raw, timestamps=np.asarray(stamps, np.int64))
    shards = sorted(f for f in os.listdir(dit_dir) if f.endswith(".safetensors"))
    emit({"phase": "forecast_setup", "write_s": time.perf_counter() - t0,
          "dit_parameters": n_dit, "dcae_parameters": n_dcae, "dit_files": shards,
          "dcae_files": sorted(os.listdir(dcae_dir))})
    if len(shards) < 2 or not os.path.isfile(os.path.join(dit_dir, hub.INDEX_NAME)):
        raise AssertionError(f"the DiT was not written index-sharded: {shards}")

    # what the encoder gives for these fields: the t=0 frame of every file
    norm = (raw - fm) / fs
    norm = torch.from_numpy(np.where(np.isnan(norm), -2.0, norm).astype(np.float32))
    static = torch.from_numpy(static_data.static_conditioning_tensor("HWC")).to(dev)
    with torch.inference_mode():
        z_ref = dcae.encode(norm.to(dev, torch.bfloat16),
                            static.to(torch.bfloat16)).float().cpu().numpy()
    enc = sphere_conv_counts(dcae.encoder)
    dec = sphere_conv_counts(dcae.decoder)

    results = {}
    runs = (("edm", ["--end_date", "2018-01-01", "--decode"], 1, 7 * 39),
            ("dpm", ["--end_date", "2018-01-01T12"], 2, 7 * 20))
    for sampler, extra, n_init, n_attn in runs:
        out = os.path.join(tmp, f"out_{sampler}")
        argv = ["--data", data, "--dit_params", dit_dir, "--dcae_params", dcae_dir,
                "--output_dir", out, "--start_date", "2018-01-01",
                "--num_samples_per_month", "1", "--ensemble_size", "20",
                "--num_inference_steps", "20", "--total_lead_time_hour", "24",
                "--sampler", sampler, "--seed", "3", *extra]
        args = pred_rollout.build_parser().parse_args(argv)
        _reset_launches(fa)
        _reset_conv_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        recs = pred_rollout.run(args)
        wall_s = time.perf_counter() - t0
        launches = {"norm_rope": fa.norm_rope.launches,
                    "fused_attention": fa.fused_attention.launches,
                    **_conv_launches()}
        decoded = "--decode" in extra
        # per init time: 7 attentions per DiT call; every sphere conv of the
        # encoder once, of the decoder once per chunk of 40 of the 80 frames
        expected = {"norm_rope": n_attn * n_init, "fused_attention": n_attn * n_init,
                    **{k: n_init * (enc[k] + (2 * dec[k] if decoded else 0))
                       for k in enc}}
        inits = [r for r in recs if "rollout_s" in r]
        rec = {"phase": "forecast", "sampler": sampler, "decode": decoded,
               "members": 20, "steps": 20, "init_times": [r["init_time"] for r in inits],
               "load_s": recs[0]["load_s"],
               "encode_s": [r["encode_s"] for r in inits],
               "rollout_s": [r["rollout_s"] for r in inits],
               "decode_s": [r["decode_s"] for r in inits],
               "per_init_s": [r["seconds"] for r in inits], "run_wall_s": wall_s,
               "launches": launches, "expected_launches": expected,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
        ok = len(inits) == n_init and launches == expected
        checks = []
        for r in inits:
            ts = r["init_time"]
            arr = np.load(os.path.join(out, f"latent_{ts}.npy"))
            z0 = z_ref[stamps.index(ts)]
            t0_frames = np.moveaxis(arr[:, :, 0], 1, -1)  # (E, h, w, C)
            chk = {"init_time": ts, "shape": list(arr.shape),
                   "finite": bool(np.isfinite(arr).all()),
                   "t0_max_abs_err": float(np.abs(t0_frames - z0).max()),
                   "t0_absmax": float(np.abs(z0).max()),
                   "member_spread": float(arr[:, :, 1:].std(axis=0).mean())}
            ok &= (chk["shape"] == [20, 84, 5, 15, 30] and chk["finite"]
                   and chk["t0_max_abs_err"] <= 1e-3 * chk["t0_absmax"]
                   and chk["member_spread"] > 0)
            if decoded:
                with np.load(os.path.join(out, f"fields_{ts}.npz")) as bundle:
                    f = bundle["fields"]
                    meta = json.loads(str(bundle["meta"]))
                chk.update(fields_shape=list(f.shape),
                           fields_finite=bool(np.isfinite(f).all()),
                           lead_hours=meta["prediction_timedelta_hours"])
                ok &= (chk["fields_shape"] == [20, 4, 120, 240, 84]
                       and chk["fields_finite"]
                       and chk["lead_hours"] == [6, 12, 18, 24])
                del f
            checks.append(chk)
        rec["files"] = checks
        if decoded:
            # the same decode (80 frames in chunks of 40) under both modes
            lat = torch.from_numpy(np.moveaxis(arr[:, :, 1:], 1, -1).copy())
            frames = lat.reshape(80, 15, 30, 84).to(dev, torch.bfloat16)
            rec["decode_80_frames_s"], rec["decode_80_frames_rel_l2"] = (
                decode_both_modes(dcae, frames, 40))
            rec["tol"] = DCAE_TOL["bfloat16"]
            ok &= rec["decode_80_frames_rel_l2"] <= DCAE_TOL["bfloat16"]
        emit(rec)
        results[sampler] = rec
        if not ok:
            raise AssertionError(f"forecast, {sampler}: {rec}")
        rec["out_dir"] = out  # the chain phase scores and tracks these files
        rec["argv"] = argv  # the int8 phase repeats the Heun run
    return results


def raw_fields(path, stamps, seed):
    """A seeded ``.npz`` of raw (physical) fields (len(stamps), 120, 240,
    84) at the ERA5 statistics' scale, SST NaN over the land of the static
    land-sea mask (south-pole row cropped), as ERA5 has it."""
    import numpy as np

    from ladcast_torch import static_data

    fm, fs = static_data.era5_mean_std()
    raw = (np.random.RandomState(seed).randn(len(stamps), 120, 240, 84) * fs
           + fm).astype(np.float32)
    lsm = np.load(ROOT / "ladcast_torch" / "static" / "240x121_land_sea_mask.npy")[1:]
    raw[:, lsm >= 0.5, 82] = np.nan
    np.savez(path, fields=raw, timestamps=np.asarray(stamps, np.int64))


def check_launches(name, got, expected):
    if got != expected:
        raise AssertionError(f"{name}: launches {got}, expected {expected}")


def dcae_grad_parity(model, fields, nan_mask, statics):
    """The DCAE training loss's gradients (a per-sample roll injected) with
    the sphere convs on the kernels against cuDNN, fp32 and bf16 compute:
    relative L2 over all parameters within DCAE_TOL."""
    import torch

    from ladcast_torch.config import DCAEConfig, config_from_dict
    from ladcast_torch.train.optim import make_optimizer
    from ladcast_torch.train.trainer_dcae import DCAETrainConfig, make_dcae_train_step

    cfg = config_from_dict(DCAEConfig, DCAE_84_YAML["encdec"])
    params = list(model.parameters())
    roll = [[37, 11], [200, 93]]  # (x, y) per sample
    for dname in ("float32", "bfloat16"):
        _, step, _ = make_dcae_train_step(cfg, DCAETrainConfig(compute_dtype=dname),
                                          make_optimizer(), fields.device)
        losses, grads = {}, {}
        for mode in ("kernel", "library"):
            with conv_mode(mode):
                _reset_conv_launches()
                loss, _ = step.loss_given_roll(model, fields, nan_mask, statics, roll)
                grads[mode] = torch.autograd.grad(loss, params)
                losses[mode] = loss.item()
                if mode == "kernel":
                    launches = _conv_launches()
        num = sum((a - b).float().square().sum() for a, b in zip(*grads.values()))
        den = sum(b.float().square().sum() for b in grads["library"])
        per = [((a - b).norm() / b.norm().clamp_min(1e-30)).item()
               for a, b in zip(*grads.values())]
        rec = {"phase": "dcae_grad_parity", "dtype": dname, "B": fields.shape[0],
               "loss": losses, "rel_l2": (num / den).sqrt().item(),
               "max_param_rel_l2": max(per), "tol": DCAE_TOL[dname],
               "finite": all(bool(torch.isfinite(g).all()) for g in grads["kernel"]),
               "kernel_launches": launches}
        emit(rec)
        if not (rec["finite"] and rec["rel_l2"] <= DCAE_TOL[dname]):
            raise AssertionError(f"DCAE gradients, kernel against library: {rec}")
        del grads
        torch.cuda.empty_cache()


def chain_phase(tmp, forecast, device="cuda"):
    """The rest of the user's chain at full width, through the CLIs' run
    functions on the shipped configs: train the DCAE (configs/dcae_84.yaml,
    CHAIN_DCAE_STEPS steps with a validation at the end), its gradients on
    the kernels against cuDNN, a decoder finetune
    (configs/dcae_84_ft_decoder.yaml) from the best weights, encode latents
    with them, compute stats and a climatology, score the forecast phase's
    latent files (fp32 decode) against truth with that climatology, compare
    with the paper's baseline, track cyclones through the decoded
    forecast, and train the 375M with validation rollouts. Every CLI runs on
    ``device``."""
    import numpy as np
    import torch

    from ladcast_torch import static_data
    from ladcast_torch.cli import (
        compare_baseline,
        compute_climatology,
        compute_stats,
        encode_latents,
        evaluate_ens,
        track,
        train_ar,
        train_dcae,
    )
    from ladcast_torch.cli.pred_rollout import _load_any_params
    from ladcast_torch.config import DCAEConfig, config_from_dict
    from ladcast_torch.data.time_utils import add_hours_int
    from ladcast_torch.models.dcae import SphereConv
    from ladcast_torch.ops import dense_conv as dc
    from ladcast_torch.ops import flash_attention as fa
    from ladcast_torch.ops.dense_conv import pack_dense_weight

    summary = {}
    t0 = time.perf_counter()
    data = {k: os.path.join(tmp, f"chain_{k}.npz") for k in ("train", "val", "clim")}
    raw_fields(data["train"], [add_hours_int(2018010100, 6 * i) for i in range(12)], 31)
    raw_fields(data["val"], [add_hours_int(2018020100, 6 * i) for i in range(4)], 32)
    # a climatology from another year's frames at the same days and hours
    raw_fields(data["clim"], [add_hours_int(2017010100, 6 * i) for i in range(12)], 33)
    emit({"phase": "chain_setup", "write_s": time.perf_counter() - t0,
          "frames": {"train": 12, "val": 4, "clim": 12}})

    # 1. DCAE training, then its gradients on the kernels against cuDNN
    run_dir = os.path.join(tmp, "dcae_run")
    args = train_dcae.build_parser().parse_args(
        ["--data", data["train"], "--val_data", data["val"], "--val_every",
         str(CHAIN_DCAE_STEPS), "--num_steps", str(CHAIN_DCAE_STEPS),
         "--output_dir", run_dir, "--log_every", "1", "--seed", "0",
         "--device", device])
    _reset_conv_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = train_dcae.run(DCAE_84_YAML, args)
    wall_s = time.perf_counter() - t0
    launches = _conv_launches()
    state, hist = res["state"], res["history"]
    enc_convs = sphere_conv_counts(state.model.encoder)
    dec_convs = sphere_conv_counts(state.model.decoder)
    per_fwd = {k: enc_convs[k] + dec_convs[k] for k in enc_convs}
    # every step and the one validation batch run the model forward once
    forwards = CHAIN_DCAE_STEPS + len(res["validations"])
    check_launches("train_dcae", launches, {k: forwards * v for k, v in per_fwd.items()})
    dense = [m.weight.detach().to(torch.bfloat16) for m in state.model.modules()
             if isinstance(m, SphereConv) and m.groups == 1]
    # in grad mode each forward lays out and packs every dense weight
    pack_ms = time_ms(lambda: [pack_dense_weight(w.permute(2, 3, 1, 0).contiguous())
                               for w in dense], rounds=5, inner=1)
    step_ms = [h["step_s"] * 1e3 for h in hist]
    rec = {"phase": "chain_train_dcae", "steps": len(hist), "batch": 4,
           "subbatch_steps": 3, "compute_dtype": "bfloat16",
           "parameters": sum(p.numel() for p in state.model.parameters()),
           "median_step_ms": statistics.median(step_ms[2:]), "step_ms": step_ms,
           "loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
           "val_loss": [v["val_loss"] for v in res["validations"]],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "run_wall_s": wall_s, "launches": launches, "forwards": forwards,
           "launches_per_step": {k: v // forwards for k, v in launches.items()},
           "pack_ms_per_step": pack_ms}
    rec["pack_share_of_step"] = pack_ms / rec["median_step_ms"]
    emit(rec)
    if (len(hist) != CHAIN_DCAE_STEPS or len(res["validations"]) != 1
            or not all(math.isfinite(x) for x in rec["loss"] + rec["grad_norm"]
                       + rec["val_loss"])):
        raise AssertionError(f"train_dcae: {rec}")
    summary["train_dcae"] = rec
    fm, fs = static_data.era5_mean_std()
    with np.load(data["train"]) as d:
        x = (d["fields"][:2] - fm) / fs
    nan_mask = torch.from_numpy(np.isnan(x[..., 82])).to(device)
    fields = torch.from_numpy(np.where(np.isnan(x), -2.0, x).astype(np.float32)).to(device)
    statics = torch.from_numpy(static_data.static_conditioning_tensor("HWC")).to(device)
    dcae_grad_parity(state.model, fields, nan_mask, statics)
    del res, state, dense, fields, nan_mask
    shutil.rmtree(os.path.join(run_dir, "ckpts"))  # the 4 GB training state
    torch.cuda.empty_cache()

    best_dir = os.path.join(run_dir, "best", f"step-{CHAIN_DCAE_STEPS}")
    loaded, _ = _load_any_params(best_dir, "dcae", None)
    ft_dir = os.path.join(tmp, "dcae_ft")
    ft = train_dcae.run(DCAE_84_FT_YAML, train_dcae.build_parser().parse_args(
        ["--data", data["train"], "--init_weights", best_dir, "--num_steps",
         str(CHAIN_FT_STEPS), "--output_dir", ft_dir, "--log_every", "1", "--seed", "1",
         "--device", device]))
    moved = {"encoder": 0, "decoder": 0}
    for n, p in ft["state"].model.named_parameters():
        moved[n.split(".")[0]] += not torch.equal(p.detach().cpu(), loaded[n])
    rec = {"phase": "chain_finetune", "steps": len(ft["history"]),
           "loss": [h["loss"] for h in ft["history"]],
           "step_ms": [h["step_s"] * 1e3 for h in ft["history"]],
           "parameters_moved": moved}
    emit(rec)
    if (rec["steps"] != CHAIN_FT_STEPS or moved["encoder"] or not moved["decoder"]
            or not all(math.isfinite(x) for x in rec["loss"])):
        raise AssertionError(f"decoder finetune: {rec}")
    del ft, loaded
    shutil.rmtree(ft_dir)
    torch.cuda.empty_cache()

    # 2. encode latents with the trained DCAE, stats and a climatology
    _reset_conv_launches()
    t0 = time.perf_counter()
    enc = encode_latents.run(encode_latents.build_parser().parse_args(
        ["--data", data["train"], "--dcae_params", best_dir, "--output",
         os.path.join(tmp, "chain_latents.npz"), "--device", device]))
    enc_wall = time.perf_counter() - t0
    check_launches("encode_latents", _conv_launches(), enc_convs)
    t0 = time.perf_counter()
    compute_stats.main(["--data", data["train"], "--output",
                        os.path.join(tmp, "stats.json"), "--start_year", "2018",
                        "--end_year", "2018"])
    stats_s = time.perf_counter() - t0
    rss_before = host_peak_rss_gb()
    t0 = time.perf_counter()
    clim = os.path.join(tmp, "clim.npz")
    compute_climatology.main(["--data", data["clim"], "--output", clim])
    clim_s = time.perf_counter() - t0
    with open(os.path.join(tmp, "stats.json")) as f:
        stats = json.load(f)
    rec = {"phase": "chain_data", "encode_s": enc["encode_s"], "encode_wall_s": enc_wall,
           "latents_shape": list(enc["latents"].shape),
           "latents_finite": bool(np.isfinite(enc["latents"]).all()),
           "stats_s": stats_s, "stats_vars": len(stats),
           "stats_finite": all(math.isfinite(v) for var in stats.values()
                               for k in ("mean", "std")
                               for v in (var[k].values() if isinstance(var[k], dict)
                                         else [var[k]])),
           "climatology_s": clim_s, "clim_npz_gb": os.path.getsize(clim) / 1e9,
           # the process's peak resident host memory before and after the
           # climatology's fp64 sums and float32 result
           "host_peak_rss_gb": {"before_climatology": rss_before,
                                "after_climatology": host_peak_rss_gb()}}
    emit(rec)
    cfg = config_from_dict(DCAEConfig, DCAE_84_YAML["encdec"])
    r = cfg.spatial_compression_ratio
    if not (rec["latents_shape"] == [12, 120 // r, 240 // r, cfg.latent_channels]
            and rec["latents_finite"]
            and rec["stats_finite"] and rec["stats_vars"] == 12):
        raise AssertionError(f"encode, stats, climatology: {rec}")
    summary["data"] = rec

    # 3. score the forecast phase's files (two init times) in fp32
    score_dir = os.path.join(tmp, "to_score")
    os.makedirs(score_dir)
    for sampler, ts in (("edm", 2018010100), ("dpm", 2018010112)):
        shutil.copy(os.path.join(forecast[sampler]["out_dir"], f"latent_{ts}.npy"),
                    score_dir)
    scores_dir = os.path.join(tmp, "scores")
    _reset_conv_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = evaluate_ens.run(evaluate_ens.build_parser().parse_args(
        ["--latent_dir", score_dir, "--truth", data["train"], "--climatology", clim,
         "--dcae_params", os.path.join(tmp, "dcae"), "--output_dir", scores_dir,
         "--diagnostics", "--device", device]))
    wall_s = time.perf_counter() - t0
    inits = [r for r in res["records"] if r.get("scored")]
    leads = 4
    expected = {k: len(inits) * leads * v for k, v in dec_convs.items()}
    launches = _conv_launches()
    # the fp32 decode's dense convs, every one on the fp32 kernel
    f32_launches = dc.dense_conv_forward.f32_launches
    arrays = {f: np.load(os.path.join(scores_dir, f))
              for f in sorted(os.listdir(scores_dir)) if f.endswith(".npy")
              and ".rank" not in f}
    verdict = compare_baseline.compare(scores_dir, step_size_hour=6)
    rec = {"phase": "chain_evaluate_ens", "init_times": [r["init_time"] for r in inits],
           "members": 20, "leads": leads, "dtype": "float32",
           "card": nvidia_smi_line() if device == "cuda" else None,
           "decode_s": [r["decode_s"] for r in inits],
           "score_s": [r["score_s"] for r in inits],
           "per_init_s": [r["seconds"] for r in inits], "run_wall_s": wall_s,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30,
           "host_peak_rss_gb": host_peak_rss_gb(), "tmp_dir_gb": dir_gb(tmp),
           "launches": launches, "expected_launches": expected,
           "f32_kernel_launches": f32_launches,
           "shapes": {k: list(v.shape) for k, v in arrays.items()},
           "finite": {k: bool(np.isfinite(v).all()) for k, v in arrays.items()},
           "summary_vars": len(res["summary"]),
           "compare_baseline": {k: verdict[k] for k in ("num_pass", "num_scored",
                                                         "all_pass")}}
    emit(rec)
    check_launches("evaluate_ens", launches, expected)
    check_launches("evaluate_ens, the fp32 dense kernel", f32_launches,
                   expected["dense_conv"] if device == "cuda" else 0)
    if (len(inits) != 2 or not all(rec["finite"].values())
            or rec["shapes"]["rank_hist.npy"] != [2, 84, leads, 21]
            or verdict["num_scored"] == 0):
        raise AssertionError(f"evaluate_ens: {rec}")
    summary["evaluate_ens"] = rec

    # 4. cyclone tracks through the decoded forecast
    t0 = time.perf_counter()
    tracks = track.run(track.build_parser().parse_args(
        ["--forecast", os.path.join(forecast["edm"]["out_dir"], "fields_2018010100.npz"),
         "--lat0", "15.0", "--lon0", "285.0", "--n_steps", "4", "--output_csv",
         os.path.join(tmp, "tracks.csv")]))
    rec = {"phase": "chain_track", "seconds": time.perf_counter() - t0,
           "members": len(tracks), "fixes": sorted({len(t) for t in tracks.values()})}
    emit(rec)
    if rec["members"] != 20 or rec["fixes"] != [5]:
        raise AssertionError(f"track: {rec}")

    # 5. the 375M trainer with validation rollouts every CHAIN_AR_VAL_EVERY
    latents = synthetic_latents(tmp)
    ar_dir = os.path.join(tmp, "ar_run")
    _reset_launches(fa)
    t0 = time.perf_counter()
    res = train_ar.run(LADCAST_375M_YAML, train_ar.build_parser().parse_args(
        ["--latents", latents, "--num_steps", str(CHAIN_AR_STEPS), "--output_dir", ar_dir,
         "--log_every", "1", "--seed", "0", "--val_every", str(CHAIN_AR_VAL_EVERY),
         "--val_latents", latents,
         "--val_num_init_times", str(CHAIN_VAL["init_times"]),
         "--val_ensemble_size", str(CHAIN_VAL["members"]),
         "--val_total_lead_time_hour", str(CHAIN_VAL["hours"]),
         "--val_num_inference_steps", str(CHAIN_VAL["steps"]), "--device", device]))
    wall_s = time.perf_counter() - t0
    launches = _launches(fa)
    n_val = CHAIN_AR_STEPS // CHAIN_AR_VAL_EVERY
    # per validation: init times x repetitions x Heun's 2n - 1 DiT calls x 7
    per_val = (CHAIN_VAL["init_times"] * (CHAIN_VAL["hours"] // 24)
               * (2 * CHAIN_VAL["steps"] - 1) * 7)
    n = 7 * CHAIN_AR_STEPS
    expected = {"norm_rope": n + n_val * per_val, "fused_attention": n + n_val * per_val,
                "fused_attention_lse": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    vals = res["validations"]
    rec = {"phase": "chain_train_ar", "steps": len(res["history"]),
           "loss": [h["loss"] for h in res["history"]],
           "validations": [{k: v[k] for k in ("step", "val_latent_rmse", "val_latent_crps")}
                           for v in vals],
           "validation_launches_each": {"norm_rope": per_val, "fused_attention": per_val},
           "launches": launches, "expected_launches": expected, "run_wall_s": wall_s}
    emit(rec)
    check_launches("train_ar with validation", launches, expected)
    if ([v["step"] for v in vals] != [CHAIN_AR_VAL_EVERY * (i + 1) for i in range(n_val)]
            or not all(math.isfinite(v["val_latent_rmse"]) and math.isfinite(
                v["val_latent_crps"]) for v in vals)
            or not all(math.isfinite(x) for x in rec["loss"])):
        raise AssertionError(f"train_ar with validation: {rec}")
    summary["train_ar"] = rec
    del res
    shutil.rmtree(ar_dir)
    torch.cuda.empty_cache()
    return summary


# The data-sources phase: DCAE training steps on the chain's frames read
# from monthly tars, AR training steps on the training phases' latents cut
# into shards; each against the same run on the .npz.
DATA_DCAE_STEPS = 2
DATA_AR_STEPS = 4
DATA_SHARDS = 3
# The int8 forecast: relative L2 of its latents (the forecast frames; the
# encoded t=0 is the bf16 run's) from the bf16 Heun run at the same seed,
# fixed before its first run on the card (PERF.md, section 6). A wrong
# scale, a transposed weight or a dropped bias reads about 1.
INT8_REL_L2 = 0.1
# (K, N) of the 375M's quantised projections: q/k/v and the attention
# outputs; the feed-forwards' and proj_mlp's up projections; their down
# projections; the single-stream proj_out over [attention; mlp]. M is the
# main path's tokens: 20 members x 2250.
INT8_GEMM_PAIRS = [(1536, 1536), (1536, 6144), (6144, 1536), (7680, 1536)]
INT8_GEMM_M = 20 * 2250
# Dense int8 tensor-core op/s (NVIDIA data sheets), matched on the card's
# name as PEAKS is; the H100 SXM is the default.
INT8_PEAKS = [("H100 PCIe", 1513e12), ("H100 NVL", 1671e12), ("H200", 1979e12),
              ("", 1979e12)]
# The dcae_temb phase's width: no shipped config sets temb_channels.
DCAE_TEMB_CHANNELS = 512


def host_cpu():
    """What the host says of its CPU: the first processor's model name,
    vendor, family, model and clock from /proc/cpuinfo (a virtual machine
    may report them as unknown), the machine's architecture and the
    instruction set PyTorch's CPU kernels use."""
    import platform

    import torch

    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, value = ln.partition(":")
                info.setdefault(key.strip().lower(), value.strip())
    except OSError:
        pass
    return {**{k: info.get(k) for k in ("model name", "vendor_id", "cpu family",
                                         "model", "cpu mhz")},
            "machine": platform.machine(),
            "torch_cpu_capability": torch.backends.cpu.get_cpu_capability()}


def same_bits(a, b):
    """Equal shapes, dtypes and bits (NaNs included)."""
    import numpy as np

    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def frames_per_s(read, n, rounds=3):
    """``n`` over the median seconds of ``read()``, host clock."""
    times = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        read()
        times.append(time.perf_counter() - t0)
    return n / statistics.median(times)


class RawArchiveSource:
    """The frames of field ``.npz`` bundles as raw monthly-tar members, filed
    under ``stamps``: a south-pole row in front and a surface-pressure
    channel behind, (121, 240, 85), which ``TarFieldSource`` crops and drops
    by default, giving back the bundles' frames."""

    def __init__(self, npz_paths, stamps):
        import numpy as np

        self.fields = np.concatenate([np.load(p)["fields"] for p in npz_paths])
        self.stamps = [int(t) for t in stamps]

    def frames_at(self, ts):
        import numpy as np

        f = self.fields[[self.stamps.index(int(t)) for t in ts]]
        f = np.concatenate([f[:, :1], f], axis=1)
        return np.concatenate([f, np.full(f.shape[:-1] + (1,), 101325.0, np.float32)],
                              axis=-1)


class _Warnings:
    """Collects the warnings logged under a logger while in a with block."""

    def __init__(self, name):
        import logging

        self.logger, self.messages = logging.getLogger(name), []
        self.handler = logging.Handler(logging.WARNING)
        self.handler.emit = lambda r: self.messages.append(r.getMessage())

    def __enter__(self):
        self.logger.addHandler(self.handler)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def data_sources_phase(tmp, dcae_yaml=DCAE_84_YAML, ar_yaml=LADCAST_375M_YAML,
                       device="cuda"):
    """The chain's raw frames written as monthly tars in the archive's
    layout and the training phases' latents cut into shards: the frames
    read back through the C++ reader and through tarfile against the
    ``.npz``; host read rates; ``train_dcae`` from the tar directory (its
    validation split from the same archive) and ``train_ar`` from the shard
    directory under ``--reader native`` and ``mmap``, each against the
    same run on the ``.npz``: losses, gradient norms and validation losses
    must be equal."""
    import numpy as np
    import torch

    from ladcast_torch.cli import train_ar, train_dcae
    from ladcast_torch.data import era5_tar, native_reader
    from ladcast_torch.data.latent_dataset import ShardedLatentSource
    from ladcast_torch.ops import flash_attention as fa

    train, val = (os.path.join(tmp, f"chain_{k}.npz") for k in ("train", "val"))
    with np.load(train) as d, np.load(val) as v:
        train_ts, val_ts = [int(t) for t in d["timestamps"]], [int(t) for t in v["timestamps"]]
        want = np.concatenate([d["fields"], v["fields"]])
    # The training frames are filed a year earlier, under 2017, so that the
    # archive's default splits (train 1979-2017, validation 2018) part them
    # from the validation frames as the two bundles do; the DCAE's training
    # reads no timestamp.
    stamps = [t - 10**6 for t in train_ts] + val_ts
    tar_dir = os.path.join(tmp, "era5_tars")
    t0 = time.perf_counter()
    era5_tar.write_tar_archive(RawArchiveSource([train, val], stamps), stamps, tar_dir)
    write_s = time.perf_counter() - t0
    tars = sorted(os.path.join(tar_dir, f) for f in os.listdir(tar_dir))
    t0 = time.perf_counter()
    native_reader.load_library()  # g++ at first use, apart from the index pass
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    members = native_reader.TarNpyMemberSource(tars)
    index_s = time.perf_counter() - t0
    member_shape = list(members.frame_shape)
    members.close()
    native = era5_tar.TarFieldSource(tar_dir, native=True)
    plain = era5_tar.TarFieldSource(tar_dir, native=False)
    rec = {"phase": "data_sources_frames", "frames": len(stamps),
           "archives": [os.path.basename(t) for t in tars],
           "member_shape": member_shape,
           "archive_mb": sum(os.path.getsize(t) for t in tars) / 1e6,
           "write_s": write_s, "reader_build_s": build_s, "index_s": index_s,
           "bit_equal": {"native": same_bits(native.frames_at(stamps), want),
                         "tarfile": same_bits(plain.frames_at(stamps), want)},
           "host_cpu": host_cpu(), "nproc": os.cpu_count(),
           "cpus_usable": len(os.sched_getaffinity(0)), "page_cache": "warm"}
    rec["tar_read_frames_per_s"] = {
        "native": frames_per_s(lambda: native.frames_at(stamps), len(stamps)),
        "tarfile": frames_per_s(lambda: plain.frames_at(stamps), len(stamps))}
    native.close()
    plain.close()

    # the training phases' latents, cut into shards
    latents = os.path.join(tmp, "latents.npz")
    if not os.path.exists(latents):
        latents = synthetic_latents(tmp)
    shard_dir = os.path.join(tmp, "latent_shards")
    os.makedirs(shard_dir)
    with np.load(latents) as d:
        lat, lat_ts = d["latents"], d["timestamps"]
    for i, part in enumerate(np.array_split(np.arange(len(lat)), DATA_SHARDS)):
        np.save(os.path.join(shard_dir, f"latents_{i:03d}.npy"), lat[part])
    np.save(os.path.join(shard_dir, "timestamps.npy"), lat_ts)
    order = np.random.RandomState(0).permutation(len(lat))
    lat_native = train_ar.load_latent_source(shard_dir, "native")
    lat_mmap = train_ar.load_latent_source(shard_dir, "mmap")
    if not (isinstance(lat_native, native_reader.NpyShardSource)
            and isinstance(lat_mmap, ShardedLatentSource)):
        raise AssertionError(f"readers: {type(lat_native)}, {type(lat_mmap)}")
    rec["latent_bit_equal"] = {"native": same_bits(lat_native.frames(order), lat[order]),
                               "mmap": same_bits(lat_mmap.frames(order), lat[order])}
    rec["latent_read_frames_per_s"] = {
        "native": frames_per_s(lambda: lat_native.frames(order), len(order)),
        "mmap": frames_per_s(lambda: lat_mmap.frames(order), len(order))}
    rec["latent_frame_kb"] = lat[0].nbytes / 1e3
    lat_native.close()
    emit(rec)
    if not (all(rec["bit_equal"].values()) and all(rec["latent_bit_equal"].values())
            and rec["member_shape"] == [85, 121, 240] and len(tars) == 2):
        raise AssertionError(f"data sources, frames: {rec}")

    def keep(res):
        return {"loss": [h["loss"] for h in res["history"]],
                "grad_norm": [h["grad_norm"] for h in res["history"]],
                "step_ms": [h["step_s"] * 1e3 for h in res["history"]],
                "val_loss": [v["val_loss"] for v in res["validations"]
                             if "val_loss" in v]}

    # train_dcae on the .npz bundles and on the tar directory; cuDNN's
    # deterministic algorithms in both, so that equal inputs give equal bits
    runs, launches = {}, {}
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, argv in (("npz", ["--data", train, "--val_data", val]),
                           ("tar", ["--data", tar_dir])):
            out = os.path.join(tmp, f"data_dcae_{name}")
            _reset_conv_launches()
            t0 = time.perf_counter()
            with _Warnings("ladcast_torch.data.era5_tar") as warned:
                res = train_dcae.run(dcae_yaml, train_dcae.build_parser().parse_args(
                    [*argv, "--num_steps", str(DATA_DCAE_STEPS), "--output_dir", out,
                     "--log_every", "1", "--seed", "0", "--device", device]))
            runs[name] = {**keep(res), "run_wall_s": time.perf_counter() - t0,
                          "warnings": list(warned)}
            launches[name] = _conv_launches()
            forwards = DATA_DCAE_STEPS + len(res["validations"])
            per_fwd = {k: a + b for (k, a), b in zip(
                sphere_conv_counts(res["state"].model.encoder).items(),
                sphere_conv_counts(res["state"].model.decoder).values())}
            del res
            shutil.rmtree(out)
            if device == "cuda":
                torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = prev
    rec = {"phase": "data_sources_train_dcae", "steps": DATA_DCAE_STEPS,
           "runs": runs, "launches": launches["tar"], "forwards": forwards,
           "expected_launches": {k: forwards * v for k, v in per_fwd.items()},
           "equal": {k: runs["npz"][k] == runs["tar"][k]
                     for k in ("loss", "grad_norm", "val_loss")}}
    emit(rec)
    if (not all(rec["equal"].values()) or runs["tar"]["warnings"]
            or len(runs["tar"]["val_loss"]) != 1 or len(runs["tar"]["loss"]) != DATA_DCAE_STEPS
            or not all(math.isfinite(x) for x in runs["tar"]["loss"])):
        raise AssertionError(f"data sources, train_dcae: {rec}")
    if device == "cuda":
        check_launches("train_dcae from tars", launches["tar"], rec["expected_launches"])
    summary = {"train_dcae": rec}

    # train_ar on the .npz and on the shard directory through each reader
    runs, launches = {}, {}
    for name, extra in (("npz", [latents]), ("native", [shard_dir, "--reader", "native"]),
                        ("mmap", [shard_dir, "--reader", "mmap"])):
        out = os.path.join(tmp, f"data_ar_{name}")
        _reset_launches(fa)
        t0 = time.perf_counter()
        res = train_ar.run(ar_yaml, train_ar.build_parser().parse_args(
            ["--latents", *extra, "--num_steps", str(DATA_AR_STEPS), "--output_dir", out,
             "--log_every", "1", "--seed", "0", "--device", device]))
        runs[name] = {**keep(res), "run_wall_s": time.perf_counter() - t0}
        launches[name] = _launches(fa)
        del res
        shutil.rmtree(out)
        if device == "cuda":
            torch.cuda.empty_cache()
    n = 7 * DATA_AR_STEPS
    rec = {"phase": "data_sources_train_ar", "steps": DATA_AR_STEPS, "shards": DATA_SHARDS,
           "runs": runs, "launches": launches["native"],
           "expected_launches": {k: n for k in launches["native"]},
           "equal": {r: all(runs[r][k] == runs["npz"][k] for k in ("loss", "grad_norm"))
                     for r in ("native", "mmap")}}
    emit(rec)
    if (not all(rec["equal"].values()) or len(runs["native"]["loss"]) != DATA_AR_STEPS
            or not all(math.isfinite(x) for x in runs["native"]["loss"])):
        raise AssertionError(f"data sources, train_ar: {rec}")
    if device == "cuda":
        check_launches("train_ar from shards", launches["native"], rec["expected_launches"])
    summary["train_ar"] = rec
    return summary


def int8_forecast_phase(tmp, forecast, peaks, int8_peak, pairs=INT8_GEMM_PAIRS,
                        M=INT8_GEMM_M, device="cuda"):
    """``cli.pred_rollout --int8_matmuls`` on the forecast phase's hub
    directories, as its Heun run without the decode: the rollout's time
    against the bf16 run's, the relative L2 of the latents from that run
    (``INT8_REL_L2``), the launches of K1 and K2 (equal to the bf16 run's)
    and of the int8 GEMM; then ``torch._int_mm`` at the 375M's (K, N)
    pairs at M tokens: its int32 product against the exact fp64 product
    of the same int8 values, and its time against bf16 ``torch.matmul`` at
    the same shape and against its bound at the card's int8 rate. The
    forecast runs on ``device`` (a CPU rehearsal skips the launch counts
    and, with no ``pairs``, the GEMMs)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ladcast_torch.cli import pred_rollout
    from ladcast_torch.config import ladcast_375m_config
    from ladcast_torch.ops import flash_attention as fa
    from ladcast_torch.ops import quant

    edm = forecast["edm"]
    out = os.path.join(tmp, "out_int8")
    argv = [a for a in edm["argv"] if a != "--decode"]
    args = pred_rollout.build_parser().parse_args(
        [*argv, "--output_dir", out, "--int8_matmuls"])
    cuda = device == "cuda"
    _reset_launches(fa)
    _reset_conv_launches()
    quant.int8_mm.launches = 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    recs = pred_rollout.run(args)
    wall_s = time.perf_counter() - t0
    launches = {"norm_rope": fa.norm_rope.launches,
                "fused_attention": fa.fused_attention.launches,
                **_conv_launches(), "int8_mm": quant.int8_mm.launches}
    inits = [r for r in recs if "rollout_s" in r]
    ts = inits[0]["init_time"]
    q = np.load(os.path.join(out, f"latent_{ts}.npy"))
    ref = np.load(os.path.join(edm["out_dir"], f"latent_{ts}.npy"))

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    cfg = ladcast_375m_config()
    calls = 2 * 20 - 1  # Heun-20, one repetition
    rec = {"phase": "int8_forecast", "sampler": args.sampler,
           "members": args.ensemble_size, "steps": args.num_inference_steps,
           "init_times": [r["init_time"] for r in inits],
           "rollout_s": [r["rollout_s"] for r in inits],
           "bf16_rollout_s": edm["rollout_s"],
           "encode_s": [r["encode_s"] for r in inits], "load_s": recs[0]["load_s"],
           "run_wall_s": wall_s, "launches": launches,
           "expected_launches": {
               "norm_rope": edm["launches"]["norm_rope"],
               "fused_attention": edm["launches"]["fused_attention"],
               "int8_mm": calls * (12 * cfg.num_layers + 5 * cfg.num_single_layers)},
           "shape": list(q.shape), "finite": bool(np.isfinite(q).all()),
           "t0_equal": bool(np.array_equal(q[:, :, 0], ref[:, :, 0])),
           "rel_l2_to_bf16": rel(q[:, :, 1:], ref[:, :, 1:]), "limit": INT8_REL_L2,
           # beside it, how far two members of the bf16 run are apart
           "bf16_member_rel_l2": rel(ref[1, :, 1:], ref[0, :, 1:]),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30 if cuda else None}
    emit(rec)
    got = {k: launches[k] for k in rec["expected_launches"]}
    if (len(inits) != 1 or not rec["finite"] or not rec["t0_equal"]
            or rec["shape"] != list(ref.shape)
            or (cuda and got != rec["expected_launches"])
            or not rec["rel_l2_to_bf16"] <= INT8_REL_L2):
        raise AssertionError(f"int8 forecast: {rec}")

    # the int8 GEMM at the path's shapes
    peak_bf16, _, bw, _ = peaks
    gemms = []
    g = torch.Generator(device=device).manual_seed(41) if pairs else None
    for K, N in pairs:
        xq = torch.randint(-127, 128, (M, K), generator=g, device=device, dtype=torch.int8)
        wq = torch.randint(-127, 128, (N, K), generator=g, device=device, dtype=torch.int8)
        acc = quant.int8_mm(xq, wq.t())
        exact = torch.equal(acc.double(), xq.double() @ wq.double().t())
        del acc
        xb, wb = xq.to(torch.bfloat16), wq.to(torch.bfloat16)
        ws = torch.rand(N, 1, generator=g, device=device) / 127
        flops = 2 * M * K * N
        r = {"phase": "int8_gemm", "M": M, "K": K, "N": N, "exact": exact,
             "int8_ms": time_ms(lambda: torch._int_mm(xq, wq.t())),
             "bf16_ms": time_ms(lambda: torch.matmul(xb, wb.t())),
             # the whole w8a8 function as the forecast runs it (weight
             # quantised once): the activation's quantisation, the product
             # and the dequantisation, against bf16 F.linear
             "w8a8_ms": time_ms(lambda: quant.int8_matmul_quantized(
                 xb, wq, ws, None, torch.bfloat16)),
             "linear_bf16_ms": time_ms(lambda: F.linear(xb, wb)),
             **bound(flops, M * K + K * N + 4 * M * N, int8_peak, bw)}
        bf = bound(flops, 2 * (M * K + K * N + M * N), peak_bf16, bw)
        r.update(bf16_bound_ms=bf["bound_ms"], bf16_bound_by=bf["bound_by"],
                 int8_tops=flops / r["int8_ms"] / 1e9,
                 bound_share=r["bound_ms"] / r["int8_ms"],
                 int8_over_bf16=r["int8_ms"] / r["bf16_ms"])
        emit(r)
        gemms.append(r)
        del xq, wq, xb, wb
        torch.cuda.empty_cache()
        if not exact:
            raise AssertionError(f"int8 GEMM not exact: {r}")
    return {"forecast": rec, "gemms": gemms}


def dcae_temb_phase(cfg=None, device="cuda"):
    """The shipped DCAE's widths with timestep conditioning
    (``temb_channels`` = DCAE_TEMB_CHANNELS) at B=4: encode and decode with
    ``time_elapsed`` under ``CONV_MODE = "kernel"`` against ``"library"``,
    fp32 and bf16, to DCAE_TOL, with the launches of K4 and K5 (a CPU
    rehearsal with a small ``cfg`` skips the launch counts)."""
    import torch

    from ladcast_torch.config import DCAEConfig
    from ladcast_torch.models.dcae import build_dcae

    dev = torch.device(device)
    cfg = cfg or dataclasses.replace(DCAEConfig(), temb_channels=DCAE_TEMB_CHANNELS)
    g = torch.Generator(device=dev).manual_seed(12)
    r = cfg.spatial_compression_ratio
    fields = torch.randn(4, 120, 240, cfg.in_channels - cfg.static_channels,
                         generator=g, device=dev)
    static = torch.randn(120, 240, cfg.static_channels, generator=g, device=dev)
    z = torch.randn(4, 120 // r, 240 // r, cfg.latent_channels, generator=g, device=dev)
    t = torch.tensor([0.0, 6.0, 24.0, 240.0], device=dev)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        dcae = build_dcae(cfg, dev, dtype, seed=13)
        expected = {"encode": sphere_conv_counts(dcae.encoder),
                    "decode": sphere_conv_counts(dcae.decoder)}
        outs, launches = {}, {}
        with torch.inference_mode():
            for mode in ("kernel", "library"):
                with conv_mode(mode):
                    for stage, fn in (
                            ("encode", lambda: dcae.encode(fields.to(dtype), static.to(dtype),
                                                           time_elapsed=t)),
                            ("decode", lambda: dcae.decode(z.to(dtype), time_elapsed=t))):
                        _reset_conv_launches()
                        outs[mode, stage] = fn().float()
                        launches[mode, stage] = _conv_launches()
            untimed = dcae.decode(z.to(dtype)).float()  # no time_elapsed
        rec = {"phase": "dcae_temb", "dtype": dname, "B": 4,
               "temb_channels": cfg.temb_channels, "tol": DCAE_TOL[dname],
               "parameters": sum(p.numel() for p in dcae.parameters()),
               "expected_launches": expected}
        ok = True
        for stage in ("encode", "decode"):
            a, b = outs["kernel", stage], outs["library", stage]
            rec[stage] = {"rel_l2": ((a - b).norm() / b.norm()).item(),
                          "max_abs_err": (a - b).abs().max().item(),
                          "finite": bool(torch.isfinite(a).all()),
                          "launches": launches["kernel", stage]}
            ok &= (rec[stage]["finite"] and rec[stage]["rel_l2"] <= DCAE_TOL[dname]
                   and (dev.type != "cuda" or launches["kernel", stage] == expected[stage])
                   and not any(launches["library", stage].values()))
        # the conditioning acts: the decode without it is another function
        d = outs["kernel", "decode"]
        rec["untimed_decode_rel_l2"] = ((untimed - d).norm() / d.norm()).item()
        ok &= rec["untimed_decode_rel_l2"] > 10 * DCAE_TOL[dname]
        emit(rec)
        if not ok:
            raise AssertionError(f"DCAE with temb, {dname}: {rec}")
        results[dname] = rec
        del dcae, outs, untimed
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return results


# kernel-name fragments -> category, first match wins: every kernel of
# ladcast_torch/csrc is named before "gemm", whose "wgmma" would take a
# kernel that issues wgmma (tests/test_torch_rules.py holds this)
# The parallel phase (ladcast_torch/parallel/): one-rank NCCL runs of the
# trainers in this process, then two processes on the one card over a gloo
# group (NCCL refuses two ranks on one GPU). Limits: the trainers' losses
# per step to PARALLEL_LOSS_RTOL of the single-device runs', the sharded
# forecast's members to the 375M bf16 limit (MODEL_TOL) of the
# single-process latents, the merged score tables to PARALLEL_SCORE_RTOL.
PARALLEL_LOSS_RTOL = 1e-5
PARALLEL_SCORE_RTOL = 1e-6
PARALLEL_SPAWN_TIMEOUT_S = 300


def _parallel_worker(rank, world, store, job, argv, out):
    """One rank of a two-process run: a gloo group, the model work on the
    device the CLI's ``--device`` names (cuda:0 for both ranks on the card);
    writes its records, launches, wall time and peak memory to ``out``."""
    sys.path.insert(0, str(ROOT))
    import torch

    from ladcast_torch.cli import evaluate_ens, pred_rollout
    from ladcast_torch.ops import flash_attention as fa
    from ladcast_torch.parallel import dist

    dist.initialize(backend="gloo", init_method=f"file://{store}", world_size=world,
                    rank=rank)
    try:
        cli = pred_rollout if job == "pred_rollout" else evaluate_ens
        args = cli.build_parser().parse_args(argv)
        cuda = args.device.startswith("cuda")
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        _reset_launches(fa)
        _reset_conv_launches()
        t0 = time.perf_counter()
        res = cli.run(args)
        wall_s = time.perf_counter() - t0
        recs = res if job == "pred_rollout" else res["records"]
        rec = {"rank": rank, "wall_s": wall_s, "records": recs,
               "launches": {**_launches(fa), **_conv_launches()},
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30 if cuda else None}
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(rec, f)
    finally:
        torch.distributed.destroy_process_group()


def spawn_two(job, argv, tmp, timeout=PARALLEL_SPAWN_TIMEOUT_S):
    """``job`` ("pred_rollout" or "evaluate_ens") with ``argv`` in two
    processes; returns each rank's record. A failed rank fails the phase;
    no process outlives the call."""
    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(dir=tmp, prefix=f"{job}_ranks_")
    ctx = mp.start_processes(
        _parallel_worker, args=(2, os.path.join(out, "store"), job, argv, out),
        nprocs=2, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise AssertionError(f"{job} over two processes outlived {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    recs = []
    for r in range(2):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs


def _step_rel_diff(got, want):
    return [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got, want)]


def parallel_phase(tmp, latents, training, dit_1p6b, forecast, chain,
                   ar_yaml=LADCAST_375M_YAML, p16_yaml=LADCAST_1P6B_YAML,
                   dcae_yaml=DCAE_84_YAML, ar_steps=TRAIN_STEPS,
                   p16_steps=TRAIN_STEPS_1P6B, dcae_steps=CHAIN_DCAE_STEPS,
                   device="cuda"):
    """``ladcast_torch.parallel`` on the card, through the CLIs' ``run``.

    1. A one-rank NCCL group in this process (a ``file://`` store under
       ``tmp``): ``train_ar`` on the 375M yaml with ``--mesh data=-1`` (DDP
       through the explicit all-reduce), the 1.6B yaml as shipped with
       ``--mesh data=-1 --zero`` (FSDP, a unit per block checkpointing inside it, remat
       as the yaml sets it) and ``train_dcae`` as the chain runs it (DDP), each
       held to its single-device run (``training``, ``dit_1p6b``,
       ``chain``): losses per step, launches, ms per step and peak memory
       beside that run's; no checkpoint is written (``train_ar
       --skip_state_ckpt``; ``train_dcae``, which has no such flag, through
       a stand-in ``save_state``).
    2. Two processes on the one card over gloo: ``pred_rollout
       --shard_ensemble`` as the forecast phase's Heun run (20 members, 10
       per rank, with the decode), its latents held to that run's per
       member and its fields to that run's; ``evaluate_ens`` over the
       forecast phase's two DPM files, one init time per rank, its merged
       tables held to a one-process run's. Wall time and each rank's peak
       memory.
    With ``device="cpu"`` (and small yamls and step counts) the phase
    rehearses on the CPU, its group on gloo."""
    import numpy as np
    import torch

    from ladcast_torch.cli import evaluate_ens, train_ar, train_dcae
    from ladcast_torch.ops import flash_attention as fa
    from ladcast_torch.parallel import dist
    from ladcast_torch.train import checkpoint as ckpt

    cuda = device == "cuda"
    dev_args = [] if cuda else ["--device", "cpu"]
    summary = {}

    def peak():
        return torch.cuda.max_memory_allocated() / 2**30 if cuda else None

    def reset():
        """Zero the launch counts and the peak; returns the memory still
        allocated (the baseline under the run's peak)."""
        _reset_launches(fa)
        _reset_conv_launches()
        gc.collect()  # an earlier run's model and optimizer, held in cycles
        if not cuda:
            return None
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated() / 2**30

    # 1. one rank, NCCL
    t_group = time.perf_counter()
    dist.initialize(backend="nccl" if cuda else "gloo",
                    init_method=f"file://{os.path.join(tmp, 'nccl_store')}",
                    world_size=1, rank=0, device=device)
    skipped = []
    save_state, ckpt.save_state = ckpt.save_state, lambda mgr, step, state: skipped.append(step)
    try:
        runs = (("train_ar_ddp", "ddp", ar_yaml, ar_steps, ["--mesh", "data=-1"],
                 training),
                ("train_1p6b_fsdp", "fsdp", p16_yaml, p16_steps,
                 ["--mesh", "data=-1", "--zero"], dit_1p6b))
        for name, regime, yaml, steps, flags, ref in runs:
            args = train_ar.build_parser().parse_args(
                ["--latents", latents, "--num_steps", str(steps), "--output_dir",
                 os.path.join(tmp, name), "--log_every", "1", "--seed", "0",
                 "--skip_state_ckpt", *flags, *dev_args])
            base_gb = reset()
            t0 = time.perf_counter()
            res = train_ar.run(yaml, args)
            wall_s = time.perf_counter() - t0
            hist = res["history"]
            step_ms = [h["step_s"] * 1e3 for h in hist]
            rec = {"phase": "parallel_train", "run": name, "ranks": 1, "backend":
                   "nccl" if cuda else "gloo", "regime": res["state"].regime,
                   "flags": flags, "steps": len(hist),
                   "loss": [h["loss"] for h in hist], "ref_loss": ref["loss"],
                   "grad_norm": [h["grad_norm"] for h in hist],
                   "ref_grad_norm": ref["grad_norm"],
                   "median_step_ms": statistics.median(step_ms[2:]) if len(step_ms) > 2 else None,
                   "ref_median_step_ms": ref["median_step_ms"], "step_ms": step_ms,
                   "peak_mem_gb": peak(), "ref_peak_mem_gb": ref["peak_mem_gb"],
                   "allocated_at_start_gb": base_gb,
                   "launches": _launches(fa), "ref_launches": ref["launches"],
                   "run_wall_s": wall_s}
            rec["loss_rel_diff"] = _step_rel_diff(rec["loss"], ref["loss"])
            rec["bit_equal"] = (rec["loss"] == ref["loss"]
                                and rec["grad_norm"] == ref["grad_norm"])
            emit(rec)
            summary[name] = rec
            del res, hist
            if cuda:
                torch.cuda.empty_cache()
            if (rec["regime"] != regime or rec["steps"] != steps
                    or len(ref["loss"]) != steps
                    or max(rec["loss_rel_diff"]) > PARALLEL_LOSS_RTOL
                    or rec["launches"] != ref["launches"]):
                raise AssertionError(f"parallel {name}: {rec}")

        train, val = (os.path.join(tmp, f"chain_{k}.npz") for k in ("train", "val"))
        args = train_dcae.build_parser().parse_args(
            ["--data", train, "--val_data", val, "--val_every", str(dcae_steps),
             "--num_steps", str(dcae_steps), "--output_dir",
             os.path.join(tmp, "dcae_ddp"), "--log_every", "1", "--seed", "0",
             *dev_args])
        ref = chain["train_dcae"]
        base_gb = reset()
        t0 = time.perf_counter()
        res = train_dcae.run(dcae_yaml, args)
        wall_s = time.perf_counter() - t0
        hist = res["history"]
        step_ms = [h["step_s"] * 1e3 for h in hist]
        rec = {"phase": "parallel_train", "run": "train_dcae_ddp", "ranks": 1,
               "backend": "nccl" if cuda else "gloo", "regime": res["state"].regime,
               "steps": len(hist), "loss": [h["loss"] for h in hist],
               "ref_loss": ref["loss"], "grad_norm": [h["grad_norm"] for h in hist],
               "ref_grad_norm": ref["grad_norm"],
               "val_loss": [v["val_loss"] for v in res["validations"]],
               "ref_val_loss": ref["val_loss"],
               "median_step_ms": statistics.median(step_ms[2:]) if len(step_ms) > 2 else None,
               "ref_median_step_ms": ref["median_step_ms"], "step_ms": step_ms,
               "peak_mem_gb": peak(), "ref_peak_mem_gb": ref["peak_mem_gb"],
               "allocated_at_start_gb": base_gb,
               "launches": _conv_launches(), "ref_launches": ref["launches"],
               "run_wall_s": wall_s}
        rec["loss_rel_diff"] = _step_rel_diff(rec["loss"] + rec["val_loss"],
                                              ref["loss"] + ref["val_loss"])
        rec["bit_equal"] = (rec["loss"] == ref["loss"] and rec["val_loss"] == ref["val_loss"]
                            and rec["grad_norm"] == ref["grad_norm"])
        emit(rec)
        summary["train_dcae_ddp"] = rec
        del res, hist
        if (rec["regime"] != "ddp" or rec["steps"] != dcae_steps
                or len(rec["val_loss"]) != len(ref["val_loss"])
                or max(rec["loss_rel_diff"]) > PARALLEL_LOSS_RTOL
                or rec["launches"] != ref["launches"]):
            raise AssertionError(f"parallel train_dcae: {rec}")
    finally:
        ckpt.save_state = save_state
        if dist.is_initialized():
            torch.distributed.destroy_process_group()
    emit({"phase": "parallel_group_done", "wall_s": time.perf_counter() - t_group,
          "checkpoint_steps_not_written": skipped})
    if cuda:
        torch.cuda.empty_cache()

    # 2a. the member-sharded forecast over two processes
    edm = forecast["edm"]
    argv = list(edm["argv"])
    out = os.path.join(tmp, "par_forecast")
    argv[argv.index("--output_dir") + 1] = out
    t0 = time.perf_counter()
    ranks = spawn_two("pred_rollout", argv + ["--shard_ensemble"], tmp)
    wall_s = time.perf_counter() - t0
    ts = edm["init_times"][0]
    got = np.load(os.path.join(out, f"latent_{ts}.npy"))
    want = np.load(os.path.join(edm["out_dir"], f"latent_{ts}.npy"))
    members = want.shape[0]
    rel = [float(np.linalg.norm(got[m] - want[m]) / np.linalg.norm(want[m]))
           for m in range(members)]
    with np.load(os.path.join(out, f"fields_{ts}.npz")) as a, \
            np.load(os.path.join(edm["out_dir"], f"fields_{ts}.npz")) as b:
        fa_, fb = a["fields"], b["fields"]
        fields_shape = list(fa_.shape)
        fields_rel = float(np.linalg.norm((fa_ - fb).ravel().astype(np.float64))
                           / np.linalg.norm(fb.ravel().astype(np.float64)))
        fields_finite = bool(np.isfinite(fa_).all())
        del fa_, fb
    per_rank = [{k: r[k] for k in ("rank", "wall_s", "launches", "peak_mem_gb")}
                | {"stages": [{k: v for k, v in x.items() if k.endswith("_s")}
                              for x in r["records"] if "rollout_s" in x]}
                for r in ranks]
    n_init = len(edm["init_times"])
    exp = edm["expected_launches"]
    enc = {k: forecast["dpm"]["expected_launches"][k] // len(forecast["dpm"]["init_times"])
           for k in ("dense_conv", "depthwise_conv")}
    per = -(-members // 2)  # members per rank
    frames = per * (got.shape[2] - 1)
    chunks = -(-frames // 40)  # the pipeline's decode chunk
    expected = {"norm_rope": exp["norm_rope"], "fused_attention": exp["fused_attention"],
                "fused_attention_lse": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                **{k: n_init * (enc[k] + chunks * (exp[k] // n_init - enc[k]) // 2)
                   for k in enc}}
    rec = {"phase": "parallel_forecast", "ranks": 2, "backend": "gloo",
           "members": members, "members_per_rank": per, "init_times": edm["init_times"],
           "shape": list(got.shape), "finite": bool(np.isfinite(got).all()),
           "member_rel_l2": rel, "max_member_rel_l2": max(rel),
           "tol": MODEL_TOL["bfloat16"], "bit_equal": bool(np.array_equal(got, want)),
           "fields_shape": fields_shape, "fields_finite": fields_finite,
           "fields_rel_l2": fields_rel, "fields_tol": DCAE_TOL["bfloat16"],
           "ref_rollout_s": edm["rollout_s"], "ref_decode_s": edm["decode_s"],
           "ref_run_wall_s": edm["run_wall_s"], "ref_peak_mem_gb": edm["peak_mem_gb"],
           "run_wall_s": wall_s, "per_rank": per_rank, "expected_launches_per_rank": expected,
           "launches": {k: sum(r["launches"][k] for r in ranks) for k in expected}}
    emit(rec)
    summary["forecast"] = rec
    if (rec["shape"] != list(want.shape) or not rec["finite"] or not fields_finite
            or rec["max_member_rel_l2"] > MODEL_TOL["bfloat16"]
            or fields_rel > DCAE_TOL["bfloat16"]
            or [r["launches"] for r in ranks] != [expected, expected]
            or ranks[1]["records"][-1].get("gather_s") is None):
        raise AssertionError(f"parallel forecast: {rec}")

    # 2b. scoring over two processes against one
    dpm = forecast["dpm"]
    score_in = os.path.join(tmp, "par_score_in")
    os.makedirs(score_in)
    for ts in dpm["init_times"]:
        shutil.copy(os.path.join(dpm["out_dir"], f"latent_{ts}.npy"), score_in)

    def score_argv(out):
        return ["--latent_dir", score_in, "--truth", train,
                "--allow_truth_mean_climatology", "--dcae_params",
                os.path.join(tmp, "dcae"), "--diagnostics", "--output_dir", out,
                *dev_args]

    base_gb = reset()
    t0 = time.perf_counter()
    one = evaluate_ens.run(evaluate_ens.build_parser().parse_args(
        score_argv(os.path.join(tmp, "par_score_one"))))
    one_s = time.perf_counter() - t0
    one_launches, one_peak = _conv_launches(), peak()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_two("evaluate_ens", score_argv(os.path.join(tmp, "par_score_two")), tmp)
    wall_s = time.perf_counter() - t0
    diffs, same = {}, True
    for name in sorted(os.listdir(os.path.join(tmp, "par_score_one"))):
        if not name.endswith(".npy") or ".rank" in name:
            continue
        a = np.load(os.path.join(tmp, "par_score_two", name)).astype(np.float64)
        b = np.load(os.path.join(tmp, "par_score_one", name)).astype(np.float64)
        if a.shape != b.shape:
            raise AssertionError(f"parallel evaluate_ens {name}: {a.shape} != {b.shape}")
        ok = np.isfinite(b)
        diffs[name] = float(np.abs(a[ok] - b[ok]).max() / max(np.abs(b[ok]).max(), 1e-30))
        same &= bool(np.array_equal(a, b, equal_nan=True))
    rec = {"phase": "parallel_evaluate_ens", "ranks": 2, "backend": "gloo",
           "init_times": dpm["init_times"], "one_process_s": one_s,
           "one_process_launches": one_launches, "one_process_peak_mem_gb": one_peak,
           "one_process_allocated_at_start_gb": base_gb,
           "run_wall_s": wall_s,
           "per_rank": [{k: r[k] for k in ("rank", "wall_s", "launches", "peak_mem_gb")}
                        | {"scored": [x["init_time"] for x in r["records"] if x["scored"]]}
                        for r in ranks],
           "rel_diff": diffs, "tol": PARALLEL_SCORE_RTOL, "bit_equal": same,
           "launches": {k: sum(r["launches"][k] for r in ranks) for k in one_launches}}
    emit(rec)
    summary["evaluate_ens"] = rec
    if (one["num_init_times"] != 2 or len(diffs) < 7
            or max(diffs.values()) > PARALLEL_SCORE_RTOL
            or rec["launches"] != one_launches
            or [p["scored"] for p in rec["per_rank"]] != [[t] for t in dpm["init_times"]]):
        raise AssertionError(f"parallel evaluate_ens: {rec}")
    return summary


CATEGORIES = [("fused_attention", ("fa_bf16_wgmma_kernel", "fa_f32_wgmma_kernel",
                                    "fa_f32_split_kernel")),
              ("flash_bwd", ("bwd_dq_bf16_wgmma_kernel", "bwd_dkv_bf16_wgmma_kernel",
                             "bwd_dq_f32_wgmma_kernel", "bwd_dkv_f32_wgmma_kernel",
                             "bwd_f32_split_kernel")),
              ("norm_rope", ("norm_rope_kernel",)),
              ("flash_plain (K6)", ("fa_plain_wgmma_kernel", "fa_plain_split_kernel")),
              ("dense_conv (K4)", ("conv_bf16_wgmma_kernel", "conv_f32_wgmma_kernel")),
              ("depthwise_conv (K5)", ("dw_rows_kernel",)),
              ("foreach (AdamW, EMA, norms)", ("multi_tensor_apply",)),
              ("cudnn_conv", ("fprop", "dgrad", "conv", "winograd", "nchwToNhwc",
                              "nhwcToNchw")),
              ("gemm", ("nvjet", "gemm", "xmma", "cutlass", "s16816", "wgmma")),
              ("reduction", ("reduce", "norm", "softmax")),
              ("copy_cat", ("CatArray", "Copy", "copy", "flip", "roll",
                            "index")),
              ("elementwise", ("elementwise", "vectorized", "fill"))]


def category(kernel_name):
    """The profile category of a device kernel, by name."""
    return next((c for c, frags in CATEGORIES
                 if any(f in kernel_name for f in frags)), "other")


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
        cat = category(e.name)
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
    ap.add_argument("--records", default=None, metavar="FILE",
                    help="also write every JSON record to FILE")
    ap.add_argument("--fp32-ab", default=None, metavar="PARENT",
                    help="only time the fp32 attention kernels and the fp32 "
                         "training step on the checkout at PARENT and on this "
                         "one, in turns (parent, this, this, parent)")
    ap.add_argument("--fp32-only", default=None, metavar="ROOT", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.fp32_only or str(ROOT))
    try:
        from ladcast_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the ladcast_torch package is missing ({e})",
              file=sys.stderr)
        return 2

    if args.records:
        global RECORDS
        RECORDS = Path(args.records)
        RECORDS.parent.mkdir(parents=True, exist_ok=True)
        RECORDS.write_text("")
    card = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    peaks = next(p[1:] for p in PEAKS if p[0] in name)
    int8_peak = next(p[1] for p in INT8_PEAKS if p[0] in name)
    if args.fp32_ab or args.fp32_only:
        if args.fp32_ab:
            fp32_ab(args.fp32_ab)
        else:
            fp32_only(peaks, card, args.fp32_only)
        return 0
    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "environment", "nvidia_smi": card, "device": name,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": time.perf_counter() - t0,
          "libraries": sorted(p.name for p in libs.values()),
          "peaks": {"bf16_flops": peaks[0], "fp32_flops": peaks[1],
                    "bytes_per_s": peaks[2], "tf32_flops": peaks[3],
                    "int8_ops": int8_peak}})
    # the kernels' registers, spills and SASS; the Hopper kernels must have
    # no mma.sync, no spills and no note of ptxas's (a serialised wgmma)
    reports = {}
    for lib in ("fused_attention", "flash_bwd", "dense_conv", "depthwise_conv",
                "flash_plain"):
        reports[lib] = kernel_report(lib)
        emit({"phase": "kernel_build", "library": lib, "kernels": reports[lib]})
    # K1 and K3 in both dtypes must be the Hopper kernels: wgmma, TMA loads
    # (their fp32 split passes are reported only)
    for lib, kname in (("fused_attention", "fa_bf16_wgmma_kernel"),
                       ("fused_attention", "fa_f32_wgmma_kernel"),
                       ("flash_bwd", "bwd_dq_bf16_wgmma_kernel"),
                       ("flash_bwd", "bwd_dkv_bf16_wgmma_kernel"),
                       ("flash_bwd", "bwd_dq_f32_wgmma_kernel"),
                       ("flash_bwd", "bwd_dkv_f32_wgmma_kernel")):
        k = reports[lib][kname]
        if (not k["sass"].get("HGMMA") or not k["sass"].get("UTMALDG")
                or k["sass"].get("HMMA") or not clean_build(k)):
            raise AssertionError(f"{kname} as built: {k}")
    # K4 in bf16 must be the Hopper kernel in every instance: wgmma, no
    # mma.sync, no spills, no note of ptxas's
    k4 = {k: v for k, v in reports["dense_conv"].items()
          if k.startswith("conv_bf16_wgmma_kernel")}
    if not k4 or any(not v["sass"].get("HGMMA") or v["sass"].get("HMMA")
                     or not clean_build(v) for v in k4.values()):
        raise AssertionError(f"conv_bf16_wgmma_kernel as built: {k4}")
    # K4 in fp32 the same, in both instances (N tiles of 96 and 128)
    k4f = {k: v for k, v in reports["dense_conv"].items()
           if k.startswith("conv_f32_wgmma_kernel")}
    if len(k4f) != 2 or any(not v["sass"].get("HGMMA") or v["sass"].get("HMMA")
                            or not clean_build(v) for v in k4f.values()):
        raise AssertionError(f"conv_f32_wgmma_kernel as built: {k4f}")
    # K6 in every tensor-core instance (three head sizes, one or three
    # planes): wgmma, TMA loads, no mma.sync, no spills, no note of ptxas's;
    # the split pass is reported only
    k6 = {k: v for k, v in reports["flash_plain"].items()
          if k.startswith("fa_plain_wgmma_kernel")}
    if len(k6) != 6 or any(not v["sass"].get("HGMMA") or not v["sass"].get("UTMALDG")
                           or v["sass"].get("HMMA") or not clean_build(v)
                           for v in k6.values()):
        raise AssertionError(f"fa_plain_wgmma_kernel as built: {k6}")

    t0 = time.perf_counter()
    results = kernel_phase(peaks)
    results["flash_attention"], k6_launches = flash_plain_phase(peaks)
    emit({"phase": "kernel_done", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    results.update(conv_kernel_phase(peaks))
    emit({"phase": "conv_kernel_done", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    scoring = conv_scoring_phase(peaks)
    emit({"phase": "conv_scoring_done", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    results.update(backward_kernel_phase(peaks))
    emit({"phase": "backward_kernel_done", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    model_parity_phase()
    emit({"phase": "model_parity_done", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    grad_parity_phase()
    emit({"phase": "grad_parity_done", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    dcae_parity_phase()
    emit({"phase": "dcae_parity_done", "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    temb = dcae_temb_phase()
    emit({"phase": "dcae_temb_done", "wall_s": time.perf_counter() - t0})
    launches, bench = main_path_phase(args.reps)
    if args.profile:
        profile_phase("inference", lambda: bench["full_forecast"](6))
    del bench
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        latents = synthetic_latents(tmp)
        training = training_phase(tmp, latents, args.profile)
        emit({"phase": "training_done", "wall_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        training_f32 = training_f32_phase(tmp, latents)
        emit({"phase": "training_f32_done", "wall_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        p16 = dit_1p6b_phase(tmp, latents)
        emit({"phase": "dit_1p6b_done", "wall_s": time.perf_counter() - t0})
    train_launches = training["kernel"]["launches"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        forecast = forecast_phase(tmp)
        emit({"phase": "forecast_done", "wall_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        chain = chain_phase(tmp, forecast)
        emit({"phase": "chain_done", "wall_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        int8 = int8_forecast_phase(tmp, forecast, peaks, int8_peak)
        emit({"phase": "int8_forecast_done", "wall_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        data = data_sources_phase(tmp)
        emit({"phase": "data_sources_done", "wall_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        parallel = parallel_phase(tmp, synthetic_latents(tmp), training["kernel"],
                                  p16["training"], forecast, chain)
        emit({"phase": "parallel_done", "wall_s": time.perf_counter() - t0})
    forecast_launches = forecast["edm"]["launches"]

    src = "ladcast_tpu/ops/pallas/flash_attention.py"
    meta = {"norm_rope": ("ladcast_torch/csrc/norm_rope.cu", f"{src}:70"),
            "fused_attention": ("ladcast_torch/csrc/fused_attention.cu", f"{src}:113"),
            "fused_attention_lse": ("ladcast_torch/csrc/fused_attention.cu",
                                    f"{src}:163"),
            "flash_bwd_dq": ("ladcast_torch/csrc/flash_bwd.cu", f"{src}:279"),
            "flash_bwd_dkv": ("ladcast_torch/csrc/flash_bwd.cu", f"{src}:318"),
            "dense_conv": ("ladcast_torch/csrc/dense_conv.cu",
                           "ladcast_tpu/ops/pallas/dense_conv.py:83"),
            "dense_conv_f32": ("ladcast_torch/csrc/dense_conv.cu",
                               "ladcast_tpu/ops/pallas/dense_conv.py:83"),
            "depthwise_conv": ("ladcast_torch/csrc/depthwise_conv.cu",
                               "ladcast_tpu/ops/pallas/depthwise_conv.py:101"),
            "flash_attention": ("ladcast_torch/csrc/flash_plain.cu", f"{src}:601")}

    def entry(kname, recs, path_launches, main_case="dual_2250", batch=None,
              dtype="bfloat16"):
        main = next(r for r in recs if r["case"] == main_case
                    and r["dtype"] == dtype and r.get("circular", True)
                    and batch in (None, r["B"]))
        return {"name": kname, "route": "cuda", "source": meta[kname][0],
                "replaces": meta[kname][1], "launches": path_launches,
                "max_abs_err": max(r["max_abs_err"] for r in recs),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": main["library_ms"], "case": main_case,
                **{k: main[k] for k in ("library_op", "tflops", "bound_share",
                                        "bound_passes", "library_rel_l2",
                                        "library_bf16p_ms") if k in main}}

    def timed_cases(recs):
        """Each timed case of a kernel's records beside its main one."""
        keys = ("B", "H", "ms", "plain_ms", "library_ms", "library_rel_l2",
                "bound_ms", "bound_by", "tflops", "bound_share")
        return {r["case"]: {k: r[k] for k in keys if k in r} for r in recs
                if "ms" in r and r["case"] != "dual_2250"}

    def parallel_launches(kname):
        """The parallel phase's launches of a kernel, per run (both ranks'
        summed for the two-process runs), where the run launches it."""
        runs = {"train_ar_ddp": parallel["train_ar_ddp"], "train_1p6b_fsdp":
                parallel["train_1p6b_fsdp"], "train_dcae_ddp": parallel["train_dcae_ddp"],
                "pred_rollout_shard_ensemble": parallel["forecast"],
                "evaluate_ens_two_ranks": parallel["evaluate_ens"]}
        return {name: rec["launches"][kname] for name, rec in runs.items()
                if rec["launches"].get(kname)}

    # launches: the bench path's for K1 and K2, the training path's (kernel
    # backward) for K1-lse and K3, the forecast path's (Heun with decode)
    # for K4 and K5, the op's own call for K6; the entries of kernels that
    # several paths run also name the other paths' launches
    summary = []
    for kname in ("norm_rope", "fused_attention"):
        e = entry(kname, results[kname], launches[kname])
        e["training_launches"] = train_launches[kname]
        e["forecast_launches"] = forecast_launches[kname]
        # the chain's AR trainer: its steps and validation rollouts
        e["chain_train_ar_launches"] = chain["train_ar"]["launches"][kname]
        # the int8 forecast (Heun, no decode) and the AR trainer on shards
        e["int8_forecast_launches"] = int8["forecast"]["launches"][kname]
        e["data_sources_train_ar_launches"] = data["train_ar"]["launches"][kname]
        e["parallel_launches"] = parallel_launches(kname)
        summary.append(e)
    e = entry("fused_attention_lse", results["fused_attention_lse"],
              train_launches["fused_attention_lse"])
    e["batch"] = 4
    e["data_sources_train_ar_launches"] = data["train_ar"]["launches"]["fused_attention_lse"]
    e["parallel_launches"] = parallel_launches("fused_attention_lse")
    summary.append(e)
    pair = next(r for r in results["flash_bwd_pair"] if r["case"] == "dual_2250"
                and r["dtype"] == "bfloat16")
    for kname in ("flash_bwd_dq", "flash_bwd_dkv"):
        e = entry(kname, results[kname], train_launches[kname])
        e["batch"] = 4
        # dq and dk/dv together against the whole plain and SDPA backward
        e["pair"] = {k: pair[k] for k in ("ms", "plain_ms", "library_ms",
                                          "bound_ms", "bound_by")}
        h16 = next(r for r in results[kname] if r["case"] == "dual_2250_h16"
                   and r["dtype"] == "bfloat16")
        e["dual_2250_h16"] = {k: h16[k] for k in ("ms", "plain_ms", "library_ms",
                                                  "bound_ms", "tflops", "bound_share")}
        e["data_sources_train_ar_launches"] = data["train_ar"]["launches"][kname]
        e["parallel_launches"] = parallel_launches(kname)
        summary.append(e)
    # the fp32 K1 and K3 on their path, the fp32 training step (every K1
    # launch there is the lse variant): launches in its run, times at
    # dual_2250 (K1 at the main path's B = 20, K1-lse and K3 at the
    # training's B = 4) and the other timed cases, bounds in six bf16 passes
    for kname in ("fused_attention", "fused_attention_lse", "flash_bwd_dq",
                  "flash_bwd_dkv"):
        recs = [r for r in results[kname] if r["dtype"] == "float32"]
        main = next(r for r in recs if r["case"] == "dual_2250" and "ms" in r)
        e = entry(kname, recs, training_f32["launches"][kname], dtype="float32")
        e.update(name=f"{kname}_f32", batch=main["B"],
                 cuda_core_bound_ms=main["cuda_core_bound_ms"],
                 launches_per_step=training_f32["launches_per_step"][kname],
                 timed_cases=timed_cases(recs))
        if kname.startswith("flash_bwd"):
            pair = next(r for r in results["flash_bwd_pair"]
                        if r["case"] == "dual_2250" and r["dtype"] == "float32")
            e["pair"] = {k: pair[k] for k in ("ms", "plain_ms", "library_ms",
                                              "bound_ms", "bound_by")}
        summary.append(e)
    for kname in ("dense_conv", "depthwise_conv"):
        case, batch = KERNEL_LINE_CASES[kname]
        e = entry(kname, results[kname], forecast_launches[kname], case, batch)
        e["batch"] = batch
        e["bench_launches"] = launches[kname]
        # the chain: per DCAE training step (forward only; the backward is
        # the plain version's VJP) and per scored init time (4 leads)
        td, ev = chain["train_dcae"], chain["evaluate_ens"]
        e["chain_launches"] = {
            "train_dcae_per_step": td["launches"][kname] // td["forwards"],
            "evaluate_ens_per_init_time":
                ev["launches"][kname] // len(ev["init_times"])}
        # the DCAE trained from tars (per run: its steps and one validation
        # batch), the temb DCAE's bf16 encode and decode at B=4, the int8
        # forecast's encode
        e["data_sources_train_dcae_launches"] = data["train_dcae"]["launches"][kname]
        e["dcae_temb_launches"] = {stage: temb["bfloat16"][stage]["launches"][kname]
                                   for stage in ("encode", "decode")}
        e["int8_forecast_launches"] = int8["forecast"]["launches"][kname]
        e["parallel_launches"] = parallel_launches(kname)
        if kname == "depthwise_conv":  # one kernel for both dtypes
            sc = next(r for r in scoring[kname]
                      if r["case"] == KERNEL_LINE_CASES[kname][0])
            e["fp32_scoring"] = {k: sc[k] for k in ("case", "B", "ms", "plain_ms",
                                                    "library_ms", "bound_ms", "bound_by",
                                                    "tflops", "bound_share")}
        summary.append(e)
    # the fp32 K4 on its path, the scorer's fp32 decode: launches per run of
    # evaluate_ens over the chain's init times, times at its B = 20
    ev = chain["evaluate_ens"]
    e = entry("dense_conv_f32", scoring["dense_conv"], ev["f32_kernel_launches"],
              KERNEL_LINE_CASES["dense_conv"][0], SCORE_BATCH, "float32")
    e["batch"] = SCORE_BATCH
    e["cuda_core_bound_ms"] = next(
        r["cuda_core_bound_ms"] for r in scoring["dense_conv"]
        if r["case"] == KERNEL_LINE_CASES["dense_conv"][0])
    e["launches_per_init_time"] = ev["f32_kernel_launches"] // len(ev["init_times"])
    e["decode_s_per_init_time"] = ev["decode_s"]
    summary.append(e)
    e = entry("flash_attention", results["flash_attention"], k6_launches, "s2250")
    e["batch"] = 2
    summary.append(e)
    print(card, flush=True)
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
