#!/usr/bin/env python3
"""Drive the PyTorch port (peclr_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the root of the repository

It needs a CUDA card and `nvcc`, and exits non-zero without printing a
result when the package is not beside it or there is no card.  Every phase prints
one JSON line that carries the card's name and power limit:

  1. device   nvidia-smi's name and power limit, torch and CUDA versions
  2. build    nvcc builds csrc/*.cu for sm_90a and the host's C++ compiler
              csrc/jpeg_decode.cc (one process per source, all started
              together)
 2a. decode   the port's own JPEG decode pool (no JPEG library linked)
              against cv2 and PIL, byte for byte: the trainer's 32 fixture
              JPEGs and an encoder matrix written here by cv2 (5 sizes x 4
              qualities x 4:2:0/4:2:2/4:4:4 x restart 0 and 3, optimized
              tables, grey), cv2 alone on two truncated files; the kinds it
              refuses (progressive, 4:1:1, 4:4:0) give None and decode_image
              gives cv2's bytes; whole batches at 1, 4 and 8 threads; the
              pool's img/s at 1, 4 and 8 threads and per core beside the
              threaded cv2 path's (scripts/bench_decode.py)
  3. kernel   each kernel against its plain PyTorch version: the grouped
              shift at the leaderboard shapes (B = 120) and at the pretrain
              recipe's and the fine-tune's (its two calls captured from one
              supervised sample), and the flat (NHWC) shift, bit for bit
              (lerp and raw mode), each on its 16-byte path, and on the
              scalar path at an unaligned view, odd row bytes and ragged
              output tails, with the path each case took and its profiler
              device time; the fused shift+matmul (f32 out within 1e-2,
              bf16 out within 1.0; zero taps exactly 0) at the pretrain
              recipe's shapes with bf16 taps and with the f32 taps of
              precision="f32" (both passes), an odd row count, rows clamped
              at both ends, dense, tent, zero and ragged taps, each with
              bf16 and f32 taps, with the mean band width the kernel walks
              (band_taps_mean), and its band pass bit-exact for both tap
              types; kernel, plain, bound and library (or grouped-route)
              times; kernels 1, 3 and 4 also on the bf16 first-pass sources
              of the all-flags augmentation (phase 10), captured from
              `augment.apply`; kernel 1 also at the accuracy proxy's shapes
              (128² uint8 canvases to 64² bf16 views, both passes, captured
              the same way); kernel 4 on float sources holding Inf and NaN
              under zero taps and in all-zero tiles, bf16 and f32 sources
              and taps at the recipe's pass-2 shapes: NaN and +-Inf where
              the plain version has them; then the step factories turn TF32
              off for a model moved to the card without resolve_device
  4. warp     affine_warp_mxu at the pred_fh geometry, kernel against plain,
              both in bf16 on the card: max abs <= 2.5 (the TPU's bound for
              the same comparison); then the pretrain geometry (256 seeded
              canvases, 224 -> 128, rotations and crops from augment.draw,
              area taps) on all three routes, each against itself on plain
              versions and against the others, the same bound; each warp's
              CUDA-event ms and its profiler device ms
  5. slice    two-pass RN50 leaderboard inference on 4 batches of 120 seeded
              frames (the last one ragged) through the kernel, with the
              lerp in the kernel and in its raw mode, in turns; launch
              counts, img/s, peak memory, the time of each stage of one
              batch; agreement with the plain path and with the CPU on a
              small input
  6. serving  InferenceSession (batch 32, 128 px) on a few requests
 6a. host_waits  the host's waits on the card, after one call of each path:
              the pretrain step (RN18, 64 -> 32, accum 2) with the recipe's
              flags and with every flag on each warp route, and on the
              matmul route in f32; the fine-tune step; one two-pass batch
              of the slice (RN50, 120 frames) and one
              InferenceSession._predict; the waits torch's sync debug mode
              reports (call sites beside them) must be none, and the host's
              time behind a busy card shows the waits torch does not report
              (required short for the paths that launch fewer kernels than
              the launch queue holds; a step fills it and blocks, with the
              call it blocked in named)
  7. pretrain the RN50 PeCLR pretrain step (microbatch 128 x accum 16, bf16
              autocast) on the warp routes in turns; img/s, ms per step,
              peak memory, launch counts (2 x accum of the route's kernel a
              step, none of the others'), where one microbatch's time goes;
              the routes' first-step losses from one state and the same
              draws within 1e-2; the card against the CPU at the dry-run
              shape (RN18, 64 -> 32, accum 2, f32): loss and BatchNorm
              running statistics within 1e-3
 7a. pretrain_f32_matmul  one RN50 recipe step at precision="f32" (TF32
              off) on the matmul route, kernel 4 with f32 taps (32
              launches), after one warm-up step, against the same step on
              the grouped route in f32 with the same draws: loss within
              1e-3 relative, ms a step, peak memory
 7b. repeat   kernels 1-4 at the recipe's shapes (kernel 1 pass 1 and 2,
              kernel 2 raw on pass 1's rows, kernel 3 pass 1, kernel 4 pass
              1 with bf16 and with f32 taps), each launched 20 times, every
              output bit-equal to the first: alone, then while a second
              process (this script re-entered with --recipe-load) runs the
              RN50 recipe step on the card, waited for until its first
              step is done; then the f32 recipe step on the matmul route
              (TF32 off) twice from one state, batch and draws: the loss,
              every gradient and every leaf module's forward output
              (integer digests of its bits) compared bit for bit and, where
              they differ, again under torch.use_deterministic_algorithms
              and cudnn.deterministic (set here only, restored after); the
              finding on a line of its own (repeat_finding)
  7c. poison  every kernel's output independent of what its buffers held:
              the repeat phase's recipe cases, ragged ones (odd row counts,
              rows and outputs off the 16-byte vector, kernel 4 with a bf16
              source, four planes, R = 97, M = 77, U = 131), the band pass
              alone and the four stream ops (bench_streams' shape and a
              ragged one, bf16 and f32), each launched as it is and then
              after the caching allocator's free blocks of the sizes it
              allocates were filled with 0x00, 0xFF (NaN in bf16 and f32, -1
              in the band scratch) and 0xA5: every buffer the wrapper
              allocates comes from the filled blocks, no filled byte
              outside them changes (a write past a buffer), the four
              outputs are equal to the bit, and the first holds to the
              plain version (bit for bit; kernel 4 within 1.0 in bf16 and
              1e-2 in f32, stats within 1e-6 of the float64 sums).
              python3 chip_smoke.py --poison runs the build and this
              phase alone
  8. trainer  first the host's JPEG codecs (the port's pool, which must be
              the decoder and link no libjpeg, cv2, PIL, the host's
              libjpeg), then the pretraining CLI (peclr_tpu_torch.cli.train)
              at the recipe (RN50, 128 x 16, LARS, bf16, 224 -> 128) for two
              epochs of one step over the committed FreiHAND-layout fixture
              (tests/fixtures/torch_freihand_like), and a named restore of
              epoch 0 that replays epoch 1; per epoch the losses, img/s, ms,
              the wait on the prefetcher, peak memory and kernel launches
              (kernel 1: 2 x 16 a step + 2 a validation batch, the others
              none); the decode path of each batch, every one the port's
              pool, and the epoch's wait on decode; top-k checkpoints, their
              bytes and save/restore ms; the replay's state as its fit
              starts equal to the bit to epoch 0's checkpoint (model,
              optimizer moments and count, step), its epoch-1 loss within
              1e-2; the initial weights the CLI draws (trainer_initial_
              weights: the stem's and the first dense layer's standard
              deviation within 5% of the reference's He-normal and
              lecun-normal, every bias 0)
  9. finetune the fine-tune step of RN25DPose (RN18, 64² crops, batch 8,
              f32) on the card against the CPU from the same weights and
              draws: loss and every BatchNorm running statistic (the z-root
              MLP's included) within 1e-3; the fine-tune CLI
              (peclr_tpu_torch.cli.finetune) at its defaults (RN50, batch
              128, 224² canvases to 128² crops, adam, f32 model, bf16 warp)
              from the trainer's epoch-0 checkpoint for two epochs of two
              steps over the same fixture: the backbone equal to the bit to
              the pretrained encoder before the first step (its initial
              draw on a line as the trainer's), per epoch the
              loss, ms a step, img/s, the wait on the prefetcher, peak
              memory, kernel 1 launched 2 a step and the others none; where
              a step's time goes (CUDA events of the sample, forward,
              backward and update; a profiled step's busy share); the
              evaluate CLI on the fine-tuned checkpoint (2 batches of 64 of
              the val split): 9 finite results, 2 launches a batch, img/s;
              evaluate() with an oracle predictor on the card within the
              reference's bounds (Mean_EPE_2D < 1e-3, Median_EPE_3D_R_V_3D <
              5e-3, AUC > 0.9); the port CLI's torchvision export of the
              trainer's checkpoint loaded strictly into a torchvision-keyed
              ResNet, its embedding equal to the encoder's within 1e-5
 10. ablation every augmentation flag the CLI takes (the recipe's, random
              crops, sobel, cut-out, blur, noise, colour drop): one RN50
              recipe step on each warp route (grouped, nhwc, matmul, gather)
              from one state, a finite loss, the route's kernel 2 x 16 times
              and no other (none on gather); the RN18 step card against CPU
              in f32 on the grouped and gather routes (loss and BatchNorm
              statistics within 1e-3); the pretraining CLI with every flag
              at the recipe for two epochs of one step over the fixture:
              per epoch the losses, img/s, ms, the wait, peak memory and
              launches (kernel 1: 2 x 16 a step + 2 a validation batch);
              where the augmentation's time goes (augment_pair with the
              recipe's flags and with every flag, each op alone).
              The kernel phase holds the first pass of this path, whose
              sources are bf16 (the f32 canvases of sobel, cut-out and blur
              in the warp's compute dtype), for kernels 1, 3 and 4
 11. ddp      data-parallel pretraining: two ranks on the card over gloo
              (spawned; NCCL refuses two ranks on one card), first the RN18
              dry-run shape in f32 (loss and BatchNorm running statistics
              within 1e-3 of one process on the card, same weights and
              draws), then the RN50 recipe step (global 128 x 16, 64 rows a
              rank, bf16, grouped route; first-step loss within 1e-2 of
              phase 7's), each with the ranks' states equal to the bit and
              kernel 1 launched 2 x accum times a step on each rank, no
              other kernel; then the pretraining CLI under
              torch.distributed.run with one rank and NCCL at the trainer
              phase's argv for one epoch more (this script re-entered with
              --ddp-cli): per epoch the losses, img/s, ms, wait, peak
              memory and launches (kernel 1: 2 x 16 a step + 2 a
              validation batch), epoch 0's loss within 1e-2 of the trainer
              phase's, rank 0's one checkpoint write an epoch; the last
              epoch profiled (busy share, top host ops, all-reduce calls,
              NCCL kernels); the host and device ms of an all-reduce and of
              a BatchNorm across ranks against a plain one; then
              dryrun_multichip(2) on the card.  The two-rank times share
              one card: not speed
 12. accuracy the accuracy path (peclr_tpu_torch/scripts): the downstream
              chain's main at the reference's widths (RN50, crop 128, batch
              64) cut in steps (24 unique frames, 8 pretrain and 8
              fine-tune steps, --freeze-encoder), all five tiers and the
              leaderboard at limit 32: the .pth round trip bit-exact and its
              row equal, the frozen backbones unchanged to the bit, finite
              losses, kernel 1 launched 2 a step, 2 an evaluate batch and 4
              a leaderboard batch, kernels 2-4 never, no host wait inside a
              pretrain or fine-tune loop; then the proxy's pretrain (RN50, 64
              px, 8 steps of 64) and one linear_probe; then the proxy's
              pretrain at RN152 at the recipe (128 x 16 of 128-px views,
              LARS) cut to 3 steps of each kind: finite losses, kernel 1
              launched 2 a microbatch, kernels 2-4 never, each step's ms
              and the PeCLR/SimCLR ratio after the first step
 12a. bench_scripts  the measurement scripts of peclr_tpu_torch/scripts,
              each main at a cut size, its artifact into a temporary
              directory: bench_serving at batches 1 and 8 (5 requests),
              bench_pred_pipeline at depths 1 and 2 over 3 batches of 128,
              bench_host_pipeline for 2 recipe steps a leg over the
              trainer's fixture tiled to 2,048 frames, profile_step of the
              recipe step and of two-pass inference (1 step, traced): the
              artifacts' keys, their accounting (trace_buckets' buckets sum
              to the kernel time, busy no more than it and within 1% of it
              on one stream, no more than the span; the device bound batch
              / busy; bound_by the slowest leg), kernel 1 launched 4 a
              two-pass batch and 32 a recipe step, none of kernels 2-4, and
              no host wait inside a timed window but the one that ends it
 12b. multichip  the multi-card and stream-rate scripts of
              peclr_tpu_torch/scripts, their artifacts into a temporary
              directory: bench_multichip's weak scaling at world 1 over NCCL
              at the RN50 recipe (128 x 16 a card, bf16) cut to one timed
              step, on the grouped, nhwc and matmul routes in one rank
              (kernels 1, 3 and 4 inside the DDP step: 2 x accum launches
              of the route's kernel a step, none of the others, the
              16-byte path), the first step's loss within 1e-4 relative of
              the same step without a mesh, which stays within 1e-5 of
              FIRST_STEP_LOSS, ms a step against it; the scaling table (RN18, f32, the
              same global batch) at meshes 1 (NCCL), 2 and 4 (gloo ranks
              sharing the card), two chained steps within 5e-5 relative of
              mesh 1; multihost_harness (two processes meeting through
              env://, gloo on one card, their own rows through a
              cuda_copier) against one process, max_rel_err < 2e-5;
              bench_streams at [256, 32, 32, 256] bf16 and f32: the four
              stream kernels of csrc/streams.cu bit-exact against their
              plain versions (bn_res_relu with a g and b drawn per
              channel; stats within 1e-6 of the float64 sum, relative to
              the sum of |x|), no share of the HBM peak above
              1.05, their eager rows and the BatchNorm's; no host wait
              inside any timed window
 12c. entry   peclr_tpu_torch.entry.entry() on the card: the RN50 bf16
              projection of its example, (8, 128) float32, finite, no host
              wait; on seeded images within 5e-2 (of the largest value) of
              the same model's f32 projection on the CPU
 12d. bench_guard  scripts/bench_guard.py's four phases (RN50 and RN152
              recipe steps, fine-tune, two-pass batch) cut to 2 iterations
              and one window: every rate, ms and busy ms finite and
              positive, kernel 1's launches counted, kernels 2-4 none; the
              band verdict printed, not checked
 13. kernels  one line listing every ported kernel and the stream kernels,
              each with its poison result (7c) and "sanitizer": null: the
              CUDA toolkit's compute-sanitizer (2025.2.1, in
              /usr/local/cuda/bin) refuses the card's host ("Device not
              supported"; PERF.md), so no phase runs it
Then the card's nvidia-smi line, and last the contract line
{"ok": true, "device": {...}}.  No weights are read (they are made from a
seed); the only data read is the trainer's fixture.

    python3 chip_smoke.py --turns    # one tree's side of a comparison

runs only what compares two trees on one card, each in its own process in
turns (turns_main: kernel 4's f32 passes, the host waits of every path, the
leaderboard's img/s, the recipe step's ms and busy share).
"""

from __future__ import annotations

import contextlib
import copy
import functools
import importlib
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
BATCH = 120
N_FRAMES = 3 * BATCH + 50  # 4 batches, the last one ragged
SLICE_REPS = 3  # runs of the main path in each shift mode, in turns
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet (700 W)
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
BF16_TC_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores
MICROBATCH, ACCUM = 128, 16  # the pretrain recipe
PRETRAIN_ROUTES = ("grouped", "matmul", "nhwc")
PRETRAIN_STEPS = {"grouped": 3, "matmul": 3, "nhwc": 1}  # timed, after 1 warm-up
#: first-step losses of the pretrain phase as PERF.md records them: the
#: routes from one seeded state with the same draws
FIRST_STEP_LOSS = {"grouped": 5.561449, "nhwc": 5.561449, "matmul": 5.561674}
TRAINER_FIXTURE = os.path.join("tests", "fixtures", "torch_freihand_like",
                               "freihand_dataset")
TRAINER_ARGV = ["--rotate", "--crop", "--color_jitter", "--resize",
                "-sources", "freihand", "-batch_size", str(MICROBATCH),
                "-accumulate_grad_batches", str(ACCUM), "-resnet_size", "50",
                "-optimizer", "LARS", "-train_ratio", "0.75",
                "-num_workers", "8", "-save_top_k", "2", "-epochs", "2"]
FINETUNE_BATCH, FINETUNE_STEPS, EVAL_BATCH, EVAL_BATCHES = 128, 2, 64, 2
#: the fine-tune CLI at its defaults (RN50, batch 128, crop 128, adam, base
#: lr 1e-4), 2 epochs of 2 steps over the trainer's fixture
FINETUNE_ARGV = ["-resnet_size", "50", "-batch_size", str(FINETUNE_BATCH),
                 "-epochs", "2", "-steps_per_epoch", str(FINETUNE_STEPS),
                 "-train_ratio", "0.75", "-num_workers", "8",
                 "-save_top_k", "2"]
EVAL_ARGV = ["-resnet_size", "50", "-batch_size", str(EVAL_BATCH),
             "-num_batches", str(EVAL_BATCHES), "-train_ratio", "0.75"]
#: every augmentation flag the CLI takes but flip (a no-op): the recipe's,
#: random crops and the five outside the recipe
ABLATION_FLAGS = ("rotate", "crop", "color_jitter", "resize", "random_crop",
                  "sobel_filter", "cut_out", "gaussian_blur",
                  "gaussian_noise", "color_drop")
ABLATION_ROUTES = ("grouped", "nhwc", "matmul", "gather")
#: the pretraining CLI at the recipe with all the flags, 2 epochs of 1 step
ABLATION_ARGV = ["--" + f for f in ABLATION_FLAGS] + [
    "-sources", "freihand", "-batch_size", str(MICROBATCH),
    "-accumulate_grad_batches", str(ACCUM), "-resnet_size", "50",
    "-optimizer", "LARS", "-train_ratio", "0.75", "-num_workers", "8",
    "-save_top_k", "1", "-epochs", "2"]
#: seconds the ddp phase's CLI run under torch.distributed.run may take
DDP_CLI_TIMEOUT_S = 600
#: the ddp phase's CLI runs the trainer phase's argv for one epoch more,
#: this last one profiled, so that epochs 0 and 1 compare unprofiled
DDP_CLI_PROFILED_EPOCH = 2
CARD = ""


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, from CUDA events around `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int):
    """Device time of fn() in ms: the card's kernel intervals in a
    torch.profiler trace of `reps` calls, summed, over reps.  Unlike
    cuda_ms it leaves out the host's time between launches, which sets the
    pace of a call shorter than its wrapper."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(spans) / reps / 1e3 if spans else None


@contextlib.contextmanager
def plain_shift():
    """Route the warp's kernels through their plain PyTorch versions (for
    the kernel-against-plain comparisons only)."""
    from peclr_tpu_torch.ops import shift_lerp, shift_lerp_matmul, warp_mxu

    kernels = (warp_mxu.fused_shift_lerp_grouped,
               warp_mxu.fused_shift_lerp_matmul, shift_lerp.fused_shift_lerp)
    warp_mxu.fused_shift_lerp_grouped = shift_lerp.shift_lerp_grouped_plain
    warp_mxu.fused_shift_lerp_matmul = shift_lerp_matmul.shift_lerp_matmul_plain
    shift_lerp.fused_shift_lerp = shift_lerp.shift_lerp_flat_plain
    try:
        yield
    finally:
        (warp_mxu.fused_shift_lerp_grouped, warp_mxu.fused_shift_lerp_matmul,
         shift_lerp.fused_shift_lerp) = kernels


def shift_paths():
    """The path (vec16 / scalar) of the last launch of kernels 1-3."""
    from peclr_tpu_torch.ops.shift_lerp import (
        fused_shift_lerp,
        fused_shift_lerp_grouped,
    )

    return {"grouped": fused_shift_lerp_grouped.last_path,
            "flat": fused_shift_lerp.last_path}


def kernel_counts():
    from peclr_tpu_torch.ops.shift_lerp import (
        fused_shift_lerp,
        fused_shift_lerp_grouped,
    )
    from peclr_tpu_torch.ops.shift_lerp_matmul import fused_shift_lerp_matmul

    return {"shift_lerp_grouped": fused_shift_lerp_grouped.launches,
            "shift_raw_grouped": fused_shift_lerp_grouped.raw_launches,
            "shift_lerp_flat": fused_shift_lerp.launches,
            "shift_lerp_matmul": fused_shift_lerp_matmul.launches}


def reset_counts() -> None:
    from peclr_tpu_torch.ops.shift_lerp import (
        fused_shift_lerp,
        fused_shift_lerp_grouped,
    )
    from peclr_tpu_torch.ops.shift_lerp_matmul import fused_shift_lerp_matmul

    fused_shift_lerp_grouped.launches = 0
    fused_shift_lerp_grouped.raw_launches = 0
    fused_shift_lerp.launches = 0
    fused_shift_lerp_matmul.launches = 0
    fused_shift_lerp_grouped.last_path = None
    fused_shift_lerp.last_path = None


# --------------------------------------------------------------------------
# phase 3: the shift kernel against its plain version


def shift_bound(rows3, k, out, out_bytes, lerp):
    """Least time (ms) for the same work on these inputs: each source byte
    that some tap reaches read once (a clamped row reads none), k and f read
    once, each output written once, 3 f32 operations per lerped output."""
    g, n, w = rows3.shape
    taps = out + 1 if lerp else out
    kk = k.long()
    reached = (kk + taps).clamp(0, w) - kk.clamp(0, w)
    moved = (g * int(reached.sum().item()) * rows3.element_size()
             + g * n * out * out_bytes + n * 4 * (2 if lerp else 1))
    ops = 3 * g * n * out if lerp else 0
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def grid_sample_shift(rows3, offsets, out, mode):
    """One library call computing the same shift: a grid_sample of each row
    (a 1-pixel-high image of G channels) at u + offset, zeros outside;
    bilinear for the lerp, nearest at the integer shift for the raw
    window."""
    import torch
    import torch.nn.functional as F

    g, n, w = rows3.shape
    x = rows3.permute(1, 0, 2).unsqueeze(2).contiguous()  # (N, G, 1, W)
    u = torch.arange(out, device=rows3.device, dtype=torch.float32)
    gx = 2.0 * (u[None, :] + offsets[:, None]) / (w - 1) - 1.0
    grid = torch.stack([gx, torch.full_like(gx, -1.0)], dim=-1)[:, None]
    grid = grid.to(rows3.dtype)
    return lambda: F.grid_sample(x, grid, mode=mode, padding_mode="zeros",
                                 align_corners=True)


def finetune_shift_calls(torch, dev):
    """The two kernel-1 calls of one fine-tune sample at the CLI's defaults
    (128 seeded 224² canvases cropped and resized to 128², the warp in
    bf16), captured as (rows3, k, f, out, out_dtype)."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )
    from peclr_tpu_torch.data.synthetic import seeded_frames

    frames = torch.from_numpy(seeded_frames(FINETUNE_BATCH, SEED + 10)).to(dev)
    return warp_shift_calls(torch, dev, frames,
                            AugmentationFlags(crop=True, resize=True),
                            AugmentationParams(), SEED + 11, "a fine-tune")


def proxy_shift_calls(torch, dev):
    """The two kernel-1 calls of one microbatch of the accuracy proxy's
    pretraining (its 64 frames doubled: 128 of its 128² canvases to 64²
    views, the recipe's flags, bf16), captured as in finetune_shift_calls."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )
    from peclr_tpu_torch.scripts.accuracy_proxy import render_batch

    imgs, _ = render_batch(np.random.default_rng(SEED + 30), 2 * 64)
    return warp_shift_calls(
        torch, dev, torch.from_numpy(imgs).to(dev),
        AugmentationFlags(crop=True, rotate=True, resize=True,
                          color_jitter=True),
        AugmentationParams(resize_shape=(64, 64)), SEED + 31,
        "an accuracy-proxy")


def warp_shift_calls(torch, dev, frames, flags, params, seed, what):
    """The kernel-1 calls of one augment.apply of `frames` (uint8 canvases
    on the card) with draws from `seed`, captured as (rows3, k, f, out,
    out_dtype); there must be two."""
    from peclr_tpu_torch.ops import augment, warp_mxu
    from peclr_tpu_torch.train.recipe import synthetic_pretrain_batch

    n, canvas = frames.shape[0], frames.shape[1]
    joints = synthetic_pretrain_batch(n, canvas, seed, device=dev)["joints25d"]
    draws = augment.draw(torch.Generator(device=dev).manual_seed(seed + 1),
                         n, flags, params)
    calls = []
    real = warp_mxu.fused_shift_lerp_grouped

    def capture(rows3, k, f, out_elems, out_dtype=None, lerp=True):
        calls.append((rows3.clone(), k.clone(), f.clone(), out_elems,
                      out_dtype))
        return real(rows3, k, f, out_elems, out_dtype, lerp)

    warp_mxu.fused_shift_lerp_grouped = capture
    try:
        augment.apply(frames, joints, draws, flags, params)
    finally:
        warp_mxu.fused_shift_lerp_grouped = real
    check(len(calls) == 2, f"{what} sample made {len(calls)} kernel-1 "
          "calls, want 2")
    return calls


def ablation_flags():
    from peclr_tpu_torch.config.defaults import AugmentationFlags

    return AugmentationFlags(**{f: True for f in ABLATION_FLAGS})


def ablation_pass1_call(torch, dev, route):
    """The first-pass kernel call of the warp on `route` in one augmentation
    of the recipe's doubled microbatch (256 seeded 224² canvases to 128²,
    bf16) with every flag on: sobel, cut-out and blur turn the canvases f32,
    so the pass reads bf16 sources.  Returns the call's (args, kwargs)."""
    from peclr_tpu_torch.config.defaults import AugmentationParams
    from peclr_tpu_torch.data.synthetic import seeded_frames
    from peclr_tpu_torch.ops import augment, shift_lerp, warp_mxu
    from peclr_tpu_torch.train.recipe import synthetic_pretrain_batch

    module, name = {"grouped": (warp_mxu, "fused_shift_lerp_grouped"),
                    "nhwc": (shift_lerp, "fused_shift_lerp"),
                    "matmul": (warp_mxu, "fused_shift_lerp_matmul")}[route]
    n, params = 2 * MICROBATCH, AugmentationParams()
    frames = torch.from_numpy(seeded_frames(n, SEED + 14)).to(dev)
    joints = synthetic_pretrain_batch(n, 224, SEED + 15, device=dev)["joints25d"]
    draws = augment.draw(torch.Generator(device=dev).manual_seed(SEED + 16),
                         n, ablation_flags(), params)
    calls = []
    real = getattr(module, name)

    def capture(*args, **kwargs):
        calls.append((tuple(a.clone() if torch.is_tensor(a) else a
                            for a in args), dict(kwargs)))
        return real(*args, **kwargs)

    # the flat kernel counts its launches on its module's name, which is
    # `capture` meanwhile: give it the counters and hand them back
    functools.update_wrapper(capture, real)
    setattr(module, name, capture)
    try:
        augment.apply(frames, joints, draws, ablation_flags(), params,
                      route=route)
    finally:
        setattr(module, name, real)
        real.__dict__.update(capture.__dict__)
    check(len(calls) == 2, f"an all-flags {route} warp made {len(calls)} "
          "kernel calls, want 2")
    args, kwargs = calls[0]
    check(args[0].dtype == torch.bfloat16, f"all-flags {route} pass 1 read "
          f"{args[0].dtype}, want bf16")
    return args, kwargs


def phase_kernel(torch, dev):
    """Kernels 1 and 2 (the grouped shift, lerp and raw mode) bit for bit
    against the plain version.  The leaderboard's, the pretrain recipe's and
    the fine-tune's cases must take the 16-byte path; an unaligned view,
    W = 130 and ragged output tails (out = 100, 129) the scalar one; the
    accuracy proxy's (128² canvases to 64² views) record the path they
    take."""
    from peclr_tpu_torch.ops.shift_lerp import (
        fused_shift_lerp_grouped,
        shift_lerp_grouped_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_main = BATCH * 224
    out = 768
    results = []

    def offsets(n, lo, hi):
        return torch.rand(n, generator=gen, device=dev) * (hi - lo) + lo

    u8 = torch.randint(0, 256, (3, n_main, 224), generator=gen, device=dev,
                       dtype=torch.uint8)
    bf = (torch.rand((3, n_main, 224), generator=gen, device=dev) * 255).to(
        torch.bfloat16)
    odd = torch.randint(0, 256, (3, 1001, 224), generator=gen, device=dev,
                        dtype=torch.uint8)
    # the same rows one byte into a buffer, and rows of 130 bytes
    spare = torch.randint(0, 256, (3 * 1001 * 224 + 1,), generator=gen,
                          device=dev, dtype=torch.uint8)
    unaligned = spare[1:].view(3, 1001, 224)
    w130 = torch.randint(0, 256, (3, 1001, 130), generator=gen, device=dev,
                         dtype=torch.uint8)
    # pass-1 style offsets span both clamps: k < -(out + 2) and k > W
    wide = offsets(n_main, -(out + 40.0), 224 + 40.0)
    clamped = torch.cat([offsets(n_main // 2, -5000.0, -(out + 3.0)),
                         offsets(n_main - n_main // 2, 225.0, 5000.0)])
    # the grouped route's shapes in the pretrain recipe (2B = 256 canvases)
    n1, n2 = 2 * MICROBATCH * 224, 2 * MICROBATCH * 128
    pre_u8 = torch.randint(0, 256, (3, n1, 224), generator=gen, device=dev,
                           dtype=torch.uint8)
    pre_bf = (torch.rand((3, n2, 224), generator=gen, device=dev) * 255).to(
        torch.bfloat16)
    vec, scalar = "vec16", "scalar"
    # the fine-tune's two calls as its main path makes them: (k, f) given
    (ft1, k1, f1, out1, dt1), (ft2, k2, f2, out2, dt2) = finetune_shift_calls(
        torch, dev)
    # the accuracy proxy's two calls (128² canvases to 64² views)
    (px1, kp1, fp1, outp1, dtp1), (px2, kp2, fp2, outp2, dtp2) = (
        proxy_shift_calls(torch, dev))
    # the all-flags pass 1 (bf16 sources) as the pretrain step makes it
    (ab, ka, fa, outa), kwa = ablation_pass1_call(torch, dev, "grouped")
    cases = [
        ("pass1_u8_to_bf16", True, u8, wide, torch.bfloat16, out, vec),
        ("pass1_u8_to_f32", True, u8, wide, torch.float32, out, vec),
        ("pass2_bf16_to_bf16", True, bf, wide, torch.bfloat16, out, vec),
        ("odd_n_1001_u8_to_bf16", True, odd, offsets(1001, -800.0, 260.0),
         torch.bfloat16, out, vec),
        ("clamped_rows_u8_to_f32", True, u8, clamped, torch.float32, out, vec),
        ("pretrain_pass1_u8_to_bf16", True, pre_u8,
         offsets(n1, -424.0, 264.0), torch.bfloat16, 384, vec),
        ("pretrain_pass2_bf16_to_bf16", True, pre_bf,
         offsets(n2, -296.0, 264.0), torch.bfloat16, 256, vec),
        ("finetune_pass1_u8_to_bf16", True, ft1, (k1, f1), dt1, out1, vec),
        ("finetune_pass2_bf16_to_bf16", True, ft2, (k2, f2), dt2, out2, vec),
        ("ablation_pass1_bf16_to_bf16", True, ab, (ka, fa),
         kwa["out_dtype"], outa, vec),
        ("proxy_pass1_u8_to_bf16", True, px1, (kp1, fp1), dtp1, outp1, None),
        ("proxy_pass2_bf16_to_bf16", True, px2, (kp2, fp2), dtp2, outp2,
         None),
        ("unaligned_view_u8_to_bf16", True, unaligned,
         offsets(1001, -800.0, 260.0), torch.bfloat16, out, scalar),
        ("odd_w_130_u8_to_bf16", True, w130, offsets(1001, -800.0, 170.0),
         torch.bfloat16, out, scalar),
        ("ragged_out_100_u8_to_bf16", True, odd, offsets(1001, -130.0, 250.0),
         torch.bfloat16, 100, scalar),
        ("ragged_out_129_bf16_to_f32", True, odd.to(torch.bfloat16),
         offsets(1001, -160.0, 250.0), torch.float32, 129, scalar),
        ("raw_pass1_u8", False, u8, wide, None, out, vec),
        ("raw_pass2_bf16", False, bf, wide, None, out, vec),
        ("raw_clamped_u8", False, u8, clamped, None, out, vec),
        ("raw_unaligned_view_u8", False, unaligned,
         offsets(1001, -800.0, 260.0), None, out, scalar),
        ("raw_ragged_out_129_u8", False, odd, offsets(1001, -160.0, 250.0),
         None, 129, scalar),
    ]
    for name, lerp, rows3, off, out_dtype, out, want_path in cases:
        if isinstance(off, tuple):  # a captured call's own k and f
            k, f = off
            off = k.float() + f
        else:
            k_true = torch.floor(off)
            k = k_true.clamp(-(out + 2), rows3.shape[2]).to(torch.int32)
            f = (off - k_true).to(torch.float32)
        fv = f if lerp else None

        def kern():
            return fused_shift_lerp_grouped(rows3, k, fv, out, out_dtype, lerp)

        def plain():
            return shift_lerp_grouped_plain(rows3, k, fv, out, out_dtype, lerp)

        got, ref = kern(), plain()
        torch.cuda.synchronize()
        path = fused_shift_lerp_grouped.last_path
        check(want_path in (None, path), f"{name}: took the {path} path, "
              f"want {want_path}")
        check(torch.equal(got, ref), f"{name}: not bit-exact")
        max_abs = (got.float() - ref.float()).abs().max().item()
        if "clamped" in name:
            check(got.abs().max().item() == 0, f"{name}: clamped rows not zero")
        g, n, w = rows3.shape
        bound, bound_by = shift_bound(rows3, k, out, got.element_size(), lerp)
        library_ms = None  # grid_sample takes no uint8, nor mixed types
        if rows3.dtype != torch.uint8 and got.dtype == rows3.dtype:
            library_ms = cuda_ms(grid_sample_shift(
                rows3, off if lerp else k.float(), out,
                "bilinear" if lerp else "nearest"), 10)
        row = {
            "case": name, "shape_in": [g, n, w], "out": out,
            "in_dtype": str(rows3.dtype), "out_dtype": str(got.dtype),
            "lerp": lerp, "path": path, "max_abs": max_abs, "tolerance": 0.0,
            "ms": cuda_ms(kern, 20), "device_ms": device_ms(kern, 10),
            "plain_ms": cuda_ms(plain, 5),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
        }
        results.append(row)
        emit("kernel", **row)
    return results


def flat_bound(rows, k, out_elems, c, out_bytes):
    """Least time (ms) of the flat shift on these inputs: each source
    element that some tap reaches read once, k and f once, each output
    written once, 3 f32 operations per output."""
    n, w = rows.shape
    kk = k.long().clamp(-(out_elems // c + 2), w // c) * c
    reached = (kk + out_elems + c).clamp(0, w) - kk.clamp(0, w)
    moved = (int(reached.sum().item()) * rows.element_size()
             + n * out_elems * out_bytes + n * 8)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = 3 * n * out_elems / F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_flat_kernel(torch, dev):
    """Kernel 3 at the NHWC route's shapes of the pretrain recipe (2B = 256
    canvases of 224 x 3): pass 1 (57,344 rows of 672 uint8 -> 1,152 bf16),
    pass 2 (32,768 rows of 672 bf16 -> 768 bf16), on the 16-byte path; then
    the scalar path at an unaligned view, W = 130 pixels and a ragged tail
    (out = 129 pixels).  Bit for bit against the plain version."""
    import torch.nn.functional as F

    from peclr_tpu_torch.ops.shift_lerp import (
        fused_shift_lerp,
        shift_lerp_flat_plain,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    c, w_px = 3, 224
    n1, n2 = 2 * MICROBATCH * 224, 2 * MICROBATCH * 128

    def offsets(n, lo, hi):
        return torch.rand(n, generator=gen, device=dev) * (hi - lo) + lo

    def rows_of(n, dtype):
        x = torch.rand((n, w_px * c), generator=gen, device=dev) * 255
        return x.to(dtype) if dtype != torch.uint8 else x.floor().to(dtype)

    u8, bf, odd = (rows_of(n1, torch.uint8), rows_of(n2, torch.bfloat16),
                   rows_of(1001, torch.uint8))
    # the rows of `odd`'s shape one byte into a buffer
    unaligned = rows_of(1002, torch.uint8).view(-1)[1:1 + 1001 * w_px * c]
    unaligned = unaligned.view(1001, w_px * c)
    w130 = torch.randint(0, 256, (1001, 130 * c), generator=gen, device=dev,
                         dtype=torch.uint8)
    clamped = torch.cat([offsets(n1 // 2, -5000.0, -(384 + 3.0)),
                         offsets(n1 - n1 // 2, w_px + 1.0, 5000.0)])
    vec, scalar = "vec16", "scalar"
    # the all-flags pass 1 (bf16 sources) as the pretrain step makes it
    (ab, ka, fa, outa, ca), kwa = ablation_pass1_call(torch, dev, "nhwc")
    check(ca == c, f"the nhwc route's pass 1 has {ca} channels")
    cases = [
        ("flat_pass1_u8_to_bf16", u8, 384, offsets(n1, -424.0, 264.0),
         torch.bfloat16, vec),
        ("flat_pass1_u8_to_f32", u8, 384, offsets(n1, -424.0, 264.0),
         torch.float32, vec),
        ("flat_pass2_bf16_to_bf16", bf, 256, offsets(n2, -296.0, 264.0),
         torch.bfloat16, vec),
        ("flat_odd_n_1001_u8_to_bf16", odd, 384, offsets(1001, -424.0, 264.0),
         torch.bfloat16, vec),
        ("flat_clamped_rows_u8_to_f32", u8, 384, clamped, torch.float32, vec),
        ("flat_ablation_pass1_bf16_to_bf16", ab, outa // c, (ka, fa),
         kwa["out_dtype"], vec),
        ("flat_unaligned_view_u8_to_bf16", unaligned, 384,
         offsets(1001, -424.0, 264.0), torch.bfloat16, scalar),
        ("flat_odd_w_130_u8_to_bf16", w130, 384, offsets(1001, -424.0, 170.0),
         torch.bfloat16, scalar),
        ("flat_ragged_out_129_u8_to_bf16", odd, 129,
         offsets(1001, -160.0, 250.0), torch.bfloat16, scalar),
    ]
    results = []
    for name, rows, out_w, off, out_dtype, want_path in cases:
        if isinstance(off, tuple):  # a captured call's own k and f
            k, f = off
            off = k.float() + f
        else:
            k_true = torch.floor(off)
            k = k_true.clamp(-(out_w + 2), rows.shape[1] // c).to(torch.int32)
            f = (off - k_true).to(torch.float32)
        out_elems = out_w * c

        def kern():
            return fused_shift_lerp(rows, k, f, out_elems, c, out_dtype)

        def plain():
            return shift_lerp_flat_plain(rows, k, f, out_elems, c, out_dtype)

        got, ref = kern(), plain()
        torch.cuda.synchronize()
        path = fused_shift_lerp.last_path
        check(path == want_path, f"{name}: took the {path} path, want "
              f"{want_path}")
        check(torch.equal(got, ref), f"{name}: not bit-exact")
        max_abs = (got.float() - ref.float()).abs().max().item()
        if name.startswith("flat_clamped"):
            check(got.abs().max().item() == 0, f"{name}: clamped rows not zero")
        bound, bound_by = flat_bound(rows, k, out_elems, c, got.element_size())
        library_ms = None  # grid_sample takes no uint8, nor mixed types
        if rows.dtype == got.dtype == torch.bfloat16:
            # one grid_sample of each row as a 1-pixel-high C-channel image
            planes = rows.view(-1, w_px, c).permute(0, 2, 1).contiguous()
            library_ms = cuda_ms(grid_sample_shift(
                planes.permute(1, 0, 2), off, out_w, "bilinear"), 10)
        row = {
            "case": name, "shape_in": list(rows.shape), "c": c,
            "out_elems": out_elems, "in_dtype": str(rows.dtype),
            "out_dtype": str(got.dtype), "path": path, "max_abs": max_abs,
            "tolerance": 0.0, "ms": cuda_ms(kern, 20),
            "device_ms": device_ms(kern, 10), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
        }
        results.append(row)
        emit("kernel", **row)
    return results


def matmul_bound(rows4, k, w_t, out):
    """Least time (ms) of the fused shift+matmul on these inputs: the taps,
    k and f read once, each output written once, and of the source only the
    elements that the taps of this run's data need: for image b with
    nonzero taps in [lo_b, hi_b) (over all of M), window taps u in that
    range, which read source k + u and k + u + 1 (none where every tap is
    zero); the multiply-adds of the taps that are not zero, on the tensor
    cores for bf16 taps, plus 3 f32 operations per needed window element."""
    import torch

    from peclr_tpu_torch.ops.shift_lerp_matmul import tap_band_plain

    g, b, r, w = rows4.shape
    _, m, u = w_t.shape
    band = tap_band_plain(w_t, max(m, 1))[:, 0].long()  # (B, 2) over all M
    lo, hi = band[:, :1], band[:, 1:]
    kk = k.long().clamp(-(u + 2), w).view(b, r)
    reached = (kk + hi + 1).clamp(0, w) - (kk + lo).clamp(0, w)
    reached = torch.where(hi > lo, reached, 0)
    moved = (g * int(reached.sum().item()) * rows4.element_size()
             + w_t.numel() * w_t.element_size()
             + out.numel() * out.element_size() + b * r * 8)
    nonzero = int((w_t != 0).sum().item())
    lerped = g * r * int((hi - lo).sum().item())
    mac_rate = BF16_TC_FLOPS if w_t.dtype == torch.bfloat16 else F32_FLOPS
    ops_ms = (2 * g * r * nonzero / mac_rate + 3 * lerped / F32_FLOPS) * 1e3
    dense_ms = 2 * g * b * r * m * u / mac_rate * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    bound = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    return bound + (dense_ms, moved)


#: outputs a band tile covers and the step its walk is rounded out to, for
#: bf16 and f32 taps (csrc/shift_lerp_matmul.cu: kBandM and kDepth, kF32TileM
#: and the 4 taps of a 16-byte load; the kernel phase holds them to the
#: wrapper's BAND_M and BAND_M_F32)
BAND_WALK = {"torch.bfloat16": (32, 16), "torch.float32": (8, 4)}


def rounded_band_mean(w_t) -> float:
    """Mean width of the bands the kernel walks for these taps: each tile's
    band (tap_band_plain at the taps' tile), lo rounded down and hi up to
    the walk's step, hi at most U rounded up, an empty band empty."""
    from peclr_tpu_torch.ops.shift_lerp_matmul import tap_band_plain

    tile, step = BAND_WALK[str(w_t.dtype)]
    u = w_t.shape[2]
    band = tap_band_plain(w_t, tile)
    lo, hi = band[..., 0].long(), band[..., 1].long()
    lo_r = lo // step * step
    hi_r = (-(-hi // step) * step).clamp(max=-(-u // step) * step)
    return (hi_r - lo_r).where(hi > lo, 0).double().mean().item()


def matmul_row(torch, name, rows4, k, f, w_t, out_dtype, tol):
    """Kernel 4 on one case against its plain version (max_abs <= tol,
    finite; exactly 0 for the clamped and zero cases), timed beside its
    bound, the plain version and the grouped route for the same pass
    (kernel 1 then torch.matmul, the yardstick of whether fusing pays),
    with the mean width of the bands it walks."""
    from peclr_tpu_torch.ops.shift_lerp import fused_shift_lerp_grouped
    from peclr_tpu_torch.ops.shift_lerp_matmul import (
        fused_shift_lerp_matmul,
        shift_lerp_matmul_plain,
    )

    g, nb, r, w = rows4.shape
    u = w_t.shape[2]

    def kern():
        return fused_shift_lerp_matmul(rows4, k, f, w_t, out_dtype)

    def plain():
        return shift_lerp_matmul_plain(rows4, k, f, w_t, out_dtype)

    def grouped_route():
        win = fused_shift_lerp_grouped(rows4.view(g, nb * r, w), k, f, u,
                                       out_dtype=w_t.dtype)
        win = win.view(g, nb, r, u).transpose(-1, -2)
        if out_dtype == torch.float32:
            return torch.matmul(w_t.float(), win.float())
        return torch.matmul(w_t, win)

    got, ref = kern(), plain()
    torch.cuda.synchronize()
    max_abs = (got.float() - ref.float()).abs().max().item()
    check(max_abs <= tol, f"{name}: max_abs {max_abs} > {tol}")
    check(bool(torch.isfinite(got).all()), f"{name}: not finite")
    if name.startswith(("matmul_clamped", "matmul_zero")):
        check(got.abs().max().item() == 0, f"{name}: output not zero")
    (bound, bound_by, dense_ms, moved) = matmul_bound(rows4, k, w_t, got)
    row = {
        "case": name, "shape_in": list(rows4.shape),
        "taps": list(w_t.shape), "in_dtype": str(rows4.dtype),
        "taps_dtype": str(w_t.dtype), "out_dtype": str(got.dtype),
        "max_abs": max_abs, "tolerance": tol,
        "ms": cuda_ms(kern, 20), "device_ms": device_ms(kern, 10),
        "plain_ms": cuda_ms(plain, 3),
        "bound_ms": bound, "bound_by": bound_by, "bytes_moved": moved,
        "dense_taps_ops_ms": dense_ms,
        "library_ms": None,  # no one PyTorch call shifts, lerps and multiplies
        "grouped_route_ms": cuda_ms(grouped_route, 10),
        "band_taps_mean": rounded_band_mean(w_t),
    }
    emit("kernel", **row)
    return row


def matmul_inputs(torch, dev, seed):
    """Seeded inputs of kernel 4 at the matmul route's shapes of the
    pretrain recipe (2B = 256 canvases): uniform(shape, lo, hi), taps(nb, u,
    m, slopes, dtype, matrix), rows_of(shape, dtype) and shifts(off, u, w)
    -> (k, f)."""
    from peclr_tpu_torch.ops.warp_mxu import _area_matrix

    gen = torch.Generator(device=dev).manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def taps(nb, u, m, lo, hi, dtype, matrix=_area_matrix):
        return matrix(uniform(nb, lo, hi), u, m, transposed=True).to(dtype)

    def rows_of(shape, dtype):
        x = uniform(shape, 0, 255)
        return x.floor().to(dtype) if dtype == torch.uint8 else x.to(dtype)

    def shifts(off, u, w):
        k_true = torch.floor(off)
        return (k_true.clamp(-(u + 2), w).to(torch.int32),
                (off - k_true).to(torch.float32))

    return uniform, taps, rows_of, shifts


def f32_pass_cases(torch, dev):
    """Kernel 4's f32-tap calls of precision="f32" at the recipe's shapes:
    pass 1, (3, 256, 224, 224) uint8 with area taps (256, 128, 384) at
    slopes 1.0-2.5 -> f32; pass 2, (3, 256, 128, 224) f32 with taps (256,
    128, 256) at slopes 1.0-1.75 -> f32."""
    uniform, taps, rows_of, shifts = matmul_inputs(torch, dev, SEED + 23)
    b = 2 * MICROBATCH
    p1 = rows_of((3, b, 224, 224), torch.uint8)
    p2 = rows_of((3, b, 128, 224), torch.float32)
    k1, f1 = shifts(uniform(b * 224, -424.0, 264.0), 384, 224)
    k2, f2 = shifts(uniform(b * 128, -296.0, 264.0), 256, 224)
    return [
        ("matmul_pass1_f32_taps_u8_to_f32", p1, k1, f1,
         taps(b, 384, 128, 1.0, 2.5, torch.float32), torch.float32, 1e-2),
        ("matmul_pass2_f32_taps_to_f32", p2, k2, f2,
         taps(b, 256, 128, 1.0, 1.75, torch.float32), torch.float32, 1e-2),
    ]


def phase_matmul_kernel(torch, dev):
    """Kernel 4 at the matmul route's shapes of the pretrain recipe, with
    area tap matrices of the recipe's slopes, bf16 taps: pass 1 (3, 256,
    224, 224) uint8, taps (256, 128, 384) -> (3, 256, 128, 224) bf16; pass 2
    (3, 256, 128, 224) bf16, taps (256, 128, 256) -> (3, 256, 128, 128) f32;
    and the same passes with the f32 taps of precision="f32"; an odd row
    count; clamped rows; dense taps (the band is all of U: the worst case);
    tent taps of an upscale; all-zero taps; U = 100 and M = 72 (scalar tap
    staging, ragged tiles): each case with bf16 and with f32 taps (matmul_row
    has what each row holds).  Then the band pass alone against its plain
    version, bit-exact, at the pass-1 and pass-2 taps of each type."""
    from peclr_tpu_torch.ops.shift_lerp_matmul import (
        BAND_M,
        BAND_M_F32,
        tap_band,
        tap_band_plain,
    )
    from peclr_tpu_torch.ops.warp_mxu import _tent_matrix

    check(BAND_WALK == {"torch.bfloat16": (BAND_M, 16),
                        "torch.float32": (BAND_M_F32, 4)},
          f"BAND_WALK {BAND_WALK} is not the kernel's tiles")
    uniform, taps, rows_of, shifts = matmul_inputs(torch, dev, SEED + 11)
    b = 2 * MICROBATCH
    p1 = rows_of((3, b, 224, 224), torch.uint8)
    p2 = rows_of((3, b, 128, 224), torch.bfloat16)
    odd = rows_of((3, 4, 1001, 224), torch.uint8)
    ragged = rows_of((3, 64, 130, 224), torch.uint8)
    n1 = b * 224
    clamped = torch.cat([uniform(n1 // 2, -5000.0, -(384 + 3.0)),
                         uniform(n1 - n1 // 2, 225.0, 5000.0)])
    dense = uniform((b, 128, 384), 0.0, 1.0)  # nonzero everywhere, rows sum to 1
    dense = dense / dense.sum(dim=2, keepdim=True)
    pass1_taps = taps(b, 384, 128, 1.0, 2.5, torch.float32)
    pass2_taps = taps(b, 256, 128, 1.0, 1.75, torch.float32)
    # the all-flags pass 1 (bf16 sources) as the pretrain step makes it
    (ab, ka, fa, wa), kwa = ablation_pass1_call(torch, dev, "matmul")
    k1, f1 = shifts(uniform(n1, -424.0, 264.0), 384, 224)
    k2, f2 = shifts(uniform(b * 128, -296.0, 264.0), 256, 224)
    ko, fo = shifts(uniform(4 * 1001, -424.0, 264.0), 384, 224)
    kc, fc = shifts(clamped, 384, 224)
    kr, fr = shifts(uniform(64 * 130, -140.0, 264.0), 100, 224)
    odd_taps = taps(4, 384, 128, 1.0, 2.5, torch.float32)
    tent = taps(b, 384, 128, 0.5, 1.0, torch.float32, _tent_matrix)
    zero = torch.zeros((b, 128, 384), device=dev)
    ragged_taps = taps(64, 100, 72, 1.0, 1.35, torch.float32)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("matmul_ablation_pass1_bf16_to_bf16", ab, ka, fa, wa,
         kwa["out_dtype"], 1.0),
        ("matmul_pass1_u8_to_bf16", p1, k1, f1, pass1_taps.to(bf16), bf16, 1.0),
        ("matmul_pass2_bf16_to_f32", p2, k2, f2, pass2_taps.to(bf16), f32,
         1e-2),
    ]
    for suffix, dtype in (("", bf16), ("_f32_taps", f32)):
        cases += [
            (f"matmul_odd_r_1001{suffix}_u8_to_f32", odd, ko, fo,
             odd_taps.to(dtype), f32, 1e-2),
            (f"matmul_clamped_rows{suffix}_u8_to_f32", p1, kc, fc,
             pass1_taps.to(dtype), f32, 1e-2),
            (f"matmul_pass1_dense_taps{suffix}_u8_to_bf16", p1, k1, f1,
             dense.to(dtype), bf16, 1.0),
            (f"matmul_pass1_tent_taps{suffix}_u8_to_bf16", p1, k1, f1,
             tent.to(dtype), bf16, 1.0),
            (f"matmul_zero_taps{suffix}_u8_to_f32", p1, k1, f1, zero.to(dtype),
             f32, 1e-2),
            (f"matmul_ragged_u100_m72{suffix}", ragged, kr, fr,
             ragged_taps.to(dtype), f32, 1e-2),
        ]
    cases += f32_pass_cases(torch, dev)
    results = [matmul_row(torch, *case) for case in cases]

    # the band pass alone: bit-exact; bound by reading the taps once.  It is
    # timed in turns over copies of the taps that together outgrow the
    # card's 50 MB L2, so that each call reads its taps from HBM.
    for name, w_t in (("tap_band_pass1", pass1_taps.to(bf16)),
                      ("tap_band_pass2", pass2_taps.to(bf16)),
                      ("tap_band_pass1_f32", pass1_taps),
                      ("tap_band_pass2_f32", pass2_taps)):
        got = tap_band(w_t)
        ref = tap_band_plain(w_t, BAND_WALK[str(w_t.dtype)][0])
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"{name}: band not bit-exact")
        moved = w_t.numel() * w_t.element_size() + got.numel() * 4
        nbytes = w_t.numel() * w_t.element_size()
        copies = [w_t.clone() for _ in range(-(-150_000_000 // nbytes))]
        turn = itertools.cycle(copies)

        def band_in_turns():
            return tap_band(next(turn))

        row = {
            "case": name, "taps": list(w_t.shape), "taps_dtype": str(w_t.dtype),
            "max_abs": (got - ref).abs().max().item(), "tolerance": 0,
            "taps_copies": len(copies),
            "ms": cuda_ms(band_in_turns, 20),
            "device_ms": device_ms(band_in_turns, 20),
            "plain_ms": cuda_ms(lambda: tap_band_plain(
                w_t, BAND_WALK[str(w_t.dtype)][0]), 5),
            "bound_ms": moved / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None,
        }
        del copies
        results.append(row)
        emit("kernel", **row)
    return results


def phase_recipe_warp(torch, dev):
    """The pretrain warp on all three routes: 256 seeded canvases, 224 ->
    128, rotations and crops drawn by augment.draw, area taps, bf16."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.data.synthetic import seeded_frames
    from peclr_tpu_torch.ops import augment
    from peclr_tpu_torch.ops.warp_mxu import ROUTES, affine_warp_mxu
    from peclr_tpu_torch.train.recipe import synthetic_pretrain_batch

    n = 2 * MICROBATCH
    flags, params = peclr_pretrain_flags(), AugmentationParams()
    frames = torch.from_numpy(seeded_frames(n, SEED + 4)).to(dev)
    joints = synthetic_pretrain_batch(n, 224, SEED + 5, device=dev)["joints25d"]
    draws = augment.draw(torch.Generator(device=dev).manual_seed(SEED + 6), n,
                         flags, params)
    matrix = augment.apply(frames, joints, draws, flags, params,
                           force_crop=True).matrix
    sx, sy = augment._warp_window_bounds((224, 224), (128, 128), params, True)
    outs, rows = {}, {}
    for route in ROUTES:
        def warp(route=route):
            return affine_warp_mxu(frames, matrix, (128, 128), interp="area",
                                   max_scale_x=sx, max_scale_y=sy,
                                   route=route)

        got = warp()
        with plain_shift():
            ref = warp()
            plain_ms = cuda_ms(warp, 3)
        torch.cuda.synchronize()
        check(got.dtype == torch.float32 and got.shape == (n, 128, 128, 3),
              f"recipe warp {route}: output shape/dtype")
        max_abs = (got - ref).abs().max().item()
        check(max_abs <= 2.5, f"recipe warp {route}: kernel vs plain "
              f"max_abs {max_abs} > 2.5")
        outs[route] = got
        rows[route] = {"max_abs_vs_plain": max_abs, "ms": cuda_ms(warp, 10),
                       "device_ms": device_ms(warp, 5), "plain_ms": plain_ms}
    for route in ROUTES:
        cross = (outs[route] - outs["grouped"]).abs().max().item()
        check(cross <= 2.5, f"recipe warp {route} vs grouped: {cross} > 2.5")
        rows[route]["max_abs_vs_grouped"] = cross
    emit("warp", geometry="pretrain", batch=n, out_hw=[128, 128],
         interp="area", compute_dtype="bfloat16", windows=[sx, sy],
         tolerance=2.5, routes=rows)


def microbatch_breakdown(torch, model, opt, batch, draws, route):
    """CUDA-event times of one microbatch of the step (augment, forward,
    backward), then the optimizer update, mirroring train/step.py."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.losses.equivariance import peclr_projections
    from peclr_tpu_torch.losses.ntxent import ntxent_loss
    from peclr_tpu_torch.ops.augment import augment_pair

    flags = peclr_pretrain_flags()
    mb = MICROBATCH
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    model.train()
    opt.zero_grad(set_to_none=True)
    ev[0].record()
    v1, v2 = augment_pair(None, batch["image"][:mb], batch["joints25d"][:mb],
                          flags, AugmentationParams(), draws=draws,
                          route=route, compute_dtype=torch.bfloat16)
    ev[1].record()
    with torch.autocast("cuda", dtype=torch.bfloat16):
        proj = model(torch.cat([v1.images, v2.images]))["projection"]
    z1, z2 = peclr_projections(proj[:mb], proj[mb:], v1.params, v2.params,
                               augmentations=flags.active())
    loss = ntxent_loss(z1, z2)
    ev[2].record()
    (loss / ACCUM).backward()
    ev[3].record()
    opt.step()
    ev[4].record()
    torch.cuda.synchronize()
    names = ("augment", "forward", "backward", "update")
    return {n: ev[i].elapsed_time(ev[i + 1]) for i, n in enumerate(names)}


def host_op_times(host) -> dict:
    """{name: [calls, self ms, total ms]} of the host's spans
    (trace_buckets.spans_of_profile): a span's self time is its own less
    its direct children's on the same thread, as key_averages counts it,
    without the profiler's slow event tree."""
    times = {}
    by_thread = {}
    for s in host:
        by_thread.setdefault(s.stream, []).append(s)
    for spans in by_thread.values():
        stack = []  # [span, time of its direct children]
        for s in sorted(spans, key=lambda s: (s.start_us, -s.end_us)):
            while stack and stack[-1][0].end_us <= s.start_us:
                _close(stack.pop(), times)
            if stack:
                stack[-1][1] += s.end_us - s.start_us
            stack.append([s, 0.0])
        while stack:
            _close(stack.pop(), times)
    return times


def _close(entry, times) -> None:
    s, children = entry
    total = (s.end_us - s.start_us) / 1e3
    row = times.setdefault(s.name, [0, 0.0, 0.0])
    row[0] += 1
    row[1] += total - children / 1e3
    row[2] += total


def trace_summary(torch, prof, wall_ms: float) -> dict:
    """What a torch.profiler capture of `wall_ms` shows: the card's busy
    time (the union of its intervals, scripts/trace_buckets.py) against
    the span (the device's busy share), the kernels that take the most
    device time, the host's ops that take the most self time, and the
    collectives (c10d's all-reduce calls, their host ms; NCCL's kernels and
    device ms)."""
    from peclr_tpu_torch.scripts import trace_buckets

    device, host = trace_buckets.spans_of_profile(prof)
    if not device:
        return {"device_time": "not measured (no CUDA events)"}
    summary = trace_buckets.summarize(device, host, top_n=10)
    nccl = [s for s in device if trace_buckets.bucket(s.name, s.op) == "nccl"]
    ops = host_op_times(host)
    top_host = sorted(ops.items(), key=lambda kv: -kv[1][1])[:12]
    return {
        "profiled_wall_ms": wall_ms, "device_busy_ms": summary["busy_ms"],
        "device_busy_share": summary["busy_ms"] / wall_ms,
        "kernel_launches": len(device),
        "aten_calls": sum(n for name, (n, _, _) in ops.items()
                          if name.startswith("aten::")),
        "top_kernels_ms": {k["name"][:90]: k["ms"]
                           for k in summary["top_kernels"]},
        "top_host_self_ms": {name[:70]: [n, self_ms]
                             for name, (n, self_ms, _) in top_host},
        "allreduce_calls": {name[:70]: [n, total_ms]
                            for name, (n, _, total_ms) in ops.items()
                            if "allreduce" in name.lower()},
        "nccl_kernels": len(nccl),
        "nccl_device_ms": summary["buckets_ms"].get("nccl", 0.0),
    }


def profile_step(torch, step, state, batch, gen):
    """One step under torch.profiler (trace_summary).  The profiler slows
    the host, so the span is longer than an unprofiled step."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        metrics["loss"].item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return state, trace_summary(torch, prof, wall_ms)


def phase_pretrain(torch, dev):
    """The RN50 PeCLR pretrain step on the card, its routes in turns."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.ops import augment
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
    )
    from peclr_tpu_torch.train.step import make_peclr_train_step

    flags, params = peclr_pretrain_flags(), AugmentationParams()
    n = MICROBATCH * ACCUM
    model, state, opt = build_pretrain_state("50", batch=MICROBATCH,
                                             accum=ACCUM, device=dev)
    batch = synthetic_pretrain_batch(n, 224, SEED + 7, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    steps = {route: make_peclr_train_step(model, opt, flags, params,
                                          accum=ACCUM, warp_route=route)
             for route in PRETRAIN_ROUTES}
    kernel_of = {"grouped": "shift_lerp_grouped",
                 "matmul": "shift_lerp_matmul", "nhwc": "shift_lerp_flat"}

    # the routes from one state and the same draws (also the warm-up)
    draws = [augment.draw(gen, 2 * MICROBATCH, flags, params)
             for _ in range(ACCUM)]
    snapshot = ({k: v.clone() for k, v in model.state_dict().items()},
                copy.deepcopy(opt.state_dict()))
    first_loss = {}
    for route in PRETRAIN_ROUTES:
        model.load_state_dict(snapshot[0])
        opt.load_state_dict(snapshot[1])
        state.step = 0
        state, metrics = steps[route](state, batch, gen, draws=draws)
        first_loss[route] = metrics["loss"].item()
        check(math.isfinite(first_loss[route]), f"{route}: loss not finite")
    for route in PRETRAIN_ROUTES:
        rel = abs(first_loss[route] / first_loss["grouped"] - 1.0)
        check(rel <= 1e-2, f"first-step loss {route} vs grouped: rel {rel}")
        drift = abs(first_loss[route] - FIRST_STEP_LOSS[route])
        check(drift <= 1e-5, f"first-step loss {route} {first_loss[route]} "
              f"moved from {FIRST_STEP_LOSS[route]}")

    # the main path: each route's counts set to 0 just before its run and
    # read just after; the routes take turns
    runs = {route: [] for route in PRETRAIN_ROUTES}
    for rep in range(max(PRETRAIN_STEPS.values())):
        for route in PRETRAIN_ROUTES:
            if rep >= PRETRAIN_STEPS[route]:
                continue
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            reset_counts()
            t0 = time.perf_counter()
            state, metrics = steps[route](state, batch, gen)
            loss = metrics["loss"].item()  # synchronises
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = kernel_counts()
            check(math.isfinite(loss), f"{route}: loss not finite")
            for kname, launched in counts.items():
                want = 2 * ACCUM if kname == kernel_of[route] else 0
                check(launched == want, f"{route}: {kname} launched "
                      f"{launched} times in a step, want {want}")
            paths = shift_paths()
            if route in ("grouped", "nhwc"):
                took = paths["grouped" if route == "grouped" else "flat"]
                check(took == "vec16", f"{route}: the step's last shift took "
                      f"the {took} path, want vec16")
            runs[route].append({
                "loss": loss, "launches": counts, "paths": paths,
                "seconds": seconds,
                "ms_per_step": seconds * 1e3, "img_per_s": n / seconds,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                "allocated_before_bytes": before,
            })
    state, profiled = profile_step(torch, steps["grouped"], state, batch, gen)
    breakdown = {route: microbatch_breakdown(torch, model, opt, batch,
                                             draws[0], route)
                 for route in ("grouped", "matmul")}
    emit("pretrain", model="PeCLR RN50 + projection head, bf16 autocast",
         microbatch=MICROBATCH, accum=ACCUM, images_per_step=n,
         first_step_loss=first_loss, runs=runs,
         microbatch_breakdown_ms=breakdown, profiled_grouped_step=profiled)
    return runs


def step_vs_cpu(torch, dev, flags, routes, seed):
    """The dry-run shape (RN18, 64 -> 32, accum 2) on the card and on the
    CPU, both in f32 (TF32 off) with the same draws, on each route: loss
    within 1e-3 relative, BatchNorm running statistics within 1e-3 of each
    tensor's scale."""
    from peclr_tpu_torch.config.defaults import AugmentationParams
    from peclr_tpu_torch.ops import augment
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
    )
    from peclr_tpu_torch.train.step import make_peclr_train_step

    params = AugmentationParams(resize_shape=(32, 32))
    gen = torch.Generator().manual_seed(seed)
    draws = [augment.draw(gen, 8, flags, params) for _ in range(2)]
    batch = synthetic_pretrain_batch(8, 64, seed, device="cpu")
    result = {}
    for route in routes:
        states = {}
        losses = {}
        for where in ("cpu", dev):
            model, state, opt = build_pretrain_state("18", batch=4, accum=2,
                                                     device=where)
            step = make_peclr_train_step(model, opt, flags, params, accum=2,
                                         warp_route=route, precision="f32")
            on = {k: v.to(where) for k, v in batch.items()}
            state, metrics = step(state, on, None, draws=draws)
            losses[str(where)] = metrics["loss"].item()
            states[str(where)] = {k: v.cpu() for k, v in
                                  model.state_dict().items()
                                  if "running" in k}
        cpu_loss, card_loss = losses["cpu"], losses[str(dev)]
        rel = abs(card_loss / cpu_loss - 1.0)
        what = f"{route} ({len(flags.active())} flags)"
        check(rel <= 1e-3, f"{what}: RN18 loss card vs CPU rel {rel} > 1e-3")
        worst = 0.0
        for key, ref in states["cpu"].items():
            err = (states[str(dev)][key] - ref).abs().max().item()
            worst = max(worst, err / max(ref.abs().max().item(), 1e-12))
        check(worst <= 1e-3, f"{what}: BN stats card vs CPU {worst} > 1e-3")
        result[route] = {"loss_cpu": cpu_loss, "loss_card": card_loss,
                         "loss_rel": rel, "bn_stats_worst_rel": worst,
                         "tolerance": 1e-3}
    return result


def phase_pretrain_vs_cpu(torch, dev):
    """step_vs_cpu with the recipe's flags on the grouped and matmul
    routes."""
    from peclr_tpu_torch.config.defaults import peclr_pretrain_flags

    emit("pretrain_vs_cpu", model="PeCLR RN18, 64 -> 32, accum 2, f32, "
         "TF32 off", routes=step_vs_cpu(torch, dev, peclr_pretrain_flags(),
                                        ("grouped", "matmul"), SEED + 9))


# --------------------------------------------------------------------------
# phase 2a: the port's JPEG decode pool on the card's host

#: the encoder matrix the decode phase writes with cv2: sizes, qualities,
#: samplings and restart intervals, optimized tables, grey
DECODE_SIZES = ((224, 224), (1, 1), (17, 33), (97, 223), (480, 640))
DECODE_QUALITIES = (10, 50, 92, 100)
DECODE_SAMPLINGS = ("420", "422", "444")
#: the kinds the pool refuses (libjpeg decodes them; decode_image goes on
#: to cv2 for them)
DECODE_REFUSED = ("progressive", "411", "440")


def decode_cases(cv2, root: str) -> list:
    """(name, path, kind) of every file the decode phase checks: the
    trainer's 32 fixture JPEGs, the encoder matrix (blurred noise from a
    seed, written here by cv2), two truncated files, and the refused
    kinds."""
    sampling = {name: getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{name}")
                for name in DECODE_SAMPLINGS + ("411", "440")}
    rgb_dir = os.path.join(TRAINER_FIXTURE, "training", "rgb")
    cases = [(f"fixture/{n}", os.path.join(rgb_dir, n), "full")
             for n in sorted(os.listdir(rgb_dir))]

    def write(name, shape, quality=92, samp="420", restart=0,
              optimize=False, grey=False, progressive=False):
        rng = np.random.default_rng(len(cases))
        img = rng.normal(128.0, 60.0, shape + (3,)).astype(np.float32)
        k = max(1, min(shape) // 8) | 1
        img = cv2.GaussianBlur(img, (k, k), 0).reshape(shape + (3,))
        img = np.clip(img + rng.normal(0.0, 12.0, img.shape), 0, 255)
        img = img.astype(np.uint8)
        path = os.path.join(root, f"{len(cases)}.jpg")
        check(cv2.imwrite(path, img[..., 0] if grey else img, [
            cv2.IMWRITE_JPEG_QUALITY, quality,
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling[samp],
            cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
            cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
            cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]),
            f"decode: cv2 could not write {name}")
        return path

    for shape in DECODE_SIZES:
        tag = "x".join(map(str, shape))
        for q in DECODE_QUALITIES:
            for samp in DECODE_SAMPLINGS:
                for restart in (0, 3):
                    name = f"{tag}/q{q}/{samp}/rst{restart}"
                    cases.append((name, write(name, shape, q, samp, restart),
                                  "full"))
            name = f"{tag}/q{q}/grey"
            cases.append((name, write(name, shape, q, grey=True), "full"))
        for samp in DECODE_SAMPLINGS:
            name = f"{tag}/q92/{samp}/optimized"
            cases.append((name, write(name, shape, optimize=True), "full"))
    full = write("truncated", (97, 223), 50, restart=3)
    with open(full, "rb") as f:
        data = f.read()
    for cut, at in (("half", len(data) // 2), ("two_short", len(data) - 2)):
        path = os.path.join(root, f"cut_{cut}.jpg")
        with open(path, "wb") as f:
            f.write(data[:at])
        cases.append((f"truncated/{cut}", path, "truncated"))
    for kind in DECODE_REFUSED:
        name = f"refused/{kind}"
        if kind == "progressive":
            path = write(name, (97, 223), progressive=True)
        else:
            path = write(name, (97, 223), samp=kind)
        cases.append((name, path, "refused"))
    return cases


def phase_decode(torch, dev):
    """The port's own JPEG decode pool (csrc/jpeg_decode.cc, built here by
    the host's C++ compiler, no JPEG library linked) against cv2 and PIL,
    byte for byte: every file of decode_cases decoded by the pool, cv2 and
    PIL (cv2 alone on the truncated ones, which PIL refuses) with 0 bytes
    differing; the refused kinds None from the pool and decode_image equal
    to cv2; whole batches at 1, 4 and 8 threads equal to the files decoded
    one by one; then bench_decode's rates (the pool at 1, 4 and 8 threads,
    per core, beside the threaded cv2 path's)."""
    import cv2
    from PIL import Image

    from peclr_tpu_torch import build
    from peclr_tpu_torch.data import native_loader
    from peclr_tpu_torch.data.pipeline import decode_image
    from peclr_tpu_torch.scripts import bench_decode

    t_phase = time.perf_counter()
    check(native_loader.available(), "decode: the pool did not load")
    root = tempfile.mkdtemp(prefix="peclr_decode_")
    try:
        cases = decode_cases(cv2, root)
        differing = {"cv2": 0, "PIL": 0}
        compared = {"cv2": 0, "PIL": 0}
        for name, path, kind in cases:
            got = native_loader.decode(path)
            via_cv2 = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
            if kind == "refused":
                check(got is None, f"decode: the pool decoded {name}")
                check(np.array_equal(decode_image(path), via_cv2),
                      f"decode: decode_image of {name} is not cv2's")
                continue
            check(got is not None, f"decode: the pool refused {name}")
            refs = {"cv2": via_cv2}
            if kind == "full":
                with Image.open(path) as im:
                    refs["PIL"] = np.asarray(im.convert("RGB"))
            for lib, ref in refs.items():
                check(got.shape == ref.shape,
                      f"decode: {name} shape {got.shape} vs {lib} {ref.shape}")
                differing[lib] += int((got != ref).sum())
                compared[lib] += got.size
        check(differing == {"cv2": 0, "PIL": 0},
              f"decode: bytes differing from cv2 and PIL {differing}")
        fixture = [path for name, path, _ in cases
                   if name.startswith("fixture/")]
        one_by_one = np.stack([native_loader.decode(p) for p in fixture])
        for threads in (1, 4, 8):
            batch = native_loader.decode_batch_to_canvas(fixture, 224, threads)
            check(batch is not None and np.array_equal(batch, one_by_one),
                  f"decode: the batch at {threads} threads differs")
        rates = bench_decode.main(["--device", str(dev), "--out",
                                   os.path.join(root, "decode.json")])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    record = {
        "library": os.path.relpath(build.library_path("jpeg_decode")),
        "files": {kind: sum(1 for c in cases if c[2] == kind)
                  for kind in ("full", "truncated", "refused")},
        "bytes_compared": compared, "bytes_differing": differing,
        "tolerance": 0, "cv2": cv2.__version__,
        "PIL": importlib.import_module("PIL").__version__,
        "batch_threads_checked": [1, 4, 8],
        "pool_img_s": rates["native_img_s"],
        "pool_single_file_img_s": rates["native_single_img_s"],
        "cv2_threaded_img_s": rates["cv2_threaded_img_s"],
        "cv2_one_thread_img_s": rates["cv2_img_s"],
        "pipeline_threaded_img_s": rates["threaded_img_s"],
        "cpu_cores": rates["cpu_cores"],
        "seconds": time.perf_counter() - t_phase,
    }
    emit("decode", **record)
    return record


# --------------------------------------------------------------------------
# phase 8: the pretraining trainer through its CLI


def host_codecs() -> dict:
    """What this host can decode JPEG with, in the pipeline's order: the
    port's own pool (csrc/jpeg_decode.cc, built here, no JPEG library
    linked), then cv2 and PIL; and whether the host has a libjpeg at all
    (the pool needs none)."""
    from peclr_tpu_torch import build
    from peclr_tpu_torch.data import native_loader

    probe = {}
    for name in ("cv2", "PIL", "sklearn", "matplotlib"):
        try:
            probe[name] = getattr(importlib.import_module(name), "__version__",
                                  "present")
        except ImportError:
            probe[name] = None
    probe["native_loader"] = native_loader.available()
    probe["native_library"] = os.path.relpath(
        build.library_path("jpeg_decode"))
    ldd = subprocess.run(["ldd", build.library_path("jpeg_decode")],
                         capture_output=True, text=True).stdout
    probe["native_links_jpeg"] = "jpeg" in ldd
    ldconfig = subprocess.run(["ldconfig", "-p"], capture_output=True,
                              text=True).stdout
    probe["ldconfig_jpeg"] = [line.strip() for line in ldconfig.splitlines()
                              if "jpeg" in line]
    probe["jpeglib_h"] = os.path.exists("/usr/include/jpeglib.h")
    probe["decoder"] = next((d for d, ok in (
        ("native", probe["native_loader"]), ("cv2", probe["cv2"]),
        ("PIL", probe["PIL"])) if ok), None)
    return probe


@contextlib.contextmanager
def launches_at_validation(snapshots: list):
    """Record kernel_counts() each time the trainer logs a validation loss,
    the end of each epoch's work on the card."""
    from peclr_tpu_torch.utils.logging import ExperimentLogger

    real = ExperimentLogger.log_metrics

    def log_metrics(self, metrics, step=None, epoch=None, context="train"):
        if context == "val":
            snapshots.append(kernel_counts())
        return real(self, metrics, step=step, epoch=epoch, context=context)

    ExperimentLogger.log_metrics = log_metrics
    try:
        yield
    finally:
        ExperimentLogger.log_metrics = real


@contextlib.contextmanager
def state_at_fit(starts: list):
    """Record a CPU copy of the trainer's state (model and optimizer
    state_dicts, step) each time fit begins: what its constructor restored."""
    from peclr_tpu_torch.train.loop import PeCLRTrainer

    real = PeCLRTrainer.fit

    def fit(self, epochs=None):
        starts.append(cpu_copy({"model": self.state.model.state_dict(),
                                "optimizer": self.state.optimizer.state_dict(),
                                "step": self.state.step}))
        return real(self, epochs)

    PeCLRTrainer.fit = fit
    try:
        yield
    finally:
        PeCLRTrainer.fit = real


def cpu_copy(tree):
    """A nest of dicts and lists with each tensor copied to the CPU."""
    if isinstance(tree, dict):
        return {k: cpu_copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cpu_copy(v) for v in tree)
    if hasattr(tree, "detach"):
        return tree.detach().to("cpu", copy=True)
    return copy.deepcopy(tree)


def iter_tensors(tree):
    """The tensors of a nest of dicts and lists."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from iter_tensors(v)
    elif hasattr(tree, "detach"):
        yield tree


def tree_mismatches(a, b, path: str = "") -> list:
    """The paths at which two nests of dicts, lists and tensors differ;
    tensors are compared to the bit, with their dtypes."""
    if isinstance(a, dict):
        if not isinstance(b, dict) or set(a) != set(b):
            return [f"{path}: keys"]
        return [m for k in a for m in tree_mismatches(a[k], b[k], f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if not isinstance(b, (list, tuple)) or len(a) != len(b):
            return [f"{path}: length"]
        return [m for i, (x, y) in enumerate(zip(a, b))
                for m in tree_mismatches(x, y, f"{path}/{i}")]
    if hasattr(a, "detach"):
        import torch

        same = (torch.is_tensor(b) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a.cpu(), b.cpu()))
        return [] if same else [path]
    return [] if a == b else [path]


def run_trainer(torch, argv, dev):
    """One run of the trainer as a user starts it, through the CLI.  Returns
    (trainer, per-epoch launch snapshots, seconds)."""
    from peclr_tpu_torch.cli import train as cli

    snapshots = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with launches_at_validation(snapshots):
        trainer = cli.main(argv + ["--device", str(dev)])
    torch.cuda.synchronize()
    return trainer, snapshots, time.perf_counter() - t0


def trainer_epochs(trainer):
    """The trainer's logged records, by (context, epoch)."""
    with open(os.path.join(trainer.tracker.dir, "metrics.jsonl")) as f:
        return {(r["context"], r["epoch"]): r for r in map(json.loads, f)}


def phase_trainer(torch, dev, root):
    """The pretraining CLI at the recipe on the card, then a named restore
    that replays epoch 1 (module docstring, phase 8); its outputs go under
    `root`.  Returns the epochs and the directory of epoch 0's
    checkpoint."""
    from peclr_tpu_torch import constants
    from peclr_tpu_torch.train.checkpoint import CheckpointManager

    probe = host_codecs()
    emit("trainer_host", **probe)
    check(probe["decoder"] == "native" and not probe["native_links_jpeg"],
          f"trainer: the port's decode pool is not the decoder ({probe})")
    constants.FREIHAND_DATA = os.path.abspath(TRAINER_FIXTURE)
    constants.SAVED_MODELS_BASE_PATH = os.path.join(root, "models")
    constants.SAVED_META_INFO_PATH = os.path.join(root, "meta")
    torch.cuda.empty_cache()
    drawn = []
    with drawn_weights(drawn):
        trainer, snaps, seconds = run_trainer(torch, TRAINER_ARGV, dev)
    check_initial_weights("trainer", drawn)
    counts = kernel_counts()
    key = trainer.tracker.experiment_key
    epoch0_dir = os.path.dirname(trainer.ckpt.path(0))
    records = trainer_epochs(trainer)
    images = MICROBATCH * ACCUM
    # a step's 2 x accum, a validation batch's 2, and the pair figure's 2
    # where the host can plot it
    figure = 2 if trainer.log_images else 0
    per_epoch = 2 * ACCUM + 2 + figure
    epochs = []
    for epoch in range(2):
        rec, val = records[("train", epoch)], records[("val", epoch)]
        check(rec["steps"] == 1, f"trainer epoch {epoch}: {rec['steps']} "
              "steps, want 1")
        check(math.isfinite(rec["loss"]) and math.isfinite(val["loss"]),
              f"trainer epoch {epoch}: loss not finite")
        before = snaps[epoch - 1] if epoch else {k: 0 for k in counts}
        launched = {k: snaps[epoch][k] - before[k] for k in counts}
        for kname, n in launched.items():
            want = per_epoch if kname == "shift_lerp_grouped" else 0
            check(n == want, f"trainer epoch {epoch}: {kname} launched "
                  f"{n} times, want {want}")
        busy_s = rec["epoch_time_s"] - rec["data_wait_s"]
        epochs.append({
            "epoch": epoch, "loss": rec["loss"], "val_loss": val["loss"],
            "lr": rec["lr"], "img_per_s": images / rec["epoch_time_s"],
            "epoch_ms": rec["epoch_time_s"] * 1e3,
            "prefetch_wait_ms": rec["data_wait_s"] * 1e3,
            "step_ms": busy_s * 1e3,
            "host_batch_img_per_s": images / max(rec["data_wait_s"], 1e-9),
            "peak_mem_bytes": rec.get("peak_mem_bytes"), "launches": launched,
        })
    check(counts == snaps[-1], "trainer: kernels launched after the "
          "last validation")
    check(all(p.is_cuda for p in trainer.model.parameters()),
          "trainer: parameters not on the card")
    check(not torch.backends.cudnn.allow_tf32, "trainer: cuDNN TF32 on")
    kept = [d for d in os.listdir(trainer.ckpt.directory)
            if d.startswith("epoch_")]
    check(len(kept) <= 2, f"trainer: {len(kept)} checkpoints kept, top-k 2")
    check(os.path.exists(os.path.join(trainer.ckpt.directory,
                                      "index.json")), "trainer: no index")
    ckpt_bytes = os.path.getsize(trainer.ckpt.path(max(
        int(d.split("_")[1]) for d in kept)))
    epoch0 = torch.load(trainer.ckpt.path(0), map_location="cpu",
                        weights_only=True)

    # save and restore the trained state once more, timed
    timing = CheckpointManager(os.path.join(root, "timing"), save_top_k=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timing.save(0, trainer.state, {"checkpoint_saving_loss": 0.0})
    save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    timing.restore(trainer.state, epoch=0)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    decode = {"train": dict(trainer.pipeline.decode_paths),
              "val": dict(trainer.val_pipeline.decode_paths)}
    for split, paths in decode.items():
        check(set(paths) == {"native"} and paths["native"] > 0,
              f"trainer: {split} batches not all decoded on the port's "
              f"pool: {paths}")
    del trainer, timing
    torch.cuda.empty_cache()

    # the named restore: epoch 0's checkpoint, replaying epoch 1; what
    # the constructor restored must be that checkpoint to the bit (the
    # replayed loss alone cannot tell: epoch 0's one update has lr 0)
    starts = []
    with state_at_fit(starts):
        replay, _, replay_s = run_trainer(
            torch, TRAINER_ARGV + ["-experiment_key", key, "-checkpoint",
                                   "epoch_0"], dev)
    check(replay.start_epoch == 1, "replay: did not start at epoch 1")
    restored = starts[0]
    check(restored["step"] == 1 and restored["optimizer"]["count"] == 1,
          f"replay: restored step {restored['step']}, optimizer count "
          f"{restored['optimizer']['count']}, want 1 and 1")
    differ = tree_mismatches(epoch0, restored)
    check(not differ, f"replay: restored state differs from epoch 0's "
          f"checkpoint at {differ[:5]} ({len(differ)} in all)")
    restored_tensors = sum(1 for _ in iter_tensors(restored))
    del epoch0, starts, restored
    replayed = trainer_epochs(replay)[("train", 1)]
    rel = abs(replayed["loss"] / records[("train", 1)]["loss"] - 1.0)
    check(rel <= 1e-2, f"replayed epoch-1 loss rel {rel} > 1e-2")
    check(set(replay.pipeline.decode_paths) == {"native"},
          f"replay: batches not all decoded on the port's pool: "
          f"{dict(replay.pipeline.decode_paths)}")
    replay_launched = kernel_counts()
    check(replay_launched["shift_lerp_grouped"] == per_epoch
          and sum(replay_launched.values()) == per_epoch,
          f"replay launches {replay_launched}")
    emit("trainer", data="FreiHAND-layout fixture " + TRAINER_FIXTURE,
         decoder=probe["decoder"], pair_figure=bool(figure),
         argv=TRAINER_ARGV, model="PeCLR RN50 + projection head, LARS, "
         "bf16 autocast", images_per_step=images, seconds=seconds,
         epochs=epochs, decode_paths=decode, checkpoint_bytes=ckpt_bytes,
         checkpoint_save_ms=save_ms, checkpoint_restore_ms=restore_ms,
         checkpoints_kept=sorted(kept), replay_seconds=replay_s,
         restored_equal_to_checkpoint=True,
         restored_tensors=restored_tensors,
         replayed_epoch1_loss=replayed["loss"], replay_rel=rel,
         replay_tolerance=1e-2, replay_launches=replay_launched,
         replay_decode_paths=dict(replay.pipeline.decode_paths),
         decode_wait_ms=[e["prefetch_wait_ms"] for e in epochs])
    del replay
    torch.cuda.empty_cache()
    check(os.path.exists(os.path.join(epoch0_dir, "state.pt")),
          "trainer: epoch 0's checkpoint is gone after the replay")
    return epochs, epoch0_dir


# --------------------------------------------------------------------------
# phase 9: supervised fine-tuning and evaluation through their CLIs


@contextlib.contextmanager
def launches_at_checkpoint(snapshots: list):
    """Record kernel_counts() each time a checkpoint is saved, the end of
    each fine-tune epoch's work on the card."""
    from peclr_tpu_torch.train.checkpoint import CheckpointManager

    real = CheckpointManager.save

    def save(self, epoch, state, metrics):
        snapshots.append(kernel_counts())
        return real(self, epoch, state, metrics)

    CheckpointManager.save = save
    try:
        yield
    finally:
        CheckpointManager.save = real


@contextlib.contextmanager
def backbone_at_load(loaded: list):
    """Record a CPU copy of the backbone each time the fine-tune CLI loads a
    pretrained encoder into it (before its first step)."""
    from peclr_tpu_torch.train import finetune

    real = finetune.load_pretrained_encoder

    def load(model, state_dict):
        out = real(model, state_dict)
        loaded.append(cpu_copy(model.backend_model.state_dict()))
        return out

    finetune.load_pretrained_encoder = load
    try:
        yield
    finally:
        finetune.load_pretrained_encoder = real


@contextlib.contextmanager
def timed_evaluate(seconds: list):
    """Record the seconds of each evaluate() call (the CLI's inference and
    metrics, without its model build and load)."""
    import torch

    from peclr_tpu_torch.eval import evaluate as ev

    real = ev.evaluate

    def evaluate(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(*args, **kwargs)
        seconds.append(time.perf_counter() - t0)
        return out

    ev.evaluate = evaluate
    try:
        yield
    finally:
        ev.evaluate = real


def fixture_pipeline(split: str, batch: int):
    from peclr_tpu_torch.data.freihand import FreihandSource
    from peclr_tpu_torch.data.pipeline import HostPipeline

    src = FreihandSource(os.path.abspath(TRAINER_FIXTURE), split,
                         train_ratio=0.75)
    return HostPipeline([src], batch_size=batch, canvas=224, shuffle=False)


def finetune_vs_cpu(torch, dev):
    """One fine-tune step of RN25DPose at RN18 (8 fixture canvases to 64²
    crops, crop + rotate, the lifted-3D loss at 0.1, f32 model and warp)
    on the CPU and on the card from the same seeded weights and draws: loss
    within 1e-3 relative, every BatchNorm running statistic (the z-root
    MLP's included) within 1e-3 of its tensor's scale."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )
    from peclr_tpu_torch.data.synthetic import seeded_rn25d_variables
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.models.port import rn25d_variables_to_state_dict
    from peclr_tpu_torch.ops import augment
    from peclr_tpu_torch.train.finetune import make_finetune_step
    from peclr_tpu_torch.train.optimizer import build_optimizer
    from peclr_tpu_torch.train.state import TrainState

    flags = AugmentationFlags(crop=True, rotate=True, resize=True)
    params = AugmentationParams(resize_shape=(64, 64))
    batch = next(fixture_pipeline("train", 8).batches(1))
    draws = augment.draw(torch.Generator().manual_seed(SEED + 13), 8, flags,
                         params)
    weights = rn25d_variables_to_state_dict(seeded_rn25d_variables("18", SEED),
                                            "18")
    losses, stats = {}, {}
    for where in ("cpu", str(dev)):
        model = RN25DPose("18")
        model.load_state_dict(weights, strict=True)
        model.to(where)
        opt, _ = build_optimizer(model, base_lr=1e-4, batch_size=8, accum=1,
                                 steps_per_epoch=2, epochs=2, optimizer="adam")
        step = make_finetune_step(model, opt, flags, params,
                                  loss_3d_weight=0.1,
                                  compute_dtype=torch.float32)
        _, metrics = step(TrainState(model, opt),
                          {k: torch.from_numpy(v).to(where)
                           for k, v in batch.items()}, None, draws=draws)
        losses[where] = metrics["loss"].item()
        stats[where] = {k: v.cpu() for k, v in model.state_dict().items()
                        if "running" in k}
    rel = abs(losses[str(dev)] / losses["cpu"] - 1.0)
    check(rel <= 1e-3, f"fine-tune RN18 loss card vs CPU rel {rel} > 1e-3")
    worst, worst_zroot = 0.0, 0.0
    for key, ref in stats["cpu"].items():
        err = (stats[str(dev)][key] - ref).abs().max().item()
        err /= max(ref.abs().max().item(), 1e-12)
        worst = max(worst, err)
        if key.startswith("zroot_ref."):
            worst_zroot = max(worst_zroot, err)
    check(worst <= 1e-3, f"fine-tune BN stats card vs CPU {worst} > 1e-3")
    return {"loss_cpu": losses["cpu"], "loss_card": losses[str(dev)],
            "loss_rel": rel, "bn_stats_worst_rel": worst,
            "zroot_bn_stats_worst_rel": worst_zroot, "tolerance": 1e-3}


def oracle_evaluate(torch, dev):
    """evaluate() on the card over the fixture's val split with a predictor
    that feeds back each batch's own 2.5D labels: the crop geometry and
    K' = T @ K on the card must score as the reference's oracle test
    bounds."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )
    from peclr_tpu_torch.eval import evaluate as ev

    stash = []
    real = ev.supervised_sample_batch

    def capturing(*args, **kwargs):
        sample = real(*args, **kwargs)
        stash.append(sample["joints"])
        return sample

    ev.supervised_sample_batch = capturing
    try:
        results = ev.evaluate(lambda images, K: stash.pop(),
                              fixture_pipeline("val", 8),
                              AugmentationFlags(crop=True, resize=True),
                              AugmentationParams(), num_batches=2, device=dev)
    finally:
        ev.supervised_sample_batch = real
    bounds = {"Mean_EPE_2D": ("<", 1e-3), "Median_EPE_3D_R_V_3D": ("<", 5e-3),
              "AUC": (">", 0.9)}
    for key, (op, bound) in bounds.items():
        ok = results[key] < bound if op == "<" else results[key] > bound
        check(ok, f"oracle evaluate {key} {results[key]} not {op} {bound}")
    return {"results": results, "bounds": {k: f"{op} {b}" for k, (op, b)
                                           in bounds.items()}}


def port_to_torchvision(torch, dev, pretrained, root):
    """The port CLI: the trainer's checkpoint to the reference's PeCLR
    layout, that to torchvision's keys; the result loads strictly into a
    torchvision-keyed ResNet (fc left out), whose embedding on the card
    equals the PeCLR encoder's."""
    from peclr_tpu_torch.cli import port as port_cli
    from peclr_tpu_torch.models import PeCLRModel
    from peclr_tpu_torch.models.resnet import ResNet
    from peclr_tpu_torch.train.checkpoint import (
        load_torch_checkpoint,
        model_state_dict,
    )

    peclr_npz = os.path.join(root, "peclr_rn50.npz")
    tv_npz = os.path.join(root, "torchvision_rn50.npz")
    with contextlib.redirect_stdout(sys.stderr):
        port_cli.main([pretrained, peclr_npz, "-format", "orbax_to_peclr"])
        port_cli.main([peclr_npz, tv_npz, "-format", "peclr_to_torchvision"])
    net = ResNet("50")
    net.fc = torch.nn.Identity()
    net.load_state_dict(load_torch_checkpoint(tv_npz), strict=True)
    peclr = PeCLRModel("50")
    peclr.load_state_dict(model_state_dict(pretrained), strict=True)
    x = torch.from_numpy(np.random.default_rng(SEED + 14).uniform(
        -2, 2, (4, 3, 128, 128)).astype(np.float32)).to(dev)
    with torch.inference_mode():
        got = net.to(dev).eval()(x)
        want = peclr.to(dev).eval().encoder(x)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    check(rel <= 1e-5, f"torchvision export embedding vs encoder rel {rel}")
    return {"tensors": len(load_torch_checkpoint(tv_npz)), "strict": True,
            "embedding_rel": rel, "tolerance": 1e-5}


def finetune_breakdown(torch, state, dev):
    """Where a fine-tune step's time goes, at the CLI's defaults on one
    batch of the fixture: CUDA-event ms of the supervised sample (the warp),
    the forward with the losses, the backward and the update, over 3 steps
    after a warm-up; then one step under the profiler (the device's busy
    share, the top kernels)."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )
    from peclr_tpu_torch.eval.evaluate import supervised_sample_batch
    from peclr_tpu_torch.losses.supervised import l1_loss_25d
    from peclr_tpu_torch.train.finetune import make_finetune_step

    model, opt = state.model, state.optimizer
    flags, params = AugmentationFlags(crop=True, resize=True), AugmentationParams()
    raw = next(fixture_pipeline("train", FINETUNE_BATCH).batches(1))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    names = ("sample", "forward", "backward", "update")
    runs = []
    for rep in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        model.train()
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        sample = supervised_sample_batch(gen, batch, flags, params)
        ev[1].record()
        out = model(sample["image"], K=sample["K"])
        l2d, lz, _ = l1_loss_25d(out["kp25d"], sample["joints"],
                                 sample["scale"], sample["joints_valid"])
        ev[2].record()
        (l2d + lz).backward()
        ev[3].record()
        opt.step()
        ev[4].record()
        torch.cuda.synchronize()
        if rep:  # the first is the warm-up
            runs.append({n: ev[i].elapsed_time(ev[i + 1])
                         for i, n in enumerate(names)})
    step = make_finetune_step(model, opt, flags, params)
    _, profiled = profile_step(torch, step, state, batch, gen)
    return {"steps_ms": runs, "profiled_step": profiled}


def phase_finetune(torch, dev, pretrained, root):
    """The fine-tune step card against CPU, the fine-tune CLI at its
    defaults from the trainer's epoch-0 checkpoint, the evaluate CLI on the
    fine-tuned checkpoint, the oracle evaluate, and the port CLI's
    torchvision export (module docstring, phase 9)."""
    from peclr_tpu_torch.cli import evaluate as evaluate_cli
    from peclr_tpu_torch.cli import finetune as finetune_cli
    from peclr_tpu_torch.models.port import peclr_to_torchvision
    from peclr_tpu_torch.train.checkpoint import model_state_dict

    vs_cpu = finetune_vs_cpu(torch, dev)

    # the fine-tune CLI: counts set to 0 just before, read at each epoch end
    workdir = os.path.join(root, "rn25d")
    snaps, loaded = [], []
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_counts()
    drawn = []
    t0 = time.perf_counter()
    with launches_at_checkpoint(snaps), backbone_at_load(loaded), \
            drawn_weights(drawn):
        state, records = finetune_cli.main(FINETUNE_ARGV + [
            "-workdir", workdir, "-pretrained", pretrained, "--device",
            str(dev)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check_initial_weights("finetune", drawn)
    encoder = peclr_to_torchvision(model_state_dict(pretrained), "50")
    backbone = {k: v for k, v in loaded[0].items() if not k.startswith("fc.")}
    differ = tree_mismatches(encoder, backbone)
    check(len(loaded) == 1 and not differ, "fine-tune: the backbone after "
          f"loading differs from the pretrained encoder at {differ[:5]}")
    check(all(p.is_cuda for p in state.model.parameters()),
          "fine-tune: parameters not on the card")
    epochs = []
    for epoch, rec in enumerate(records):
        before = snaps[epoch - 1] if epoch else {k: 0 for k in snaps[0]}
        launched = {k: snaps[epoch][k] - before[k] for k in snaps[0]}
        check(rec["steps"] == FINETUNE_STEPS and math.isfinite(rec["loss"]),
              f"fine-tune epoch {epoch}: {rec['steps']} steps, loss "
              f"{rec['loss']}")
        for kname, n in launched.items():
            want = 2 * FINETUNE_STEPS if kname == "shift_lerp_grouped" else 0
            check(n == want, f"fine-tune epoch {epoch}: {kname} launched {n} "
                  f"times, want {want}")
        busy_s = rec["epoch_time_s"] - rec["data_wait_s"]
        epochs.append({
            "epoch": epoch, "loss": rec["loss"],
            "img_per_s": rec["images_per_sec"],
            "epoch_ms": rec["epoch_time_s"] * 1e3,
            "prefetch_wait_ms": rec["data_wait_s"] * 1e3,
            "step_ms": busy_s * 1e3 / rec["steps"],
            "peak_mem_bytes": rec.get("peak_mem_bytes"), "launches": launched,
        })
    check(kernel_counts() == snaps[-1], "fine-tune: kernels launched after "
          "the last epoch")
    per_step = epochs[0]["launches"]["shift_lerp_grouped"] / FINETUNE_STEPS
    kept = sorted(d for d in os.listdir(os.path.join(workdir, "checkpoints"))
                  if d.startswith("epoch_"))
    breakdown = finetune_breakdown(torch, state, dev)
    del state
    torch.cuda.empty_cache()

    # the evaluate CLI on the last fine-tuned checkpoint
    ckpt = os.path.join(workdir, "checkpoints", kept[-1])
    inner = []
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr), timed_evaluate(inner):
        results = evaluate_cli.main(EVAL_ARGV + ["-checkpoint", ckpt,
                                                 "--device", str(dev)])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_counts = kernel_counts()
    check(len(results) == 9 and all(math.isfinite(v)
                                    for v in results.values()),
          f"evaluate CLI results {results}")
    for kname, n in eval_counts.items():
        want = 2 * EVAL_BATCHES if kname == "shift_lerp_grouped" else 0
        check(n == want, f"evaluate CLI: {kname} launched {n} times, want "
              f"{want}")
    per_batch = eval_counts["shift_lerp_grouped"] / EVAL_BATCHES

    oracle = oracle_evaluate(torch, dev)
    exported = port_to_torchvision(torch, dev, pretrained, root)
    emit("finetune", model="RN25DPose RN50 (RN_25D_wMLPref), f32, TF32 off; "
         "warp bf16", data="FreiHAND-layout fixture " + TRAINER_FIXTURE,
         argv=FINETUNE_ARGV, pretrained="trainer phase epoch_0",
         backbone_equal_to_pretrained=True, step_card_vs_cpu=vs_cpu,
         seconds=seconds, epochs=epochs, checkpoints_kept=kept,
         step_breakdown=breakdown,
         evaluate={"argv": EVAL_ARGV, "checkpoint": kept[-1],
                   "results": results, "launches": eval_counts,
                   "cli_seconds": eval_s, "evaluate_seconds": inner[0],
                   "img_per_s": EVAL_BATCH * EVAL_BATCHES / inner[0]},
         oracle_evaluate=oracle, port_cli=exported)
    return {"launches_per_step": per_step, "launches_per_eval_batch": per_batch,
            "epochs": epochs}


# --------------------------------------------------------------------------
# phase 10: the augmentation ablation (every flag) through the CLI


def ablation_routes(torch, dev):
    """One RN50 pretrain step at the recipe (128 x 16, bf16) with every flag
    on each warp route, from one seeded state and batch: a finite loss, the
    route's kernel 2 x 16 times and no other (none on the gather route),
    the step's ms and peak memory.  The three two-pass routes' losses
    within 1e-2 of each other (as the recipe's); the gather warp is
    bilinear, not a lerp of lerps, and its loss is reported."""
    from peclr_tpu_torch.config.defaults import AugmentationParams
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
    )
    from peclr_tpu_torch.train.step import make_peclr_train_step

    model, state, opt = build_pretrain_state("50", batch=MICROBATCH,
                                             accum=ACCUM, device=dev)
    batch = synthetic_pretrain_batch(MICROBATCH * ACCUM, 224, SEED + 17,
                                     device=dev)
    snapshot = ({k: v.clone() for k, v in model.state_dict().items()},
                copy.deepcopy(opt.state_dict()))
    kernel_of = {"grouped": "shift_lerp_grouped", "nhwc": "shift_lerp_flat",
                 "matmul": "shift_lerp_matmul", "gather": None}
    runs = {}
    for route in ABLATION_ROUTES:
        model.load_state_dict(snapshot[0])
        opt.load_state_dict(snapshot[1])
        state.step = 0
        step = make_peclr_train_step(model, opt, ablation_flags(),
                                     AugmentationParams(), accum=ACCUM,
                                     warp_route=route)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        state, metrics = step(state, batch,
                              torch.Generator(device=dev).manual_seed(SEED + 18))
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kernel_counts()
        check(math.isfinite(loss), f"all-flags {route}: loss not finite")
        for kname, launched in counts.items():
            want = 2 * ACCUM if kname == kernel_of[route] else 0
            check(launched == want, f"all-flags {route}: {kname} launched "
                  f"{launched} times in a step, want {want}")
        runs[route] = {"first_loss": loss, "launches": counts,
                       "ms_per_step": seconds * 1e3,
                       "img_per_s": MICROBATCH * ACCUM / seconds,
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    for route in ("nhwc", "matmul"):
        rel = abs(runs[route]["first_loss"] / runs["grouped"]["first_loss"]
                  - 1.0)
        check(rel <= 1e-2, f"all-flags first loss {route} vs grouped: rel "
              f"{rel} > 1e-2")
        runs[route]["loss_rel_vs_grouped"] = rel
    runs["gather"]["loss_rel_vs_grouped"] = abs(
        runs["gather"]["first_loss"] / runs["grouped"]["first_loss"] - 1.0)
    del model, state, opt, batch, snapshot
    torch.cuda.empty_cache()
    return runs


def ablation_augment(torch, dev):
    """Where the augmentation's time goes with every flag: one augment_pair
    of the recipe's microbatch (128 seeded canvases, 224 -> 128, grouped,
    bf16) with the recipe's flags and with every flag (CUDA-event ms over
    the host's pacing, profiler device ms), and each op outside the recipe
    alone at the shape it sees (the doubled microbatch's f32 canvases, or
    its views)."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.data.synthetic import seeded_frames
    from peclr_tpu_torch.ops import augment
    from peclr_tpu_torch.ops import image as im
    from peclr_tpu_torch.train.recipe import synthetic_pretrain_batch

    params, n = AugmentationParams(), MICROBATCH
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    frames = torch.from_numpy(seeded_frames(n, SEED + 20)).to(dev)
    joints = synthetic_pretrain_batch(n, 224, SEED + 21, device=dev)["joints25d"]
    pair = {}
    for name, flags in (("recipe", peclr_pretrain_flags()),
                        ("all_flags", ablation_flags())):
        draws = augment.draw(gen, 2 * n, flags, params)

        def run(flags=flags, draws=draws):
            return augment.augment_pair(None, frames, joints, flags, params,
                                        draws=draws,
                                        compute_dtype=torch.bfloat16)

        pair[name] = {"ms": cuda_ms(run, 5), "device_ms": device_ms(run, 3)}
    canvases = torch.cat([frames, frames]).float()
    views = torch.rand((2 * n, 128, 128, 3), generator=gen, device=dev) * 255
    d = augment.draw(gen, 2 * n, ablation_flags(), params)
    anchor = joints.repeat(2, 1, 1)[:, 0, :2]
    ops = {
        "sobel_filter": lambda: im.sobel_filter(canvases),
        "cutout": lambda: im.cutout(canvases, anchor, d["cut_out_fraction"],
                                    d["cut_out_fill"]),
        "gaussian_blur": lambda: im.gaussian_blur(canvases, d["sigma"]),
        "gaussian_noise": lambda: im.gaussian_noise(views, d["noise"]),
        "grayscale": lambda: im.grayscale(views),
    }
    op_ms = {name: {"ms": cuda_ms(fn, 5), "device_ms": device_ms(fn, 3)}
             for name, fn in ops.items()}
    return {"augment_pair_ms": pair, "ops_ms": op_ms,
            "ops_shapes": {"canvases": list(canvases.shape),
                           "views": list(views.shape)}}


def phase_ablation(torch, dev):
    """Every augmentation flag: the four routes one recipe step each, the
    RN18 card-against-CPU check, then the pretraining CLI at the recipe for
    two epochs of one step over the fixture (the trainer phase's constants:
    its data and output paths), its counts set to 0 just before and read
    at each validation (module docstring, phase 10)."""
    t_phase = time.perf_counter()
    routes = ablation_routes(torch, dev)
    augment_time = ablation_augment(torch, dev)
    # the bound of the recipe's check (phase 7)
    vs_cpu = step_vs_cpu(torch, dev, ablation_flags(), ("grouped", "gather"),
                         SEED + 19)
    torch.cuda.empty_cache()
    trainer, snaps, seconds = run_trainer(torch, ABLATION_ARGV, dev)
    counts = kernel_counts()
    records = trainer_epochs(trainer)
    check(trainer.train_cfg.augmentation_flags == ablation_flags(),
          "ablation: the CLI's flags")
    figure = 2 if trainer.log_images else 0
    per_epoch = 2 * ACCUM + 2 + figure
    images = MICROBATCH * ACCUM
    epochs = []
    for epoch in range(2):
        rec, val = records[("train", epoch)], records[("val", epoch)]
        check(rec["steps"] == 1 and math.isfinite(rec["loss"])
              and math.isfinite(val["loss"]),
              f"ablation epoch {epoch}: {rec['steps']} steps, loss "
              f"{rec['loss']}, val {val['loss']}")
        before = snaps[epoch - 1] if epoch else {k: 0 for k in counts}
        launched = {k: snaps[epoch][k] - before[k] for k in counts}
        for kname, n in launched.items():
            want = per_epoch if kname == "shift_lerp_grouped" else 0
            check(n == want, f"ablation epoch {epoch}: {kname} launched {n} "
                  f"times, want {want}")
        busy_s = rec["epoch_time_s"] - rec["data_wait_s"]
        epochs.append({
            "epoch": epoch, "loss": rec["loss"], "val_loss": val["loss"],
            "img_per_s": images / rec["epoch_time_s"],
            "epoch_ms": rec["epoch_time_s"] * 1e3,
            "prefetch_wait_ms": rec["data_wait_s"] * 1e3,
            "step_ms": busy_s * 1e3,
            "peak_mem_bytes": rec.get("peak_mem_bytes"), "launches": launched,
        })
    check(counts == snaps[-1], "ablation: kernels launched after the last "
          "validation")
    del trainer
    torch.cuda.empty_cache()
    emit("ablation", data="FreiHAND-layout fixture " + TRAINER_FIXTURE,
         argv=ABLATION_ARGV, model="PeCLR RN50 + projection head, LARS, "
         "bf16 autocast", images_per_step=images, pair_figure=bool(figure),
         seconds=seconds, epochs=epochs, routes=routes,
         step_card_vs_cpu=vs_cpu, augment_time=augment_time,
         phase_seconds=time.perf_counter() - t_phase)
    return {"launches_per_step": 2 * ACCUM, "epochs": epochs,
            "routes": routes}


# --------------------------------------------------------------------------
# phase 11: data parallel


def state_digests(model) -> dict:
    """sha256 of the model's parameters and of its buffers, each tensor's
    bytes in name order: equal digests are states equal to the bit."""
    import hashlib

    out = {}
    for part, named in (("params", model.named_parameters()),
                        ("buffers", model.named_buffers())):
        h = hashlib.sha256()
        for name, tensor in named:
            h.update(name.encode())
            h.update(tensor.detach().cpu().contiguous().numpy().tobytes())
        out[part] = h.hexdigest()
    return out


def ddp_case(case: str) -> dict:
    """The two shapes the ddp phase runs on two ranks: the RN18 dry run in
    f32 and the RN50 recipe in bf16 (phase 7's state, batch and draws)."""
    if case == "rn18":
        return dict(resnet="18", micro=4, accum=2, canvas=64, view=32,
                    precision="f32", batch_seed=SEED + 21, draw_seed=SEED + 22)
    return dict(resnet="50", micro=MICROBATCH, accum=ACCUM, canvas=224,
                view=128, precision="bf16", batch_seed=SEED + 7,
                draw_seed=SEED + 8)


def ddp_step(torch, case: str, dev, mesh=None) -> dict:
    """One pretrain step of `case` on the grouped route, from the seeded
    state, with draws from the case's generator on `dev`; with a mesh, this
    rank's rows.  The loss, the BatchNorm running statistics (RN18), the
    state's digests, the launches and the step's seconds."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.ops import augment
    from peclr_tpu_torch.parallel.mesh import shard_batch
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
    )
    from peclr_tpu_torch.train.step import make_peclr_train_step

    c = ddp_case(case)
    flags = peclr_pretrain_flags()
    params = AugmentationParams(resize_shape=(c["view"], c["view"]))
    model, state, opt = build_pretrain_state(c["resnet"], batch=c["micro"],
                                             accum=c["accum"], device=dev)
    step = make_peclr_train_step(model, opt, flags, params, accum=c["accum"],
                                 warp_route="grouped",
                                 precision=c["precision"], mesh=mesh)
    batch = synthetic_pretrain_batch(c["micro"] * c["accum"], c["canvas"],
                                     c["batch_seed"], device=dev)
    if mesh is not None:
        batch = shard_batch(mesh, batch, c["accum"])
    gen = torch.Generator(device=dev).manual_seed(c["draw_seed"])
    draws = [augment.draw(gen, 2 * c["micro"], flags, params)
             for _ in range(c["accum"])]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    state, metrics = step(state, batch, None, draws=draws)
    loss = metrics["loss"].item()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return {"loss": loss, "launches": kernel_counts(), "seconds": seconds,
            "step": state.step, "digests": state_digests(model),
            "rows_a_microbatch": len(batch["image"]) // c["accum"],
            "running": ({k: v.cpu().numpy() for k, v in
                         model.state_dict().items() if "running" in k}
                        if case == "rn18" else None)}


def ddp_rank(mesh, case: str) -> dict:
    """What each spawned rank of the ddp phase runs (gloo, one card)."""
    import torch

    return ddp_step(torch, case, mesh.device, mesh)


def profile_epoch_loop(torch, epoch: int, out: dict):
    """A stand-in for the trainer's `trace` (utils/profiler.py, which it
    enters once an epoch around its step loop) that profiles the loop of
    epoch `epoch` (counted from the first it enters) and puts its
    trace_summary into `out`."""
    from torch.profiler import ProfilerActivity, profile

    entered = []

    @contextlib.contextmanager
    def trace(_logdir):
        entered.append(None)
        if len(entered) != epoch + 1:
            yield
            return
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            yield
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out.update(trace_summary(torch, prof, wall_ms))

    return trace


def ddp_cli_rank(out: str, argv: list) -> int:
    """A rank of the pretraining CLI under torch.distributed.run (this
    script re-entered with --ddp-cli): cli.main(argv) as the module's entry
    point runs it, with the launches counted at each validation and each
    checkpoint save's writer recorded; writes what it saw to out.rankN."""
    import torch

    from peclr_tpu_torch.cli import train as cli
    from peclr_tpu_torch.train import checkpoint, loop

    writes = []
    save = checkpoint.CheckpointManager.save

    def counted(self, *args, **kwargs):
        wrote = save(self, *args, **kwargs)
        writes.append(wrote)
        return wrote

    checkpoint.CheckpointManager.save = counted
    profiled = {}
    loop.trace = profile_epoch_loop(torch, DDP_CLI_PROFILED_EPOCH, profiled)
    snapshots = []
    reset_counts()
    with launches_at_validation(snapshots):
        trainer = cli.main(argv)
    rank = int(os.environ["RANK"])
    record = {"rank": rank, "world": int(os.environ["WORLD_SIZE"]),
              "snapshots": snapshots, "counts": kernel_counts(),
              "writes": writes, "device": str(trainer.device),
              "backend": trainer.mesh.backend,
              "log_images": trainer.log_images,
              "on_card": all(p.is_cuda for p in trainer.model.parameters()),
              "cudnn_tf32": torch.backends.cudnn.allow_tf32,
              "checkpoints": sorted(os.listdir(trainer.ckpt.directory)),
              "profiled": profiled,
              "epochs": ({f"{c}_{e}": r for (c, e), r in
                          trainer_epochs(trainer).items()}
                         if rank == 0 else None)}
    with open(f"{out}.rank{rank}", "w") as f:
        json.dump(record, f)
    return 0


def ddp_host_costs(mesh, reps: int = 200) -> dict:
    """Host and device ms of what the data-parallel step adds, on one NCCL
    rank (spawned): an all-reduce of a BatchNorm's packed statistics, and a
    BatchNorm forward and backward across the ranks against the same
    without a mesh, each `reps` times: at one of RN50's BatchNorm inputs of
    a recipe microbatch (256 x 256 x 32², bf16, channels last: the device's
    cost) and at 8 x 256 x 8² (too little work to hold the host back: the
    host's cost).  Host ms on the host's clock until the last call returns,
    device ms from CUDA events after a synchronise."""
    import torch

    from peclr_tpu_torch.models.batchnorm import BatchNorm2d, set_mesh

    dev = mesh.device

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        end.record()
        torch.cuda.synchronize()
        return {"host_ms": host_ms,
                "device_ms": start.elapsed_time(end) / reps}

    packed = torch.zeros(2 * 256 + 1, device=dev)
    out = {"all_reduce_513_f32": timed(
        lambda: torch.distributed.all_reduce(packed))}
    for shape_name, shape in (("recipe", (256, 256, 32, 32)),
                              ("small", (8, 256, 8, 8))):
        x = torch.randn(*shape, device=dev).to(
            torch.bfloat16, memory_format=torch.channels_last)
        dy = torch.randn_like(x)
        for name, with_mesh in (("plain", None), ("across_ranks", mesh)):
            bn = BatchNorm2d(256).to(dev).train()
            set_mesh(bn, with_mesh)
            xr = x.detach().requires_grad_(True)

            def fwd_bwd():
                bn(xr).backward(dy)

            out[f"batchnorm_{name}_{shape_name}"] = timed(fwd_bwd)
    return out


def ddp_two_ranks(torch, dev, case: str, one: dict) -> dict:
    """The case on two gloo ranks on the card against one process (`one`,
    the same step on the card): loss, parameters bit-equal across ranks,
    kernel 1 2 x accum times on each rank and no other kernel."""
    from peclr_tpu_torch.parallel.dryrun import spawn

    c = ddp_case(case)
    t0 = time.perf_counter()
    ranks = spawn(ddp_rank, 2, args=(case,), device=dev, backend="gloo")
    seconds = time.perf_counter() - t0
    tol = 1e-3 if case == "rn18" else 1e-2
    for r, got in enumerate(ranks):
        check(got["step"] == 1 and math.isfinite(got["loss"]),
              f"ddp {case} rank {r}: step {got['step']}, loss {got['loss']}")
        check(got["rows_a_microbatch"] == c["micro"] // 2,
              f"ddp {case} rank {r}: {got['rows_a_microbatch']} rows")
        for kname, n in got["launches"].items():
            want = 2 * c["accum"] if kname == "shift_lerp_grouped" else 0
            check(n == want, f"ddp {case} rank {r}: {kname} launched {n} "
                  f"times in a step, want {want}")
    check(ranks[0]["digests"] == ranks[1]["digests"],
          f"ddp {case}: the ranks' states differ after the step")
    check(ranks[0]["loss"] == ranks[1]["loss"], f"ddp {case}: rank losses "
          f"{ranks[0]['loss']} / {ranks[1]['loss']}")
    rel = abs(ranks[0]["loss"] / one["loss"] - 1.0)
    check(rel <= tol, f"ddp {case}: loss {ranks[0]['loss']} against one "
          f"process's {one['loss']}, rel {rel} > {tol}")
    out = {"loss_two_ranks": ranks[0]["loss"], "loss_one_process": one["loss"],
           "loss_rel": rel, "tolerance": tol,
           "launches_per_rank": ranks[0]["launches"],
           "rank_step_s": [g["seconds"] for g in ranks],
           "spawn_s": seconds, "ranks_bit_equal": True}
    if case == "rn18":
        worst = 0.0
        for key, ref in one["running"].items():
            err = np.abs(ranks[0]["running"][key] - ref).max()
            worst = max(worst, float(err / max(np.abs(ref).max(), 1e-12)))
        check(worst <= tol, f"ddp rn18: BN stats against one process "
              f"{worst} > {tol}")
        out["bn_stats_worst_rel"] = worst
    return out


def ddp_cli(torch, dev, root, trainer_run) -> dict:
    """The pretraining CLI at the recipe under torch.distributed.run, one
    rank with NCCL, for one epoch more than the trainer phase, the last
    profiled; against the trainer phase's epochs (phase 8: same seed, data
    and draws)."""
    out = os.path.join(root, "ddp_cli")
    env = dict(os.environ,
               DATA_PATH=os.path.abspath(os.path.dirname(TRAINER_FIXTURE)),
               SAVED_MODELS_BASE_PATH=os.path.join(root, "ddp_models"),
               SAVED_META_INFO_PATH=os.path.join(root, "ddp_meta"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", os.path.abspath(__file__), "--ddp-cli",
           out, *TRAINER_ARGV, "-epochs", str(DDP_CLI_PROFILED_EPOCH + 1)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=DDP_CLI_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
    check(proc.returncode == 0, f"ddp CLI under torch.distributed.run "
          f"exited {proc.returncode}")
    with open(out + ".rank0") as f:
        rec = json.load(f)
    check(rec["world"] == 1 and rec["backend"] == "nccl"
          and rec["device"] == "cuda:0" and rec["on_card"]
          and not rec["cudnn_tf32"], f"ddp CLI: {rec['world']} ranks, "
          f"{rec['backend']}, {rec['device']}, on card {rec['on_card']}, "
          f"TF32 {rec['cudnn_tf32']}")
    n_epochs = DDP_CLI_PROFILED_EPOCH + 1
    check(rec["writes"] == [True] * n_epochs, f"ddp CLI: rank 0's checkpoint "
          f"writes {rec['writes']}, want one an epoch")
    check(len([d for d in rec["checkpoints"] if d.startswith("epoch_")]) == 2
          and "index.json" in rec["checkpoints"],
          f"ddp CLI: checkpoints {rec['checkpoints']} (top-k 2)")
    figure = 2 if rec["log_images"] else 0
    per_epoch = 2 * ACCUM + 2 + figure
    images = MICROBATCH * ACCUM
    epochs = []
    for epoch in range(n_epochs):
        train = rec["epochs"][f"train_{epoch}"]
        val = rec["epochs"][f"val_{epoch}"]
        check(train["steps"] == 1 and math.isfinite(train["loss"])
              and math.isfinite(val["loss"]), f"ddp CLI epoch {epoch}: "
              f"{train['steps']} steps, loss {train['loss']}")
        before = rec["snapshots"][epoch - 1] if epoch else {
            k: 0 for k in rec["counts"]}
        launched = {k: rec["snapshots"][epoch][k] - before[k]
                    for k in rec["counts"]}
        for kname, n in launched.items():
            want = per_epoch if kname == "shift_lerp_grouped" else 0
            check(n == want, f"ddp CLI epoch {epoch}: {kname} launched {n} "
                  f"times, want {want}")
        epochs.append({
            "epoch": epoch, "loss": train["loss"], "val_loss": val["loss"],
            "img_per_s": images / train["epoch_time_s"],
            "epoch_ms": train["epoch_time_s"] * 1e3,
            "prefetch_wait_ms": train["data_wait_s"] * 1e3,
            "step_ms": (train["epoch_time_s"] - train["data_wait_s"]) * 1e3,
            "peak_mem_bytes": train.get("peak_mem_bytes"),
            "launches": launched})
    check(rec["counts"] == rec["snapshots"][-1], "ddp CLI: kernels launched "
          "after the last validation")
    rel = abs(epochs[0]["loss"] / trainer_run[0]["loss"] - 1.0)
    check(rel <= 1e-2, f"ddp CLI epoch-0 loss {epochs[0]['loss']} against "
          f"the trainer phase's {trainer_run[0]['loss']}: rel {rel} > 1e-2")
    return {"argv": TRAINER_ARGV, "epochs_run": n_epochs, "seconds": seconds,
            "epochs": epochs,
            "epoch0_loss_rel_to_trainer_phase": rel, "tolerance": 1e-2,
            "trainer_phase_step_ms": [e["step_ms"] for e in trainer_run],
            "trainer_phase_peak_mem_bytes": [e["peak_mem_bytes"]
                                             for e in trainer_run],
            "epoch1_step_ms_over_trainer_phase": (
                epochs[1]["step_ms"] / trainer_run[1]["step_ms"]),
            "checkpoint_writes_rank0": rec["writes"],
            f"profiled_epoch{DDP_CLI_PROFILED_EPOCH}_step": rec["profiled"],
            "pair_figure": bool(figure)}


def phase_ddp(torch, dev, root, trainer_run) -> dict:
    """Data-parallel pretraining (module docstring, phase 11)."""
    from peclr_tpu_torch.parallel.dryrun import dryrun_multichip, spawn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rn18 = ddp_two_ranks(torch, dev, "rn18", ddp_step(torch, "rn18", dev))
    # the one-process recipe step is phase 7's, from the same state, batch
    # and draws, held there within 1e-5 of FIRST_STEP_LOSS
    rn50 = ddp_two_ranks(torch, dev, "rn50",
                         {"loss": FIRST_STEP_LOSS["grouped"]})
    cli = ddp_cli(torch, dev, root, trainer_run)
    host_costs = spawn(ddp_host_costs, 1, device=dev, backend="nccl")[0]
    t0 = time.perf_counter()
    dry_loss = dryrun_multichip(2, device="cuda")
    dry_s = time.perf_counter() - t0
    check(math.isfinite(dry_loss), "dryrun_multichip(2): loss not finite")
    emit("ddp", two_ranks_one_card="gloo, both ranks on " + str(dev) +
         "; their times share the card and stage through the host: not "
         "speed", rn18_f32=rn18, rn50_recipe_bf16=rn50, cli_nccl_world1=cli,
         host_costs_nccl_world1=host_costs,
         dryrun_multichip_2={"loss": dry_loss, "seconds": dry_s},
         phase_seconds=time.perf_counter() - t_phase)
    return {"rn50": rn50, "cli": cli}


# --------------------------------------------------------------------------
# phase 7a: the RN50 recipe step in f32 on the matmul route


def phase_pretrain_f32_matmul(torch, dev):
    """One RN50 recipe step at precision="f32" (TF32 off) on the matmul
    route, kernel 4 with f32 taps, after one warm-up step, and the same step
    on the grouped route in f32 from the same state with the same draws:
    2 x 16 launches of the route's kernel and none of the others', the
    losses within 1e-3 relative (both f32; the routes differ in their
    order of summation), ms a step and peak memory."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.ops import augment
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
    )
    from peclr_tpu_torch.train.step import make_peclr_train_step

    t_phase = time.perf_counter()
    flags, params = peclr_pretrain_flags(), AugmentationParams()
    model, state, opt = build_pretrain_state("50", batch=MICROBATCH,
                                             accum=ACCUM, device=dev)
    batch = synthetic_pretrain_batch(MICROBATCH * ACCUM, 224, SEED + 7,
                                     device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    draws = [augment.draw(gen, 2 * MICROBATCH, flags, params)
             for _ in range(ACCUM)]
    snapshot = ({k: v.clone() for k, v in model.state_dict().items()},
                copy.deepcopy(opt.state_dict()))
    kernel_of = {"matmul": "shift_lerp_matmul",
                 "grouped": "shift_lerp_grouped"}
    steps = {route: make_peclr_train_step(model, opt, flags, params,
                                          accum=ACCUM, warp_route=route,
                                          precision="f32")
             for route in kernel_of}
    steps["matmul"](state, batch, gen, draws=draws)  # the warm-up
    runs = {}
    for route in kernel_of:  # the main path first, then its yardstick
        model.load_state_dict(snapshot[0])
        opt.load_state_dict(snapshot[1])
        state.step = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        t0 = time.perf_counter()
        state, metrics = steps[route](state, batch, gen, draws=draws)
        loss = metrics["loss"].item()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = kernel_counts()
        check(math.isfinite(loss), f"f32 {route}: loss not finite")
        for kname, launched in counts.items():
            want = 2 * ACCUM if kname == kernel_of[route] else 0
            check(launched == want, f"f32 {route}: {kname} launched "
                  f"{launched} times in a step, want {want}")
        runs[route] = {"loss": loss, "launches": counts,
                       "ms_per_step": seconds * 1e3,
                       "img_per_s": MICROBATCH * ACCUM / seconds,
                       "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    rel = abs(runs["matmul"]["loss"] / runs["grouped"]["loss"] - 1.0)
    check(rel <= 1e-3, f"f32 step matmul vs grouped: loss rel {rel} > 1e-3")
    emit("pretrain_f32_matmul", model="PeCLR RN50 + projection head, f32, "
         "TF32 off", microbatch=MICROBATCH, accum=ACCUM,
         images_per_step=MICROBATCH * ACCUM, loss_rel_vs_grouped=rel,
         tolerance=1e-3, runs=runs,
         phase_seconds=time.perf_counter() - t_phase)
    del model, state, opt, batch, snapshot, steps
    torch.cuda.empty_cache()
    return runs


# --------------------------------------------------------------------------
# phase 6a: the host's waits on the card


def host_ms_behind_busy_card(torch, fn, busy_ms: float) -> float:
    """The host's time in fn() (ms) while the card works through a spin
    kernel of about busy_ms queued just before it: about busy_ms or more
    when fn waits for the card anywhere, fn's own host time otherwise.
    Unlike scripts.host_waits it also sees waits that torch does not
    report (a library's own synchronisation)."""
    probe = 10_000_000
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(probe)
    end.record()
    end.synchronize()
    torch.cuda._sleep(int(probe * busy_ms / start.elapsed_time(end)))
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return host_ms


def host_wait_paths(torch, dev, rn50, x0, K0) -> dict:
    """The paths whose waits phase_host_waits counts, each a function of no
    argument: the pretrain step (RN18 at the dry-run shape, 64 -> 32,
    accum 2) with the recipe's flags and with every flag on each warp route
    in bf16, and with the recipe's on the matmul route in f32; the
    fine-tune step (RN18 RN25DPose, 96² canvases to 64² crops, batch 8, the
    lifted-3D loss); one two-pass leaderboard batch of `rn50` from the
    frames x0 and intrinsics K0 on the card to kp3d; one
    InferenceSession._predict of `rn50` (32 x 128², from numpy)."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.data.synthetic import seeded_rn25d_variables
    from peclr_tpu_torch.eval.pred_fh import run_two_pass
    from peclr_tpu_torch.eval.serving import InferenceSession
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.models.port import rn25d_variables_to_state_dict
    from peclr_tpu_torch.train.finetune import make_finetune_step
    from peclr_tpu_torch.train.optimizer import build_optimizer
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
        synthetic_supervised_batch,
    )
    from peclr_tpu_torch.train.state import TrainState
    from peclr_tpu_torch.train.step import make_peclr_train_step

    paths = {}
    model, state, opt = build_pretrain_state("18", batch=4, accum=2,
                                             device=dev)
    batch = synthetic_pretrain_batch(8, canvas=64, seed=SEED + 24, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    params = AugmentationParams(resize_shape=(32, 32))
    cases = [(f, r, "bf16") for f in ("recipe", "all_flags")
             for r in ABLATION_ROUTES] + [("recipe", "matmul", "f32")]
    for flags_name, route, precision in cases:
        flags = (peclr_pretrain_flags() if flags_name == "recipe"
                 else ablation_flags())
        step = make_peclr_train_step(model, opt, flags, params, accum=2,
                                     warp_route=route, precision=precision)
        paths[f"pretrain_step_{flags_name}_{route}_{precision}"] = (
            functools.partial(step, state, batch, gen))

    pose = RN25DPose("18")
    pose.load_state_dict(rn25d_variables_to_state_dict(
        seeded_rn25d_variables("18", SEED), "18"), strict=True)
    pose.to(dev)
    ft_opt, _ = build_optimizer(pose, base_lr=1e-4, batch_size=8, accum=1,
                                steps_per_epoch=2, epochs=2, optimizer="adam")
    ft_step = make_finetune_step(
        pose, ft_opt, AugmentationFlags(crop=True, rotate=True, resize=True),
        AugmentationParams(resize_shape=(64, 64)), loss_3d_weight=0.1)
    ft_batch = synthetic_supervised_batch(8, canvas=96, seed=SEED + 26,
                                          device=dev)
    paths["finetune_step"] = functools.partial(
        ft_step, TrainState(pose, ft_opt), ft_batch,
        torch.Generator(device=dev).manual_seed(SEED + 27))

    paths["run_two_pass_batch"] = functools.partial(run_two_pass, rn50, x0, K0)
    sess = InferenceSession(rn50, batch_size=32, image_size=128, device=dev)
    req = np.random.default_rng(SEED + 28).integers(
        0, 256, (32, 128, 128, 3), dtype=np.uint8)
    K = np.broadcast_to(np.asarray(((400.0, 0.0, 64.0), (0.0, 400.0, 64.0),
                                    (0.0, 0.0, 1.0)), np.float32),
                        (32, 3, 3)).copy()
    paths["inference_session_predict"] = functools.partial(sess._predict,
                                                           req, K)
    return paths


def launch_queue_depth(torch, busy_ms: float = 200.0, most: int = 8192) -> int:
    """How many kernels the host queues behind a busy card before a launch
    blocks: one-element adds launched behind a spin kernel of busy_ms,
    counted until one takes over busy_ms / 2 of host time (`most` if none
    does)."""
    x = torch.zeros(1, device="cuda")
    queued = most
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    torch.cuda._sleep(int(10_000_000 * busy_ms / start.elapsed_time(end)))
    for i in range(most):
        t0 = time.perf_counter()
        x.add_(1.0)
        if (time.perf_counter() - t0) * 1e3 > busy_ms / 2:
            queued = i
            break
    torch.cuda.synchronize()
    return queued


def blocking_call(torch, fn, busy_ms: float) -> str:
    """The call in which fn's host blocked behind a busy card: the function
    with the most own time under cProfile."""
    import cProfile
    import pstats

    prof = cProfile.Profile()
    host_ms_behind_busy_card(torch, lambda: prof.runcall(fn), busy_ms)
    (path, line, name), stat = max(pstats.Stats(prof).stats.items(),
                                   key=lambda kv: kv[1][2])
    return f"{name} ({os.path.basename(path)}:{line}), {stat[2] * 1e3:.1f} ms"


def phase_host_waits(torch, dev, rn50, x0, K0, require_none: bool = True):
    """Each path of host_wait_paths, and torch.linalg.inv_ex of 3 x 3
    matrices at the batches the paths invert, after one call that builds
    what it builds on first use: its own host time, the waits torch reports
    (host_waits, with their call sites) and its host time behind a busy
    card (host_ms_behind_busy_card, the card busy for 5 times its own host
    time and at least 250 ms).  The last sees any wait, torch's or a
    library's, but also the host blocking in a launch once the launch queue
    is full (launch_queue_depth kernels behind the card), which every step
    fills; where the host blocked, the call it blocked in (blocking_call).
    With require_none no path makes a wait torch reports, and the paths
    that launch fewer kernels than the queue holds (a two-pass batch, a
    serving request, the inverses) spend under half the busy time behind
    the card."""
    from peclr_tpu_torch.scripts import host_waits

    t_phase = time.perf_counter()
    paths = host_wait_paths(torch, dev, rn50, x0, K0)
    eye = torch.eye(3, device=dev)
    for n in (8, 32, 120, 128, 256):  # the batches the port inverts
        mats = eye.expand(n, 3, 3) * torch.rand(n, 1, 1, device=dev) + eye
        paths[f"linalg_inv_ex_{n}"] = functools.partial(torch.linalg.inv_ex,
                                                        mats)
    rows = {}
    for name, fn in paths.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        own_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        waits = host_waits(fn)
        torch.cuda.synchronize()
        busy_ms = max(250.0, 5.0 * own_ms)
        sites = {}
        for w in waits:
            site = " <- ".join(reversed(w))
            sites[site] = sites.get(site, 0) + 1
        behind = host_ms_behind_busy_card(torch, fn, busy_ms)
        rows[name] = {"waits": len(waits), "call_sites": sites,
                      "host_ms": own_ms, "busy_card_ms": busy_ms,
                      "host_ms_behind_busy_card": behind}
        if behind >= busy_ms / 2:
            rows[name]["blocked_in"] = blocking_call(torch, fn, busy_ms)
    depth = launch_queue_depth(torch)
    emit("host_waits", paths=rows, launch_queue_depth=depth,
         note="after one call of each path; sync debug mode 'warn'",
         phase_seconds=time.perf_counter() - t_phase)
    if require_none:
        for name, row in rows.items():
            check(row["waits"] == 0, f"{name}: {row['waits']} host waits: "
                  f"{row['call_sites']}")
            if not name.startswith(("pretrain_step", "finetune_step")):
                check(row["host_ms_behind_busy_card"] < row["busy_card_ms"] / 2,
                      f"{name}: the host took {row['host_ms_behind_busy_card']}"
                      f" ms behind a card busy for {row['busy_card_ms']} ms")
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------
# phase 4 / 5 inputs


def pred_fh_affines(torch, b, seed):
    """initial_affine() for half the batch, random refined boxes for the
    other half (the two passes' geometry)."""
    from peclr_tpu_torch.eval.pred_fh import CROP_SIZE, TARGET_DIST, initial_affine
    from peclr_tpu_torch.geometry.affine import affine_from_bbox

    rng = np.random.default_rng(seed)
    half = b // 2
    centre = rng.uniform(60, 164, (b - half, 2))
    side = rng.uniform(40, 200, (b - half, 1))
    boxes = np.concatenate([centre - side / 2, centre + side / 2], axis=1)
    refined = affine_from_bbox(boxes.astype(np.float32), CROP_SIZE, TARGET_DIST)
    first = torch.as_tensor(initial_affine()).expand(half, 3, 3)
    return torch.cat([first, refined])


# --------------------------------------------------------------------------


def nonfinite_bound(torch, x, k, f, w_t, out):
    """Least time (ms) of the fused shift+matmul on a float source that may
    hold Inf or NaN anywhere: every source element read once (a non-finite
    value under a zero tap still decides the output), the taps, k and f
    read once, each output written once; or the multiply-adds of the
    nonzero taps (tensor cores for bf16 taps) and 3 f32 operations a
    source element, if longer."""
    g, _, r, _ = x.shape
    moved = sum(t.numel() * t.element_size() for t in (x, k, f, w_t, out))
    mac_rate = BF16_TC_FLOPS if w_t.dtype == torch.bfloat16 else F32_FLOPS
    nonzero = int((w_t != 0).sum().item())
    ops_ms = (2 * g * r * nonzero / mac_rate
              + 3 * x.numel() / F32_FLOPS) * 1e3
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")


def phase_matmul_nonfinite(torch, dev):
    """Kernel 4 on float sources that hold Inf and NaN, at the recipe's
    pass-2 shapes ((3, 256, 128, 224) sources, taps (256, 128, 256) at
    slopes 1.0-1.75, f32 out): some under zero taps only, one in a row whose
    window is finite in f32 and Inf once cast to bf16 taps, and image 1's
    taps all zero (every tile's band (0, 0)); bf16 and f32 sources, each
    with bf16 and f32 taps.  NaN, +Inf and -Inf where the plain (dense)
    version has them, the other values within 1e-2, one counted launch a
    call, and the device time beside the same call on the finite source."""
    from peclr_tpu_torch.ops.shift_lerp_matmul import (
        fused_shift_lerp_matmul,
        shift_lerp_matmul_plain,
    )

    uniform, taps, rows_of, shifts = matmul_inputs(torch, dev, SEED + 41)
    b = 2 * MICROBATCH
    finite = rows_of((3, b, 128, 224), torch.float32)
    k, f = shifts(uniform(b * 128, -296.0, 264.0), 256, 224)
    w_t = taps(b, 256, 128, 1.0, 1.75, torch.float32)
    w_t[1] = 0
    bad = finite.clone()
    k_host = k.cpu()
    places = ((0, 0, 3, 100, math.inf), (1, 0, 40, 7, -math.inf),
              (2, 1, 65, 200, math.nan), (0, 5, 33, 0, math.nan),
              (1, 9, 10, 223, math.inf), (2, 200, 127, 50, math.nan))
    for g, bi, r, col, val in places:
        bad[g, bi, r, col] = val
        k_host[bi * 128 + r] = col - 60  # within the row's window
    bad[2, 7, 50, 120:122] = 3.4e38  # finite in f32, Inf in bf16
    k_host[7 * 128 + 50] = 60
    k = k_host.to(dev)
    rows = []
    for src_dtype in (torch.bfloat16, torch.float32):
        for tap_dtype in (torch.bfloat16, torch.float32):
            name = (f"matmul_nonfinite_{str(src_dtype)[6:]}_src_"
                    f"{str(tap_dtype)[6:]}_taps")
            x, taps_t = bad.to(src_dtype), w_t.to(tap_dtype)
            launches = fused_shift_lerp_matmul.launches
            got = fused_shift_lerp_matmul(x, k, f, taps_t, torch.float32)
            ref = shift_lerp_matmul_plain(x, k, f, taps_t, torch.float32)
            torch.cuda.synchronize()
            check(fused_shift_lerp_matmul.launches == launches + 1,
                  f"{name}: not one counted launch")
            masks = {}
            for mask in (torch.isnan, torch.isposinf, torch.isneginf):
                same = torch.equal(mask(got), mask(ref))
                check(same, f"{name}: {mask.__name__} masks differ")
                masks[mask.__name__] = int(mask(ref).sum().item())
            check(masks["isnan"] > 0 and bool(torch.isnan(ref[:, 1]).any()),
                  f"{name}: the inputs make no NaN in the all-zero tiles")
            ok = torch.isfinite(ref)
            max_abs = (got[ok] - ref[ok]).abs().max().item()
            check(max_abs <= 1e-2, f"{name}: max_abs {max_abs} > 1e-2")
            clean = finite.to(src_dtype)
            bound, bound_by = nonfinite_bound(torch, x, k, f, taps_t, got)
            row = {"case": name, "shape_in": list(x.shape),
                   "taps": list(taps_t.shape), "max_abs": max_abs,
                   "tolerance": 1e-2, "ref_counts": masks,
                   "bound_ms": bound, "bound_by": bound_by,
                   "device_ms": device_ms(lambda: fused_shift_lerp_matmul(
                       x, k, f, taps_t, torch.float32), 10),
                   "finite_source_device_ms": device_ms(
                       lambda: fused_shift_lerp_matmul(
                           clean, k, f, taps_t, torch.float32), 10)}
            rows.append(row)
            emit("kernel_nonfinite", **row)
    return rows


def phase_tf32(torch, dev):
    """The step factories turn TF32 off for a model their caller moved to
    the card itself (not through resolve_device)."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )
    from peclr_tpu_torch.models import PeCLRModel, RN25DPose
    from peclr_tpu_torch.train.finetune import make_finetune_step
    from peclr_tpu_torch.train.optimizer import build_optimizer
    from peclr_tpu_torch.train.step import (
        make_peclr_eval_step,
        make_peclr_train_step,
    )

    flags, params = AugmentationFlags(crop=True, resize=True), AugmentationParams()
    switches = ((torch.backends.cudnn, "allow_tf32"),
                (torch.backends.cuda.matmul, "allow_tf32"),
                (torch.backends.cuda.matmul,
                 "allow_bf16_reduced_precision_reduction"))
    peclr, rn25d = PeCLRModel("18").to(dev), RN25DPose("18").to(dev)
    builds = {
        "pretrain": lambda: make_peclr_train_step(
            peclr, build_optimizer(peclr, 1e-4, 8, 1, 10, 1)[0], flags,
            params),
        "pretrain_eval": lambda: make_peclr_eval_step(peclr, flags, params),
        "finetune": lambda: make_finetune_step(
            rn25d, build_optimizer(rn25d, 1e-4, 8, 1, 10, 1)[0], flags,
            params),
    }
    after = {}
    for name, build in builds.items():
        for module, attr in switches:
            setattr(module, attr, True)
        build()
        after[name] = [getattr(module, attr) for module, attr in switches]
    for module, attr in switches:
        setattr(module, attr, False)
    for name, flags_after in after.items():
        check(not any(flags_after), f"tf32: {name} left {flags_after}")
    emit("tf32", switches=[attr for _, attr in switches], after_build=after)


#: the accuracy phase: the downstream chain at the reference's widths (RN50,
#: crop 128, batch 64), cut in steps only, and the proxy's pretraining
ACCURACY_CHAIN_ARGV = ["--resnet", "50", "--crop", "128", "--batch", "64",
                       "--num-unique", "24", "--pretrain-steps", "8",
                       "--finetune-steps", "8", "--freeze-encoder"]
ACCURACY_PROXY_STEPS, ACCURACY_PROXY_IMAGES = 8, 512
#: the proxy's recipe (128 x 16, LARS at 1e-5, 128-px canvases and views)
#: at RN152, cut in steps only: its pool is the curves' 4,096 frames
RECIPE_PROXY = dict(batch=MICROBATCH, accum=ACCUM, optimizer="LARS",
                    lr=1e-5, view=128)
RN152_STEPS, RECIPE_IMAGES = 3, 4096
#: the bench_scripts phase: each measurement script's argv, cut in size
BENCH_ARGV = {
    "bench_serving": ["--batches", "1,8", "--iters", "5"],
    "bench_pred_pipeline": ["--depths", "1,2", "--num-batches", "3",
                            "--repeats", "1"],
    "bench_host_pipeline": ["--root", TRAINER_FIXTURE, "--steps", "2"],
    "profile_step_pretrain": ["--phase", "pretrain", "--iters", "1",
                              "--trace"],
    "profile_step_pred": ["--phase", "pred", "--iters", "1", "--trace"],
}
#: kernel 1's launches in each BENCH_ARGV run: 4 a two-pass batch, 2 x
#: ACCUM = 32 a recipe step (the grouped route); serving runs none.  Pred
#: pipeline: a warm-up and a profiled batch, then 3 batches at each of 2
#: depths (8 batches); host pipeline: 2 warm-up and 2 timed steps in the
#: device-only leg, 1 warm-up and 2 timed in the sustained one (7 steps);
#: profile_step: 2 warm-up, 1 timed and 1 profiled step (4 steps, or 4
#: batches)
BENCH_LAUNCHES = {"bench_serving": 0, "bench_pred_pipeline": 4 * 8,
                  "bench_host_pipeline": 2 * ACCUM * 7,
                  "profile_step_pretrain": 2 * ACCUM * 4,
                  "profile_step_pred": 4 * 4}
#: the multichip phase: weak scaling at the recipe's accum (FIRST_STEP_LOSS
#: is accum 16's first step) cut to one timed step; the streams' launches
MULTICHIP_ITERS, STREAM_ITERS = 1, 20


def phase_accuracy(torch, dev):
    """The accuracy path (peclr_tpu_torch/scripts): the downstream chain's
    main at ACCURACY_CHAIN_ARGV, all five tiers and the leaderboard at
    limit 32, into a temporary directory; the round trip bit-exact and its
    row equal to peclr_full's (rel 1e-9, the reference's test), every frozen backbone unchanged to the bit,
    the losses finite, kernel 1 launched 2 a pretrain and a fine-tune step,
    2 an evaluate batch and 4 a leaderboard batch, kernels 2-4 never, and
    no host wait (torch's sync debug mode) inside a pretrain or fine-tune
    loop.  Then the proxy's pretrain at RN50, 64 px, 8 steps of 64 on 512
    frames, and one linear_probe on them: finite, 2 launches a step."""
    from peclr_tpu_torch import scripts as common
    from peclr_tpu_torch.scripts import accuracy_proxy, downstream_chain

    tmp = tempfile.mkdtemp(prefix="peclr_accuracy_")
    loop_waits = []
    real_run_steps = downstream_chain.run_steps

    def watched(*args, **kwargs):
        out = []
        loop_waits.extend(common.host_waits(
            lambda: out.append(real_run_steps(*args, **kwargs))))
        return out[0]

    downstream_chain.run_steps = watched
    try:
        reset_counts()
        t0 = time.perf_counter()
        chain = downstream_chain.main(
            ACCURACY_CHAIN_ARGV + ["--device", str(dev),
                                   "--root", os.path.join(tmp, "fh"),
                                   "--out", os.path.join(tmp, "chain.json")])
        torch.cuda.synchronize()
        chain_seconds = time.perf_counter() - t0
        chain_counts = kernel_counts()
    finally:
        downstream_chain.run_steps = real_run_steps
        shutil.rmtree(tmp, ignore_errors=True)
    steps = int(ACCURACY_CHAIN_ARGV[ACCURACY_CHAIN_ARGV.index(
        "--pretrain-steps") + 1])
    by = {r["encoder"]: r for r in chain["rows"]}
    check(list(by) == ["none", "peclr_quarter", "peclr_full",
                       "peclr_full_pth_roundtrip", "simclr_full"],
          f"accuracy: chain tiers {list(by)}")
    check(chain["port_roundtrip"]["encoder_bitexact"],
          "accuracy: the .pth round trip is not bit-exact")
    for key, value in by["peclr_full"].items():
        if key != "encoder":
            check(math.isclose(by["peclr_full_pth_roundtrip"][key], value,
                               rel_tol=1e-9),
                  f"accuracy: the round trip's {key} differs")
    check(chain["pred_fh_entries"] == 32, "accuracy: leaderboard entries "
          f"{chain['pred_fh_entries']}")
    for name, phase in chain["phases"].items():
        want = {"pretrain": 2 * steps, "finetune": 2 * steps,
                "evaluate": 2, "leaderboard": 4}[name.split("_")[0]]
        check(phase["kernel1_launches"] == want, f"accuracy: {name} launched "
              f"kernel 1 {phase['kernel1_launches']} times, want {want}")
        check(math.isfinite(phase.get("last_loss", 0.0)),
              f"accuracy: {name} loss not finite")
        check(phase.get("frozen_backbone_bitexact", True),
              f"accuracy: {name} moved the frozen backbone")
    others = {k: v for k, v in chain_counts.items() if k != "shift_lerp_grouped"}
    check(not any(others.values()), f"accuracy: other kernels ran {others}")
    check(not loop_waits, f"accuracy: host waits in the loops {loop_waits}")

    reset_counts()
    t0 = time.perf_counter()
    imgs, joints = accuracy_proxy.render_batch(np.random.default_rng(5),
                                               ACCURACY_PROXY_IMAGES)
    embed, losses, _ = accuracy_proxy.pretrain(
        "peclr", imgs, joints, ACCURACY_PROXY_STEPS, 64, 5, 64, "50",
        device=dev)
    proxy_counts = kernel_counts()
    probe = accuracy_proxy.linear_probe(embed, imgs, joints, 64,
                                        3 * ACCURACY_PROXY_IMAGES // 4, 5)
    proxy_seconds = time.perf_counter() - t0
    check(all(math.isfinite(v) for v in losses + list(probe.values())),
          f"accuracy: proxy losses {losses}, probe {probe}")
    check(proxy_counts["shift_lerp_grouped"] == 2 * ACCURACY_PROXY_STEPS,
          f"accuracy: proxy launches {proxy_counts}")
    rn152 = accuracy_rn152(torch, dev)
    run = {"chain_seconds": chain_seconds, "chain_launches": chain_counts,
           "chain_phases": chain["phases"],
           "chain_auc_procrustes": {k: r["auc_procrustes"]
                                    for k, r in by.items()},
           "loop_host_waits": len(loop_waits),
           "proxy_seconds": proxy_seconds, "proxy_launches": proxy_counts,
           "proxy_losses": losses, "proxy_probe_epe_px": probe}
    emit("accuracy", chain_argv=ACCURACY_CHAIN_ARGV, **run)
    emit("accuracy_rn152", **rn152)
    return {**run, "rn152": rn152}


def accuracy_rn152(torch, dev) -> dict:
    """The proxy's pretrain at RN152 at the recipe (RECIPE_PROXY), cut to
    RN152_STEPS steps of each kind: finite losses, kernel 1 launched 2 a
    microbatch and kernels 2-4 never, each step's ms (the card synchronised
    after each, through the probe hook), and the PeCLR/SimCLR ratio of the
    steps after the first."""
    from peclr_tpu_torch.scripts import accuracy_proxy

    t0 = time.perf_counter()
    imgs, joints = accuracy_proxy.render_batch(np.random.default_rng(5),
                                               RECIPE_IMAGES)
    out = {"steps": RN152_STEPS, **RECIPE_PROXY}
    for kind in ("peclr", "simclr"):
        stamps = []

        def stamp(_done, _embed):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())

        reset_counts()
        _, losses, _ = accuracy_proxy.pretrain(
            kind, imgs, joints, RN152_STEPS, seed=5, resnet="152",
            probe_hook=stamp, probe_every=1, device=dev, **RECIPE_PROXY)
        counts = kernel_counts()
        check(all(math.isfinite(v) for v in losses),
              f"accuracy rn152: {kind} losses {losses}")
        for kname, launched in counts.items():
            want = (2 * ACCUM * RN152_STEPS
                    if kname == "shift_lerp_grouped" else 0)
            check(launched == want, f"accuracy rn152: {kind} launched "
                  f"{kname} {launched} times, want {want}")
        out[kind] = {"step_ms": [(b - a) * 1e3
                                 for a, b in zip(stamps, stamps[1:])],
                     "losses": losses, "launches": counts}
    after_first = {kind: float(np.mean(out[kind]["step_ms"][1:]))
                   for kind in ("peclr", "simclr")}
    out["ms_per_step_after_first"] = after_first
    out["peclr_over_simclr"] = after_first["peclr"] / after_first["simclr"]
    out["phase_seconds"] = time.perf_counter() - t0
    return out


def trace_accounting(what: str, summary: dict) -> None:
    """trace_buckets' accounting on a capture of the card: the buckets sum
    to the kernel time; 90% of it or more was linked to the host op that
    launched it (the buckets go by those ops); busy (the union) is no more
    than it, and within 1% of it where one stream ran; busy no more than
    the span."""
    kernel, busy = summary["kernel_ms"], summary["busy_ms"]
    check(summary["op_linked_ms"] >= 0.9 * kernel, f"{what}: only "
          f"{summary['op_linked_ms']} of {kernel} kernel ms linked to an op")
    check(math.isclose(sum(summary["buckets_ms"].values()), kernel,
                       rel_tol=1e-9), f"{what}: buckets do not sum to the "
          "kernel time")
    check(busy <= kernel * (1 + 1e-9), f"{what}: busy {busy} > kernels "
          f"{kernel}")
    if summary["streams"] == 1:
        check(busy >= 0.99 * kernel, f"{what}: busy {busy} not within 1% "
              f"of the kernel time {kernel} on one stream")
    check(busy <= summary["wall_ms"], f"{what}: busy {busy} > span "
          f"{summary['wall_ms']}")


def phase_bench_scripts(torch, dev):
    """Each measurement script's main (peclr_tpu_torch/scripts) at
    BENCH_ARGV's cut size on the card, its artifact into a temporary
    directory: the artifact's keys and accounting, kernel 1 launched as
    BENCH_LAUNCHES says, kernels 2-4 never, and no host wait (torch's sync
    debug mode) inside a window the scripts time with
    scripts.chained_seconds but the wait that ends it.  One line a
    script."""
    from peclr_tpu_torch import scripts as common
    from peclr_tpu_torch.scripts import (
        bench_host_pipeline,
        bench_pred_pipeline,
        bench_serving,
        profile_step,
    )

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="peclr_bench_")
    window_waits = []

    def watched(run, device):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        window_waits.extend(common.host_waits(run))
        torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    real = common.chained_seconds
    common.chained_seconds = watched
    runs = {}
    try:
        for name, module in (
                ("bench_serving", bench_serving),
                ("bench_pred_pipeline", bench_pred_pipeline),
                ("bench_host_pipeline", bench_host_pipeline),
                ("profile_step_pretrain", profile_step),
                ("profile_step_pred", profile_step)):
            window_waits.clear()
            reset_counts()
            t0 = time.perf_counter()
            record = module.main(BENCH_ARGV[name] + [
                "--device", str(dev),
                "--out", os.path.join(tmp, f"{name}.json")])
            torch.cuda.synchronize()
            counts = kernel_counts()
            check(counts["shift_lerp_grouped"] == BENCH_LAUNCHES[name],
                  f"{name}: kernel 1 launched {counts['shift_lerp_grouped']} "
                  f"times, want {BENCH_LAUNCHES[name]}")
            others = {k: v for k, v in counts.items()
                      if k != "shift_lerp_grouped" and v}
            check(not others, f"{name}: other kernels ran {others}")
            check(not window_waits, f"{name}: host waits inside a timed "
                  f"window {window_waits}")
            runs[name] = {"seconds": time.perf_counter() - t0,
                          "launches": counts, "record": record}
            torch.cuda.empty_cache()
    finally:
        common.chained_seconds = real
        shutil.rmtree(tmp, ignore_errors=True)

    serving = runs["bench_serving"]["record"]
    check([r["batch"] for r in serving["rows"]] == [1, 8],
          "bench_serving: the batches")
    for row in serving["rows"]:
        check(set(row) == {"batch", "sync_ms_p50", "sync_ms_p99",
                           "chained_ms", "chained_img_per_s"}
              and row["sync_ms_p99"] >= row["sync_ms_p50"] > 0
              and row["chained_ms"] > 0, f"bench_serving: row {row}")
    pred = runs["bench_pred_pipeline"]["record"]
    check(set(pred["depths"]) == {"1", "2"}, "bench_pred_pipeline: depths")
    check(math.isclose(pred["device_bound_img_per_sec"],
                       pred["batch"] / (pred["device_busy_ms_per_batch"]
                                        / 1e3), rel_tol=1e-9),
          "bench_pred_pipeline: the device bound is not batch / busy")
    trace_accounting("bench_pred_pipeline", pred["profile"])
    host = runs["bench_host_pipeline"]["record"]
    rates = {"host": host["host_only_img_s"],
             "device": host["device_only_img_s"],
             "transfer": host["transfer_img_s"]}
    check(host["bound_by"] == min(rates, key=rates.get),
          f"bench_host_pipeline: bound_by {host['bound_by']} of {rates}")
    for name in ("profile_step_pretrain", "profile_step_pred"):
        for variant, v in runs[name]["record"]["variants"].items():
            trace_accounting(f"{name} {variant}", v["trace"])
    out = {}
    for name, run in runs.items():
        record = run.pop("record")
        if name.startswith("profile_step"):
            record = {variant: {key: v[key] for key in (
                "ms_per_step", "img_per_s")} | {key: v["trace"][key] for key in (
                    "kernel_ms", "op_linked_ms", "busy_ms", "busy_share",
                    "wall_ms", "streams", "buckets_ms")}
                for variant, v in record["variants"].items()}
        elif name == "bench_pred_pipeline":
            record = {k: v for k, v in record.items() if k != "profile"}
        emit(name, argv=BENCH_ARGV[name], **run, artifact=record)
        out[name] = run
    emit("bench_scripts", seconds=time.perf_counter() - t_phase)
    return out


def phase_multichip(torch, dev):
    """The multi-card and stream-rate scripts (module docstring, 12b): one
    line each, and the stream kernels' rows for the kernels line."""
    from peclr_tpu_torch.scripts import (
        bench_multichip,
        bench_streams,
        multihost_harness,
    )

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="peclr_multichip_")
    try:
        t0 = time.perf_counter()
        weak = bench_multichip.main([
            "--world", "1", "--iters", str(MULTICHIP_ITERS),
            "--route", ",".join(PRETRAIN_ROUTES), "--device", "cuda",
            "--out", os.path.join(tmp, "multichip_weak.json")])
        weak_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        table = bench_multichip.main([
            "--scaling_table", "--mesh_sizes", "1,2,4", "--device", "cuda",
            "--out", os.path.join(tmp, "multichip_scaling.json")])
        table_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        harness = multihost_harness.main([
            "--device", "cuda", "--timeout", "300", "--tmpdir", tmp,
            "--out", os.path.join(tmp, "multihost_crossproc.json")])
        harness_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rates = bench_streams.main([
            "--iters", str(STREAM_ITERS), "--device", "cuda",
            "--out", os.path.join(tmp, "stream_rates.json")])
        # the timed launches, not those that held each kernel to its plain
        # version
        stream_launches = rates["timed_launches"]
        streams_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    check(weak["world"] == 1 and weak["collective_backend"] == "nccl",
          f"weak scaling: world {weak['world']}, "
          f"{weak['collective_backend']}")
    for route, got in weak["routes"].items():
        kname = bench_multichip.ROUTE_KERNEL[route]
        for launches in (got["launches_per_step_per_rank"][0],
                         got["no_mesh"]["launches_per_step"]):
            for name, n in launches.items():
                want = 2 * ACCUM if name == kname else 0
                check(n == want, f"weak {route}: {name} launched {n} times a "
                      f"step, want {want}")
        if route != "matmul":
            path = got["last_paths_per_rank"][0][kname]
            check(path == "vec16", f"weak {route}: the step's last shift "
                  f"took the {path} path, want vec16")
        # the BatchNorm across ranks sums the statistics its own way, and
        # bf16 rounds some activations the other side (7.4e-5 through the
        # pretraining CLI at world 1)
        rel = abs(got["loss_step1"] / got["no_mesh"]["loss_step1"] - 1.0)
        check(math.isfinite(got["loss_step1"]) and rel <= 1e-4,
              f"weak {route}: first-step loss {got['loss_step1']} against "
              f"{got['no_mesh']['loss_step1']} without a mesh (rel {rel} > "
              "1e-4)")
        drift = abs(got["no_mesh"]["loss_step1"] - FIRST_STEP_LOSS[route])
        check(drift <= 1e-5, f"weak {route}: the no-mesh first-step loss "
              f"{got['no_mesh']['loss_step1']} moved from "
              f"{FIRST_STEP_LOSS[route]}")
        check(got["host_waits_in_window"] == 0
              and got["no_mesh"]["host_waits_in_window"] == 0,
              f"weak {route}: host waits inside the timed window")
    check([r["mesh"] for r in table["rows"]] == [1, 2, 4]
          and [r["backend"] for r in table["rows"]] == ["nccl", "gloo",
                                                         "gloo"],
          f"scaling table rows {table['rows']}")
    check(table["max_rel_to_mesh1"] <= 5e-5, f"scaling table: "
          f"{table['max_rel_to_mesh1']} > 5e-5 relative to mesh 1")
    check(harness["ok"] and harness["max_rel_err"] < 2e-5
          and harness["collective_backend"] == "gloo",
          f"multihost harness: ok {harness['ok']}, "
          f"{harness.get('max_rel_err')}")
    for key, case in rates["cases"].items():
        exact = case.get("bit_exact") or (
            case.get("max_rel_err_f64", 1.0) <= bench_streams.STATS_TOL)
        check(exact, f"streams {key}: kernel against plain {case}")
        check(case["path"] == "vec16", f"streams {key}: path {case['path']}")
        for row in (case, case["eager"]):
            check(row["share_of_peak"] <= 1.05, f"streams {key}: share "
                  f"{row['share_of_peak']} > 1.05 of the HBM peak")
    check(rates["host_waits_in_windows"] == 0, "streams: host waits inside "
          "a timed window")
    for name in ("stream_copy", "stream_add", "stream_bn_res_relu",
                 "stream_stats"):
        check(stream_launches.get(name, 0) > 0,
              f"streams: {name} never launched")

    emit("multichip_weak", seconds=weak_s, artifact=weak)
    emit("multichip_scaling", seconds=table_s, artifact=table)
    emit("multihost_harness", seconds=harness_s, artifact=harness)
    emit("bench_streams", seconds=streams_s, launches=stream_launches,
         artifact=rates)
    emit("multichip", seconds=time.perf_counter() - t_phase)

    rows = []
    source = "peclr_tpu_torch/csrc/streams.cu"
    for name, pattern, line, library in (
            ("stream_copy", "copy_1r1w", 104, True),
            ("stream_add", "add_2r1w", 110, True),
            ("stream_bn_res_relu", "bn_res_relu_2r1w", 114, False),
            ("stream_stats", "stats", 120, False)):
        case = rates["cases"][f"bf16:{pattern}"]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": (f"none (scripts/bench_streams.py:{line}, an XLA "
                         "fusion of the reference's stream benchmark)"),
            "launches": stream_launches[name],
            # stats is two launches a call: the partials, then their sum
            "launches_per_call": 2 if name == "stream_stats" else 1,
            "max_abs_err": case.get("max_abs_err",
                                    case.get("max_abs_err_f64")),
            "ms": case["ms"], "plain_ms": case["eager"]["ms"],
            "bound_ms": case["bytes"] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": case["eager"]["ms"] if library else None,
            "timed_case": f"bf16:{pattern}", "path": case["path"],
            "f32_ms": rates["cases"][f"f32:{pattern}"]["ms"],
            "f32_bound_ms": (rates["cases"][f"f32:{pattern}"]["bytes"]
                             / HBM_BYTES_PER_S * 1e3)})
    return {"weak": weak, "kernel_rows": rows}


# --------------------------------------------------------------------------
# phase 7b: repeatability on the card


REPEAT_LAUNCHES = 20  # launches of each kernel case, each against the first
RECIPE_LOAD_S = 300.0  # the most the concurrent recipe process runs
RECIPE_LOAD_START_S = 300.0  # the most its first step may take to finish


def repeat_cases(torch, dev):
    """[(name, launch, plain)] of kernels 1-4 at the recipe's shapes (2B =
    256 canvases of 224² to 128² views): kernel 1 pass 1 and 2, kernel 2
    (raw) on pass 1's rows, kernel 3 pass 1, kernel 4 pass 1 with bf16 and
    with f32 taps; each launch makes a new output from the same inputs, and
    plain() the plain version's on the card."""
    from peclr_tpu_torch.ops.shift_lerp import (
        fused_shift_lerp,
        fused_shift_lerp_grouped,
        shift_lerp_flat_plain,
        shift_lerp_grouped_plain,
    )
    from peclr_tpu_torch.ops.shift_lerp_matmul import (
        fused_shift_lerp_matmul,
        shift_lerp_matmul_plain,
    )

    uniform, taps, rows_of, shifts = matmul_inputs(torch, dev, SEED + 40)
    b = 2 * MICROBATCH
    n1, n2 = b * 224, b * 128
    pass1 = rows_of((3, n1, 224), torch.uint8)
    pass2 = rows_of((3, n2, 224), torch.bfloat16)
    flat1 = rows_of((n1, 224 * 3), torch.uint8)
    k1, f1 = shifts(uniform(n1, -424.0, 264.0), 384, 224)
    k2, f2 = shifts(uniform(n2, -296.0, 264.0), 256, 224)
    area = taps(b, 384, 128, 1.0, 2.5, torch.float32)
    bf16, f32 = torch.bfloat16, torch.float32
    area16 = area.to(bf16)
    rows4 = pass1.view(3, b, 224, 224)
    return [
        ("kernel1_pass1_u8_to_bf16",
         lambda: fused_shift_lerp_grouped(pass1, k1, f1, 384, bf16),
         lambda: shift_lerp_grouped_plain(pass1, k1, f1, 384, bf16)),
        ("kernel1_pass2_bf16_to_bf16",
         lambda: fused_shift_lerp_grouped(pass2, k2, f2, 256, bf16),
         lambda: shift_lerp_grouped_plain(pass2, k2, f2, 256, bf16)),
        ("kernel2_raw_pass1_u8",
         lambda: fused_shift_lerp_grouped(pass1, k1, None, 384, None, False),
         lambda: shift_lerp_grouped_plain(pass1, k1, None, 384, None, False)),
        ("kernel3_pass1_u8_to_bf16",
         lambda: fused_shift_lerp(flat1, k1, f1, 384 * 3, 3, bf16),
         lambda: shift_lerp_flat_plain(flat1, k1, f1, 384 * 3, 3, bf16)),
        ("kernel4_pass1_bf16_taps",
         lambda: fused_shift_lerp_matmul(rows4, k1, f1, area16, bf16),
         lambda: shift_lerp_matmul_plain(rows4, k1, f1, area16, bf16)),
        ("kernel4_pass1_f32_taps",
         lambda: fused_shift_lerp_matmul(rows4, k1, f1, area, f32),
         lambda: shift_lerp_matmul_plain(rows4, k1, f1, area, f32)),
    ]


def repeat_launches(torch, cases, reps: int = REPEAT_LAUNCHES) -> dict:
    """Each case launched `reps` times back to back, then every output held
    to the first bit for bit: {case: {launches, differing (outputs not
    equal to the first), ms (the launches' wall, one wait at the end)}}."""
    out = {}
    for name, launch, _plain in cases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [launch() for _ in range(reps)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        differing = sum(not torch.equal(o, outs[0]) for o in outs[1:])
        out[name] = {"launches": reps, "differing": differing, "ms": ms}
        del outs
    return out


def recipe_load(ready: str) -> int:
    """`--recipe-load READY`: the RN50 recipe step (128 x 16, bf16, grouped
    route) in a loop on the card, READY written once the first step is
    done; ends after RECIPE_LOAD_S unless stopped before."""
    import torch

    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
    )
    from peclr_tpu_torch.train.step import make_peclr_train_step

    dev = resolve_device("cuda")
    model, state, opt = build_pretrain_state("50", batch=MICROBATCH,
                                             accum=ACCUM, device=dev)
    batch = synthetic_pretrain_batch(MICROBATCH * ACCUM, 224, SEED + 7,
                                     device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    step = make_peclr_train_step(model, opt, peclr_pretrain_flags(),
                                 AugmentationParams(), accum=ACCUM,
                                 warp_route="grouped")
    t0, steps = time.monotonic(), 0
    while time.monotonic() - t0 < RECIPE_LOAD_S:
        state, metrics = step(state, batch, gen)
        steps += 1
        if steps == 1:
            loss = metrics["loss"].item()  # the first step is done
            with open(ready + ".tmp", "w") as f:
                f.write(f"{loss}\n")
            os.replace(ready + ".tmp", ready)
    print(f"recipe load: {steps} steps", flush=True)
    return 0


def under_recipe_load(run):
    """run() while another process runs the RN50 recipe step on the same
    card (this script re-entered with --recipe-load), started first and
    waited for until its first step is done; the process is stopped after.
    Returns (run()'s result, the first step's loss, the seconds it took to
    start)."""
    tmp = tempfile.mkdtemp(prefix="peclr_smoke_load_")
    ready, log_path = os.path.join(tmp, "ready"), os.path.join(tmp, "log")
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--recipe-load",
             ready], stdout=log, stderr=subprocess.STDOUT,
            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        t0 = time.perf_counter()
        while not os.path.exists(ready):
            if proc.poll() is not None or (
                    time.perf_counter() - t0 > RECIPE_LOAD_START_S):
                with open(log_path) as f:
                    tail = f.read()[-3000:]
                check(False, f"the recipe load did not start (exit "
                      f"{proc.poll()}):\n{tail}")
            time.sleep(0.2)
        start_s = time.perf_counter() - t0
        with open(ready) as f:
            loss = float(f.read())
        result = run()
        check(proc.poll() is None, "the recipe load ended before the "
              "launches under it did")
        return result, loss, start_s
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def output_digest(torch, t):
    """Two integer sums over the bits of `t` (its elements as integers of
    their width, and their squares, in int64): equal for equal bits in any
    order of summation, and moved by a change to any one element."""
    x = t.detach().reshape(-1)
    bits = {4: torch.int32, 2: torch.int16, 1: torch.uint8}[x.element_size()]
    x = x.view(bits).to(torch.int64)
    return torch.stack([x.sum(), (x * x).sum()])


def step_once(torch, model, opt, state, step, batch, draws, snapshot):
    """One step from `snapshot` (model and optimizer state) on `batch` with
    `draws`: (loss, {parameter: gradient}, [(module, output digest)] in the
    order the leaf modules ran)."""
    model.load_state_dict(snapshot[0])
    opt.load_state_dict(snapshot[1])
    state.step = 0
    digests = []
    hooks = [module.register_forward_hook(
        lambda m, i, o, name=name: digests.append(
            (name, output_digest(torch, o))))
        for name, module in model.named_modules()
        if not list(module.children())]
    try:
        state, metrics = step(state, batch, None, draws=draws)
    finally:
        for hook in hooks:
            hook.remove()
    grads = {name: p.grad.detach().clone()
             for name, p in model.named_parameters() if p.grad is not None}
    return metrics["loss"].detach().clone(), grads, digests


def compare_steps(torch, a, b) -> dict:
    """Two step_once results bit for bit: the loss, each gradient (the
    first that differs in the backward pass's order, which runs the
    parameters from the last), the first leaf module whose forward output
    differs."""
    (loss_a, grads_a, dig_a), (loss_b, grads_b, dig_b) = a, b
    differ = [name for name in grads_a
              if not torch.equal(grads_a[name], grads_b[name])]
    first_module = next((na for (na, da), (nb, db) in zip(dig_a, dig_b)
                         if not torch.equal(da, db)), None)
    return {
        "loss_equal": bool(torch.equal(loss_a, loss_b)),
        "loss": [loss_a.item(), loss_b.item()],
        "gradients": len(grads_a), "gradients_differing": len(differ),
        "first_differing_in_backward": differ[-1] if differ else None,
        "max_abs_gradient_diff": max(
            ((grads_a[n] - grads_b[n]).abs().max().item() for n in differ),
            default=0.0),
        "module_outputs": len(dig_a),
        "first_module_output_differing": first_module,
        "equal": bool(torch.equal(loss_a, loss_b)) and not differ
        and first_module is None,
    }


def f32_step_repeat(torch, dev):
    """The recipe step at precision="f32" (TF32 off) on the matmul route,
    twice from the same state, batch and draws, after a warm-up: the loss,
    every gradient and every leaf module's forward output compared bit for
    bit.  Where they differ, again under torch.use_deterministic_algorithms
    (warn only: the ops without a deterministic version are listed) and
    cudnn.deterministic, set here only and restored after."""
    import warnings

    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.ops import augment
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
    )
    from peclr_tpu_torch.train.step import make_peclr_train_step

    flags, params = peclr_pretrain_flags(), AugmentationParams()
    model, state, opt = build_pretrain_state("50", batch=MICROBATCH,
                                             accum=ACCUM, device=dev)
    data = synthetic_pretrain_batch(MICROBATCH * ACCUM, 224, SEED + 7,
                                    device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    draws = [augment.draw(gen, 2 * MICROBATCH, flags, params)
             for _ in range(ACCUM)]
    snapshot = ({k: v.clone() for k, v in model.state_dict().items()},
                copy.deepcopy(opt.state_dict()))
    step = make_peclr_train_step(model, opt, flags, params, accum=ACCUM,
                                 warp_route="matmul", precision="f32")
    args = (torch, model, opt, state, step, data, draws, snapshot)
    step_once(*args)  # the warm-up
    out = {"default": compare_steps(torch, step_once(*args),
                                    step_once(*args))}
    if not out["default"]["equal"]:
        cudnn = torch.backends.cudnn.deterministic
        workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.backends.cudnn.deterministic = True
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                step_once(*args)  # the warm-up of the deterministic plans
                out["deterministic"] = compare_steps(
                    torch, step_once(*args), step_once(*args))
            out["deterministic"]["nondeterministic_ops"] = sorted({
                str(w.message).split(" does not have")[0][:120]
                for w in caught if "deterministic" in str(w.message)})
        finally:
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = cudnn
            if workspace is None:
                os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
            else:
                os.environ["CUBLAS_WORKSPACE_CONFIG"] = workspace
    del model, state, opt, data, snapshot, step
    return out


def repeat_finding(f32: dict) -> str:
    """One sentence on the f32 step's repeatability."""
    d = f32["default"]
    if d["equal"]:
        return (f"f32 matmul-route recipe step repeats to the bit: loss and "
                f"all {d['gradients']} gradients and {d['module_outputs']} "
                "module outputs equal")
    said = (f"f32 matmul-route recipe step does not repeat: loss equal "
            f"{d['loss_equal']}, {d['gradients_differing']} of "
            f"{d['gradients']} gradients differ (first in the backward "
            f"pass: {d['first_differing_in_backward']}, max "
            f"{d['max_abs_gradient_diff']:.3g}), first forward output "
            f"differing: {d['first_module_output_differing']}")
    det = f32["deterministic"]
    if det["equal"]:
        return said + ("; under deterministic algorithms and cuDNN it "
                       "repeats to the bit: the nondeterminism is the "
                       "library's algorithms, not the kernels (bit-equal "
                       "over their launches)")
    return said + (f"; under deterministic algorithms it still differs: "
                   f"{det['gradients_differing']} gradients, first forward "
                   f"output {det['first_module_output_differing']}, ops "
                   f"without a deterministic version "
                   f"{det['nondeterministic_ops']}")


def phase_repeat(torch, dev):
    """Kernels 1-4 at the recipe's shapes, each launched REPEAT_LAUNCHES
    times, every output bit-equal to the first: alone, then while another
    process runs the RN50 recipe step on the card; then the f32 recipe
    step's repeatability (f32_step_repeat) and its finding on a line of
    its own."""
    t_phase = time.perf_counter()
    cases = repeat_cases(torch, dev)
    alone = repeat_launches(torch, cases)
    loaded, load_loss, load_start_s = under_recipe_load(
        lambda: repeat_launches(torch, cases))
    del cases
    torch.cuda.empty_cache()
    for when, runs in (("alone", alone), ("under the recipe load", loaded)):
        for name, run in runs.items():
            check(run["differing"] == 0, f"repeat {name} {when}: "
                  f"{run['differing']} of {run['launches'] - 1} outputs "
                  "differ from the first launch's")
    f32 = f32_step_repeat(torch, dev)
    torch.cuda.empty_cache()
    finding = repeat_finding(f32)
    emit("repeat", launches_per_case=REPEAT_LAUNCHES, alone=alone,
         under_recipe_load=loaded, recipe_load_first_loss=load_loss,
         recipe_load_start_s=load_start_s, f32_step=f32,
         phase_seconds=time.perf_counter() - t_phase)
    emit("repeat_finding", finding=finding)
    return f32


# --------------------------------------------------------------------------
# phase 7c: poisoned buffers


#: the bytes the allocator's free blocks are filled with before a launch:
#: 0xFF is NaN in bf16 and f32, -1 in kernel 4's int32 band and 255 in its
#: flags
POISON_BYTES = (0x00, 0xFF, 0xA5)
#: blocks of each size a launch allocates that are filled before it: twice
#: what the launch takes, and then as many again
POISON_COPIES = 4
#: kernel 4 against its plain version, by output type (the kernel phase's)
MATMUL_TOL = {"torch.bfloat16": 1.0, "torch.float32": 1e-2}


def ragged_cases(torch, dev):
    """[(name, launch, plain)] at ragged shapes: odd row counts; rows and
    outputs whose bytes are not a multiple of 16 (kernels 1-3's scalar
    path) beside an odd row count on the 16-byte path; kernel 4 with a bf16
    source (so with its non-finite flags), four planes (a partial plane
    group), R = 97 (not a multiple of FLAG_ROWS), M = 77 (not a multiple of
    either band tile), U = 131 (not a multiple of the 16-byte vector; dense
    bf16 taps walk two segments of 128) and W = 221, with bf16 and with f32
    taps; the band pass alone at the recipe's pass-1 taps and at the ragged
    ones, of each type."""
    from peclr_tpu_torch.ops.shift_lerp import (
        fused_shift_lerp,
        fused_shift_lerp_grouped,
        shift_lerp_flat_plain,
        shift_lerp_grouped_plain,
    )
    from peclr_tpu_torch.ops.shift_lerp_matmul import (
        band_tile,
        fused_shift_lerp_matmul,
        shift_lerp_matmul_plain,
        tap_band,
        tap_band_plain,
    )

    uniform, taps, rows_of, shifts = matmul_inputs(torch, dev, SEED + 41)
    bf16, f32, u8 = torch.bfloat16, torch.float32, torch.uint8
    n = 1001
    x224, x221 = rows_of((3, n, 224), u8), rows_of((3, n, 221), u8)
    x131 = rows_of((3, 999, 131), bf16)
    flat = rows_of((n, 221 * 3), u8)
    k136, f136 = shifts(uniform(n, -140.0, 226.0), 136, 224)
    k131, f131 = shifts(uniform(n, -135.0, 223.0), 131, 221)
    k77, f77 = shifts(uniform(999, -81.0, 133.0), 77, 131)
    cases = [
        ("kernel1_ragged_vec16_u8_to_bf16",
         lambda: fused_shift_lerp_grouped(x224, k136, f136, 136, bf16),
         lambda: shift_lerp_grouped_plain(x224, k136, f136, 136, bf16)),
        ("kernel1_ragged_scalar_u8_to_bf16",
         lambda: fused_shift_lerp_grouped(x221, k131, f131, 131, bf16),
         lambda: shift_lerp_grouped_plain(x221, k131, f131, 131, bf16)),
        ("kernel1_ragged_scalar_bf16_to_f32",
         lambda: fused_shift_lerp_grouped(x131, k77, f77, 77, f32),
         lambda: shift_lerp_grouped_plain(x131, k77, f77, 77, f32)),
        ("kernel2_raw_ragged_scalar_u8",
         lambda: fused_shift_lerp_grouped(x221, k131, None, 131, None, False),
         lambda: shift_lerp_grouped_plain(x221, k131, None, 131, None,
                                          False)),
        ("kernel3_ragged_scalar_u8_to_bf16",
         lambda: fused_shift_lerp(flat, k131, f131, 131 * 3, 3, bf16),
         lambda: shift_lerp_flat_plain(flat, k131, f131, 131 * 3, 3, bf16)),
    ]
    nb, r, w, u, m = 5, 97, 221, 131, 77
    rows4 = rows_of((4, nb, r, w), bf16)
    k4, f4 = shifts(uniform(nb * r, -(u + 9.0), w + 9.0), u, w)
    dense = uniform((nb, m, u), 0.0, 1.0)  # every tap nonzero, rows sum to 1
    dense = (dense / dense.sum(dim=2, keepdim=True)).to(bf16)
    area = taps(nb, u, m, 1.0, 2.5, f32)
    for name, w_t, out in (("kernel4_ragged_bf16_src_bf16_taps", dense, bf16),
                           ("kernel4_ragged_bf16_src_f32_taps", area, f32)):
        cases.append((
            name,
            lambda w_t=w_t, out=out: fused_shift_lerp_matmul(rows4, k4, f4,
                                                             w_t, out),
            lambda w_t=w_t, out=out: shift_lerp_matmul_plain(rows4, k4, f4,
                                                             w_t, out)))
    recipe = taps(2 * MICROBATCH, 384, 128, 1.0, 2.5, f32)
    for name, w_t in (("tap_band_pass1_bf16", recipe.to(bf16)),
                      ("tap_band_pass1_f32", recipe),
                      ("tap_band_ragged_bf16", dense),
                      ("tap_band_ragged_f32", area)):
        cases.append((name, lambda w_t=w_t: tap_band(w_t),
                      lambda w_t=w_t: tap_band_plain(w_t,
                                                     band_tile(w_t.dtype))))
    return cases


#: the stream ops' shapes in phase 7c: bench_streams' SHAPE, then a ragged
#: one whose element count leaves a tail past the last 16-byte vector and
#: whose C is not a multiple of it (the scalar bn_res_relu and stats)
STREAM_POISON_SHAPES = (("bench", (256, 32, 32, 256)),
                        ("ragged", (7, 9, 11, 37)))


def stream_cases(torch, dev, shapes=STREAM_POISON_SHAPES):
    """[(name, launch, plain)] of the four stream ops of ops/streams.py, in
    bf16 and in f32, at each of `shapes`.  bn_res_relu takes bench_streams'
    checking g and b."""
    from peclr_tpu_torch.ops import streams
    from peclr_tpu_torch.scripts.bench_streams import check_scale_shift

    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    cases = []
    for where, shape in shapes:
        g, b = check_scale_shift(shape[-1], dev)
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=gen, device=dev).to(dtype)
            r = torch.randn(shape, generator=gen, device=dev).to(dtype)
            tag = f"{where}_{str(dtype).split('.')[-1]}"
            cases += [
                (f"stream_copy_{tag}", lambda x=x: streams.stream_copy(x),
                 lambda x=x: streams.copy_plain(x)),
                (f"stream_add_{tag}",
                 lambda x=x, r=r: streams.stream_add(x, r),
                 lambda x=x, r=r: streams.add_plain(x, r)),
                (f"stream_bn_res_relu_{tag}",
                 lambda x=x, r=r, g=g, b=b: streams.stream_bn_res_relu(
                     x, r, g, b),
                 lambda x=x, r=r, g=g, b=b: streams.bn_res_relu_plain(
                     x, r, g, b)),
                # stats' plain() hands back x, whose float64 sums hold it
                (f"stream_stats_{tag}", lambda x=x: streams.stream_stats(x),
                 lambda x=x: x),
            ]
    return cases


@contextlib.contextmanager
def recorded_allocations(torch, into: list):
    """Record (address, bytes) of every CUDA tensor that torch.empty and
    torch.empty_like make inside the context: the wrappers' outputs and
    scratch."""
    empty, empty_like = torch.empty, torch.empty_like

    def record(t):
        if t.is_cuda:
            into.append((t.data_ptr(), t.untyped_storage().nbytes()))
        return t

    torch.empty = lambda *a, **k: record(empty(*a, **k))
    torch.empty_like = lambda *a, **k: record(empty_like(*a, **k))
    try:
        yield
    finally:
        torch.empty, torch.empty_like = empty, empty_like


def recorded_launch(torch, dev, name, launch, allocs: list):
    """launch() with its buffers recorded into `allocs`; the case may make
    no other allocation (the checks below would not cover it)."""
    stat = "allocation.all.allocated"
    before = torch.cuda.memory_stats(dev)[stat]
    with recorded_allocations(torch, allocs):
        out = launch()
    made = torch.cuda.memory_stats(dev)[stat] - before
    torch.cuda.synchronize(dev)
    check(made == len(allocs), f"poison {name}: the launch made {made} "
          f"allocations, {len(allocs)} of them the wrapper's buffers")
    return out


def poison_free_blocks(torch, dev, sizes, byte: int) -> list:
    """Empty the caching allocator's cache, then take POISON_COPIES blocks
    of each size (rounded up to the allocator's 512-byte blocks), fill them
    with `byte` and free them all.  Freed, they merge back into the free
    blocks they were cut from, so the allocator hands the next requests of
    these sizes the blocks it handed these: filled ones.  Returns the
    filled address ranges, merged: [(start, end)]."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    held = [torch.empty(-(-size // 512) * 512, dtype=torch.uint8,
                        device=dev).fill_(byte)
            for size in sizes for _ in range(POISON_COPIES)]
    torch.cuda.synchronize(dev)
    spans = sorted((t.data_ptr(), t.data_ptr() + t.numel()) for t in held)
    del held
    merged = []
    for start, end in spans:
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def written_outside(torch, dev, sizes, byte: int, spans, keep) -> int:
    """After a launch that followed poison_free_blocks: the bytes of the
    filled ranges `spans` that no longer hold `byte`, outside the wrapper's
    buffers `keep` ([(address, bytes)]).  POISON_COPIES blocks of each size
    are taken from the allocator again (not filled), and each is read where
    it lies in the filled ranges: a kernel that writes past its buffers
    into a neighbouring block shows here."""
    held = [torch.empty(-(-size // 512) * 512, dtype=torch.uint8, device=dev)
            for size in sizes for _ in range(POISON_COPIES)]
    changed = 0
    for block in held:
        p, n = block.data_ptr(), block.numel()
        mask = torch.zeros(n, dtype=torch.bool, device=dev)
        for start, end in spans:
            if start < p + n and end > p:
                mask[max(start, p) - p:min(end, p + n) - p] = True
        for start, nbytes in keep:
            if start < p + n and start + nbytes > p:
                mask[max(start, p) - p:min(start + nbytes, p + n) - p] = False
        changed += int(((block != byte) & mask).sum())
    return changed


def bits_of(torch, t):
    """t's elements as integers of their width (NaN compares by its bits)."""
    return t.reshape(-1).view(
        {4: torch.int32, 2: torch.int16, 1: torch.uint8}[t.element_size()])


def same_bits(torch, a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(bits_of(torch, a), bits_of(torch, b)))


def poison_case(torch, dev, name, launch, plain) -> dict:
    """One case of phase 7c: launched once as it is, then once after each
    of POISON_BYTES filled the allocator's free blocks of the sizes the
    launch allocates; every output bit-equal to the first, every buffer the
    wrapper allocated inside the filled ranges, no filled byte outside them
    changed (written_outside), and the first output against
    plain() (bit for bit for kernels 1-3, the band pass and the elementwise
    stream ops; kernel 4 within MATMUL_TOL; stats within bench_streams'
    STATS_TOL of the float64 sum)."""
    from peclr_tpu_torch.scripts.bench_streams import STATS_TOL, _stats_err

    t0 = time.perf_counter()
    allocs = []
    first = recorded_launch(torch, dev, name, launch, allocs)
    path = None
    if name.startswith(("kernel1", "kernel2", "kernel3")):
        path = shift_paths()["flat" if name.startswith("kernel3")
                             else "grouped"]
        for want in ("vec16", "scalar"):
            check(f"_{want}_" not in name or path == want,
                  f"poison {name}: took the {path} path")
    sizes = sorted({n for _, n in allocs}, reverse=True)
    poisoned, differing, outside = [], [], []
    for byte in POISON_BYTES:
        spans = poison_free_blocks(torch, dev, sizes, byte)
        got_allocs = []
        got = recorded_launch(torch, dev, name, launch, got_allocs)
        inside = sum(any(s <= p and p + n <= e for s, e in spans)
                     for p, n in got_allocs)
        poisoned.append(f"{inside}/{len(got_allocs)}")
        outside.append(written_outside(torch, dev, sizes, byte, spans,
                                       got_allocs))
        check(len(got_allocs) == len(allocs) and inside == len(allocs),
              f"poison {name} {byte:#04x}: {inside} of {len(got_allocs)} "
              "buffers came from the filled blocks")
        if not same_bits(torch, got, first):
            differing.append(f"{byte:#04x}")
        del got
    row = {"case": name, "shape": list(first.shape),
           "dtype": str(first.dtype), "path": path, "buffers": len(allocs),
           "buffer_bytes": sum(n for _, n in allocs),
           "poisoned_buffers": poisoned, "differing_patterns": differing,
           "bytes_written_outside": outside}
    ref = plain()
    if name.startswith("stream_stats"):
        row["max_rel_err_f64"], row["max_abs_err"] = _stats_err(first, ref)
        row["tolerance"] = STATS_TOL
        ok = row["max_rel_err_f64"] <= STATS_TOL
    elif name.startswith("kernel4"):
        row["max_abs_err"] = (first.float() - ref.float()).abs().max().item()
        row["tolerance"] = MATMUL_TOL[str(first.dtype)]
        ok = (row["max_abs_err"] <= row["tolerance"]
              and bool(torch.isfinite(first).all()))
    else:
        ok = same_bits(torch, first, ref)
        row["max_abs_err"] = (0.0 if ok else
                              (first.float() - ref.float()).abs().max().item())
        row["tolerance"] = 0.0
    check(not differing, f"poison {name}: the output after filling with "
          f"{differing} differs from the unpoisoned one: the kernel reads or "
          "leaves memory it does not own")
    check(not any(outside), f"poison {name}: {outside} bytes of the filled "
          "blocks outside its buffers changed: the kernel writes past them")
    check(ok, f"poison {name}: against its plain version {row}")
    row["seconds"] = time.perf_counter() - t0
    return row


#: the kernels line's row of each case, by the case's name
POISON_KERNEL_OF = (
    ("kernel1", "shift_lerp_grouped"), ("kernel2", "shift_raw_grouped"),
    ("kernel3", "shift_lerp_flat"), ("kernel4", "shift_lerp_matmul"),
    ("tap_band", "shift_lerp_matmul"), ("stream_copy", "stream_copy"),
    ("stream_add", "stream_add"), ("stream_bn_res_relu", "stream_bn_res_relu"),
    ("stream_stats", "stream_stats"))


def phase_poison(torch, dev) -> dict:
    """Each kernel's output independent of what its buffers held before
    (module docstring, 7c): the repeat phase's recipe cases, the ragged
    ones, the band pass alone and the four stream ops, each launched as it
    is and after each of POISON_BYTES filled the allocator's free blocks.
    Returns {kernels line row: {cases, bit_equal, patterns}}."""
    t_phase = time.perf_counter()
    rows = []
    for source in (repeat_cases, ragged_cases, stream_cases):
        cases = source(torch, dev)
        rows += [poison_case(torch, dev, *case) for case in cases]
        del cases
        torch.cuda.empty_cache()
    summary = {}
    for row in rows:
        kernel = next(k for prefix, k in POISON_KERNEL_OF
                      if row["case"].startswith(prefix))
        entry = summary.setdefault(kernel, {
            "cases": 0, "bit_equal": True, "bytes_written_outside": 0,
            "patterns": [f"{b:#04x}" for b in POISON_BYTES]})
        entry["cases"] += 1
        entry["bit_equal"] &= not row["differing_patterns"]
        entry["bytes_written_outside"] += sum(row["bytes_written_outside"])
    emit("poison", cases=rows, kernels=summary,
         phase_seconds=time.perf_counter() - t_phase)
    return summary


# --------------------------------------------------------------------------
# phase 8/9: the initial weights the trainer and the fine-tune CLI draw


def initial_weight_stats(model) -> dict:
    """The stem's standard deviation and the first dense layer's against
    the reference's (He-normal on fan_out, lecun-normal on fan_in), and the
    largest bias of a convolution or dense layer (0 in the reference)."""
    from torch import nn

    stem = next(m for m in model.modules()
                if isinstance(m, nn.Conv2d) and m.kernel_size == (7, 7))
    fc_name, fc = next((n, m) for n, m in model.named_modules()
                       if isinstance(m, nn.Linear))
    biases = [m.bias for m in model.modules()
              if isinstance(m, (nn.Conv2d, nn.Linear)) and m.bias is not None]
    return {
        "stem_std": stem.weight.std().item(),
        "stem_std_reference": math.sqrt(2.0 / (stem.out_channels * 49)),
        "fc": fc_name, "fc_std": fc.weight.std().item(),
        "fc_std_reference": 1.0 / math.sqrt(fc.in_features),
        "max_abs_bias": max(b.abs().max().item() for b in biases),
        "max_abs_bias_reference": 0.0,
    }


@contextlib.contextmanager
def drawn_weights(stats: list):
    """Record initial_weight_stats of each model drawn by init_as_reference
    (the trainer reads it from train/loop.py, the fine-tune CLI from
    models/init.py), as it is drawn."""
    from peclr_tpu_torch.models import init
    from peclr_tpu_torch.train import loop

    real = init.init_as_reference

    def draw(model, seed):
        out = real(model, seed)
        stats.append(initial_weight_stats(out))
        return out

    init.init_as_reference = loop.init_as_reference = draw
    try:
        yield
    finally:
        init.init_as_reference = loop.init_as_reference = real


def check_initial_weights(what: str, stats: list) -> None:
    """Each drawn model's stem and first dense layer within 5% of the
    reference's standard deviation (a few thousand weights or more: the
    sample's own error is under 1.5%), every bias exactly 0; one line."""
    check(bool(stats), f"{what}: no model drawn by init_as_reference")
    for s in stats:
        for key in ("stem_std", "fc_std"):
            rel = abs(s[key] / s[key + "_reference"] - 1.0)
            check(rel < 0.05, f"{what}: {key} {s[key]} against the "
                  f"reference's {s[key + '_reference']}")
        check(s["max_abs_bias"] == 0.0, f"{what}: a bias of "
              f"{s['max_abs_bias']}, the reference's are 0")
    emit(what + "_initial_weights", models=stats, tolerance_rel=0.05)


# --------------------------------------------------------------------------
# phase 12c: the entry point; 12d: the perf guard


#: entry()'s bf16 projection on the card against the same model's f32
#: projection on the CPU, over the largest f32 value (0.6% on the CPU's own
#: bf16 autocast)
ENTRY_TOL = 5e-2


def phase_entry(torch, dev):
    """peclr_tpu_torch.entry.entry(): the RN50 projection of its example
    (8 x 128² zeros) on the card under bf16 autocast: shape (8, 128),
    float32, finite, no host wait (after one warm-up call); its ms; and on
    seeded images (the example's projection is 0: zero biases, BatchNorm at
    its initial statistics) within ENTRY_TOL of the CPU's f32."""
    from peclr_tpu_torch.entry import entry
    from peclr_tpu_torch.scripts import host_waits

    fn, args = entry()
    model, images = args
    check(images.is_cuda and next(model.parameters()).is_cuda,
          "entry: the example is not on the card")
    fn(*args)
    waits = host_waits(lambda: fn(*args))
    out = fn(*args)
    torch.cuda.synchronize()
    check(out.is_cuda and tuple(out.shape) == (8, 128)
          and out.dtype == torch.float32, f"entry: output {out.shape} "
          f"{out.dtype} on {out.device}")
    check(bool(torch.isfinite(out).all()), "entry: projection not finite")
    check(not waits, f"entry: the host waited on the card at {waits}")
    x = torch.from_numpy(np.random.default_rng(SEED + 50).standard_normal(
        tuple(images.shape)).astype(np.float32))
    got = fn(model, x.to(dev)).cpu()
    want = fn(copy.deepcopy(model).cpu(), x)
    rel = ((got - want).abs().max() / want.abs().max()).item()
    check(rel <= ENTRY_TOL, f"entry: card bf16 against CPU f32 {rel} > "
          f"{ENTRY_TOL}")
    emit("entry", shape=list(out.shape), dtype=str(out.dtype),
         host_waits=len(waits), ms=cuda_ms(lambda: fn(*args), 20),
         example_projection_abs_max=out.abs().max().item(),
         seeded_card_bf16_vs_cpu_f32=rel, tolerance=ENTRY_TOL)


def phase_bench_guard(torch, dev):
    """scripts/bench_guard.py's four phases cut to 2 iterations and one
    window, its artifact into a temporary directory: every rate and ms
    finite and positive, busy ms measured for finetune and pred, kernel 1
    launched 32 a recipe step, 2 a fine-tune step and 4 a two-pass batch
    (profile_step's warm-up and the profiled window included), kernels 2-4
    never.  The band verdict is printed, not checked: a cut run is noise."""
    from peclr_tpu_torch.scripts import bench_guard, profile_step

    iters = 2
    tmp = tempfile.mkdtemp(prefix="peclr_smoke_guard_")
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        record = bench_guard.main(["--iters", str(iters), "--windows", "1",
                                   "--out", os.path.join(tmp, "guard.json")])
        seconds = time.perf_counter() - t0
        counts = kernel_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, p in record["phases"].items():
        keys = ["img_per_sec", "ms_per_step"] + (
            ["trace_busy_ms", "wall_ms"] if name in bench_guard.PROFILED
            else [])
        for key in keys:
            value = p[key]
            check(value is not None and math.isfinite(value) and value > 0,
                  f"bench_guard {name}: {key} = {value}")
    runs = profile_step.WARMUP + iters  # a timed window's calls
    want = {"shift_lerp_grouped": 2 * 2 * ACCUM * runs
            + (2 + 4) * (runs + iters)}
    for kname, launched in counts.items():
        check(launched == want.get(kname, 0), f"bench_guard: {kname} "
              f"launched {launched} times, want {want.get(kname, 0)}")
    emit("bench_guard", seconds=seconds, launches=counts,
         verdict={n: p["pass"] for n, p in record["phases"].items()},
         verdict_checked=False, record=record)


def main() -> int:
    global CARD
    try:
        import peclr_tpu_torch  # noqa: F401  (beside this script)
    except ImportError:
        print("chip_smoke: the peclr_tpu_torch package is not beside this "
              "script; run it from the root of the repository",
              file=sys.stderr)
        return 3
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from peclr_tpu_torch import build
    from peclr_tpu_torch.data.synthetic import (
        seeded_frames,
        seeded_intrinsics,
        seeded_rn25d_variables,
    )
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.eval.pred_fh import (
        _preprocess,
        initial_affine,
        make_two_pass_predictor,
        padded_batches,
        pipelined,
        refine_affine,
        run_two_pass,
    )
    from peclr_tpu_torch.eval.serving import InferenceSession
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.models.port import rn25d_variables_to_state_dict
    from peclr_tpu_torch.ops.shift_lerp import fused_shift_lerp_grouped
    from peclr_tpu_torch.ops.warp_mxu import affine_warp_mxu

    t_start = time.perf_counter()
    smi = CARD = card_line()
    dev = resolve_device("cuda")
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    per_source = build.build(["shift_lerp", "shift_lerp_matmul", "streams",
                              "jpeg_decode"])
    emit("build", seconds=time.perf_counter() - t0, per_source=per_source,
         arch="sm_90a", host_sources=["jpeg_decode"])
    # ---- 2a. the port's JPEG decode pool on this host ----------------------
    phase_decode(torch, dev)

    # ---- 3. kernel against plain -------------------------------------------
    kernel_rows = phase_kernel(torch, dev)
    flat_rows = phase_flat_kernel(torch, dev)
    matmul_rows = phase_matmul_kernel(torch, dev)
    nonfinite_rows = phase_matmul_nonfinite(torch, dev)
    phase_tf32(torch, dev)

    # ---- 4. warp at the pred_fh geometry -------------------------------------
    frames = seeded_frames(N_FRAMES, SEED)
    Ks = seeded_intrinsics(N_FRAMES, SEED + 1)
    imgs = torch.from_numpy(frames[:BATCH]).to(dev)
    T = pred_fh_affines(torch, BATCH, SEED + 2).to(dev)

    def warp():
        return affine_warp_mxu(imgs, T, (224, 224), fill_value=0.485,
                               max_scale=3.0)

    got = warp()
    with plain_shift():
        ref = warp()
        plain_warp_ms = cuda_ms(warp, 3)
    warp_ms = cuda_ms(warp, 10)
    warp_device_ms = device_ms(warp, 5)
    warp_abs = (got - ref).abs().max().item()
    check(got.dtype == torch.float32 and got.shape == (BATCH, 224, 224, 3),
          "warp output shape/dtype")
    check(warp_abs <= 2.5, f"warp kernel vs plain max_abs {warp_abs} > 2.5")
    emit("warp", geometry="pred_fh", batch=BATCH, out_hw=[224, 224],
         compute_dtype="bfloat16", max_abs=warp_abs, tolerance=2.5,
         ms=warp_ms, device_ms=warp_device_ms, plain_ms=plain_warp_ms)
    phase_recipe_warp(torch, dev)

    # ---- 5. the slice: two-pass RN50 inference ---------------------------------
    model = RN25DPose("50")
    model.load_state_dict(
        rn25d_variables_to_state_dict(seeded_rn25d_variables("50", SEED), "50"),
        strict=True)
    model = model.to(dev).eval()
    x0 = torch.from_numpy(frames[:BATCH]).to(dev)
    K0 = torch.from_numpy(Ks[:BATCH]).to(dev)

    kern = run_two_pass(model, x0, K0)  # also warms cuDNN up
    with plain_shift():
        plain = run_two_pass(model, x0, K0)
    torch.cuda.synchronize()
    kp_abs = (kern["kp25d_1"] - plain["kp25d_1"]).abs().max().item()
    t2_abs = (kern["T2"] - plain["T2"]).abs().max().item()
    # the kernel matches the plain version bit for bit (phase 3), so the
    # same warp feeds the same model: pass-1 keypoints agree to 1e-3 px
    check(kp_abs <= 1e-3, f"pass-1 kp25d kernel vs plain {kp_abs} px > 1e-3")
    for key, value in kern.items():
        check(bool(torch.isfinite(value).all()), f"{key} not finite")

    # reference on a small input: the card against the CPU, both in f32
    cpu_model = RN25DPose("50")
    cpu_model.load_state_dict(model.state_dict())
    cpu_model.eval()
    small = frames[:2]
    T_small = T[:2].cpu()
    with torch.inference_mode():
        crop_cpu = affine_warp_mxu(torch.from_numpy(small), T_small,
                                   (224, 224), fill_value=0.485, max_scale=3.0)
        crop_gpu = affine_warp_mxu(torch.from_numpy(small).to(dev),
                                   T_small.to(dev), (224, 224),
                                   fill_value=0.485, max_scale=3.0,
                                   compute_dtype=torch.float32)
        warp_ref_abs = (crop_gpu.cpu() - crop_cpu).abs().max().item()
        img_cpu = _preprocess(torch.from_numpy(small), T_small)
        K_small = torch.from_numpy(Ks[:2])
        out_cpu = cpu_model(img_cpu, K=K_small)
        out_gpu = model(img_cpu.to(dev), K=K_small.to(dev))
        model_ref_abs = (out_gpu["kp25d"].cpu() - out_cpu["kp25d"]).abs().max().item()
        model_ref_scale = out_cpu["kp25d"].abs().max().item()
    check(warp_ref_abs <= 1e-2, f"f32 warp card vs CPU {warp_ref_abs} > 1e-2")
    check(model_ref_abs <= 1e-3 * max(model_ref_scale, 1.0),
          f"RN50 kp25d card vs CPU {model_ref_abs}")

    # the main path: each mode's counts are set to 0 just before its run and
    # read just after; the modes take turns so that drift shows up in both
    runs = {"lerp_in_kernel": [], "raw_kernel": []}
    kp3d_of = {}
    for _ in range(SLICE_REPS):
        for mode, lerp_in_kernel in (("lerp_in_kernel", True),
                                     ("raw_kernel", False)):
            predict = make_two_pass_predictor(
                model, lerp_in_kernel=lerp_in_kernel, device=dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            before = torch.cuda.memory_allocated(dev)
            reset_counts()
            t0 = time.perf_counter()
            outs = list(pipelined(
                predict,
                padded_batches(frames.__getitem__, Ks, N_FRAMES, BATCH),
                depth=2, device=dev,
            ))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            run = {
                "launches": fused_shift_lerp_grouped.launches,
                "raw_launches": fused_shift_lerp_grouped.raw_launches,
                "seconds": seconds,
                "img_per_s": N_FRAMES / seconds,
                "ms_per_batch": seconds / len(outs) * 1e3,
                "peak_mem_bytes": torch.cuda.max_memory_allocated(dev),
                "allocated_before_bytes": before,
                "batches": len(outs),
            }
            kp3d = np.concatenate([o for _, o in outs])
            check(kp3d.shape == (N_FRAMES, 21, 3),
                  f"{mode}: kp3d shape {kp3d.shape}")
            check(bool(np.isfinite(kp3d).all()), f"{mode}: kp3d not finite")
            run["path"] = shift_paths()["grouped"]
            check(run["path"] == "vec16", f"{mode}: the slice's last shift "
                  f"took the {run['path']} path, want vec16")
            launched = run["launches" if lerp_in_kernel else "raw_launches"]
            check(launched >= 4 * run["batches"],
                  f"{mode}: kernel launched {launched} times for "
                  f"{run['batches']} batches, fewer than 4 per batch")
            if mode in kp3d_of:
                check(np.array_equal(kp3d, kp3d_of[mode]),
                      f"{mode}: output changed between runs")
            kp3d_of[mode] = kp3d
            runs[mode].append(run)
    mode_abs = float(np.abs(kp3d_of["lerp_in_kernel"]
                            - kp3d_of["raw_kernel"]).max())

    # where one batch's time goes, from CUDA events between the stages
    T1 = torch.as_tensor(initial_affine(), device=dev).expand(BATCH, 3, 3)
    K0f = K0.to(torch.float32)
    with torch.inference_mode():
        for _ in range(3):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            img1 = _preprocess(x0, T1)
            ev[1].record()
            out1 = model(img1, K=torch.einsum("bij,bjk->bik", T1, K0f))
            ev[2].record()
            T2 = refine_affine(out1["kp25d"][..., :2], T1)
            ev[3].record()
            img2 = _preprocess(x0, T2)
            ev[4].record()
            model(img2, K=torch.einsum("bij,bjk->bik", T2, K0f))
            ev[5].record()
            torch.cuda.synchronize()
    stages = ("warp_1", "model_1", "refine", "warp_2", "model_2")
    breakdown = {s: ev[i].elapsed_time(ev[i + 1]) for i, s in enumerate(stages)}

    emit("slice", model="RN25DPose RN50 (RN_25D_wMLPref), f32, TF32 off",
         batch=BATCH, frames=N_FRAMES, depth=2, breakdown_ms=breakdown,
         pass1_kp25d_kernel_vs_plain_px=kp_abs, pass1_kp25d_tolerance_px=1e-3,
         T2_kernel_vs_plain=t2_abs,
         f32_warp_card_vs_cpu=warp_ref_abs, rn50_kp25d_card_vs_cpu=model_ref_abs,
         kp3d_lerp_vs_raw_mode=mode_abs, runs=runs)

    # ---- 6. serving --------------------------------------------------------------
    sess = InferenceSession(model, batch_size=32, image_size=128,
                            device=dev).warmup()
    rng = np.random.default_rng(SEED + 3)
    latencies = []
    for size in (32, 7, 45, 1, 32):
        req = rng.integers(0, 256, (size, 128, 128, 3), dtype=np.uint8)
        t0 = time.perf_counter()
        out = sess.predict(req)
        latencies.append({"images": size,
                          "ms": (time.perf_counter() - t0) * 1e3})
        check(out["kp3d"].shape == (size, 21, 3)
              and bool(np.isfinite(out["kp3d"]).all()),
              f"serving request of {size}")
    emit("serving", batch=32, image_size=128, requests=latencies)
    del sess, cpu_model
    torch.cuda.empty_cache()

    # ---- 6a. no path makes the host wait on the card -----------------------------
    phase_host_waits(torch, dev, model, x0, K0)
    del model
    torch.cuda.empty_cache()

    # ---- 7. the pretrain step ------------------------------------------------------
    pretrain_runs = phase_pretrain(torch, dev)
    phase_pretrain_vs_cpu(torch, dev)
    # ---- 7a. the recipe step in f32 through kernel 4's f32 taps -----------------
    f32_runs = phase_pretrain_f32_matmul(torch, dev)
    # ---- 7b. repeatability: the kernels alone and under load, the f32 step ------
    phase_repeat(torch, dev)
    # ---- 7c. poisoned buffers ----------------------------------------------------
    poison = phase_poison(torch, dev)

    # ---- 8. the trainer through its CLI; 9. fine-tune and evaluate from its
    # checkpoint --------------------------------------------------------------------
    root = tempfile.mkdtemp(prefix="peclr_smoke_")
    try:
        trainer_run, pretrained = phase_trainer(torch, dev, root)
        finetune_run = phase_finetune(torch, dev, pretrained, root)
        # ---- 10. every augmentation flag, through the same CLI -----------------
        ablation_run = phase_ablation(torch, dev)
        # ---- 11. data parallel ----------------------------------------------------
        ddp_run = phase_ddp(torch, dev, root, trainer_run)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # ---- 12. the accuracy path; 12a. the measurement scripts ---------------------
    accuracy_run = phase_accuracy(torch, dev)
    phase_bench_scripts(torch, dev)
    # ---- 12b. the multi-card and stream-rate scripts ------------------------------
    multichip_run = phase_multichip(torch, dev)
    from peclr_tpu_torch.scripts.bench_multichip import ROUTE_KERNEL
    weak_launches = {route: multichip_run["weak"]["routes"][route][
        "launches_per_step_per_rank"][0][ROUTE_KERNEL[route]]
        for route in PRETRAIN_ROUTES}
    # ---- 12c. the entry point; 12d. the perf guard, cut ----------------------------
    phase_entry(torch, dev)
    phase_bench_guard(torch, dev)

    # ---- 13. kernels line --------------------------------------------------------
    def summary(name, source, replaces, launches, rows, timed_case, **extra):
        timed = next(r for r in rows if r["case"] == timed_case)
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs"] for r in rows),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"], "timed_case": timed_case,
            "device_ms": timed["device_ms"], **extra,
        }

    shift_src = "peclr_tpu_torch/csrc/shift_lerp.cu"
    matmul_of = {r["case"]: r for r in matmul_rows}
    kernel_of = {r["case"]: r for r in kernel_rows}
    flat_of = {r["case"]: r for r in flat_rows}
    kernels = [
        summary("shift_lerp_grouped", shift_src,
                "peclr_tpu/ops/pallas/barrel_shift.py:100",
                runs["lerp_in_kernel"][0]["launches"],
                [r for r in kernel_rows if r["lerp"]], "pass2_bf16_to_bf16",
                launches_per_pretrain_step=pretrain_runs["grouped"][0][
                    "launches"]["shift_lerp_grouped"],
                launches_per_trainer_epoch=[
                    e["launches"]["shift_lerp_grouped"]
                    for e in trainer_run],
                launches_per_finetune_step=finetune_run["launches_per_step"],
                launches_per_eval_batch=finetune_run[
                    "launches_per_eval_batch"],
                launches_per_ablation_epoch=[
                    e["launches"]["shift_lerp_grouped"]
                    for e in ablation_run["epochs"]],
                launches_per_ddp_step_per_rank=ddp_run["rn50"][
                    "launches_per_rank"]["shift_lerp_grouped"],
                launches_per_weak_scaling_step=weak_launches["grouped"],
                launches_per_ddp_cli_epoch=[
                    e["launches"]["shift_lerp_grouped"]
                    for e in ddp_run["cli"]["epochs"]],
                ablation_pass1_ms=kernel_of["ablation_pass1_bf16_to_bf16"][
                    "ms"],
                ablation_pass1_device_ms=kernel_of[
                    "ablation_pass1_bf16_to_bf16"]["device_ms"],
                finetune_ms={r["case"]: r["ms"] for r in kernel_rows
                             if r["case"].startswith("finetune_")},
                finetune_device_ms={r["case"]: r["device_ms"]
                                    for r in kernel_rows
                                    if r["case"].startswith("finetune_")},
                path=kernel_of["pass2_bf16_to_bf16"]["path"],
                pretrain_ms={r["case"]: r["ms"] for r in kernel_rows
                             if r["case"].startswith("pretrain_")},
                pretrain_device_ms={r["case"]: r["device_ms"]
                                    for r in kernel_rows
                                    if r["case"].startswith("pretrain_")},
                launches_per_accuracy_chain=accuracy_run["chain_launches"][
                    "shift_lerp_grouped"],
                launches_per_accuracy_proxy=accuracy_run["proxy_launches"][
                    "shift_lerp_grouped"],
                launches_per_accuracy_rn152_run={
                    kind: accuracy_run["rn152"][kind]["launches"][
                        "shift_lerp_grouped"] for kind in ("peclr", "simclr")},
                proxy={r["case"]: {key: r[key] for key in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "path")}
                    for r in kernel_rows if r["case"].startswith("proxy_")}),
        summary("shift_raw_grouped", shift_src,
                "peclr_tpu/ops/pallas/barrel_shift.py:118",
                runs["raw_kernel"][0]["raw_launches"],
                [r for r in kernel_rows if not r["lerp"]], "raw_pass2_bf16",
                path=kernel_of["raw_pass2_bf16"]["path"]),
        summary("shift_lerp_flat", shift_src,
                "peclr_tpu/ops/pallas/barrel_shift.py:163",
                pretrain_runs["nhwc"][0]["launches"]["shift_lerp_flat"],
                flat_rows, "flat_pass2_bf16_to_bf16",
                path=flat_of["flat_pass2_bf16_to_bf16"]["path"],
                pass1_ms=flat_of["flat_pass1_u8_to_bf16"]["ms"],
                pass1_device_ms=flat_of["flat_pass1_u8_to_bf16"]["device_ms"],
                launches_per_ablation_step=ablation_run["routes"]["nhwc"][
                    "launches"]["shift_lerp_flat"],
                launches_per_ddp_step_per_rank=weak_launches["nhwc"],
                ablation_pass1_ms=flat_of["flat_ablation_pass1_bf16_to_bf16"][
                    "ms"],
                ablation_pass1_device_ms=flat_of[
                    "flat_ablation_pass1_bf16_to_bf16"]["device_ms"]),
        summary("shift_lerp_matmul",
                "peclr_tpu_torch/csrc/shift_lerp_matmul.cu",
                "peclr_tpu/ops/pallas/barrel_shift.py:392",
                pretrain_runs["matmul"][0]["launches"]["shift_lerp_matmul"],
                matmul_rows, "matmul_pass1_u8_to_bf16",
                grouped_route_ms=matmul_of["matmul_pass1_u8_to_bf16"][
                    "grouped_route_ms"],
                band_taps_mean=matmul_of["matmul_pass1_u8_to_bf16"][
                    "band_taps_mean"],
                pass2_ms=matmul_of["matmul_pass2_bf16_to_f32"]["ms"],
                band_pass_device_ms=matmul_of["tap_band_pass1"]["device_ms"],
                launches_per_f32_step=f32_runs["matmul"]["launches"][
                    "shift_lerp_matmul"],
                launches_per_ddp_step_per_rank=weak_launches["matmul"],
                f32_taps={case: {key: matmul_of[case][key] for key in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "grouped_route_ms", "band_taps_mean", "max_abs")}
                    for case in ("matmul_pass1_f32_taps_u8_to_f32",
                                 "matmul_pass2_f32_taps_to_f32")},
                f32_band_pass_device_ms=matmul_of["tap_band_pass1_f32"][
                    "device_ms"],
                launches_per_ablation_step=ablation_run["routes"]["matmul"][
                    "launches"]["shift_lerp_matmul"],
                ablation_pass1_ms=matmul_of[
                    "matmul_ablation_pass1_bf16_to_bf16"]["ms"],
                ablation_pass1_device_ms=matmul_of[
                    "matmul_ablation_pass1_bf16_to_bf16"]["device_ms"],
                nonfinite={r["case"]: r["device_ms"] for r in nonfinite_rows},
                nonfinite_max_abs=max(r["max_abs"] for r in nonfinite_rows)),
        *multichip_run["kernel_rows"],
    ]
    for row in kernels:
        row["poison"] = poison[row["name"]]
        # compute-sanitizer refuses this card's host (module docstring, 13)
        row["sanitizer"] = None
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def turns_main() -> int:
    """`--turns`: what compares this tree with another one on one card,
    each run in its own process, in turns (parent, change, change, parent;
    the other tree unpacked with this script copied into it): kernel 4's
    f32-tap passes of the recipe (matmul_row), the host waits of every path
    (phase_host_waits, not required to be none), the leaderboard's img/s
    (3 runs of the slice's 4 batches of 120, after one) and the grouped
    recipe step's ms (2 steps after one) and profiled busy share.  One JSON
    line {"turns": ...}; only these public functions of the package are
    used, so that an older tree runs it too."""
    import torch

    from peclr_tpu_torch import build
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.data.synthetic import (
        seeded_frames,
        seeded_intrinsics,
        seeded_rn25d_variables,
    )
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.eval.pred_fh import (
        make_two_pass_predictor,
        padded_batches,
        pipelined,
    )
    from peclr_tpu_torch.models import RN25DPose
    from peclr_tpu_torch.models.port import rn25d_variables_to_state_dict
    from peclr_tpu_torch.train.recipe import (
        build_pretrain_state,
        synthetic_pretrain_batch,
    )
    from peclr_tpu_torch.train.step import make_peclr_train_step

    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    CARD = card_line()
    dev = resolve_device("cuda")
    tree = os.path.dirname(os.path.abspath(__file__))
    build.build(["shift_lerp", "shift_lerp_matmul"])
    out = {"tree": tree, "card": CARD}
    out["kernel4_f32"] = {
        case[0]: {key: row[key] for key in ("ms", "device_ms", "plain_ms",
                                           "bound_ms", "grouped_route_ms",
                                           "band_taps_mean", "max_abs")}
        for case in f32_pass_cases(torch, dev)
        for row in [matmul_row(torch, *case)]}

    frames = seeded_frames(N_FRAMES, SEED)
    Ks = seeded_intrinsics(N_FRAMES, SEED + 1)
    model = RN25DPose("50")
    model.load_state_dict(rn25d_variables_to_state_dict(
        seeded_rn25d_variables("50", SEED), "50"), strict=True)
    model = model.to(dev).eval()
    x0 = torch.from_numpy(frames[:BATCH]).to(dev)
    K0 = torch.from_numpy(Ks[:BATCH]).to(dev)
    out["host_waits"] = phase_host_waits(torch, dev, model, x0, K0,
                                         require_none=False)
    predict = make_two_pass_predictor(model, device=dev)
    slice_img_per_s = []
    for rep in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = list(pipelined(predict, padded_batches(
            frames.__getitem__, Ks, N_FRAMES, BATCH), depth=2, device=dev))
        seconds = time.perf_counter() - t0
        check(sum(len(kp) for _, kp in got) == N_FRAMES, "leaderboard frames")
        if rep:
            slice_img_per_s.append(N_FRAMES / seconds)
    out["leaderboard_img_per_s"] = slice_img_per_s
    del model, predict, x0, K0
    torch.cuda.empty_cache()

    model, state, opt = build_pretrain_state("50", batch=MICROBATCH,
                                             accum=ACCUM, device=dev)
    batch = synthetic_pretrain_batch(MICROBATCH * ACCUM, 224, SEED + 7,
                                     device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    step = make_peclr_train_step(model, opt, peclr_pretrain_flags(),
                                 AugmentationParams(), accum=ACCUM,
                                 warp_route="grouped")
    step_ms = []
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        metrics["loss"].item()
        torch.cuda.synchronize()
        if rep:
            step_ms.append((time.perf_counter() - t0) * 1e3)
    out["pretrain_grouped_step_ms"] = step_ms
    state, profiled = profile_step(torch, step, state, batch, gen)
    out["pretrain_grouped_profiled"] = {
        k: profiled.get(k) for k in ("profiled_wall_ms", "device_busy_ms",
                                     "device_busy_share", "kernel_launches")}
    print(json.dumps({"turns": out}), flush=True)
    return 0


def poison_main() -> int:
    """`--poison`: the build and phase 7c alone; its line, then the card's
    nvidia-smi line."""
    import torch

    from peclr_tpu_torch import build
    from peclr_tpu_torch.device import resolve_device

    global CARD
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    CARD = card_line()
    build.build(["shift_lerp", "shift_lerp_matmul", "streams"])
    phase_poison(torch, resolve_device("cuda"))
    print(CARD, flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--poison"]:  # phase 7c alone
        sys.exit(poison_main())
    if sys.argv[1:2] == ["--ddp-cli"]:  # a rank of the ddp phase's CLI run
        sys.exit(ddp_cli_rank(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--turns"]:  # parent against change, in turns
        sys.exit(turns_main())
    if sys.argv[1:2] == ["--recipe-load"]:  # the repeat phase's load
        sys.exit(recipe_load(sys.argv[2]))
    sys.exit(main())
