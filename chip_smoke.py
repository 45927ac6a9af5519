#!/usr/bin/env python3
"""Drive the PyTorch port (peclr_tpu_torch) on one NVIDIA card and check it.

    python3 chip_smoke.py            # from the root of the repository

It needs a CUDA card and `nvcc`, and exits non-zero without printing a
result when the package is not beside it or there is no card.  Every phase prints
one JSON line that carries the card's name and power limit:

  1. device   nvidia-smi's name and power limit, torch and CUDA versions
  2. build    nvcc builds csrc/*.cu for sm_90a (one process per source)
  3. kernel   each kernel against its plain PyTorch version at the
              leaderboard shapes (B = 120): raw mode bit-exact, lerp within
              1e-3 (f32 out) or 1.0 (bf16 out) on the 0-255 scale; kernel,
              plain, bound and library times
  4. warp     affine_warp_mxu at the pred_fh geometry, kernel against plain,
              both in bf16 on the card: max abs <= 2.5 (the TPU's bound for
              the same comparison)
  5. slice    two-pass RN50 leaderboard inference on 4 batches of 120 seeded
              frames (the last one ragged) through the kernel, with the
              lerp in the kernel and in its raw mode, in turns; launch
              counts, img/s, peak memory, the time of each stage of one
              batch; agreement with the plain path and with the CPU on a
              small input
  6. serving  InferenceSession (batch 32, 128 px) on a few requests
  7. kernels  one line listing every ported kernel
Then the card's nvidia-smi line, and last the contract line
{"ok": true, "device": {...}}.  No weights or data files are read: weights
and frames are made from a seed.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

import numpy as np

SEED = 0
BATCH = 120
N_FRAMES = 3 * BATCH + 50  # 4 batches, the last one ragged
SLICE_REPS = 3  # runs of the main path in each shift mode, in turns
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet (700 W)
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
CARD = ""


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


@contextlib.contextmanager
def plain_shift():
    """Route the warp's row shift through the plain PyTorch version (for
    the kernel-against-plain comparisons only)."""
    from peclr_tpu_torch.ops import shift_lerp, warp_mxu

    warp_mxu.fused_shift_lerp_grouped = shift_lerp.shift_lerp_grouped_plain
    try:
        yield
    finally:
        warp_mxu.fused_shift_lerp_grouped = shift_lerp.fused_shift_lerp_grouped


def reset_counts() -> None:
    from peclr_tpu_torch.ops.shift_lerp import fused_shift_lerp_grouped as k

    k.launches = 0
    k.raw_launches = 0


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


def phase_kernel(torch, dev):
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
    # pass-1 style offsets span both clamps: k < -(out + 2) and k > W
    wide = offsets(n_main, -(out + 40.0), 224 + 40.0)
    clamped = torch.cat([offsets(n_main // 2, -5000.0, -(out + 3.0)),
                         offsets(n_main - n_main // 2, 225.0, 5000.0)])
    cases = [
        ("pass1_u8_to_bf16", True, u8, wide, torch.bfloat16, 1.0),
        ("pass1_u8_to_f32", True, u8, wide, torch.float32, 1e-3),
        ("pass2_bf16_to_bf16", True, bf, wide, torch.bfloat16, 1.0),
        ("odd_n_1001_u8_to_bf16", True, odd, offsets(1001, -800.0, 260.0),
         torch.bfloat16, 1.0),
        ("clamped_rows_u8_to_f32", True, u8, clamped, torch.float32, 1e-3),
        ("raw_pass1_u8", False, u8, wide, None, 0.0),
        ("raw_pass2_bf16", False, bf, wide, None, 0.0),
        ("raw_clamped_u8", False, u8, clamped, None, 0.0),
    ]
    for name, lerp, rows3, off, out_dtype, tol in cases:
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
        if lerp:
            max_abs = (got.float() - ref.float()).abs().max().item()
            check(max_abs <= tol, f"{name}: max_abs {max_abs} > {tol}")
        else:
            check(torch.equal(got, ref), f"{name}: raw window not bit-exact")
            max_abs = (got.float() - ref.float()).abs().max().item()
        if name.startswith("clamped") or name.startswith("raw_clamped"):
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
            "lerp": lerp, "max_abs": max_abs, "tolerance": tol,
            "ms": cuda_ms(kern, 20), "plain_ms": cuda_ms(plain, 5),
            "bound_ms": bound, "bound_by": bound_by, "library_ms": library_ms,
        }
        results.append(row)
        emit("kernel", **row)
    return results


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    CARD = smi
    dev = resolve_device("cuda")
    emit("device", nvidia_smi=smi, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    per_source = build.build(["shift_lerp"])
    emit("build", seconds=time.perf_counter() - t0, per_source=per_source,
         arch="sm_90a")

    # ---- 3. kernel against plain -------------------------------------------
    kernel_rows = phase_kernel(torch, dev)

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
    warp_abs = (got - ref).abs().max().item()
    check(got.dtype == torch.float32 and got.shape == (BATCH, 224, 224, 3),
          "warp output shape/dtype")
    check(warp_abs <= 2.5, f"warp kernel vs plain max_abs {warp_abs} > 2.5")
    emit("warp", batch=BATCH, out_hw=[224, 224], compute_dtype="bfloat16",
         max_abs=warp_abs, tolerance=2.5, ms=warp_ms, plain_ms=plain_warp_ms)

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
                "batches": len(outs),
            }
            kp3d = np.concatenate([o for _, o in outs])
            check(kp3d.shape == (N_FRAMES, 21, 3),
                  f"{mode}: kp3d shape {kp3d.shape}")
            check(bool(np.isfinite(kp3d).all()), f"{mode}: kp3d not finite")
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

    # ---- 7. kernels line ---------------------------------------------------------
    def summary(name, replaces, launches, lerp, timed_case):
        rows = [r for r in kernel_rows if r["lerp"] == lerp]
        timed = next(r for r in rows if r["case"] == timed_case)
        return {
            "name": name, "route": "cuda",
            "source": "peclr_tpu_torch/csrc/shift_lerp.cu",
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(r["max_abs"] for r in rows),
            "ms": timed["ms"], "plain_ms": timed["plain_ms"],
            "bound_ms": timed["bound_ms"], "bound_by": timed["bound_by"],
            "library_ms": timed["library_ms"], "timed_case": timed_case,
        }

    kernels = [
        summary("shift_lerp_grouped",
                "peclr_tpu/ops/pallas/barrel_shift.py:100",
                runs["lerp_in_kernel"][0]["launches"], True,
                "pass2_bf16_to_bf16"),
        summary("shift_raw_grouped",
                "peclr_tpu/ops/pallas/barrel_shift.py:118",
                runs["raw_kernel"][0]["raw_launches"], False,
                "raw_pass2_bf16"),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("done", seconds=time.perf_counter() - t_start)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
