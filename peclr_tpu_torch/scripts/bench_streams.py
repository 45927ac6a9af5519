"""HBM stream rates on the recipe's layer-1 BatchNorm fusion shape (port of
the reference repository's scripts/bench_streams.py).

The reference timed XLA fusions of four access patterns on bf16/f32
[256, 32, 32, 256] to ask how far the step's BatchNorm and residual
fusions sat from what one pass over HBM costs.  On the card each pattern is
one pass of a hand-written kernel (ops/streams.py, csrc/streams.cu):

  copy_1r1w         y = x + 1                            1 read, 1 write
  add_2r1w          y = x + r                            2 reads, 1 write
  bn_res_relu_2r1w  y = relu(x·g + b + r) in f32, cast   2 reads, 1 write
  stats             per-channel Σx and Σx² in f32        1 read

(the reference's stats chain also wrote the tensor back, "stats_1r1w"; a
card needs no chain to time a launch, so the pass reads x once).  Beside
each kernel, timed the same way, its `eager` row: the same math composed
from torch ops, as the port's step composes it (ops/streams.py's plain
versions on the card); and `batchnorm_train`: the port's
models/batchnorm.py BatchNorm2d in train mode at this shape under bf16
autocast, as the step runs it, forward alone and forward + backward.

Each time comes from CUDA events around --iters launches queued back to
back, after a warm-up, with one wait at the end, the best of two turns
(kernel, eager, eager, kernel); the elementwise passes
ping-pong between two buffers, so each launch reads the last one's output.
Every tensor (134 MB in bf16) is larger than the 50 MB L2.  Per case:
`ms`, `bytes` (what the pass reads and writes: each input once, each output
once), `GBps` and `share_of_peak` over the H100 SXM's 3.35 TB/s; the
kernel's path, its agreement with the plain version on the card (bit-exact
for the elementwise passes, bn_res_relu with a g and b drawn per channel,
not the timed rows' ones and zeros; stats against a float64 sum, relative
to the sum of |x|, or of x², over the channel), and the host's waits
inside the timed windows (none expected).

    python -m peclr_tpu_torch.scripts.bench_streams [--iters 50]
        [--device cuda] [--out tests/fixtures/torch_bench/stream_rates.json]

On the card by default; `--device cpu` runs the plain versions (their rates
are the CPU's, not a device's).
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from peclr_tpu_torch import scripts as common

SHAPE = (256, 32, 32, 256)  # the layer-1 fusion shape (2B views)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet (700 W)
PATTERNS = ("copy_1r1w", "add_2r1w", "bn_res_relu_2r1w", "stats")
#: stats against a float64 sum, relative to the channel's sum of |x| (of
#: x² for the squares): f32 sums in another order than the plain version's.
#: The sound kernel reads 1.7e-7 at SHAPE (PERF.md); one row of its 262,144
#: a channel dropped or counted twice moves a channel by about 3.8e-6
STATS_TOL = 1e-6
#: the g and b that bn_res_relu's agreement is checked with
CHECK_GB = "g ~ U(0.5, 1.5), b ~ U(-1, 1) per channel, seed 2"


def check_scale_shift(c: int, dev) -> tuple:
    """(g, b) of CHECK_GB, f32 on dev."""
    rng = np.random.default_rng(2)
    g = rng.uniform(0.5, 1.5, c).astype(np.float32)
    b = rng.uniform(-1.0, 1.0, c).astype(np.float32)
    return torch.from_numpy(g).to(dev), torch.from_numpy(b).to(dev)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--shape", default=",".join(map(str, SHAPE)),
                    help="B,H,W,C of the channels-last tensors")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(common.BENCH_DIR,
                                                  "stream_rates.json"))
    return ap.parse_args(argv)


def timed_chain(fn: Callable, state: torch.Tensor, extras: Sequence,
                iters: int, warmup: int = 1, chain: bool = True,
                waits: Optional[list] = None) -> float:
    """Seconds a launch of fn(s, *extras) over `iters` launches queued back
    to back after `warmup`, from CUDA events (the host's clock on the CPU),
    with one wait at the end.  chain=True feeds each launch the last one's
    output (fn returns the next state); chain=False launches fn on `state`
    each time.  `waits` gets the number of times the host waited on the
    card while it queued the launches (scripts.host_waits)."""
    dev = state.device
    s = state
    for _ in range(warmup):
        out = fn(s, *extras)
        s = out if chain else s

    def run():
        nonlocal s
        for _ in range(iters):
            out = fn(s, *extras)
            s = out if chain else s

    if dev.type != "cuda":
        return common.chained_seconds(run, dev) / iters
    common.sync(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    n_waits = len(common.host_waits(run))
    end.record()
    end.synchronize()
    if waits is not None:
        waits.append(n_waits)
    return start.elapsed_time(end) / 1e3 / iters


def pingpong(kernel: Callable, state: torch.Tensor) -> Callable:
    """fn(s, *extras) that writes kernel(s, *extras, out=) into whichever of
    two buffers shaped like `state` s is not: a chain of launches that
    allocates nothing."""
    bufs = [torch.empty_like(state), torch.empty_like(state)]

    def fn(s, *extras):
        out = bufs[1] if s.data_ptr() == bufs[0].data_ptr() else bufs[0]
        return kernel(s, *extras, out=out)

    return fn


def _rate(seconds: float, nbytes: int) -> dict:
    gbps = nbytes / seconds / 1e9
    return {"ms": seconds * 1e3, "GBps": gbps,
            "share_of_peak": gbps * 1e9 / HBM_BYTES_PER_S}


def _stats_err(got: torch.Tensor, x: torch.Tensor):
    """The worst channel's |got - float64 sum|, alone and over its sum of
    |x| (row 0) or of x² (row 1)."""
    xd = x.double().reshape(-1, x.shape[-1])
    want = torch.stack([xd.sum(0), (xd * xd).sum(0)])
    scale = torch.stack([xd.abs().sum(0), (xd * xd).sum(0)]).clamp_min(1e-30)
    err = (got.double() - want).abs()
    return (err / scale).max().item(), err.max().item()


def _case(streams, pattern, x, r, g, b, check_gb, iters, waits, timed):
    """The kernel and eager rows of one pattern and the kernel's agreement
    with its plain version; adds the kernel's timed launches to `timed`.
    The rows are timed with the reference's g and b (ones and zeros), the
    agreement is checked with `check_gb`, a g and b that make each channel's
    multiply-add matter."""
    if pattern == "stats":
        kernel, plain, extras = streams.stream_stats, streams.stats_plain, ()
        got = kernel(x)
        rel, err = _stats_err(got, x)
        if rel > STATS_TOL:
            raise AssertionError(f"stats: {rel} > {STATS_TOL} of the float64 "
                                 "sum")
        agreement = {"max_rel_err_f64": rel, "max_abs_err_f64": err,
                     "tolerance": STATS_TOL}
        path = kernel.last_path
        runs = {"kernel": (kernel, False), "eager": (plain, False)}
    else:
        kernel, plain, extras, checked = {
            "copy_1r1w": (streams.stream_copy, streams.copy_plain, (), ()),
            "add_2r1w": (streams.stream_add, streams.add_plain, (r,), (r,)),
            "bn_res_relu_2r1w": (streams.stream_bn_res_relu,
                                 streams.bn_res_relu_plain, (r, g, b),
                                 (r, *check_gb)),
        }[pattern]
        got, want = kernel(x, *checked), plain(x, *checked)
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            raise AssertionError(f"{pattern}: kernel against plain max_abs "
                                 f"{err}, want bit-exact")
        agreement = {"bit_exact": True, "max_abs_err": 0.0}
        if pattern == "bn_res_relu_2r1w":
            agreement["checked_with"] = CHECK_GB
        path = kernel.last_path
        runs = {"kernel": (pingpong(kernel, x), True), "eager": (plain, True)}
    del got
    # in turns (kernel, eager, eager, kernel), the best of each; the
    # launches counted from here on are the timed ones
    first = kernel.launches
    seconds = {}
    for turn in range(2):
        for name in (list(runs) if turn == 0 else list(runs)[::-1]):
            fn, chain = runs[name]
            t = timed_chain(fn, x, extras, iters, chain=chain, waits=waits)
            seconds[name] = min(seconds.get(name, t), t)
    timed[kernel.__name__] = timed.get(kernel.__name__, 0) + (
        kernel.launches - first)
    return seconds, agreement, path


def batchnorm_train(x: torch.Tensor, iters: int, waits: list) -> dict:
    """The port's BatchNorm2d in train mode on x ([B, H, W, C] bf16, as
    the [B, C, H, W] channels-last activation it is) under bf16 autocast:
    forward alone and forward + backward, GB/s over the one-pass logical
    bytes (forward: x read, y written; backward: dy and x read, dx
    written)."""
    from peclr_tpu_torch.models.batchnorm import BatchNorm2d

    dev = x.device
    c = x.shape[-1]
    bn = BatchNorm2d(c).to(dev).train()
    xc = x.permute(0, 3, 1, 2)  # channels last in memory
    dy = torch.randn(x.shape, generator=torch.Generator(dev).manual_seed(2),
                     device=dev).to(x.dtype).permute(0, 3, 1, 2)
    xg = xc.detach().requires_grad_(True)
    auto = dict(device_type=dev.type, dtype=torch.bfloat16,
                enabled=dev.type == "cuda")

    def forward(_s):
        with torch.autocast(**auto):
            bn(xc)
        return _s

    def forward_backward(_s):
        with torch.autocast(**auto):
            y = bn(xg)
        # the gradients as a step's backward makes them, none accumulated
        torch.autograd.grad(y, (xg, bn.weight, bn.bias), dy)
        return _s

    nbytes = x.numel() * x.element_size()
    out = {}
    for name, fn, logical in (("fwd", forward, 2 * nbytes),
                              ("fwd_bwd", forward_backward, 5 * nbytes)):
        seconds = timed_chain(fn, x, (), iters, chain=False, waits=waits)
        out[name] = {"bytes": logical, **_rate(seconds, logical)}
    return out


def main(argv=None) -> dict:
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.ops import streams

    args = parse_args(argv)
    dev = resolve_device(args.device)
    shape = tuple(int(v) for v in args.shape.split(","))
    results = {"shape": list(shape), "cases": {}}
    waits: list = []
    timed: dict = {}
    for dtype_name, dtype in (("bf16", torch.bfloat16),
                              ("f32", torch.float32)):
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            shape).astype(np.float32)).to(dev, dtype)
        r = torch.from_numpy(np.random.default_rng(1).standard_normal(
            shape).astype(np.float32)).to(dev, dtype)
        nbytes = x.numel() * x.element_size()
        g = torch.ones((shape[-1],), dtype=torch.float32, device=dev)
        b = torch.zeros((shape[-1],), dtype=torch.float32, device=dev)
        check_gb = check_scale_shift(shape[-1], dev)
        channel_bytes = 2 * shape[-1] * 4
        moved = {"copy_1r1w": 2 * nbytes, "add_2r1w": 3 * nbytes,
                 "bn_res_relu_2r1w": 3 * nbytes + channel_bytes,
                 "stats": nbytes + channel_bytes}
        for pattern in PATTERNS:
            seconds, agreement, path = _case(streams, pattern, x, r, g, b,
                                             check_gb, args.iters, waits,
                                             timed)
            key = f"{dtype_name}:{pattern}"
            kernel = _rate(seconds["kernel"], moved[pattern])
            eager = _rate(seconds["eager"], moved[pattern])
            results["cases"][key] = {
                **kernel, "bytes": moved[pattern], "path": path,
                "eager": eager,
                "eager_over_kernel": seconds["eager"] / seconds["kernel"],
                **agreement}
            print(f"{key:24s} kernel {kernel['ms']:8.4f} ms "
                  f"{kernel['GBps']:8.1f} GB/s ({kernel['share_of_peak']:.3f})"
                  f"   eager {eager['ms']:8.4f} ms {eager['GBps']:8.1f} GB/s",
                  flush=True)
        if dtype == torch.bfloat16:
            results["batchnorm_train"] = {"dtype": "bf16", **batchnorm_train(
                x, args.iters, waits)}
            for name, row in results["batchnorm_train"].items():
                if isinstance(row, dict):
                    print(f"bf16:batchnorm_train_{name:8s} {row['ms']:8.4f} ms "
                          f"{row['GBps']:8.1f} GB/s (logical)", flush=True)
        del x, r
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    results.update({
        "iters": args.iters,
        "timed_launches": timed,
        "host_waits_in_windows": sum(waits),
        "peak_bytes_per_s": HBM_BYTES_PER_S,
        "note": (
            "kernel: one pass of csrc/streams.cu; eager: the same math from "
            "torch ops (ops/streams.py's plain versions); batchnorm_train: "
            "models/batchnorm.py's BatchNorm2d in train mode under bf16 "
            "autocast, GB/s over the one-pass logical bytes; every time from "
            "CUDA events over --iters launches queued back to back"),
        "backend": dev.type,
        "device": common.card_name(dev),
        "cpu_cores": common.cpu_cores(),
        "torch": torch.__version__,
    })
    common.write_artifact(args.out, results)
    return results


if __name__ == "__main__":
    main()
