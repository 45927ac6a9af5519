"""Train-mode BatchNorm with the residual add and the ReLU that follow it,
as four hand-written CUDA passes (`csrc/batch_norm_act.cu`, whose header
says how they are designed and what bounds them):

  batch_norm_stats           (2, C) f32: the batch's mean and 1/sqrt(var +
                             eps), var biased, from f64 sums, each rounded
                             once to f32; the running statistics moved
                             toward the batch's by `momentum`, and the count
                             of batches one more, in the same launch
  batch_norm_moments         (2, C) f64: Σx and Σx², the statistics pass's
                             sums alone, for statistics across processes
  batch_norm_apply           relu(bn(x) [+ r]) in x's type
  batch_norm_backward_reduce (6, C) f32: Σdy', Σdy'(x - mean), the weight's
                             gradient, then the elementwise pass's factors
                             mean(dy'), invstd² mean(dy'(x - mean)) and
                             weight·invstd; dy' is dy under the ReLU's mask
  batch_norm_backward_elemt  dx, and dy' as the residual's gradient

No TPU kernel stands behind them: XLA fuses the BatchNorm, the add and the
ReLU for the JAX package.  x, r, dy and the outputs are (N, C, H, W) bf16 or
f32 tensors laid out channels-last (C contiguous, a multiple of 16 bytes;
`takes`), the weight, bias and running statistics f32 (C,); every base
16-byte aligned.  For CUDA tensors each wrapper launches its
kernel and counts it (`.launches`); CPU tensors take the plain versions
(`*_plain`), torch ops that the card's tests hold the kernels to: the apply
and the elementwise backward bit for bit given the same statistics and sums
(on the card the plain apply is torch.batch_norm_elemt -> add -> relu,
which the trunk ran before), the statistics within one f32 rounding of
float64's and the backward's sums within f32 summation order of them.

`mask` says where the ReLU's mask comes from in the backward: NO_RELU,
RELU_FROM_X (recomputed from x by the apply's own arithmetic: the block's
bn1 and bn2, which then read no output) or RELU_FROM_Y (read from the
forward's output y: bn3, whose residual the mask also covers).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

from peclr_tpu_torch import build

#: dtype codes of csrc/batch_norm_act.cu
_DTYPE_CODES = {torch.bfloat16: 1, torch.float32: 2}
#: where the backward's ReLU mask comes from (csrc/batch_norm_act.cu `Mask`)
NO_RELU, RELU_FROM_X, RELU_FROM_Y = 0, 1, 2
#: rows of batch_norm_backward_reduce's output
SUM_DY, SUM_DY_XMU, GRAD_WEIGHT, MEAN_DY, FACTOR_1, FACTOR_2 = range(6)
_CL = torch.channels_last


def takes(x: torch.Tensor) -> bool:
    """Whether the kernels take x: a CUDA (N, C, H, W) bf16 or f32 tensor,
    channels-last from a 16-byte aligned base, with more than one element a
    channel and C a multiple of the 8 bf16 or 4 f32 elements in 16 bytes
    (every ResNet width is a multiple of 64)."""
    return (x.is_cuda and x.dim() == 4 and x.dtype in _DTYPE_CODES
            and x.is_contiguous(memory_format=_CL)
            and x.numel() > x.shape[1] > 0
            and x.shape[1] * x.element_size() % 16 == 0
            and x.data_ptr() % 16 == 0)


# ---------------------------------------------------------------------------
# plain versions


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def _compute_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def batch_norm_stats_plain(x, running_mean, running_var, num_batches_tracked,
                           eps: float, momentum: float) -> torch.Tensor:
    """(2, C): mean and 1/sqrt(var + eps) of x per channel from float64
    sums, var biased; the running statistics and the count updated as the
    kernel updates them."""
    xd = x.double()
    mean = xd.mean(dim=(0, 2, 3))
    var = (xd - _per_channel(mean)).square().mean(dim=(0, 2, 3))
    stats = torch.stack([mean, (var + eps).rsqrt()]).to(_compute_dtype(x))
    with torch.no_grad():
        running_mean.lerp_(mean.to(running_mean.dtype), momentum)
        running_var.lerp_(var.to(running_var.dtype), momentum)
        if num_batches_tracked is not None:
            num_batches_tracked.add_(1)
    return stats


def batch_norm_moments_plain(x) -> torch.Tensor:
    """(2, C) float64: Σx and Σx² per channel."""
    xd = x.double()
    return torch.stack([xd.sum(dim=(0, 2, 3)), xd.square().sum(dim=(0, 2, 3))])


def normalized_plain(x, stats, weight, bias) -> torch.Tensor:
    """The BatchNorm of x with the statistics `stats`, in x's type: on the
    card torch's own channels-last transform (the kernel's arithmetic),
    elsewhere the same formula in f32 op by op."""
    if x.is_cuda:
        return torch.batch_norm_elemt(x, weight, bias, stats[0], stats[1],
                                      0.0)
    xf = x.to(_compute_dtype(x))
    y = ((_per_channel(weight) * (xf - _per_channel(stats[0])))
         * _per_channel(stats[1]) + _per_channel(bias))
    return y.to(x.dtype)


def batch_norm_apply_plain(x, stats, weight, bias,
                           residual: Optional[torch.Tensor] = None,
                           relu: bool = True) -> torch.Tensor:
    """The unfused chain given the statistics: the BatchNorm rounded to x's
    type, the residual added (f32, rounded once), the ReLU."""
    y = normalized_plain(x, stats, weight, bias)
    if residual is not None:
        y = y + residual
    return torch.relu(y) if relu else y


def masked_plain(dy, x, stats, weight, bias, mask: int,
                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dy' in f32: dy with zeros where the forward's output is <= 0 (NaN
    passes), as torch's ReLU backward gives it."""
    dyf = dy.to(_compute_dtype(x))
    if mask == NO_RELU:
        return dyf
    if mask == RELU_FROM_X:
        y = normalized_plain(x, stats, weight, bias)
    return dyf.masked_fill(y <= 0, 0.0)


def batch_norm_backward_reduce_plain(dy, x, stats, weight, bias, mask: int,
                                     y: Optional[torch.Tensor] = None
                                     ) -> torch.Tensor:
    """(6, C) as the kernel's rows, the sums from float64."""
    d = masked_plain(dy, x, stats, weight, bias, mask, y).double()
    dims = (0, 2, 3)
    mean, invstd = stats[0].double(), stats[1].double()
    sum_dy = d.sum(dims)
    sum_dy_xmu = (d * (x.double() - _per_channel(mean))).sum(dims)
    norm = 1.0 / (x.numel() // x.shape[1])
    return torch.stack([
        sum_dy, sum_dy_xmu, sum_dy_xmu * invstd, sum_dy * norm,
        invstd * invstd * sum_dy_xmu * norm, weight.double() * invstd,
    ]).to(_compute_dtype(x))


def batch_norm_backward_elemt_plain(dy, x, stats, weight, bias, sums,
                                    mask: int,
                                    y: Optional[torch.Tensor] = None,
                                    residual: bool = False
                                    ) -> Tuple[torch.Tensor,
                                               Optional[torch.Tensor]]:
    """(dx, dr): ((dy' - mean(dy')) - (x - mean) f1) f2 from the reduce's
    rows, one rounding an operation as the kernel; dr = dy' (or None)."""
    d = masked_plain(dy, x, stats, weight, bias, mask, y)
    xf = x.to(d.dtype)
    dx = ((d - _per_channel(sums[MEAN_DY]))
          - (xf - _per_channel(stats[0])) * _per_channel(sums[FACTOR_1])
          ) * _per_channel(sums[FACTOR_2])
    return dx.to(x.dtype), d.to(x.dtype) if residual else None


# ---------------------------------------------------------------------------
# the kernels


def _library() -> ctypes.CDLL:
    lib = build.load("batch_norm_act")
    if lib.peclr_bn_act_apply.argtypes is None:
        i32, ll, p, f = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, \
            ctypes.c_float
        sigs = {
            "peclr_bn_act_grid": [i32, ll, i32, ctypes.POINTER(i32)],
            "peclr_bn_act_stats": [i32, p, ll, i32, i32, i32, i32, i32, p, p,
                                   p, p, p, p, ctypes.c_double, f, p],
            "peclr_bn_act_moments": [i32, p, ll, i32, i32, i32, i32, i32, p,
                                     p, p, p],
            "peclr_bn_act_apply": [i32, p, p, p, p, p, p, ll, i32, i32, p],
            "peclr_bn_act_backward_reduce": [i32, p, p, p, i32, p, p, p, ll,
                                             i32, i32, i32, i32, i32, p, p,
                                             p, p],
            "peclr_bn_act_backward_elemt": [i32, p, p, p, i32, p, p, p, p, p,
                                            p, ll, i32, p],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
        lib.peclr_bn_act_error_string.restype = ctypes.c_char_p
        lib.peclr_bn_act_error_string.argtypes = [ctypes.c_int]
    return lib


def _raise_on(rc: int, lib: ctypes.CDLL, what: str) -> None:
    if rc != 0:
        reason = ("arguments the kernel does not take" if rc == -1 else
                  lib.peclr_bn_act_error_string(rc).decode())
        raise RuntimeError(f"{what} kernel launch failed: {reason}")


_grids: Dict[tuple, tuple] = {}
_counters: Dict[tuple, torch.Tensor] = {}


def _grid(lib, dtype: int, rows: int, c: int, device) -> tuple:
    """(lanes, tiles, row blocks, pitch) of the reductions at this shape."""
    key = (dtype, rows, c, device)
    grid = _grids.get(key)
    if grid is None:
        out = (ctypes.c_int * 4)()
        _raise_on(lib.peclr_bn_act_grid(dtype, rows, c, out), lib,
                  "batch_norm_act grid")
        grid = _grids[key] = tuple(out)
    return grid


def counters(device: torch.device, tiles: int = 64) -> torch.Tensor:
    """The reductions' counters (one a tile, 0 between launches) of the
    current stream on `device`, made once (zeroed) and grown as needed."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, stream)
    held = _counters.get(key)
    if held is None or held.numel() < tiles:
        held = _counters[key] = torch.zeros(max(tiles, 64), dtype=torch.int32,
                                            device=device)
    return held


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_input(x: torch.Tensor, *same: Optional[torch.Tensor]) -> None:
    if not takes(x):
        raise ValueError("the batch_norm_act kernels take CUDA (N, C, H, W) "
                         "bf16 or f32 tensors laid out channels-last from a "
                         "16-byte aligned base, C a multiple of 16 bytes, "
                         f"not {x.dtype} {tuple(x.shape)} {x.stride()} at "
                         f"{x.data_ptr():#x}")
    for t in same:
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype
                              or t.device != x.device
                              or not t.is_contiguous(memory_format=_CL)
                              or t.data_ptr() % 16):
            raise ValueError("residual, dy and y must be laid out as x, from "
                             "a 16-byte aligned base")


def _check_vectors(c: int, device, *vectors: Optional[torch.Tensor]) -> None:
    for v in vectors:
        if v is not None and (v.dtype != torch.float32 or v.device != device
                              or not v.is_contiguous() or v.numel() < c
                              or v.data_ptr() % 16):
            raise ValueError("per-channel vectors must be contiguous float32 "
                             f"of at least {c} on {device}, from a 16-byte "
                             "aligned base")


#: a host op of a capture recorded as torch's own ops are, so that the
#: trace links the kernels launched in it to it (a user annotation, as
#: torch.profiler.record_function makes, is not linked)
_host_op = getattr(torch._C._profiler, "_RecordFunctionFast", record_function)


def _launching(x: torch.Tensor, name: str):
    """A launch's context: x's device as the current one, where it is not
    already, and under a capture the host op `peclr::<name>`, to which the
    trace links the kernel (scripts/trace_buckets.py's op_linked_ms)."""
    profiling = _autograd_profiler._is_profiler_enabled
    switch = x.device.index != torch.cuda.current_device()
    if not (profiling or switch):
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    if switch:
        stack.enter_context(torch.cuda.device(x.device))
    if profiling:
        stack.enter_context(_host_op("peclr::" + name))
    return stack


def batch_norm_stats(x: torch.Tensor, running_mean: torch.Tensor,
                     running_var: torch.Tensor,
                     num_batches_tracked: Optional[torch.Tensor],
                     eps: float, momentum: float) -> torch.Tensor:
    """(2, C) f32: x's per-channel mean and 1/sqrt(var + eps), var biased
    (flax's); running_mean and running_var moved toward the batch's mean and
    var by `momentum` (torch's lerp_), num_batches_tracked one more, in
    place."""
    if not x.is_cuda:
        return batch_norm_stats_plain(x, running_mean, running_var,
                                      num_batches_tracked, eps, momentum)
    _check_input(x)
    c = x.shape[1]
    rows = x.numel() // c
    _check_vectors(c, x.device, running_mean, running_var)
    if num_batches_tracked is not None and (
            num_batches_tracked.dtype != torch.int64
            or num_batches_tracked.device != x.device):
        raise ValueError("num_batches_tracked must be int64 on x's device")
    stats = torch.empty((2, c), dtype=torch.float32, device=x.device)
    lib = _library()
    dtype = _DTYPE_CODES[x.dtype]
    lanes, tiles, row_blocks, pitch = _grid(lib, dtype, rows, c, x.device)
    partial = torch.empty(tiles * row_blocks * pitch, dtype=torch.float64,
                          device=x.device)
    with _launching(x, "batch_norm_stats"):
        rc = lib.peclr_bn_act_stats(
            dtype, x.data_ptr(), rows, c, lanes, tiles, row_blocks,
            pitch, partial.data_ptr(), counters(x.device, tiles).data_ptr(),
            stats.data_ptr(), running_mean.data_ptr(),
            running_var.data_ptr(), _ptr(num_batches_tracked), eps,
            momentum, _stream(x))
    _raise_on(rc, lib, "batch_norm_act_stats")
    batch_norm_stats.launches += 1
    return stats


def batch_norm_moments(x: torch.Tensor) -> torch.Tensor:
    """(2, C) float64: x's per-channel Σx and Σx² (the statistics pass's
    sums, unshifted), which ranks add before they take the statistics."""
    if not x.is_cuda:
        return batch_norm_moments_plain(x)
    _check_input(x)
    c = x.shape[1]
    rows = x.numel() // c
    moments = torch.empty((2, c), dtype=torch.float64, device=x.device)
    lib = _library()
    dtype = _DTYPE_CODES[x.dtype]
    lanes, tiles, row_blocks, pitch = _grid(lib, dtype, rows, c, x.device)
    partial = torch.empty(tiles * row_blocks * pitch, dtype=torch.float64,
                          device=x.device)
    with _launching(x, "batch_norm_moments"):
        rc = lib.peclr_bn_act_moments(
            dtype, x.data_ptr(), rows, c, lanes, tiles, row_blocks,
            pitch, partial.data_ptr(), counters(x.device, tiles).data_ptr(),
            moments.data_ptr(), _stream(x))
    _raise_on(rc, lib, "batch_norm_act_stats (moments)")
    batch_norm_moments.launches += 1
    return moments


def batch_norm_apply(x: torch.Tensor, stats: torch.Tensor,
                     weight: torch.Tensor, bias: torch.Tensor,
                     residual: Optional[torch.Tensor] = None,
                     relu: bool = True) -> torch.Tensor:
    """relu(bn(x) [+ residual]) in x's type and layout, with the statistics
    `stats` ((2, C): mean, invstd)."""
    if not x.is_cuda:
        return batch_norm_apply_plain(x, stats, weight, bias, residual, relu)
    _check_input(x, residual)
    c = x.shape[1]
    _check_vectors(c, x.device, stats, weight, bias)
    y = torch.empty_like(x, memory_format=_CL)
    lib = _library()
    with _launching(x, "batch_norm_apply"):
        rc = lib.peclr_bn_act_apply(
            _DTYPE_CODES[x.dtype], x.data_ptr(), _ptr(residual),
            stats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            y.data_ptr(), x.numel() // c, c, int(relu), _stream(x))
    _raise_on(rc, lib, "batch_norm_act_apply")
    batch_norm_apply.launches += 1
    return y


def batch_norm_backward_reduce(dy: torch.Tensor, x: torch.Tensor,
                               stats: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, mask: int,
                               y: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """(6, C) f32: Σdy', Σdy'(x - mean), the weight's gradient Σdy'(x -
    mean)·invstd, mean(dy'), invstd² mean(dy'(x - mean)) and weight·invstd
    (the bias's gradient is row 0)."""
    if not x.is_cuda:
        return batch_norm_backward_reduce_plain(dy, x, stats, weight, bias,
                                                mask, y)
    _check_input(x, dy, y)
    if mask == RELU_FROM_Y and y is None:
        raise ValueError("the mask read from y needs y")
    c = x.shape[1]
    rows = x.numel() // c
    _check_vectors(c, x.device, stats, weight, bias)
    sums = torch.empty((6, c), dtype=torch.float32, device=x.device)
    lib = _library()
    dtype = _DTYPE_CODES[x.dtype]
    lanes, tiles, row_blocks, pitch = _grid(lib, dtype, rows, c, x.device)
    partial = torch.empty(tiles * row_blocks * pitch, dtype=torch.float32,
                          device=x.device)
    with _launching(x, "batch_norm_backward_reduce"):
        rc = lib.peclr_bn_act_backward_reduce(
            dtype, dy.data_ptr(), x.data_ptr(), _ptr(y), mask,
            stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), rows, c,
            lanes, tiles, row_blocks, pitch, partial.data_ptr(),
            counters(x.device, tiles).data_ptr(), sums.data_ptr(),
            _stream(x))
    _raise_on(rc, lib, "batch_norm_act_backward_reduce")
    batch_norm_backward_reduce.launches += 1
    return sums


def batch_norm_backward_elemt(dy: torch.Tensor, x: torch.Tensor,
                              stats: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, sums: torch.Tensor,
                              mask: int, y: Optional[torch.Tensor] = None,
                              residual: bool = False
                              ) -> Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]:
    """(dx, dr): x's gradient, and with `residual` the residual's (dy')."""
    if not x.is_cuda:
        return batch_norm_backward_elemt_plain(dy, x, stats, weight, bias,
                                               sums, mask, y, residual)
    _check_input(x, dy, y)
    if mask == RELU_FROM_Y and y is None:
        raise ValueError("the mask read from y needs y")
    c = x.shape[1]
    _check_vectors(c, x.device, stats, weight, bias, sums)
    dx = torch.empty_like(x, memory_format=_CL)
    dr = torch.empty_like(x, memory_format=_CL) if residual else None
    lib = _library()
    with _launching(x, "batch_norm_backward_elemt"):
        rc = lib.peclr_bn_act_backward_elemt(
            _DTYPE_CODES[x.dtype], dy.data_ptr(), x.data_ptr(), _ptr(y),
            mask, stats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            sums.data_ptr(), dx.data_ptr(), _ptr(dr), x.numel() // c, c,
            _stream(x))
    _raise_on(rc, lib, "batch_norm_act_backward_elemt")
    batch_norm_backward_elemt.launches += 1
    return dx, dr


for _wrapper in (batch_norm_stats, batch_norm_moments, batch_norm_apply,
                 batch_norm_backward_reduce, batch_norm_backward_elemt):
    _wrapper.launches = 0
