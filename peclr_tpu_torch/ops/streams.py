"""HBM stream passes, the yardstick of scripts/bench_streams.py.

No TPU kernel stands behind these: they port the four access patterns of
the reference repository's scripts/bench_streams.py (`f_copy`, `f_add`,
`f_bn_res_relu`, `f_stats`), each as one pass of a hand-written CUDA kernel
(`csrc/streams.cu`, whose header says how it is designed and what bounds
it), to say how far the step's BatchNorm and elementwise passes sit from one
pass over HBM.  No training or serving path calls them.

  stream_copy(x)                  y = x + 1
  stream_add(x, r)                y = x + r
  stream_bn_res_relu(x, r, g, b)  y = relu(x * g + b + r) in f32, cast to x's
                                  type; g, b f32 per channel (the last axis)
  stream_stats(x)                 (2, C) f32: per-channel sum of x and of x^2
                                  over every axis but the last

x and r are bf16 or f32 of one shape, channels last.  The elementwise
wrappers write into `out` where it is given (it may be x, or a buffer of
the same shape and type), so that a chain of launches can ping-pong between
two buffers.  For CUDA tensors each launches its kernel, counts the
launches (`.launches`: one a call, two for stream_stats) and records the
path it took (`.last_path`, as `stream_path` chose it: "vec16" or
"scalar"); CPU tensors take the plain versions
(`*_plain`), which compose the same arithmetic from torch ops in the same
order, so that the kernel's elementwise outputs equal them bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from peclr_tpu_torch import build

#: dtype codes of csrc/streams.cu
_DTYPE_CODES = {torch.bfloat16: 1, torch.float32: 2}
#: op codes of csrc/streams.cu
_COPY, _ADD, _BN_RES_RELU = 0, 1, 2


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1


def add_plain(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    return x + r


def bn_res_relu_plain(x: torch.Tensor, r: torch.Tensor, g: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    """relu(x·g + b + r): the products and sums in f32, one rounding each,
    the result cast to x's type."""
    return torch.relu(x.float() * g + b + r.float()).to(x.dtype)


def stats_plain(x: torch.Tensor) -> torch.Tensor:
    """(2, C) f32: the per-channel sums of x and of x² over every axis but
    the last."""
    xf = x.float().reshape(-1, x.shape[-1])
    return torch.stack([xf.sum(dim=0), (xf * xf).sum(dim=0)])


def stream_path(*tensors: Optional[torch.Tensor], channels: int = 0) -> str:
    """The kernel path for these operands: "vec16" when every base address
    is a multiple of 16 bytes and `channels` (bn_res_relu's and stats'; 0
    for the others) a multiple of the elements in 16 bytes, else "scalar".
    Both paths are the CUDA kernel."""
    x = tensors[0]
    per_vec = 16 // x.element_size()
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors if t is not None)
    return "vec16" if aligned and channels % per_vec == 0 else "scalar"


def _library() -> ctypes.CDLL:
    lib = build.load("streams")
    fn = lib.peclr_stream_elementwise
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        blocks = lib.peclr_stream_stats_blocks
        blocks.restype = ctypes.c_int
        blocks.argtypes = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                           ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        stats = lib.peclr_stream_stats
        stats.restype = ctypes.c_int
        stats.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                          ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.peclr_stream_error_string.restype = ctypes.c_char_p
        lib.peclr_stream_error_string.argtypes = [ctypes.c_int]
    return lib


def _raise_on(rc: int, lib: ctypes.CDLL, what: str) -> None:
    if rc != 0:
        reason = {-1: "unsupported dtype or op",
                  -2: "operands unfit for the 16-byte path"}.get(rc)
        if reason is None:
            reason = lib.peclr_stream_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: {reason}")


def _check(x: torch.Tensor, *others: Optional[torch.Tensor]) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"stream kernels take bf16 or f32, not {x.dtype}")
    for t in (x,) + others:
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError("all operands must be on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def _output(x: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    if out is None:
        return torch.empty_like(x)
    if out.shape != x.shape or out.dtype != x.dtype:
        raise ValueError(f"out is {out.dtype} {tuple(out.shape)}, want "
                         f"{x.dtype} {tuple(x.shape)}")
    return out


def _elementwise(wrapper, op: int, plain, x, r, g, b, out):
    if x.device.type == "cpu":
        y = plain()
        return y if out is None else _output(x, out).copy_(y)
    if x.device.type != "cuda":
        raise ValueError(f"no stream kernel for device {x.device}")
    if r is not None and (r.shape != x.shape or r.dtype != x.dtype):
        raise ValueError("r must have x's shape and dtype")
    channels = 0
    if op == _BN_RES_RELU:
        channels = x.shape[-1]
        for name, t in (("g", g), ("b", b)):
            if t.shape != (channels,) or t.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 of shape "
                                 f"({channels},)")
    y = _output(x, out)
    _check(x, r, g, b, y)
    path = stream_path(x, r, g, b, y, channels=channels)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.peclr_stream_elementwise(
            op, _DTYPE_CODES[x.dtype], x.data_ptr(),
            None if r is None else r.data_ptr(),
            None if g is None else g.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(), x.numel(),
            channels, int(path == "vec16"), stream)
    _raise_on(rc, lib, wrapper.__name__)
    wrapper.last_path = path
    wrapper.launches += 1
    return y


def stream_copy(x: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x + 1 in x's type (one read, one write)."""
    return _elementwise(stream_copy, _COPY, lambda: copy_plain(x), x, None,
                        None, None, out)


def stream_add(x: torch.Tensor, r: torch.Tensor,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = x + r in x's type (two reads, one write)."""
    return _elementwise(stream_add, _ADD, lambda: add_plain(x, r), x, r, None,
                        None, out)


def stream_bn_res_relu(x: torch.Tensor, r: torch.Tensor, g: torch.Tensor,
                       b: torch.Tensor,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """y = relu(x·g + b + r) in f32, cast to x's type; g, b (C,) f32 over
    the last axis (two reads, one write)."""
    return _elementwise(stream_bn_res_relu, _BN_RES_RELU,
                        lambda: bn_res_relu_plain(x, r, g, b), x, r, g, b,
                        out)


def stream_stats(x: torch.Tensor) -> torch.Tensor:
    """(2, C) f32: the per-channel sums of x and of x² over every axis but
    the last (one read), in a fixed order: per-block partial sums, then one
    small launch that adds them in block order."""
    if x.device.type == "cpu":
        return stats_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"no stream kernel for device {x.device}")
    _check(x)
    c = x.shape[-1]
    rows = x.numel() // c if c else 0
    path = stream_path(x, channels=c)
    vec16 = int(path == "vec16")
    lib = _library()
    blocks = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        # the grid is one wave of the card the tensor lies on
        rc = lib.peclr_stream_stats_blocks(_DTYPE_CODES[x.dtype], rows, c,
                                           vec16, ctypes.byref(blocks))
        _raise_on(rc, lib, "stream_stats")
        partial = torch.empty((blocks.value, 2 * c), dtype=torch.float32,
                              device=x.device)
        out = torch.empty((2, c), dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.peclr_stream_stats(_DTYPE_CODES[x.dtype], x.data_ptr(),
                                    partial.data_ptr(), out.data_ptr(), rows,
                                    c, blocks.value, vec16, stream)
    _raise_on(rc, lib, "stream_stats")
    stream_stats.last_path = path
    stream_stats.launches += 2  # the partials, then their sum
    return out


for _wrapper in (stream_copy, stream_add, stream_bn_res_relu, stream_stats):
    _wrapper.launches = 0
    _wrapper.last_path = None
del _wrapper
