"""The port's fused shift + lerp + tap matmul, kernel 4
(peclr_tpu_torch/ops/shift_lerp_matmul.py), against the reference's Pallas
kernel `_matmul_kernel` in interpret mode and a numpy oracle.

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel is
held against that plain version on the card by tests/test_torch_cuda.py
and by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.ops.pallas.barrel_shift import (
    fused_shift_lerp_matmul as jax_matmul,
)
from peclr_tpu_torch.ops.shift_lerp_matmul import (
    fused_shift_lerp_matmul,
    shift_lerp_matmul_plain,
)


def _inputs(rng, g, b, r, w, u, m, dtype=np.float32):
    shape = (g, b, r, w)
    if dtype == np.uint8:
        rows4 = rng.integers(0, 256, shape).astype(np.uint8)
    else:
        rows4 = rng.uniform(0, 255, shape).astype(dtype)
    # shifts past both clamps: k < -(u + 2) and k > w
    k = rng.integers(-(u + 5), w + 5, (b * r,)).astype(np.int32)
    f = rng.uniform(0, 1, (b * r,)).astype(np.float32)
    w_t = rng.uniform(-1, 1, (b, m, u)).astype(np.float32)
    return rows4, k, f, w_t


def _oracle(rows4, k, f, w_t):
    g, b, r, w = rows4.shape
    u = w_t.shape[2]
    kk = np.clip(k, -(u + 2), w).reshape(b, r)
    win = np.zeros((g, b, r, u + 1), np.float32)
    for bi in range(b):
        for ri in range(r):
            for t in range(u + 1):
                s = t + kk[bi, ri]
                if 0 <= s < w:
                    win[:, bi, ri, t] = rows4[:, bi, ri, s]
    fr = f.reshape(1, b, r, 1)
    lerped = win[..., :-1] * (1 - fr) + win[..., 1:] * fr
    return np.einsum("gbru,bmu->gbmr", lerped, w_t)


@pytest.mark.parametrize("in_dtype", [np.float32, np.uint8])
def test_matches_pallas_interpret(rng, in_dtype):
    """f32 taps and output, the reference test's shapes
    (test_pallas_kernels.py:64-89), clamped shifts included: rtol 1e-5 /
    atol 1e-2 (f32 sums of up to 128 products of values up to 255, taken
    in another order)."""
    g, b, r, w, u, m = 3, 2, 16, 256, 128, 8
    rows4, k, f, w_t = _inputs(rng, g, b, r, w, u, m, in_dtype)
    ref = np.asarray(jax_matmul(jnp.asarray(rows4), jnp.asarray(k),
                                jnp.asarray(f), jnp.asarray(w_t),
                                out_dtype=jnp.float32, interpret=True))
    got = fused_shift_lerp_matmul(torch.from_numpy(rows4),
                                  torch.from_numpy(k), torch.from_numpy(f),
                                  torch.from_numpy(w_t))
    assert got.dtype == torch.float32 and got.shape == (g, b, m, r)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-2)


def test_bf16_output_matches_pallas_interpret(rng):
    """out_dtype bf16 (pass 1 of the warp): the f32 sums round once, so the
    two differ by at most one bf16 step of the largest output."""
    g, b, r, w, u, m = 2, 2, 8, 128, 128, 16
    rows4, k, f, w_t = _inputs(rng, g, b, r, w, u, m, np.uint8)
    w_t = np.abs(w_t) / u  # taps of a resample: outputs within the inputs
    ref = np.asarray(jax_matmul(jnp.asarray(rows4), jnp.asarray(k),
                                jnp.asarray(f), jnp.asarray(w_t),
                                out_dtype=jnp.bfloat16, interpret=True)
                     .astype(jnp.float32))
    got = fused_shift_lerp_matmul(torch.from_numpy(rows4),
                                  torch.from_numpy(k), torch.from_numpy(f),
                                  torch.from_numpy(w_t),
                                  out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1.0, rtol=0)


def test_odd_shapes_match_numpy_oracle(rng):
    """Any G, B, R, W, U and M: no 128-alignment and no multiple-of-8 gate."""
    rows4, k, f, w_t = _inputs(rng, 2, 3, 7, 19, 23, 5, np.uint8)
    got = fused_shift_lerp_matmul(torch.from_numpy(rows4),
                                  torch.from_numpy(k), torch.from_numpy(f),
                                  torch.from_numpy(w_t))
    np.testing.assert_allclose(got.numpy(), _oracle(rows4, k, f, w_t),
                               rtol=1e-5, atol=1e-3)


def test_window_is_cast_to_the_taps_type(rng):
    """bf16 taps: the lerped window is rounded to bf16 before the product,
    as the TPU kernel does, then summed in f32."""
    rows4, k, f, w_t = _inputs(rng, 1, 2, 4, 16, 24, 3)
    wt16 = torch.from_numpy(w_t).to(torch.bfloat16)
    got = shift_lerp_matmul_plain(torch.from_numpy(rows4),
                                  torch.from_numpy(k), torch.from_numpy(f),
                                  wt16)
    lerped = _oracle(rows4, k, f, np.eye(24, dtype=np.float32)[None]
                     .repeat(2, 0))  # (g, b, u, r): the window itself
    win16 = torch.from_numpy(lerped).to(torch.bfloat16).float()
    ref = torch.einsum("gbur,bmu->gbmr", win16, wt16.float())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-3)


def test_clamped_rows_come_out_zero(rng):
    rows4, _, f, w_t = _inputs(rng, 1, 1, 4, 10, 12, 3)
    k = np.array([-14, -10_000, 10, 10_000], np.int32)
    got = fused_shift_lerp_matmul(torch.from_numpy(rows4),
                                  torch.from_numpy(k), torch.from_numpy(f),
                                  torch.from_numpy(w_t)).numpy()
    assert not got.any()


def test_cpu_call_counts_no_launch(rng):
    rows4, k, f, w_t = _inputs(rng, 1, 2, 3, 8, 8, 4)
    before = fused_shift_lerp_matmul.launches
    fused_shift_lerp_matmul(*(torch.from_numpy(a) for a in (rows4, k, f, w_t)))
    assert fused_shift_lerp_matmul.launches == before


def test_no_plain_fallback_off_the_cpu():
    rows4 = torch.empty((1, 2, 3, 8), device="meta")
    k = torch.empty((6,), dtype=torch.int32, device="meta")
    f = torch.empty((6,), device="meta")
    w_t = torch.empty((2, 4, 8), device="meta")
    with pytest.raises(ValueError, match="no shift"):
        fused_shift_lerp_matmul(rows4, k, f, w_t)
