"""The port's flat (NHWC) row shift, kernel 3 (peclr_tpu_torch/ops/
shift_lerp.py:fused_shift_lerp and shift_rows), against the reference's
Pallas kernel `_kernel(grouped=False)` in interpret mode, its XLA shifter
and a numpy oracle.

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel is
held against that plain version on the card by tests/test_torch_cuda.py
and by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.ops.pallas.barrel_shift import fused_shift_lerp as jax_flat
from peclr_tpu.ops.pallas.barrel_shift import shift_rows_pallas
from peclr_tpu.ops.warp_mxu import _shift_rows
from peclr_tpu_torch.ops import shift_lerp
from peclr_tpu_torch.ops.shift_lerp import (
    fused_shift_lerp,
    shift_lerp_flat_plain,
    shift_rows,
)


def _inputs(rng, n, w_px, c, out_w, dtype=np.float32):
    shape = (n, w_px * c)
    if dtype == np.uint8:
        rows = rng.integers(0, 256, shape).astype(np.uint8)
    else:
        rows = rng.uniform(0, 255, shape).astype(dtype)
    # shifts past both clamps: k < -(out_w + 2) and k > w
    k = rng.integers(-(out_w + 12), w_px + 12, (n,)).astype(np.int32)
    f = rng.uniform(0, 1, (n,)).astype(np.float32)
    return rows, k, f


def _oracle(rows, k, f, out_w, c):
    """Direct numpy shift of (N, W*C) rows: taps outside the row read 0."""
    n, elems = rows.shape
    kk = np.clip(k, -(out_w + 2), elems // c)
    win = np.zeros((n, (out_w + 1) * c), np.float32)
    for i in range(n):
        for e in range((out_w + 1) * c):
            t = e + kk[i] * c
            if 0 <= t < elems:
                win[i, e] = rows[i, t]
    fr = f[:, None]
    return win[:, :-c] * (1 - fr) + win[:, c:] * fr


@pytest.mark.parametrize("in_dtype", [np.float32, np.uint8])
def test_flat_matches_pallas_interpret(rng, in_dtype):
    """f32 out: the plain version against `_kernel(grouped=False)` in
    interpret mode, at a Pallas-legal shape (N % 32 == 0, 128-aligned
    elements, C = 3), within 1e-4 (both lerp in f32)."""
    n, w_px, c, out_w = 64, 128, 3, 128
    rows, k, f = _inputs(rng, n, w_px, c, out_w, in_dtype)
    ref = np.asarray(jax_flat(jnp.asarray(rows), jnp.asarray(k),
                              jnp.asarray(f), out_w * c, c,
                              out_dtype=jnp.float32, interpret=True))
    got = fused_shift_lerp(torch.from_numpy(rows), torch.from_numpy(k),
                           torch.from_numpy(f), out_w * c, c,
                           out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (n, out_w * c)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_flat_bf16_out_matches_pallas_interpret(rng):
    """bf16 out: both lerp in f32 and round once, so they differ by at most
    one bf16 step (1.0 on values up to 255)."""
    n, w_px, c, out_w = 32, 128, 3, 128
    rows, k, f = _inputs(rng, n, w_px, c, out_w, np.uint8)
    ref = np.asarray(jax_flat(jnp.asarray(rows), jnp.asarray(k),
                              jnp.asarray(f), out_w * c, c,
                              interpret=True).astype(jnp.float32))
    got = fused_shift_lerp(torch.from_numpy(rows), torch.from_numpy(k),
                           torch.from_numpy(f), out_w * c, c)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1.0, rtol=0)


def test_shift_rows_matches_reference(rng):
    """shift_rows against shift_rows_pallas (interpret mode) and the XLA
    barrel shifter `_shift_rows` on (B, H, W, C) images, within 1e-3 (the
    reference's own bound between the two)."""
    b, h, w, c, window = 4, 16, 128, 3, 128
    images = rng.uniform(0, 255, (b, h, w, c)).astype(np.float32)
    offsets = rng.uniform(-140, 160, (b, h)).astype(np.float32)
    got = shift_rows(torch.from_numpy(images), torch.from_numpy(offsets),
                     window, torch.float32).numpy()
    assert got.shape == (b, h, window, c)
    pallas = np.asarray(shift_rows_pallas(
        jnp.asarray(images), jnp.asarray(offsets), window,
        lerp_dtype=jnp.float32, interpret=True))
    xla = np.asarray(_shift_rows(jnp.asarray(images), jnp.asarray(offsets),
                                 pad=window - w, lerp_dtype=jnp.float32))
    np.testing.assert_allclose(got, pallas, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got, xla, atol=1e-3, rtol=0)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_odd_shapes_match_numpy_oracle(rng, c):
    """Any N, W, C and out: no row-block gate, no 128-element padding."""
    n, w_px, out_w = 37, 23, 41
    rows, k, f = _inputs(rng, n, w_px, c, out_w, np.uint8)
    got = fused_shift_lerp(torch.from_numpy(rows), torch.from_numpy(k),
                           torch.from_numpy(f), out_w * c, c,
                           out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), _oracle(rows, k, f, out_w, c),
                               atol=1e-4, rtol=0)


def test_c1_equals_grouped_plain(rng):
    """With C = 1 the flat kernel is the grouped one on a single plane."""
    rows, k, f = _inputs(rng, 20, 30, 1, 40)
    x, kt, ft = (torch.from_numpy(a) for a in (rows, k, f))
    flat = shift_lerp_flat_plain(x, kt, ft, 40, 1, torch.float32)
    grouped = shift_lerp.shift_lerp_grouped_plain(x[None], kt, ft, 40,
                                                  torch.float32)[0]
    assert torch.equal(flat, grouped)


def test_clamped_rows_come_out_zero(rng):
    n, w_px, c, out_w = 6, 20, 3, 30
    rows = rng.uniform(1, 255, (n, w_px * c)).astype(np.float32)
    k = np.array([-(out_w + 2), -10_000, w_px, 10_000, -out_w, 0], np.int32)
    f = rng.uniform(0, 1, n).astype(np.float32)
    got = fused_shift_lerp(torch.from_numpy(rows), torch.from_numpy(k),
                           torch.from_numpy(f), out_w * c, c,
                           out_dtype=torch.float32).numpy()
    assert not got[:4].any()
    # k = -out_w: only the last output pixel's upper tap reaches pixel 0
    assert not got[4, :-c].any() and (got[4, -c:] > 0).all()
    np.testing.assert_allclose(got, _oracle(rows, k, f, out_w, c), atol=1e-4)


def test_cpu_call_counts_no_launch(rng):
    rows, k, f = _inputs(rng, 8, 10, 3, 12)
    before = fused_shift_lerp.launches
    fused_shift_lerp(torch.from_numpy(rows), torch.from_numpy(k),
                     torch.from_numpy(f), 36, 3)
    assert fused_shift_lerp.launches == before


def test_no_plain_fallback_off_the_cpu():
    rows = torch.empty((4, 24), device="meta")
    k = torch.empty((4,), dtype=torch.int32, device="meta")
    f = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="no shift kernel"):
        fused_shift_lerp(rows, k, f, 24, 3)


@pytest.mark.parametrize("c", [1, 3, 4])
def test_flat_tails_match_pallas_interpret(rng, c):
    """The plain version at N = 1001, W = 130 pixels and out = 129 pixels
    (odd row bytes and a ragged tail), against `_kernel(grouped=False)` in
    interpret mode on inputs padded to its grid (N to 1024, elements to
    multiples of 128): zero elements past the row and outputs past the
    window change none of the first out*C outputs.  f32 within 1e-4."""
    n, w_px, out_w = 1001, 130, 129
    rows, k, f = _inputs(rng, n, w_px, c, out_w, np.uint8)
    in_elems = -(-w_px * c // 128) * 128
    out_elems = -(-out_w * c // 128) * 128
    padded = np.zeros((1024, in_elems), np.uint8)
    padded[:n, :w_px * c] = rows
    kp, fp = np.zeros(1024, np.int32), np.zeros(1024, np.float32)
    kp[:n], fp[:n] = k, f
    ref = np.asarray(jax_flat(jnp.asarray(padded), jnp.asarray(kp),
                              jnp.asarray(fp), out_elems, c,
                              out_dtype=jnp.float32, interpret=True))
    got = shift_lerp_flat_plain(torch.from_numpy(rows), torch.from_numpy(k),
                                torch.from_numpy(f), out_w * c, c,
                                torch.float32).numpy()
    np.testing.assert_allclose(got, ref[:n, :out_w * c], atol=1e-4, rtol=0)
