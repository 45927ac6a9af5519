"""The port's grouped row shift (peclr_tpu_torch/ops/shift_lerp.py) against
the reference's Pallas kernel in interpret mode and a numpy oracle.

On the CPU the wrapper runs the plain PyTorch version; the CUDA kernel is
held against that plain version on the card by tests/test_torch_cuda.py
and by chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.ops.pallas.barrel_shift import (
    fused_shift_lerp_grouped as jax_grouped,
)
from peclr_tpu_torch.ops import shift_lerp
from peclr_tpu_torch.ops.shift_lerp import (
    VEC16_MAX_ROW_BYTES,
    fused_shift_lerp_grouped,
    shift_lerp_grouped_plain,
    shift_path,
)


def _inputs(rng, g, n, w, out, dtype=np.float32):
    if dtype == np.uint8:
        rows = rng.integers(0, 256, (g, n, w)).astype(np.uint8)
    else:
        rows = rng.uniform(0, 255, (g, n, w)).astype(dtype)
    # shifts past both clamps: k < -(out + 2) and k > w
    k = rng.integers(-(out + 12), w + 12, (n,)).astype(np.int32)
    f = rng.uniform(0, 1, (n,)).astype(np.float32)
    return rows, k, f


def _oracle(rows, k, f, out, lerp):
    """Direct numpy shift: taps outside [0, W) read 0, k clamped first."""
    g, n, w = rows.shape
    kk = np.clip(k, -(out + 2), w)
    taps = out + 1 if lerp else out
    win = np.zeros((g, n, taps), rows.dtype)
    for i in range(n):
        for u in range(taps):
            t = u + kk[i]
            if 0 <= t < w:
                win[:, i, u] = rows[:, i, t]
    if not lerp:
        return win
    win = win.astype(np.float32)
    return win[..., :-1] * (1 - f[None, :, None]) + win[..., 1:] * f[None, :, None]


@pytest.mark.parametrize("in_dtype", [np.float32, np.uint8])
def test_lerp_matches_pallas_interpret(rng, in_dtype):
    """lerp=True, f32 out: the plain version against the TPU kernel body
    `_kernel(grouped=True)` run in interpret mode, within 1e-4."""
    g, n, w, out = 3, 64, 256, 128
    rows, k, f = _inputs(rng, g, n, w, out, in_dtype)
    ref = np.asarray(jax_grouped(jnp.asarray(rows), jnp.asarray(k),
                                 jnp.asarray(f), out, out_dtype=jnp.float32,
                                 interpret=True))
    got = fused_shift_lerp_grouped(torch.from_numpy(rows), torch.from_numpy(k),
                                   torch.from_numpy(f), out,
                                   out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (g, n, out)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)


def test_lerp_bf16_out_matches_pallas_interpret(rng):
    """bf16 out (the warp's default): both lerp in f32 and round once, so
    they differ by at most one bf16 step (1.0 on values up to 255)."""
    g, n, w, out = 3, 64, 256, 128
    rows, k, f = _inputs(rng, g, n, w, out, np.uint8)
    ref = np.asarray(jax_grouped(jnp.asarray(rows), jnp.asarray(k),
                                 jnp.asarray(f), out, interpret=True)
                     .astype(jnp.float32))
    got = fused_shift_lerp_grouped(torch.from_numpy(rows), torch.from_numpy(k),
                                   torch.from_numpy(f), out)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), ref, atol=1.0, rtol=0)


@pytest.mark.parametrize("in_dtype", [np.float32, np.uint8])
def test_raw_matches_pallas_interpret_exactly(rng, in_dtype):
    """lerp=False (`_kernel_raw`): the integer-shifted window in the input
    type, bit for bit."""
    g, n, w, out = 3, 64, 256, 128
    rows, k, _ = _inputs(rng, g, n, w, out, in_dtype)
    ref = np.asarray(jax_grouped(jnp.asarray(rows), jnp.asarray(k), None,
                                 out, interpret=True, lerp=False))
    got = fused_shift_lerp_grouped(torch.from_numpy(rows),
                                   torch.from_numpy(k), None, out, lerp=False)
    assert got.numpy().dtype == ref.dtype == in_dtype
    np.testing.assert_array_equal(got.numpy(), ref)


def test_raw_bf16_keeps_type_and_bits(rng):
    g, n, w, out = 2, 40, 33, 50
    rows, k, _ = _inputs(rng, g, n, w, out)
    x = torch.from_numpy(rows).to(torch.bfloat16)
    got = fused_shift_lerp_grouped(x, torch.from_numpy(k), None, out,
                                   lerp=False)
    assert got.dtype == torch.bfloat16
    ref = _oracle(x.float().numpy(), k, None, out, lerp=False)
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("lerp", [True, False])
def test_odd_shapes_match_numpy_oracle(rng, lerp):
    """Any N, W and out: no row-block gate and no 128-column padding."""
    g, n, w, out = 3, 37, 50, 70
    rows, k, f = _inputs(rng, g, n, w, out, np.uint8)
    got = fused_shift_lerp_grouped(torch.from_numpy(rows), torch.from_numpy(k),
                                   torch.from_numpy(f), out,
                                   out_dtype=torch.float32 if lerp else None,
                                   lerp=lerp)
    ref = _oracle(rows, k, f, out, lerp)
    if lerp:
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-4, rtol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), ref)


def test_clamped_rows_come_out_zero(rng):
    g, n, w, out = 2, 8, 20, 30
    rows = rng.uniform(1, 255, (g, n, w)).astype(np.float32)
    k = np.array([-(out + 2), -10_000, w, 10_000, -out, w - 1, 0, 5],
                 np.int32)
    f = rng.uniform(0, 1, n).astype(np.float32)
    got = fused_shift_lerp_grouped(torch.from_numpy(rows), torch.from_numpy(k),
                                   torch.from_numpy(f), out,
                                   out_dtype=torch.float32).numpy()
    assert not got[:, :4].any()
    # k = -out: only the last output's upper tap reaches column 0
    assert not got[:, 4, :-1].any() and (got[:, 4, -1] > 0).all()
    np.testing.assert_allclose(got, _oracle(rows, k, f, out, True), atol=1e-4)


def test_cpu_call_counts_no_launch(rng):
    rows, k, f = _inputs(rng, 1, 8, 16, 24)
    before = (fused_shift_lerp_grouped.launches,
              fused_shift_lerp_grouped.raw_launches)
    fused_shift_lerp_grouped(torch.from_numpy(rows), torch.from_numpy(k),
                             torch.from_numpy(f), 24)
    fused_shift_lerp_grouped(torch.from_numpy(rows), torch.from_numpy(k),
                             None, 24, lerp=False)
    assert (fused_shift_lerp_grouped.launches,
            fused_shift_lerp_grouped.raw_launches) == before


def test_no_plain_fallback_off_the_cpu():
    """A tensor that is not on the CPU never takes the plain version."""
    rows = torch.empty((1, 4, 8), device="meta")
    k = torch.empty((4,), dtype=torch.int32, device="meta")
    f = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="no shift kernel"):
        fused_shift_lerp_grouped(rows, k, f, 8)


def test_raw_mode_rejects_out_dtype(rng):
    rows, k, _ = _inputs(rng, 1, 8, 16, 24, np.uint8)
    with pytest.raises(ValueError):
        shift_lerp_grouped_plain(torch.from_numpy(rows), torch.from_numpy(k),
                                 None, 24, out_dtype=torch.float32, lerp=False)


def test_operand_checks(rng):
    """What the CUDA wrapper refuses before a launch."""
    rows, k, f = _inputs(rng, 2, 8, 16, 24)
    x, kt, ft = (torch.from_numpy(a) for a in (rows, k, f))
    check = shift_lerp._check_cuda_operands
    check(x, kt, ft, 24, torch.bfloat16, True)
    with pytest.raises(ValueError, match="int32"):
        check(x, kt.long(), ft, 24, torch.bfloat16, True)
    with pytest.raises(ValueError, match="float32"):
        check(x, kt, None, 24, torch.bfloat16, True)
    with pytest.raises(ValueError, match="contiguous"):
        check(x.transpose(0, 1).contiguous().transpose(0, 1), kt, ft, 24,
              torch.bfloat16, True)
    with pytest.raises(TypeError):
        check(x.double(), kt, ft, 24, torch.float32, True)
    with pytest.raises(TypeError):
        check(x, kt, ft, 24, torch.uint8, True)



def _pad_to(a, axis, size):
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, size - a.shape[axis])
    return np.pad(a, widths)


@pytest.mark.parametrize("w,out,lerp", [
    (224, 100, True),   # a ragged tail: 100 bf16 outputs are 200 bytes a row
    (224, 129, True),
    (130, 100, True),   # odd source row bytes
    (224, 129, False),
    (130, 129, False),
])
def test_tails_match_pallas_interpret(rng, w, out, lerp):
    """The plain version at N = 1001 and widths the Pallas kernel does not
    take, against that kernel in interpret mode on inputs padded to its
    grid (N to 1024, W and out to 256): zero columns past W and outputs past
    `out` change none of the first `out` outputs, since a shift clamped at
    either width leaves them all reading zero.  f32 within 1e-4; raw
    bit-exact."""
    g, n = 3, 1001
    rows, k, f = _inputs(rng, g, n, w, out, np.uint8)
    padded = _pad_to(_pad_to(rows, 1, 1024), 2, 256)
    ref = np.asarray(jax_grouped(
        jnp.asarray(padded), jnp.asarray(_pad_to(k, 0, 1024)),
        jnp.asarray(_pad_to(f, 0, 1024)) if lerp else None, 256,
        out_dtype=jnp.float32 if lerp else jnp.bfloat16, interpret=True,
        lerp=lerp))[:, :n, :out]
    got = shift_lerp_grouped_plain(
        torch.from_numpy(rows), torch.from_numpy(k),
        torch.from_numpy(f) if lerp else None, out,
        out_dtype=torch.float32 if lerp else None, lerp=lerp).numpy()
    assert got.shape == (g, n, out)
    if lerp:
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    else:
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("in_ptr,in_row,out_ptr,out_row,want", [
    (0, 224, 256, 768 * 2, "vec16"),   # the recipe's uint8 rows -> bf16
    (1, 224, 256, 768 * 2, "scalar"),  # an unaligned base (a view at byte 1)
    (0, 130, 256, 768 * 2, "scalar"),  # odd source row bytes (W = 130 uint8)
    (0, 224, 256, 100 * 4, "vec16"),   # f32 output: 100 outputs, 400 bytes
    (0, 224, 256, 100 * 2, "scalar"),  # bf16 output: 100 outputs, 200 bytes
    (0, 224, 8, 768 * 2, "scalar"),    # an unaligned output base
    (0, VEC16_MAX_ROW_BYTES, 0, 512, "vec16"),
    (0, VEC16_MAX_ROW_BYTES + 16, 0, 512, "scalar"),  # too wide to stage
])
def test_shift_path_choice(in_ptr, in_row, out_ptr, out_row, want):
    """The wrapper's choice between the kernel's two paths, pinned as the
    pure function it is."""
    assert shift_path(in_ptr, in_row, out_ptr, out_row) == want


def test_path_of_tensors_follows_their_addresses():
    """A contiguous tensor at an aligned base takes the 16-byte path, the
    same rows as a view one byte into a buffer the scalar one."""
    buf = torch.zeros(3 * 8 * 224 + 1, dtype=torch.uint8)
    out = torch.empty((3, 8, 768), dtype=torch.bfloat16)
    assert shift_lerp._path_of(buf[:-1].view(3, 8, 224), out) == "vec16"
    assert shift_lerp._path_of(buf[1:].view(3, 8, 224), out) == "scalar"
