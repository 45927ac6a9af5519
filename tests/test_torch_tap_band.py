"""The band pass of kernel 4 (peclr_tpu_torch/ops/shift_lerp_matmul.py) and
the premise of the band-limited product.

`tap_band_plain` finds, for each tile of outputs (BAND_M for bf16 taps,
BAND_M_F32 for f32 taps), the range of u where the taps are not zero; the
CUDA kernel multiplies only that range, rounded out to the MMA depth (bf16)
or to 4 taps (f32).  Here the plain band is held against a numpy oracle,
and the product restricted to each tile's rounded band against the dense
plain version and the reference's Pallas kernel in interpret mode, at the
warp's tap matrices and slopes.  The CUDA band pass and product are held
against these plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.ops.pallas.barrel_shift import (
    fused_shift_lerp_matmul as jax_matmul,
)
from peclr_tpu_torch.ops.shift_lerp import shift_lerp_grouped_plain
from peclr_tpu_torch.ops.shift_lerp_matmul import (
    BAND_M,
    BAND_M_F32,
    band_tile,
    shift_lerp_matmul_plain,
    tap_band,
    tap_band_plain,
)
from peclr_tpu_torch.ops.warp_mxu import _area_matrix, _tent_matrix

MMA_DEPTH = 16  # kDepth of csrc/shift_lerp_matmul.cu
F32_ROUND = 4  # the f32 product walks its bands in steps of 4 taps


def rounded_band(band, u, depth=MMA_DEPTH):
    """The taps the CUDA kernel walks for each tile of `band`: lo rounded
    down and hi up to `depth`, hi at most U rounded up; an empty band stays
    empty.  -> (lo, hi) int64 tensors."""
    lo, hi = band[..., 0].long(), band[..., 1].long()
    lo_r = lo // depth * depth
    u_end = -(-u // depth) * depth
    hi_r = (-(-hi // depth) * depth).clamp(max=u_end)
    return lo_r, torch.where(hi > lo, hi_r, lo_r)


def _oracle_band(w_t, bm):
    b, m, u = w_t.shape
    tiles = -(-m // bm)
    out = np.zeros((b, tiles, 2), np.int32)
    for bi in range(b):
        for t in range(tiles):
            used = np.flatnonzero((w_t[bi, t * bm:(t + 1) * bm] != 0).any(0))
            if used.size:
                out[bi, t] = used[0], used[-1] + 1
    return out


def _sparse_taps(rng, b, m, u, density):
    w = rng.uniform(-1, 1, (b, m, u)).astype(np.float32)
    return np.where(rng.uniform(0, 1, w.shape) < density, w, 0).astype(np.float32)


def _case_taps(case, rng):
    if case == "random_sparse":
        return _sparse_taps(rng, 3, 96, 128, 0.02)
    if case == "zero_tiles":  # tiles 0 and 2 of image 1 all zero, image 2 empty
        w = _sparse_taps(rng, 3, 96, 64, 0.05)
        w[1, :BAND_M] = 0
        w[1, 2 * BAND_M:] = 0
        w[2] = 0
        return w
    if case == "edges":  # a nonzero at u = 0 in one tile and at u = U - 1 in another
        w = np.zeros((2, 64, 48), np.float32)
        w[0, 3, 0] = 0.5
        w[0, 40, 47] = -0.25
        w[1, 10, 0] = 1.0
        w[1, 20, 47] = 1.0
        return w
    if case == "ragged_m":  # M not a multiple of BAND_M
        return _sparse_taps(rng, 2, 72, 64, 0.03)
    if case == "ragged_u":  # U not a multiple of 8
        return _sparse_taps(rng, 2, 64, 100, 0.03)
    if case == "negative_zero":  # -0 counts as zero, as `w_t != 0` says
        w = np.full((1, 40, 24), -0.0, np.float32)
        w[0, 35, 7] = 2.0
        return w
    raise ValueError(case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["random_sparse", "zero_tiles", "edges",
                                  "ragged_m", "ragged_u", "negative_zero"])
def test_tap_band_plain_matches_numpy_oracle(rng, case, dtype):
    w = _case_taps(case, rng)
    got = tap_band_plain(torch.from_numpy(w).to(dtype))
    assert got.dtype == torch.int32
    assert got.shape == (w.shape[0], -(-w.shape[1] // BAND_M), 2)
    np.testing.assert_array_equal(got.numpy(), _oracle_band(w, BAND_M))


def test_tap_band_plain_takes_any_tile_size(rng):
    w = _sparse_taps(rng, 2, 50, 37, 0.05)
    for bm in (1, 7, 16, 64):
        np.testing.assert_array_equal(
            tap_band_plain(torch.from_numpy(w), bm).numpy(), _oracle_band(w, bm))


def test_rounded_band_is_the_kernels_walk():
    """lo down and hi up to the MMA depth, hi at most U rounded up, an
    empty band stays empty."""
    band = torch.tensor([[[0, 0], [5, 20], [16, 32], [90, 100], [7, 7]]],
                        dtype=torch.int32)
    lo, hi = rounded_band(band, 100)
    assert lo.tolist() == [[0, 0, 16, 80, 0]]
    assert hi.tolist() == [[0, 32, 32, 112, 0]]


def _recipe_inputs(seed, lo_s, hi_s, u, m, taps):
    """Warp-shaped inputs: G = 3 planes of B images of R rows of 256 uint8
    pixels, shifts over the window's range, the warp's tap matrix (f32) at
    slopes in [lo_s, hi_s)."""
    rng = np.random.default_rng(seed)
    g, b, r, w = 3, 4, 16, 256
    rows4 = rng.integers(0, 256, (g, b, r, w)).astype(np.uint8)
    off = rng.uniform(-(u + 40), w + 40, (b * r,))
    k = np.clip(np.floor(off), -(u + 2), w).astype(np.int32)
    f = (off - np.floor(off)).astype(np.float32)
    slopes = torch.from_numpy(rng.uniform(lo_s, hi_s, (b,)).astype(np.float32))
    w_t = taps(slopes, u, m, transposed=True).numpy()
    return rows4, k, f, w_t


def _banded_product(rows4, k, f, w_t, bm=BAND_M, depth=MMA_DEPTH):
    """The CUDA kernel's sum: for each tile of bm outputs only the taps in
    its band rounded out to `depth` (taps past U are zero), in f32."""
    g, b, r, w = rows4.shape
    _, m, u = w_t.shape
    win = shift_lerp_grouped_plain(rows4.reshape(g, b * r, w), k, f, u,
                                   out_dtype=w_t.dtype).reshape(g, b, r, u)
    lo, hi = rounded_band(tap_band_plain(w_t, bm), u, depth)
    out = torch.zeros((g, b, m, r), dtype=torch.float32)
    for bi in range(b):
        for t in range(lo.shape[1]):
            a, z = int(lo[bi, t]), min(int(hi[bi, t]), u)
            ms = slice(t * bm, (t + 1) * bm)
            out[:, bi, ms] = torch.einsum(
                "gru,mu->gmr", win[:, bi, :, a:z].float(),
                w_t[bi, ms, a:z].float())
    return out, lo, hi


@pytest.mark.parametrize("name,lo_s,hi_s,u,taps", [
    ("pass1_area", 1.0, 2.5, 384, _area_matrix),
    ("pass2_area", 1.0, 1.75, 256, _area_matrix),
    ("upscale_tent", 0.5, 1.0, 384, _tent_matrix),
])
def test_banded_product_equals_dense(name, lo_s, hi_s, u, taps):
    """The premise of the design: on the warp's tap matrices the product
    over each tile's rounded band equals the dense plain product within
    1e-3 on the 0-255 scale (f32, summation order only) and the reference's
    Pallas kernel in interpret mode (rtol 1e-5 / atol 1e-2, as
    test_torch_shift_matmul.py), and each band is at most BAND_M * s + 3
    taps wide."""
    m = 128
    rows4, k, f, w_t = _recipe_inputs(3, lo_s, hi_s, u, m, taps)
    tensors = [torch.from_numpy(a) for a in (rows4, k, f, w_t)]
    got, lo, hi = _banded_product(*tensors)
    dense = shift_lerp_matmul_plain(*tensors)
    torch.testing.assert_close(got, dense, rtol=0, atol=1e-3)
    ref = np.asarray(jax_matmul(jnp.asarray(rows4), jnp.asarray(k),
                                jnp.asarray(f), jnp.asarray(w_t),
                                out_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-2)
    band = tap_band_plain(tensors[3])
    assert int((band[..., 1] - band[..., 0]).max()) <= BAND_M * hi_s + 3
    assert int((hi - lo).max()) < u  # the band is narrower than the window


def test_bf16_taps_keep_the_band(rng):
    """The warp casts its taps to bf16 before the kernel: no tap of the
    recipe's area matrices rounds to zero or leaves the f32 band."""
    slopes = torch.from_numpy(rng.uniform(1.0, 2.5, (8,)).astype(np.float32))
    w_t = _area_matrix(slopes, 384, 128, transposed=True)
    assert torch.equal(tap_band_plain(w_t),
                       tap_band_plain(w_t.to(torch.bfloat16)))


def test_cpu_band_counts_no_launch(rng):
    """tap_band on the CPU is the plain version at its taps' tile (8
    outputs for f32 taps, 32 for bf16), and launches nothing."""
    w = torch.from_numpy(_sparse_taps(rng, 2, 40, 24, 0.1))
    before = tap_band.launches
    for taps in (w, w.to(torch.bfloat16)):
        assert torch.equal(tap_band(taps),
                           tap_band_plain(taps, band_tile(taps.dtype)))
    assert tap_band(w).shape == (2, 40 // BAND_M_F32, 2)
    assert tap_band.launches == before


def test_no_plain_band_off_the_cpu():
    with pytest.raises(ValueError, match="no band kernel"):
        tap_band(torch.empty((2, 40, 24), device="meta"))


@pytest.mark.parametrize("case", ["random_sparse", "zero_tiles", "edges",
                                  "ragged_m", "ragged_u", "negative_zero"])
def test_f32_tap_band_plain_matches_numpy_oracle(rng, case):
    """The band pass of f32 taps, at their tile of BAND_M_F32 outputs."""
    w = _case_taps(case, rng)
    got = tap_band_plain(torch.from_numpy(w), BAND_M_F32)
    assert got.shape == (w.shape[0], -(-w.shape[1] // BAND_M_F32), 2)
    np.testing.assert_array_equal(got.numpy(), _oracle_band(w, BAND_M_F32))


def _f32_case(name):
    """Inputs of the f32-tap path: G = 3 planes of B images of R rows of
    256 source elements (uint8 canvases or the f32 output of a first pass),
    shifts over the window's range, f32 taps of U = 128-384."""
    rng = np.random.default_rng(11)
    src, taps, lo_s, hi_s, u, m, r = {
        "pass1_area_u8": ("u8", "area", 1.0, 2.5, 384, 128, 16),
        "pass2_area_f32": ("f32", "area", 1.0, 1.75, 256, 128, 16),
        "tent_u8": ("u8", "tent", 0.5, 1.0, 384, 128, 16),
        "dense_f32": ("f32", "dense", 0, 0, 128, 64, 16),
        "zero_u8": ("u8", "zero", 0, 0, 128, 64, 16),
        "ragged_m_r_f32": ("f32", "area", 1.0, 1.6, 128, 72, 40),
        "ragged_m_r_u8": ("u8", "tent", 0.6, 1.0, 128, 40, 24),
    }[name]
    g, b, w = 3, 3, 256
    if src == "u8":
        rows4 = rng.integers(0, 256, (g, b, r, w)).astype(np.uint8)
    else:
        rows4 = rng.uniform(0, 255, (g, b, r, w)).astype(np.float32)
    off = rng.uniform(-(u + 40), w + 40, (b * r,))
    k = np.clip(np.floor(off), -(u + 2), w).astype(np.int32)
    f = (off - np.floor(off)).astype(np.float32)
    if taps == "dense":  # nonzero everywhere, each output's taps sum to 1
        w_t = rng.uniform(0, 1, (b, m, u)).astype(np.float32)
        w_t /= w_t.sum(axis=2, keepdims=True)
    elif taps == "zero":
        w_t = np.zeros((b, m, u), np.float32)
    else:
        matrix = _area_matrix if taps == "area" else _tent_matrix
        slopes = torch.from_numpy(rng.uniform(lo_s, hi_s, (b,)).astype(
            np.float32))
        w_t = matrix(slopes, u, m, transposed=True).numpy()
    return rows4, k, f, w_t


@pytest.mark.parametrize("name", ["pass1_area_u8", "pass2_area_f32",
                                  "tent_u8", "dense_f32", "zero_u8",
                                  "ragged_m_r_f32", "ragged_m_r_u8"])
def test_f32_banded_product_matches_reference(name):
    """The f32-tap path's sum, each tile of BAND_M_F32 outputs over its band
    rounded out to 4 taps, against the reference's Pallas kernel in
    interpret mode with f32 taps (within 1e-4 on the 0-255 scale: f32, the
    summation order only) and against the dense plain version."""
    rows4, k, f, w_t = _f32_case(name)
    tensors = [torch.from_numpy(a) for a in (rows4, k, f, w_t)]
    got, lo, hi = _banded_product(*tensors, bm=BAND_M_F32, depth=F32_ROUND)
    ref = np.asarray(jax_matmul(jnp.asarray(rows4), jnp.asarray(k),
                                jnp.asarray(f), jnp.asarray(w_t),
                                out_dtype=jnp.float32, interpret=True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    torch.testing.assert_close(got, shift_lerp_matmul_plain(*tensors),
                               rtol=0, atol=1e-4)
    if name == "zero_u8":
        assert int(hi.max()) == 0 and float(got.abs().max()) == 0.0
    if name.startswith(("pass", "tent")):
        # a tile of 8 outputs walks at most 8 s + 2 taps, rounded out to 4
        assert int((hi - lo).max()) <= -(-(BAND_M_F32 * 2.5 + 2) // 4) * 4 + 4
