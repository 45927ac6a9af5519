"""The cases of chip_smoke.py's poison phase (7c), on the CPU.

On the card the phase launches each kernel after filling the caching
allocator's free blocks with a byte pattern; here the wrappers take their
plain versions, so these tests hold what the card cannot check for itself:
that each ragged case is as ragged as its name says, that its launch and
its plain version agree, and that every case has a row in the kernels line.
tests/test_torch_cuda.py runs the poison check itself on the card.
"""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from peclr_tpu_torch.ops.shift_lerp_matmul import (  # noqa: E402
    BAND_M,
    BAND_M_F32,
    FLAG_ROWS,
)
from peclr_tpu_torch.scripts import bench_streams  # noqa: E402

CPU = torch.device("cpu")
RAGGED = ["kernel1_ragged_vec16_u8_to_bf16",
          "kernel1_ragged_scalar_u8_to_bf16",
          "kernel1_ragged_scalar_bf16_to_f32", "kernel2_raw_ragged_scalar_u8",
          "kernel3_ragged_scalar_u8_to_bf16",
          "kernel4_ragged_bf16_src_bf16_taps",
          "kernel4_ragged_bf16_src_f32_taps", "tap_band_pass1_bf16",
          "tap_band_pass1_f32", "tap_band_ragged_bf16", "tap_band_ragged_f32"]
STREAMS = [f"stream_{op}_ragged_{dtype}"
           for dtype in ("bfloat16", "float32")
           for op in ("copy", "add", "bn_res_relu", "stats")]
RAGGED_STREAM_SHAPES = [s for s in chip_smoke.STREAM_POISON_SHAPES
                        if s[0] == "ragged"]


def _ragged():
    torch.manual_seed(0)
    return {name: (launch, plain)
            for name, launch, plain in chip_smoke.ragged_cases(torch, CPU)}


def test_ragged_cases_are_the_listed_ones():
    assert list(_ragged()) == RAGGED


@pytest.mark.parametrize("name", RAGGED)
def test_ragged_case_launch_equals_plain_on_the_cpu(name):
    launch, plain = _ragged()[name]
    got, want = launch(), plain()
    assert chip_smoke.same_bits(torch, got, want)
    if name.startswith(("kernel1", "kernel2", "kernel3")):
        assert got.shape[-2] % 2 == 1  # an odd row count
        out_bytes = got.shape[-1] * got.element_size()
        assert (out_bytes % 16 == 0) == ("vec16" in name)


def test_kernel4_ragged_shapes_cut_every_tile():
    cases = _ragged()
    out = cases["kernel4_ragged_bf16_src_bf16_taps"][0]()
    g, b, m, r = out.shape
    assert g % 3 and r % FLAG_ROWS and m % BAND_M and m % BAND_M_F32
    band = cases["tap_band_ragged_bf16"][0]()
    # dense bf16 taps: every tile's band is all of U = 131, off the 8-tap
    # vector, walked in two segments of 128
    assert band.shape == (b, -(-m // BAND_M), 2)
    assert (band[..., 1] == 131).all() and (band[..., 0] == 0).all()


def test_stream_poison_shapes_start_at_bench_streams_shape():
    assert chip_smoke.STREAM_POISON_SHAPES[0] == ("bench", bench_streams.SHAPE)
    (_, ragged), = RAGGED_STREAM_SHAPES
    n, c = torch.Size(ragged).numel(), ragged[-1]
    for vec in (8, 4):  # elements in 16 bytes of bf16, f32
        assert n % vec and c % vec


@pytest.mark.parametrize("name", STREAMS)
def test_ragged_stream_case_on_the_cpu(name):
    cases = {n: (launch, plain) for n, launch, plain in
             chip_smoke.stream_cases(torch, CPU, RAGGED_STREAM_SHAPES)}
    assert list(cases) == [s for s in STREAMS if "bfloat16" in s] + [
        s for s in STREAMS if "float32" in s]
    launch, plain = cases[name]
    got, want = launch(), plain()
    if "stats" in name:
        rel, _ = bench_streams._stats_err(got, want)
        assert rel <= bench_streams.STATS_TOL
    else:
        assert chip_smoke.same_bits(torch, got, want)


def test_every_case_has_a_kernels_line_row():
    rows = {"shift_lerp_grouped", "shift_raw_grouped", "shift_lerp_flat",
            "shift_lerp_matmul", "stream_copy", "stream_add",
            "stream_bn_res_relu", "stream_stats"}
    recipe = ["kernel1_pass1_u8_to_bf16", "kernel1_pass2_bf16_to_bf16",
              "kernel2_raw_pass1_u8", "kernel3_pass1_u8_to_bf16",
              "kernel4_pass1_bf16_taps", "kernel4_pass1_f32_taps"]
    seen = set()
    for name in recipe + RAGGED + STREAMS:
        kernel = next(k for prefix, k in chip_smoke.POISON_KERNEL_OF
                      if name.startswith(prefix))
        seen.add(kernel)
    assert seen == rows


def test_same_bits_compares_bits():
    nan = torch.tensor([float("nan"), 0.0])
    assert chip_smoke.same_bits(torch, nan, nan.clone())
    assert not chip_smoke.same_bits(torch, torch.tensor([0.0]),
                                    torch.tensor([-0.0]))
    assert not chip_smoke.same_bits(torch, torch.zeros(2),
                                    torch.zeros(2, dtype=torch.bfloat16))
