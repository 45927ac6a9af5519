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
PHOTOMETRIC = [f"photometric_ragged_{case[0]}"
               for case in chip_smoke.PHOTOMETRIC_RAGGED]
BATCH_NORM_ACT = [f"batch_norm_act_{kernel}_{where}_{dtype}"
                  for where, _ in chip_smoke.BN_ACT_POISON_SHAPES
                  for dtype in ("bfloat16", "float32")
                  for kernel in ("stats", "apply", "backward_reduce",
                                 "backward_elemt")]


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


def test_photometric_cases_are_the_listed_ones():
    assert PHOTOMETRIC == ["photometric_ragged_planes_w130",
                           "photometric_ragged_planes_h77",
                           "photometric_ragged_nhwc_7x13x36",
                           "photometric_ragged_planes_no_jitter"]
    assert [n for n, _, _ in chip_smoke.photometric_cases(torch, CPU)] == (
        PHOTOMETRIC)


@pytest.mark.parametrize("case", chip_smoke.PHOTOMETRIC_RAGGED,
                         ids=PHOTOMETRIC)
def test_photometric_case_on_the_cpu(case):
    """Kernel 5's ragged cases: launch equal to plain, on the case's shape
    and layout."""
    name = f"photometric_ragged_{case[0]}"
    launch, plain = {n: (lc, pl) for n, lc, pl in
                     chip_smoke.photometric_cases(torch, CPU)}[name]
    got = launch()
    assert chip_smoke.same_bits(torch, got, plain())
    x = {n: x for n, x, _, _ in
         chip_smoke.photometric_ragged_inputs(torch, CPU)}[name]
    _, shape, planes, _ = case
    assert tuple(x.shape) == (*shape, 3)
    assert x.is_contiguous() != planes


def test_batch_norm_act_shapes_are_ragged():
    """Odd row counts, C a multiple of the 16-byte vector (the kernels take
    no other), and more rows than one row block of a reduction tile takes
    (256 threads over the tile's lanes, 16 rows each), bf16 and f32."""
    for _, (n, c, h, w) in chip_smoke.BN_ACT_POISON_SHAPES:
        rows = n * h * w
        assert rows % 2
        for per_vec in (8, 4):
            assert c % per_vec == 0
            lanes = min(c // per_vec, 32)
            assert rows > 256 // lanes * 16, (c, per_vec)


def _batch_norm_act_cases():
    torch.manual_seed(0)
    return {name: (launch, plain) for name, launch, plain in
            chip_smoke.batch_norm_act_cases(torch, CPU)}


def test_batch_norm_act_cases_are_the_listed_ones():
    assert list(_batch_norm_act_cases()) == BATCH_NORM_ACT


@pytest.mark.parametrize("name", BATCH_NORM_ACT)
def test_batch_norm_act_case_on_the_cpu(name):
    """Kernel 6's cases: the launch (the plain passes here) against the
    plain version by the poison phase's own check."""
    launch, plain = _batch_norm_act_cases()[name]
    got, ref = launch(), plain()
    fields = chip_smoke.bn_case_ok(torch, name, got, ref)
    assert fields["ok"], fields


def test_every_case_has_a_kernels_line_row():
    rows = {"shift_lerp_grouped", "shift_raw_grouped", "shift_lerp_flat",
            "shift_lerp_matmul", "stream_copy", "stream_add",
            "stream_bn_res_relu", "stream_stats", "photometric",
            "batch_norm_act"}
    recipe = ["kernel1_pass1_u8_to_bf16", "kernel1_pass2_bf16_to_bf16",
              "kernel2_raw_pass1_u8", "kernel3_pass1_u8_to_bf16",
              "kernel4_pass1_bf16_taps", "kernel4_pass1_f32_taps"]
    seen = set()
    for name in recipe + RAGGED + STREAMS + PHOTOMETRIC + BATCH_NORM_ACT:
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
