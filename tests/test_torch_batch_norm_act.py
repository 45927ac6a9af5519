"""The trunk's BatchNorm -> [+ residual] -> [ReLU] (models/batchnorm.py:
batch_norm_act, ops/batch_norm_act.py, csrc/batch_norm_act.cu).

On the CPU: batch_norm_act is the chain it replaced, bit for bit (outputs,
running statistics, count, gradients); the autograd function on the plain
passes against the chain and float64 gradcheck; the ResNet modules' keys.
Marked `cuda` (skipped without a card): each kernel against the chain at
every BatchNorm shape of the RN50 trunk at the pretrain cell's microbatch
(1,024 views of 128^2) and at ragged ones, bf16 and f32.  This file imports
neither JAX nor the reference package:

    python -m pytest tests/test_torch_batch_norm_act.py -m cuda
"""

import copy
import os
import sys

import pytest
import torch
from torch import nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from peclr_tpu_torch.models import batchnorm as bnm  # noqa: E402
from peclr_tpu_torch.models.batchnorm import (  # noqa: E402
    BatchNorm2d,
    _BatchNormAct,
    batch_norm_act,
)
from peclr_tpu_torch.models.resnet import (  # noqa: E402
    BasicBlock,
    Bottleneck,
    ResNetEncoder,
)
from peclr_tpu_torch.ops import batch_norm_act as bnk  # noqa: E402

#: (residual, relu) as the trunk uses them: bn1/bn2 and the stem, bn3, the
#: downsample
MODES = [(False, True), (True, True), (False, False)]
MODE_IDS = ["relu", "residual_relu", "plain"]
#: every BatchNorm input shape of the RN50 trunk at the pretrain cell's
#: microbatch (2 x 512 views of 128^2), (N, C, H, W), with the modes the
#: trunk runs at it (chip_smoke.RN50_BATCH_NORMS)
RN50_MB512 = {}
for _c, _h, _mode, _ in chip_smoke.RN50_BATCH_NORMS:
    RN50_MB512.setdefault((1024, _c, _h, _h), []).append(_mode)
RN50_MB512 = list(RN50_MB512.items())
#: ragged: odd row counts, a tile of 9 lanes (C 72 in bf16) over two row
#: blocks, one row block, rows a tile can not fill, a last tile part full
RAGGED = [(5, 72, 13, 11), (3, 64, 5, 7), (2, 24, 1, 1), (1, 3000, 3, 1)]


def _bn(c, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    bn = BatchNorm2d(c)
    with torch.no_grad():
        bn.weight.copy_(torch.rand(c, generator=gen) + 0.5)
        bn.bias.copy_(torch.rand(c, generator=gen) - 0.5)
        bn.running_mean.copy_(torch.randn(c, generator=gen))
        bn.running_var.copy_(torch.rand(c, generator=gen) + 0.5)
    return bn.to(device)


def _inputs(shape, dtype, seed, device="cpu"):
    gen = torch.Generator().manual_seed(seed)
    c = shape[1]
    # channels with their own offsets and scales, as a convolution gives
    offset = torch.randn(1, c, 1, 1, generator=gen) * 2
    scale = torch.rand(1, c, 1, 1, generator=gen) + 0.25
    x = torch.randn(shape, generator=gen) * scale + offset
    r = torch.randn(shape, generator=gen)
    dy = torch.randn(shape, generator=gen)
    cl = torch.channels_last
    return tuple(t.to(device=device, dtype=dtype).contiguous(memory_format=cl)
                 for t in (x, r, dy))


def _chain(bn, x, residual, relu):
    out = bn(x)
    if residual is not None:
        out = out + residual
    return torch.relu(out) if relu else out


def _run(fn, bn, x, r, dy, residual, relu):
    """Output, gradients (x, weight, bias, residual) and the module's
    buffers after one forward and backward of fn."""
    bn.zero_grad()
    x = x.detach().requires_grad_(True)
    r = r.detach().requires_grad_(True) if residual else None
    out = fn(bn, x, r, relu)
    out.backward(dy)
    grads = (x.grad, bn.weight.grad, bn.bias.grad,
             r.grad if residual else None)
    return out.detach(), grads, {k: v.clone() for k, v in
                                 bn.named_buffers()}


# ---------------------------------------------------------------------------
# the CPU


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_cpu_path_is_the_chain_bit_for_bit(mode, layout):
    residual, relu = mode
    x, r, dy = _inputs((4, 6, 5, 3), torch.float32, 1)
    if layout == "contiguous":
        x, r, dy = (t.contiguous() for t in (x, r, dy))
    bn = _bn(6, 2)
    bn2 = copy.deepcopy(bn)
    got = _run(batch_norm_act, bn, x, r, dy, residual, relu)
    want = _run(_chain, bn2, x, r, dy, residual, relu)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert (g is None and w is None) or torch.equal(g, w)
    assert got[2].keys() == want[2].keys()
    for key in want[2]:
        assert torch.equal(got[2][key], want[2][key]), key
    assert int(got[2]["num_batches_tracked"]) == 1


def test_cpu_eval_mode_is_the_chain():
    x, r, _ = _inputs((3, 4, 2, 2), torch.float32, 3)
    bn = _bn(4, 4).eval()
    want = torch.relu(bn(x) + r)
    assert torch.equal(batch_norm_act(bn, x, r), want)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_autograd_function_on_the_plain_passes_against_the_chain(mode):
    """The function the card runs, here on the plain passes: output,
    running statistics and gradients against the chain within f32
    rounding (the plain statistics sum in float64, torch's in f32)."""
    residual, relu = mode
    x, r, dy = _inputs((6, 8, 7, 5), torch.float32, 5)
    bn, bn2 = _bn(8, 6), _bn(8, 6)

    def fused(bn, x, res, relu):
        return bnm._fused_call(bn, x, res, relu)

    got = _run(fused, bn, x, r, dy, residual, relu)
    want = _run(_chain, bn2, x, r, dy, residual, relu)
    assert (got[0] - want[0]).abs().max() <= 1e-5
    for g, w in zip(got[1], want[1]):
        if w is None:
            assert g is None
        else:
            assert (g - w).abs().max() <= 1e-4 * max(1.0, w.abs().max())
    for key in ("running_mean", "running_var"):
        assert torch.allclose(got[2][key], want[2][key], rtol=1e-5, atol=1e-6)
    assert int(got[2]["num_batches_tracked"]) == 1


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_autograd_function_gradcheck_float64(mode):
    residual, relu = mode
    gen = torch.Generator().manual_seed(7)
    shape = (3, 4, 3, 2)
    x = torch.randn(shape, generator=gen, dtype=torch.float64)
    r = torch.randn(shape, generator=gen, dtype=torch.float64)
    w = torch.rand(4, generator=gen, dtype=torch.float64) + 0.5
    b = torch.randn(4, generator=gen, dtype=torch.float64)
    running = [torch.zeros(4, dtype=torch.float64),
               torch.ones(4, dtype=torch.float64)]
    nbt = torch.zeros((), dtype=torch.int64)
    inputs = [t.requires_grad_(True) for t in (x, w, b)]
    if residual:
        inputs.append(r.requires_grad_(True))

    def fn(x, w, b, *res):
        return _BatchNormAct.apply(x, w, b, res[0] if res else None,
                                   *running, nbt, 1e-5, relu)

    assert torch.autograd.gradcheck(fn, inputs, atol=1e-6, rtol=1e-5)


def test_plain_mask_passes_nan_and_zeroes_nonpositive_outputs():
    y = torch.tensor([1.0, 0.0, -2.0, float("nan")]).view(1, 4, 1, 1)
    dy = torch.full_like(y, 3.0)
    stats = torch.zeros(2, 4)
    ones, zeros = torch.ones(4), torch.zeros(4)
    got = bnk.masked_plain(dy, y, stats, ones, zeros, bnk.RELU_FROM_Y, y)
    assert got.view(-1).tolist() == [3.0, 0.0, 0.0, 3.0]
    dx, dr = bnk.batch_norm_backward_elemt_plain(
        dy, y, stats, ones, zeros, torch.zeros(6, 4), bnk.RELU_FROM_Y, y,
        residual=True)
    assert torch.equal(dr, got)


def test_plain_statistics_are_flax_biased_variance():
    x, _, _ = _inputs((4, 3, 5, 5), torch.float32, 8)
    rm, rv = torch.zeros(3), torch.ones(3)
    nbt = torch.zeros((), dtype=torch.int64)
    stats = bnk.batch_norm_stats_plain(x, rm, rv, nbt, 1e-5, 0.1)
    xd = x.double()
    var = xd.var(dim=(0, 2, 3), unbiased=False)
    assert torch.allclose(stats[0].double(), xd.mean(dim=(0, 2, 3)),
                          atol=1e-6)
    assert torch.allclose(stats[1].double(), (var + 1e-5).rsqrt(), rtol=1e-6)
    assert torch.allclose(rv.double(), 0.9 + 0.1 * var, rtol=1e-6)
    assert int(nbt) == 1


def test_plain_moments_are_float64_sums():
    x, _, _ = _inputs((3, 6, 4, 5), torch.bfloat16, 9)
    got = bnk.batch_norm_moments(x)
    xd = x.double()
    assert got.dtype == torch.float64
    assert torch.equal(got[0], xd.sum(dim=(0, 2, 3)))
    assert torch.equal(got[1], xd.square().sum(dim=(0, 2, 3)))


def test_local_moments_on_the_cpu_stay_f32():
    """The mesh path's sums on the CPU are the f32 formulas as before; the
    f64 sums are the card's, for tensors the kernels take."""
    x, _, _ = _inputs((3, 6, 4, 5), torch.float32, 10)
    packed = bnm._local_moments(x)
    assert packed.dtype == torch.float32 and packed.shape == (13,)
    assert packed[-1].item() == 3 * 4 * 5


def test_the_kernels_take_no_cpu_tensor():
    x = torch.zeros(2, 8, 2, 2).contiguous(memory_format=torch.channels_last)
    assert not bnk.takes(x)
    assert not bnm._fused(_bn(8, 0), x, None)


# the modules keep torchvision's and the reference checkpoint's keys
BOTTLENECK_KEYS = [
    f"{m}.{p}" for m in ("conv1", "bn1", "conv2", "bn2", "conv3", "bn3",
                         "downsample.0", "downsample.1")
    for p in (("weight",) if m.startswith("conv") or m == "downsample.0"
              else ("weight", "bias", "running_mean", "running_var",
                    "num_batches_tracked"))]


def test_bottleneck_and_basic_block_keep_their_keys():
    assert list(Bottleneck(64, 64, 1, True).state_dict()) == BOTTLENECK_KEYS
    basic = [k for k in BOTTLENECK_KEYS if not k.startswith(("conv3", "bn3"))]
    assert list(BasicBlock(64, 64, 2, True).state_dict()) == basic


def test_encoder_keeps_its_sequential_indices_and_keys():
    enc = ResNetEncoder("50")
    kinds = [type(m) for m in enc.features]
    assert kinds[:4] == [nn.Conv2d, BatchNorm2d, nn.ReLU, nn.MaxPool2d]
    assert kinds[4:] == [nn.Sequential] * 4
    keys = list(enc.state_dict())
    assert keys[:6] == ["features.0.weight", "features.1.weight",
                        "features.1.bias", "features.1.running_mean",
                        "features.1.running_var",
                        "features.1.num_batches_tracked"]
    assert "features.4.0.downsample.1.running_var" in keys
    assert "features.7.2.bn3.weight" in keys
    assert sum(isinstance(m, BatchNorm2d) for m in enc.modules()) == 53


def test_encoder_forward_on_the_cpu_is_the_sequential():
    enc = ResNetEncoder("18")
    x = torch.randn(2, 3, 32, 32)
    want = torch.mean(enc.features(x), dim=(2, 3)).float()
    assert torch.equal(enc(x), want)


# ---------------------------------------------------------------------------
# the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


def _same(a, b):
    """Equal values and equal NaN positions (signs of zero aside)."""
    nan = torch.isnan(a)
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan], b[~nan]))


#: the statistics' and the backward sums' tolerances against float64, with
#: their reasons there
MEAN_TOL, INVSTD_TOL = chip_smoke.BN_ACT_MEAN_TOL, chip_smoke.BN_ACT_INVSTD_TOL
SUMS_TOL = chip_smoke.BN_ACT_SUMS_TOL


def _kernels_against_plain(card, shape, dtype, modes, seed):
    x, r, dy = _inputs(shape, dtype, seed, card)
    c = shape[1]
    bn = _bn(c, seed + 1, card)
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    nbt = torch.zeros((), dtype=torch.int64, device=card)
    stats = bnk.batch_norm_stats(x, rm, rv, nbt, 1e-5, 0.1)
    mean_err, inv_err = chip_smoke.bn_stats_errors(torch, x, stats)
    assert mean_err <= MEAN_TOL and inv_err <= INVSTD_TOL, (mean_err, inv_err)
    assert int(nbt) == 1
    # the running statistics as torch's lerp_ moves them from these stats
    var = (stats[1].double() ** -2 - 1e-5).float()
    assert torch.allclose(rm, bn.running_mean.lerp(stats[0], 0.1), rtol=0,
                          atol=1e-6)
    assert torch.allclose(rv, bn.running_var.lerp(var, 0.1), rtol=1e-4)
    w, b = bn.weight.detach(), bn.bias.detach()
    for mode in modes:
        residual, relu = MODES[MODE_IDS.index(mode)]
        res = r if residual else None
        y = bnk.batch_norm_apply(x, stats, w, b, res, relu)
        assert y.is_contiguous(memory_format=torch.channels_last)
        assert _same(y, bnk.batch_norm_apply_plain(x, stats, w, b, res, relu))
        mask = (bnk.NO_RELU if not relu else
                bnk.RELU_FROM_Y if residual else bnk.RELU_FROM_X)
        sums = bnk.batch_norm_backward_reduce(dy, x, stats, w, b, mask, y)
        want = bnk.batch_norm_backward_reduce_plain(dy, x, stats, w, b, mask,
                                                    y)
        err = chip_smoke.bn_sums_error(sums, want)
        assert err <= SUMS_TOL, (mode, err)
        dx, dr = bnk.batch_norm_backward_elemt(dy, x, stats, w, b, sums,
                                               mask, y, residual)
        pdx, pdr = bnk.batch_norm_backward_elemt_plain(
            dy, x, stats, w, b, sums, mask, y, residual)
        assert _same(dx, pdx)
        assert (dr is None) == (not residual)
        if residual:
            assert _same(dr, pdr)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("case", RN50_MB512,
                         ids=[f"{c}x{h}" for (_, c, h, _), _ in RN50_MB512])
def test_kernels_at_the_rn50_trunk_shapes(card, case, dtype):
    """Statistics within MEAN_TOL / INVSTD_TOL of float64; the apply
    bit-equal to torch.batch_norm_elemt -> add -> relu given them; the
    backward's sums within SUMS_TOL of float64; dx and dr bit-equal to the
    plain elementwise backward given the sums."""
    shape, modes = case
    _kernels_against_plain(card, shape, dtype, modes, 11)
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", RAGGED, ids=["x".join(map(str, s))
                                               for s in RAGGED])
def test_kernels_at_ragged_shapes(card, shape, dtype):
    _kernels_against_plain(card, shape, dtype, MODE_IDS, 13)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_batch_norm_act_against_the_chain_on_the_card(card, mode, dtype):
    """The module path (batch_norm_act) against the chain it replaced, on
    one layer1 shape of a small batch: output within one rounding of x's
    type given statistics that differ in summation order, running
    statistics, count and the four gradients."""
    residual, relu = mode
    shape = (64, 256, 16, 16)
    x, r, dy = _inputs(shape, dtype, 17, card)
    bn, bn2 = _bn(256, 18, card), _bn(256, 18, card)
    launched = bnk.batch_norm_stats.launches
    got = _run(batch_norm_act, bn, x, r, dy, residual, relu)
    assert bnk.batch_norm_stats.launches == launched + 1
    want = _run(_chain, bn2, x, r, dy, residual, relu)
    ulp = 2 ** -7 if dtype == torch.bfloat16 else 2 ** -22
    scale = want[0].float().abs().max().item()
    assert (got[0].float() - want[0].float()).abs().max().item() <= (
        4 * ulp * scale)
    for g, w in zip(got[1], want[1]):
        if w is None:
            assert g is None
            continue
        g, w = g.float(), w.float()
        tol = (2e-2 if dtype == torch.bfloat16 else 1e-4) * w.abs().max()
        assert (g - w).abs().max().item() <= tol.item()
    for key in ("running_mean", "running_var"):
        assert torch.allclose(got[2][key], want[2][key], rtol=1e-4,
                              atol=1e-5)
    assert int(got[2]["num_batches_tracked"]) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
def test_nan_and_inf_propagate_as_in_the_chain(card, mode, dtype):
    residual, relu = mode
    x, r, dy = _inputs((8, 16, 6, 6), dtype, 19, card)
    with torch.no_grad():
        x[2, 3, 1, 1] = float("nan")
        x[5, 7, 0, 2] = float("inf")
        x[1, 9, 4, 4] = float("-inf")
        r[3, 11, 2, 2] = float("nan")
    bn, bn2 = _bn(16, 20, card), _bn(16, 20, card)
    got = _run(batch_norm_act, bn, x, r, dy, residual, relu)
    want = _run(_chain, bn2, x, r, dy, residual, relu)
    assert torch.equal(torch.isnan(got[0]), torch.isnan(want[0]))
    for g, w in zip(got[1], want[1]):
        if w is not None:
            assert torch.equal(torch.isnan(g), torch.isnan(w))
    for key in ("running_mean", "running_var"):
        assert torch.equal(torch.isnan(got[2][key]),
                           torch.isnan(want[2][key]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("shape", [(1024, 64, 16, 16), (1024, 2048, 4, 4)]
                         + RAGGED, ids=lambda s: "x".join(map(str, s)))
def test_moments_against_float64(card, shape, dtype):
    """Σx and Σx² in f64: each within 1e-12 of the channel's Σ|x| and Σx²
    (f64 chains of up to ~500 terms, 2^-53 a term; the squares of bf16 and
    f32 values are exact in f64)."""
    x, _, _ = _inputs(shape, dtype, 21, card)
    got = bnk.batch_norm_moments(x)
    want = bnk.batch_norm_moments_plain(x)
    scale = torch.stack([x.double().abs().sum(dim=(0, 2, 3)), want[1]])
    assert ((got - want).abs() <= 1e-12 * scale).all()


@pytest.mark.cuda
def test_the_kernels_refuse_what_they_do_not_take(card):
    """C off the 16-byte vector or a base off 16 bytes: the wrappers raise;
    the module path runs the chain for a C they do not take, launching
    nothing."""
    x, r, dy = _inputs((4, 36, 5, 5), torch.bfloat16, 24, card)
    bn = _bn(36, 25, card)
    w, b = bn.weight.detach(), bn.bias.detach()
    stats = torch.zeros(2, 36, device=card)
    assert not bnk.takes(x)
    with pytest.raises(ValueError):
        bnk.batch_norm_apply(x, stats, w, b)
    launched = bnk.batch_norm_stats.launches
    bn2 = copy.deepcopy(bn)
    got = _run(batch_norm_act, bn, x, r, dy, True, True)
    want = _run(_chain, bn2, x, r, dy, True, True)
    assert bnk.batch_norm_stats.launches == launched
    assert torch.equal(got[0], want[0])
    x, r, _ = _inputs((4, 64, 5, 5), torch.bfloat16, 26, card)
    w, b = torch.ones(64, device=card), torch.zeros(64, device=card)
    stats = torch.zeros(2, 64, device=card)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=card)[1:]
    shifted = shifted.as_strided(x.shape, x.stride()).copy_(x)
    assert not bnk.takes(shifted)
    with pytest.raises(ValueError):
        bnk.batch_norm_apply(x, stats, w, b, shifted)
    with pytest.raises(ValueError):
        bnk.batch_norm_apply(x, stats, torch.ones(65, device=card)[1:], b)


def _one_rank_mesh(mesh, x, seed):
    """A BatchNorm2d's train-mode forward across a one-rank mesh on its
    card, and the same without a mesh: outputs and running statistics."""
    from peclr_tpu_torch.models.batchnorm import set_mesh

    out = []
    for across in (True, False):
        bn = _bn(x.shape[1], seed, mesh.device)
        if across:
            set_mesh(bn, mesh)
        y = bn(x.to(mesh.device))
        out.append((y.cpu(), bn.running_mean.cpu(), bn.running_var.cpu()))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_one_rank_mesh_normalises_as_the_path_without_a_mesh(card, dtype):
    """Across a mesh the statistics come from the kernels' f64 sums, so one
    rank's output is the path without a mesh's to the bit (both round the
    float64 statistics once), its running statistics within an f32
    rounding."""
    from peclr_tpu_torch.parallel.dryrun import spawn

    x, _, _ = _inputs((32, 256, 8, 8), dtype, 22)
    (ranks,) = spawn(_one_rank_mesh, 1, args=(x, 23), device="cuda:0",
                     backend="gloo", timeout=300.0)
    (y, rm, rv), (y0, rm0, rv0) = ranks
    assert _same(y, y0)
    assert torch.allclose(rm, rm0, rtol=1e-6, atol=1e-7)
    assert torch.allclose(rv, rv0, rtol=1e-6)


@pytest.mark.cuda
def test_trunk_launches_each_kernel_once_a_batch_norm(card):
    """An RN50 encoder's train-mode forward and backward on channels-last
    bf16 under autocast: each kernel 53 times, the same loss as the
    chain's within bf16 rounding."""
    enc = ResNetEncoder("50").to(card)
    x = torch.randn(4, 3, 64, 64, device=card).contiguous(
        memory_format=torch.channels_last)
    wrappers = (bnk.batch_norm_stats, bnk.batch_norm_apply,
                bnk.batch_norm_backward_reduce, bnk.batch_norm_backward_elemt)
    before = [w.launches for w in wrappers]
    with torch.autocast("cuda", dtype=torch.bfloat16):
        loss = enc(x).square().mean()
    loss.backward()
    assert [w.launches - n for w, n in zip(wrappers, before)] == [53] * 4
