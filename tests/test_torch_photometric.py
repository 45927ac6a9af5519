"""The augmentation's photometric tail (peclr_tpu_torch/ops/photometric.py):
its plain version against the chain `ops/augment.py:apply` and
`augment_pair` composed before the tail was one kernel, the wrapper's
checks, and (marker `cuda`, skipped without a card) the CUDA kernel against
the plain version on the card.

On the card the kernel equals the plain version bit for bit, but under the
colour drop, whose gray value the plain version takes with an einsum
(cuBLAS's sum order): there the normalised output may differ by 1e-6, and
samples whose drop coin is 0 stay bit-equal.  This file imports neither JAX
nor the reference package:

    python -m pytest tests/test_torch_photometric.py -m cuda
"""

import dataclasses
import itertools

import pytest
import torch

from peclr_tpu_torch.config.defaults import (
    AugmentationParams,
    peclr_pretrain_flags,
)
from peclr_tpu_torch.ops import augment
from peclr_tpu_torch.ops import image as im
from peclr_tpu_torch.ops.photometric import photometric, photometric_plain

CPU = torch.device("cpu")
#: (jitter, noise, drop) x normalize
FLAG_CASES = list(itertools.product((False, True), repeat=4))
#: the drop's gray value may move by a few ulp of 255 on the card
DROP_TOL = 1e-6


def _composed(x, h, s, a, b, noise, noise_flag, drop_flag, jitter,
              normalize, noise_std=25.0):
    """The tail as apply and augment_pair composed it before it was one
    kernel, torch op by torch op."""
    if jitter:
        x = im.color_jitter(x, h, s, a, b)
    if noise is not None:
        x = torch.where(noise_flag[:, None, None, None] > 0,
                        im.gaussian_noise(x, noise, noise_std), x)
    if drop_flag is not None:
        x = torch.where(drop_flag[:, None, None, None] > 0, im.grayscale(x),
                        x)
    x = x / 255.0
    if normalize:
        x = im.normalize_imagenet(x)
    return x


def _planes(dev, b, h, w, layout, gen):
    """(B, H, W, 3) f32 in [0, 255] laid out as a warp route hands it over:
    "grouped" (C, B, H, W) planes, "matmul" (B, C, H, W), "nhwc"
    contiguous, "transposed" (C, B, W, H) planes, "offset" an NHWC view one
    float into its buffer.  A sixth of the values are 0, 255 or integers
    (the canvases' own values)."""
    x = torch.rand((3, b, h, w), generator=gen, device=dev) * 255.0
    pick = torch.rand((3, b, h, w), generator=gen, device=dev)
    x = torch.where(pick < 0.05, torch.zeros_like(x), x)
    x = torch.where(pick > 0.95, torch.full_like(x, 255.0), x)
    x = torch.where((pick > 0.5) & (pick < 0.57), torch.floor(x), x)
    if layout == "grouped":
        return x.permute(1, 2, 3, 0)
    if layout == "matmul":
        return x.permute(1, 0, 2, 3).contiguous().permute(0, 2, 3, 1)
    if layout == "transposed":
        return x.transpose(2, 3).contiguous().permute(1, 3, 2, 0)
    nhwc = x.permute(1, 2, 3, 0).contiguous()
    if layout == "offset":
        buf = torch.empty(nhwc.numel() + 1, device=dev)
        buf[1:] = nhwc.reshape(-1)
        return buf[1:].view(nhwc.shape)
    return nhwc


def _draws(dev, b, h, w, gen, saturate=False):
    """The recipe's factor ranges (AugmentationParams), or factors that
    drive every clamp: hue x5, saturation x3, value x2 + 200 or - 300."""
    p = AugmentationParams()

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=gen, device=dev)

    if saturate:
        d = {"h": torch.full((b,), 5.0, device=dev),
             "s": torch.full((b,), 3.0, device=dev),
             "a": torch.full((b,), 2.0, device=dev),
             "b": torch.where(torch.arange(b, device=dev) % 2 == 0,
                              torch.full((b,), 200.0, device=dev),
                              torch.full((b,), -300.0, device=dev))}
    else:
        d = {"h": uniform(*p.hue_factor_range),
             "s": uniform(*p.sat_factor_range),
             "a": uniform(*p.value_factor_alpha_range),
             "b": uniform(*p.value_factor_beta_range)}
    coin = (torch.arange(b, device=dev) % 2).float()
    d["noise"] = torch.randn((b, h, w, 3), generator=gen, device=dev)
    d["noise_flag"] = coin
    d["drop_flag"] = 1.0 - coin
    return d


def _call(fn, x, d, jitter, noise, drop, normalize):
    return fn(x, d["h"], d["s"], d["a"], d["b"],
              noise=d["noise"] if noise else None,
              noise_flag=d["noise_flag"] if noise else None,
              drop_flag=d["drop_flag"] if drop else None,
              jitter=jitter, normalize=normalize)


#: the edge pixels' (H, W): 8^3 triples and 36 boundary hues, padded
EDGE_HW = (16, 36)


def _edge_pixels(dev):
    """(1, 16, 36, 3): every triple of {0, 1, 127.5, 128, 254, 255, 0.25,
    60} (grays with delta 0, ties of the largest channel between two or
    three channels, both ends of the range), then hues at the sextant
    boundaries (one channel at 0 and the others equal, or one at the
    maximum and one at the minimum)."""
    vals = (0.0, 1.0, 127.5, 128.0, 254.0, 255.0, 0.25, 60.0)
    triples = list(itertools.product(vals, repeat=3))
    for m in (30.0, 120.0, 255.0):
        for lo in (0.0, m / 2):
            triples += [(m, m, lo), (m, lo, m), (lo, m, m), (m, lo, lo),
                        (lo, m, lo), (lo, lo, m)]
    triples += [(0.0, 0.0, 0.0)] * (EDGE_HW[0] * EDGE_HW[1] - len(triples))
    return torch.tensor(triples, device=dev).reshape(1, *EDGE_HW, 3)


# --------------------------------------------------------------------------
# the CPU


@pytest.mark.parametrize("jitter,noise,drop,normalize", FLAG_CASES)
def test_plain_is_the_composed_chain(jitter, noise, drop, normalize):
    """photometric_plain, and the wrapper on a CPU tensor, equal the chain
    apply and augment_pair composed, bit for bit, in its layout."""
    gen = torch.Generator().manual_seed(3)
    x = _planes(CPU, 4, 9, 12, "grouped", gen)
    d = _draws(CPU, 4, 9, 12, gen)
    want = _call(_composed, x, d, jitter, noise, drop, normalize)
    assert torch.equal(_call(photometric_plain, x, d, jitter, noise, drop,
                             normalize), want)
    got = _call(photometric, x, d, jitter, noise, drop, normalize)
    assert torch.equal(got, want) and got.stride() == want.stride()


@pytest.mark.parametrize("route", augment.ROUTES)
def test_apply_views_are_the_composed_chain(route, monkeypatch):
    """apply on the CPU returns the views it returned before, for the
    recipe's flags: the tail of the warp's output through the composed
    chain, in [0, 1]; augment_pair normalised as it was, after the tail."""
    flags, params = peclr_pretrain_flags(), AugmentationParams()
    gen = torch.Generator().manual_seed(11)
    b = 2
    images = torch.randint(0, 256, (b, 224, 224, 3), generator=gen,
                           dtype=torch.uint8)
    joints = torch.rand((b, 21, 3), generator=gen) * 80.0 + 70.0
    draws = augment.draw(gen, 2 * b, flags, params)
    warped = []
    tail = augment.photometric

    def capture(x, *args, **kwargs):
        warped.append(x)
        return tail(x, *args, **kwargs)

    monkeypatch.setattr(augment, "photometric", capture)
    one = {k: v[:b] for k, v in draws.items()}
    out = augment.apply(images, joints, one, flags, params, force_crop=True,
                        route=route)
    want = _composed(warped[0], one["h"], one["s"], one["a"], one["b"], None,
                     None, None, True, False)
    assert torch.equal(out.images, want)
    assert out.images.stride() == want.stride()
    v1, v2 = augment.augment_pair(None, images, joints, flags, params,
                                  draws=draws, route=route)
    want = _composed(warped[1], draws["h"], draws["s"], draws["a"],
                     draws["b"], None, None, None, True, True)
    assert torch.equal(torch.cat([v1.images, v2.images]), want)


@pytest.mark.parametrize("case", [
    "float64", "uint8", "four_channels", "three_dims", "factor_shape",
    "factor_dtype", "noise_without_coins", "meta_device"])
def test_wrapper_raises_on_what_the_kernel_does_not_take(case):
    gen = torch.Generator().manual_seed(5)
    x = _planes(CPU, 2, 4, 8, "nhwc", gen)
    d = _draws(CPU, 2, 4, 8, gen)
    kwargs = {}
    error = ValueError
    if case == "float64":
        x, error = x.double(), TypeError
    elif case == "uint8":
        x, error = x.to(torch.uint8), TypeError
    elif case == "four_channels":
        x = torch.cat([x, x[..., :1]], dim=-1)
    elif case == "three_dims":
        x = x[0]
    elif case == "factor_shape":
        d["h"] = d["h"][:1]
    elif case == "factor_dtype":
        d["s"] = d["s"].double()
    elif case == "noise_without_coins":
        kwargs = {"noise": d["noise"]}
    else:
        x = torch.empty(x.shape, device="meta")
    with pytest.raises(error):
        photometric(x, d["h"], d["s"], d["a"], d["b"], **kwargs)


# --------------------------------------------------------------------------
# the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    return torch.device("cuda")


def _check_against_plain(x, d, jitter, noise, drop, normalize):
    """The kernel against the plain version on the card: bit for bit, but
    under the drop within DROP_TOL on the samples whose coin is 1; laid out
    as the plain version with the jitter and with neither noise nor drop."""
    launches = photometric.launches
    got = _call(photometric, x, d, jitter, noise, drop, normalize)
    want = _call(photometric_plain, x, d, jitter, noise, drop, normalize)
    torch.cuda.synchronize()
    assert photometric.launches == launches + 1
    assert got.shape == x.shape
    if jitter or not (noise or drop):
        assert got.stride() == want.stride()
    if not drop:
        assert torch.equal(got, want), (got - want).abs().max().item()
        return
    off = d["drop_flag"] == 0
    assert torch.equal(got[off], want[off])
    gap = (got[~off] - want[~off]).abs().max().item()
    assert gap <= (DROP_TOL if normalize else DROP_TOL * 0.225)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["grouped", "matmul", "nhwc",
                                    "transposed", "offset"])
@pytest.mark.parametrize("jitter,noise,drop,normalize", FLAG_CASES)
def test_kernel_matches_plain(card, layout, jitter, noise, drop, normalize):
    gen = torch.Generator(device=card).manual_seed(17)
    x = _planes(card, 6, 32, 64, layout, gen)
    d = _draws(card, 6, 32, 64, gen)
    _check_against_plain(x, d, jitter, noise, drop, normalize)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,layout", [((5, 77, 130), "grouped"),
                                          ((3, 77, 128), "grouped"),
                                          ((7, 13, 36), "nhwc"),
                                          ((1, 1, 1), "nhwc"),
                                          ((2, 2049, 3), "matmul")])
def test_kernel_ragged_sizes_match_plain(card, shape, layout):
    """Ragged (B, H, W): W not a multiple of 4, H not a multiple of a
    block's rows, a block's last pixels part of a warp."""
    gen = torch.Generator(device=card).manual_seed(19)
    x = _planes(card, *shape, layout, gen)
    d = _draws(card, *shape, gen)
    for flags in ((True, False, False, True), (True, True, True, True),
                  (False, False, False, False)):
        _check_against_plain(x, d, *flags)


@pytest.mark.cuda
@pytest.mark.parametrize("saturate", [False, True])
@pytest.mark.parametrize("layout", ["grouped", "nhwc", "offset"])
def test_kernel_edge_pixels_match_plain(card, saturate, layout):
    """Pixels at 0 and 255, grays (delta 0), ties of the largest channel,
    hues at the sextant boundaries; factors in the recipe's ranges and
    factors that saturate every clamp; one value-shift per sample."""
    edge = _edge_pixels(card)
    gen = torch.Generator(device=card).manual_seed(23)
    x = edge.expand(4, -1, -1, -1).contiguous()
    if layout == "grouped":
        x = x.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
    elif layout == "offset":
        buf = torch.empty(x.numel() + 1, device=card)
        buf[1:] = x.reshape(-1)
        x = buf[1:].view(x.shape)
    d = _draws(card, 4, *EDGE_HW, gen, saturate=saturate)
    if not saturate:  # sample 0 keeps each hue: H on the sextant boundaries
        for key, identity in (("h", 1.0), ("s", 1.0), ("a", 1.0), ("b", 0.0)):
            d[key][0] = identity
    for flags in ((True, False, False, True), (True, False, False, False),
                  (True, True, True, True)):
        _check_against_plain(x, d, *flags)


@pytest.mark.cuda
@pytest.mark.parametrize("route", augment.ROUTES)
def test_apply_takes_one_launch_on_each_route(card, route, monkeypatch):
    """One apply (every flag the kernel reads on) is one launch of the
    kernel on the warp's own output, equal to the plain version on that
    output, into a contiguous tensor."""
    flags = dataclasses.replace(peclr_pretrain_flags(), gaussian_noise=True,
                                color_drop=True)
    params = AugmentationParams()
    gen = torch.Generator(device=card).manual_seed(29)
    b = 4
    images = torch.randint(0, 256, (b, 224, 224, 3), generator=gen,
                           device=card, dtype=torch.uint8)
    joints = torch.rand((b, 21, 3), generator=gen, device=card) * 80.0 + 70.0
    draws = augment.draw(gen, b, flags, params)
    seen = []
    tail = augment.photometric

    def capture(x, *args, **kwargs):
        seen.append(x)
        return tail(x, *args, **kwargs)

    monkeypatch.setattr(augment, "photometric", capture)
    launches = photometric.launches
    out = augment.apply(images, joints, draws, flags, params,
                        force_crop=True, route=route, normalize=True)
    torch.cuda.synchronize()
    assert photometric.launches == launches + 1
    assert out.images.is_contiguous()
    _check_against_plain(seen[0], draws, True, True, True, True)
