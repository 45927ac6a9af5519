"""The port's augmentation (peclr_tpu_torch/ops/augment.py, ops/image.py
colour jitter, geometry/affine.py rotation) against the reference on the
CPU, with the recipe's flags and with the five flags outside it.

torch cannot replay jax.random, so `apply` is fed the parameters the
reference drew (AugmentOutput.params) and, for the flags outside the
recipe, the draws its augment_batch makes from its key splits, replayed
here (`_replayed_draws`); `draw` is checked for its distributions, and the
recipe's draws for being the tensors they were before those flags were
ported.  Joints and matrices agree to 1e-4.  Images agree to 1e-3 on
the 0-255 scale except where the colour jitter's floor (the reference's
uint8 round trip) turns a 1e-5 difference of the warp into a whole step of
H, S or V, which moves a channel by a few units: at least 99.9% of the
values agree to 1e-3 and every value to 10."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.config.defaults import AugmentationFlags as JaxFlags
from peclr_tpu.config.defaults import AugmentationParams as JaxParams
from peclr_tpu.config.defaults import peclr_pretrain_flags as jax_flags
from peclr_tpu.geometry import affine as jax_affine
from peclr_tpu.ops import augment as jax_augment
from peclr_tpu.ops import image as jax_image
from peclr_tpu_torch.config.defaults import (
    AugmentationFlags,
    AugmentationParams,
    peclr_pretrain_flags,
)
from peclr_tpu_torch.geometry.affine import rotation_about_center
from peclr_tpu_torch.ops import augment, image


def _batch(rng, n, canvas):
    images = rng.integers(0, 256, (n, canvas, canvas, 3)).astype(np.uint8)
    joints = np.concatenate([
        rng.uniform(0.27 * canvas, 0.71 * canvas, (n, 21, 2)),
        rng.normal(size=(n, 21, 1))], axis=-1).astype(np.float32)
    return images, joints


def _t(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


#: the flags outside the recipe, each on top of it in the per-flag test
EXTRA_FLAGS = ("sobel_filter", "cut_out", "gaussian_blur", "gaussian_noise",
               "color_drop")


def _all_flags(cls):
    return cls(rotate=True, crop=True, color_jitter=True, resize=True,
               random_crop=True, **{name: True for name in EXTRA_FLAGS})


def _replayed_draws(key, n, params):
    """The draws of the flags outside the recipe that the reference's
    augment_batch(key, ...) makes for n samples, by its own key splits:
    split(key, 12), then split(k_cut, 3) for the cut-out."""
    (k_sobel, k_cut_flag, k_cut, k_blur_flag, _, _, _, _, _, k_noise_flag,
     k_noise, k_drop) = jax.random.split(key, 12)
    kj, kr, kf = jax.random.split(k_cut, 3)
    out_w, out_h = params.resize_shape
    lo, hi = params.cut_out_fraction
    draws = {
        "sobel_flag": jax.random.bernoulli(k_sobel, 0.5, (n,)),
        "cut_out_flag": jax.random.bernoulli(k_cut_flag, 0.5, (n,)),
        "cut_out_joint": jax.random.randint(kj, (n,), 0, 20),
        "cut_out_fraction": jax.random.uniform(kr, (n,), minval=lo, maxval=hi),
        "cut_out_fill": jax.random.randint(kf, (n,), 0, 255),
        "blur_flag": jax.random.bernoulli(k_blur_flag, 0.5, (n,)),
        "noise_flag": jax.random.bernoulli(k_noise_flag, 0.5, (n,)),
        "noise": jax.random.normal(k_noise, (n, out_h, out_w, 3)),
        "drop_flag": jax.random.bernoulli(k_drop, 0.5, (n,)),
    }
    return {k: torch.from_numpy(np.array(v)).float() for k, v in draws.items()}


def _reference_draws(key, n, ref_params, params):
    """The reference's reported parameters and its replayed extra draws:
    a full draw for `apply`."""
    return {**_replayed_draws(key, n, params), **_t(ref_params)}


def _assert_images_close(got, ref):
    diff = np.abs(got * 255.0 - ref * 255.0)
    assert (diff <= 1e-3).mean() >= 0.999, (diff > 1e-3).mean()
    assert diff.max() <= 10.0, diff.max()


def test_config_matches_reference():
    assert AugmentationParams().__dict__ == JaxParams().__dict__
    assert AugmentationFlags().__dict__ == JaxFlags().__dict__
    assert peclr_pretrain_flags().active() == jax_flags().active()


def test_rotation_about_center_matches(rng):
    angle = rng.uniform(-90, 90, 5).astype(np.float32)
    cx, cy = rng.uniform(0, 224, (2, 5)).astype(np.float32)
    got = rotation_about_center(torch.from_numpy(angle), torch.from_numpy(cx),
                                torch.from_numpy(cy)).numpy()
    ref = np.asarray(jax_affine.rotation_about_center(angle, cx, cy))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


def test_color_jitter_matches_exactly(rng):
    """Identical inputs: the HSV round trip with its quirks agrees to 1e-4,
    the floors included; grey and saturated pixels are in the mix."""
    x = rng.uniform(0, 255, (4, 16, 16, 3)).astype(np.float32)
    x[0, :4] = 128.0  # grey: delta 0
    x[1, :4, :, 0] = 0.0  # a zero channel
    x = np.floor(x)
    factors = [rng.uniform(lo, hi, 4).astype(np.float32)
               for lo, hi in ((0.01, 1), (0.01, 1), (0.5, 1), (5, 20))]
    got = image.color_jitter(torch.from_numpy(x),
                             *(torch.from_numpy(f) for f in factors)).numpy()
    ref = np.asarray(jax_image.color_jitter(jnp.asarray(x), *factors))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    h, s, v = image.rgb_to_hsv_cv2(torch.from_numpy(x))
    for a, b in zip((h, s, v), jax_image.rgb_to_hsv_cv2(jnp.asarray(x))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


@pytest.mark.parametrize("route", ["grouped", "matmul"])
def test_apply_matches_augment_batch(rng, route):
    """The recipe's flags, 64 -> 32 canvases, with the draws of the
    reference's augment_batch."""
    images, joints = _batch(rng, 6, 64)
    flags, jflags = peclr_pretrain_flags(), jax_flags()
    ref = jax_augment.augment_batch(
        jax.random.PRNGKey(3), jnp.asarray(images), jnp.asarray(joints),
        jflags, JaxParams(resize_shape=(32, 32)))
    got = augment.apply(torch.from_numpy(images), torch.from_numpy(joints),
                        _t(ref.params), flags,
                        AugmentationParams(resize_shape=(32, 32)), route=route)
    np.testing.assert_allclose(got.matrix.numpy(), np.asarray(ref.matrix),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.joints.numpy(), np.asarray(ref.joints),
                               rtol=1e-4, atol=1e-4)
    for key in ref.params:
        np.testing.assert_allclose(got.params[key].numpy(),
                                   np.asarray(ref.params[key]), atol=1e-6,
                                   err_msg=key)
    _assert_images_close(got.images.numpy(), np.asarray(ref.images))


def test_augment_pair_matches_at_the_recipe_geometry(rng):
    """augment_pair (normalised views) at 224 -> 128 on the reference's
    draws for the doubled batch."""
    images, joints = _batch(rng, 2, 224)
    params = JaxParams()
    r1, r2 = jax_augment.augment_pair(jax.random.PRNGKey(7),
                                      jnp.asarray(images),
                                      jnp.asarray(joints), jax_flags(), params)
    draws = {k: torch.cat([torch.from_numpy(np.array(r1.params[k])),
                           torch.from_numpy(np.array(r2.params[k]))])
             for k in r1.params}
    v1, v2 = augment.augment_pair(None, torch.from_numpy(images),
                                  torch.from_numpy(joints),
                                  peclr_pretrain_flags(), AugmentationParams(),
                                  draws=draws)
    std = np.asarray(jax_image.IMAGENET_STD)
    for got, ref in ((v1, r1), (v2, r2)):
        assert got.images.shape == (2, 128, 128, 3)
        np.testing.assert_allclose(got.joints.numpy(), np.asarray(ref.joints),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(got.matrix.numpy(), np.asarray(ref.matrix),
                                   rtol=1e-4, atol=1e-4)
        # back to [0, 1] before the 0-255 comparison
        _assert_images_close(got.images.numpy() * std,
                             np.asarray(ref.images) * std)


def test_draw_statistics():
    """angle = floor(U[-45, 45]); jitter = trunc(U[0, 15)), reported
    negated; the colour factors uniform on their ranges."""
    n = 20_000
    d = augment.draw(torch.Generator().manual_seed(0), n,
                     peclr_pretrain_flags(), AugmentationParams())
    angle = d["angle"].numpy()
    assert np.array_equal(angle, np.floor(angle))
    assert angle.min() == -45 and angle.max() == 44
    assert abs(angle.mean() + 0.5) < 0.5
    for key in ("jitter_x", "jitter_y"):
        jitter = -d[key].numpy()
        assert np.array_equal(jitter, np.trunc(jitter))
        assert set(np.unique(jitter)) == set(range(15))
        assert abs(jitter.mean() - 7.0) < 0.2
    for key, (lo, hi) in (("h", (0.01, 1.0)), ("s", (0.01, 1.0)),
                          ("a", (0.5, 1.0)), ("b", (5.0, 20.0))):
        v = d[key].numpy()
        assert v.min() >= lo and v.max() < hi
        assert abs(v.mean() - (lo + hi) / 2) < 0.02 * (hi - lo)
    assert (d["crop_margin_scale"].numpy() == 1.25).all()
    off = augment.draw(torch.Generator().manual_seed(0), 8,
                       AugmentationFlags(resize=True), AugmentationParams())
    assert not off["angle"].any() and not off["jitter_x"].any()


def test_window_bounds_and_crop_box_match(rng):
    for rotate in (True, False):
        assert (augment._warp_window_bounds((224, 224), (128, 128),
                                            AugmentationParams(), rotate)
                == jax_augment._warp_window_bounds(
                    (224, 224), (128, 128), JaxParams(), rotate))
    wide = AugmentationParams(min_angle=-85.0, max_angle=85.0)
    with pytest.raises(ValueError, match="80"):
        augment._warp_window_bounds((224, 224), (128, 128), wide, True)
    pts = rng.uniform(20, 200, (4, 21, 2)).astype(np.float32)
    jitter = np.trunc(rng.uniform(0, 15, (4, 2))).astype(np.float32)
    margin = np.full(4, 1.25, np.float32)
    got = augment._crop_box(*(torch.from_numpy(a) for a in (pts, jitter,
                                                            margin)))
    ref = jax_augment._crop_box(pts, jitter, margin)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def _check_apply(flags, jflags, route, rng, monkeypatch):
    """apply against augment_batch at 64 -> 32 on the reference's draws; on
    the gather route against the reference's gather backend."""
    if route == "gather":
        monkeypatch.setattr(jax_augment, "WARP_BACKEND", "gather")
    images, joints = _batch(rng, 6, 64)
    jparams = JaxParams(resize_shape=(32, 32))
    key = jax.random.PRNGKey(3)
    ref = jax_augment.augment_batch(key, jnp.asarray(images),
                                    jnp.asarray(joints), jflags, jparams)
    got = augment.apply(torch.from_numpy(images), torch.from_numpy(joints),
                        _reference_draws(key, 6, ref.params, jparams), flags,
                        AugmentationParams(resize_shape=(32, 32)), route=route)
    assert set(got.params) == set(ref.params) == set(augment.PARAM_KEYS)
    for key_ in ref.params:
        np.testing.assert_allclose(got.params[key_].numpy(),
                                   np.asarray(ref.params[key_]), atol=1e-6,
                                   err_msg=key_)
    np.testing.assert_allclose(got.matrix.numpy(), np.asarray(ref.matrix),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.joints.numpy(), np.asarray(ref.joints),
                               rtol=1e-4, atol=1e-4)
    _assert_images_close(got.images.numpy(), np.asarray(ref.images))


@pytest.mark.parametrize("flag", EXTRA_FLAGS)
def test_flag_outside_the_recipe_matches(rng, monkeypatch, flag):
    """The recipe's flags plus one flag outside it, on the grouped route."""
    flags = dataclasses.replace(peclr_pretrain_flags(), **{flag: True})
    jflags = dataclasses.replace(jax_flags(), **{flag: True})
    _check_apply(flags, jflags, "grouped", rng, monkeypatch)


@pytest.mark.parametrize("route", augment.ROUTES)
def test_apply_with_all_flags_matches(rng, monkeypatch, route):
    """All ten flags the CLI takes (flip is a no-op in both), each route."""
    _check_apply(_all_flags(AugmentationFlags), _all_flags(JaxFlags), route,
                 rng, monkeypatch)


@pytest.mark.parametrize("route", augment.ROUTES)
def test_augment_pair_with_all_flags_matches(rng, monkeypatch, route):
    """augment_pair at 64 -> 32 with all flags: the reference augments the
    doubled batch with one key, so its 2B draws are replayed from it."""
    if route == "gather":
        monkeypatch.setattr(jax_augment, "WARP_BACKEND", "gather")
    images, joints = _batch(rng, 3, 64)
    jparams = JaxParams(resize_shape=(32, 32))
    key = jax.random.PRNGKey(11)
    r1, r2 = jax_augment.augment_pair(key, jnp.asarray(images),
                                      jnp.asarray(joints),
                                      _all_flags(JaxFlags), jparams)
    reported = {k: np.concatenate([np.asarray(r1.params[k]),
                                   np.asarray(r2.params[k])])
                for k in r1.params}
    v1, v2 = augment.augment_pair(
        None, torch.from_numpy(images), torch.from_numpy(joints),
        _all_flags(AugmentationFlags), AugmentationParams(resize_shape=(32, 32)),
        draws=_reference_draws(key, 6, reported, jparams), route=route)
    std = np.asarray(jax_image.IMAGENET_STD)
    for got, ref in ((v1, r1), (v2, r2)):
        assert set(got.params) == set(augment.PARAM_KEYS)
        np.testing.assert_allclose(got.joints.numpy(), np.asarray(ref.joints),
                                   rtol=1e-4, atol=1e-4)
        _assert_images_close(got.images.numpy() * std,
                             np.asarray(ref.images) * std)


def _recipe_draw_before_the_extra_flags(generator, n, params):
    """`draw` as it was while the flags outside the recipe raised: the
    recipe's stream, in its order."""
    def uniform(shape, bounds):
        lo, hi = bounds
        return lo + (hi - lo) * torch.rand(shape, generator=generator)

    angle = torch.floor(uniform(n, (params.min_angle, params.max_angle)))
    jitter = torch.trunc(uniform((n, 2), params.crop_box_jitter))
    return {"angle": angle, "jitter_x": -jitter[:, 0],
            "jitter_y": -jitter[:, 1], "h": uniform(n, params.hue_factor_range),
            "s": uniform(n, params.sat_factor_range),
            "a": uniform(n, params.value_factor_alpha_range),
            "b": uniform(n, params.value_factor_beta_range),
            "sigma": uniform(n, (0.1, 2.0)), "blur_flag": torch.zeros(n),
            "crop_margin_scale": torch.full((n,), params.crop_margin)}


def test_recipe_draws_are_unchanged():
    """The same generator gives the recipe the same tensors as before the
    flags outside it were ported, bit for bit, and, with every flag on, the
    same recipe draws first (blur_flag turns into its coin)."""
    params = AugmentationParams()
    got = augment.draw(torch.Generator().manual_seed(7), 16,
                       peclr_pretrain_flags(), params)
    want = _recipe_draw_before_the_extra_flags(
        torch.Generator().manual_seed(7), 16, params)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the stream continues where the recipe's ends: the next draws agree
    gen_a, gen_b = (torch.Generator().manual_seed(7) for _ in range(2))
    augment.draw(gen_a, 16, peclr_pretrain_flags(), params)
    _recipe_draw_before_the_extra_flags(gen_b, 16, params)
    assert torch.equal(torch.rand(4, generator=gen_a),
                       torch.rand(4, generator=gen_b))
    every = augment.draw(torch.Generator().manual_seed(7), 16,
                         dataclasses.replace(peclr_pretrain_flags(),
                                             **{f: True for f in EXTRA_FLAGS}),
                         params)
    for k in want:
        if k != "blur_flag":
            assert torch.equal(every[k], want[k]), k


def test_extra_draw_statistics():
    """Coins Bernoulli(0.5); the cut-out's joint in [0, 20) and fill in
    [0, 255) (upper ends exclusive, as jax.random.randint), its fraction
    uniform on cut_out_fraction; the noise standard normal of the views'
    shape."""
    n = 20_000
    params = AugmentationParams(resize_shape=(8, 6))
    d = augment.draw(torch.Generator().manual_seed(1), n,
                     _all_flags(AugmentationFlags), params)
    for key in ("sobel_flag", "cut_out_flag", "blur_flag", "noise_flag",
                "drop_flag"):
        assert set(np.unique(d[key].numpy())) == {0.0, 1.0}, key
        assert abs(d[key].mean().item() - 0.5) < 0.02, key
    joint = d["cut_out_joint"].numpy()
    assert set(np.unique(joint)) == set(range(20))
    fill = d["cut_out_fill"].numpy()
    assert fill.min() == 0 and fill.max() == 254
    frac = d["cut_out_fraction"].numpy()
    assert frac.min() >= 0.0 and frac.max() < 0.16
    assert abs(frac.mean() - 0.08) < 0.01
    assert d["noise"].shape == (n, 6, 8, 3)
    assert abs(d["noise"].mean().item()) < 0.01
    assert abs(d["noise"].std().item() - 1.0) < 0.01


def test_gather_route_keeps_the_80_degree_check():
    """The reference sizes the two-pass windows before it picks its warp,
    so a range beyond 80 degrees raises on the gather backend too (its
    message recommends that backend): a quirk kept."""
    wide = AugmentationParams(min_angle=-85.0, max_angle=85.0,
                              resize_shape=(16, 16))
    images = torch.zeros(2, 32, 32, 3, dtype=torch.uint8)
    joints = torch.full((2, 21, 3), 16.0)
    flags = peclr_pretrain_flags()
    d = augment.draw(torch.Generator().manual_seed(0), 2, flags, wide)
    with pytest.raises(ValueError, match="80"):
        augment.apply(images, joints, d, flags, wide, route="gather")
    with pytest.raises(ValueError, match="80"):
        jax_augment._warp_window_bounds((32, 32), (16, 16),
                                        JaxParams(min_angle=-85.0,
                                                  max_angle=85.0), True)
    with pytest.raises(ValueError, match="route"):
        augment.apply(images, joints, d, flags, AugmentationParams(),
                      route="bilinear")


def test_relative_params_match(rng):
    flags = _all_flags(AugmentationFlags)
    keys = augment.PARAM_KEYS
    p1, p2 = ({k: rng.uniform(-30, 30, 5).astype(np.float32) for k in keys}
              for _ in range(2))
    for p in (p1, p2):
        p["blur_flag"] = rng.integers(0, 2, 5).astype(np.float32)
    ref = jax_augment.relative_params(p1, p2, _all_flags(JaxFlags))
    got = augment.relative_params(_t(p1), _t(p2), flags)
    assert set(got) == set(ref) == {"jitter", "color_jitter", "blur",
                                    "rotation"}
    for k in ref:
        assert got[k].shape == ref[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-5, err_msg=k)
    none = augment.relative_params(_t(p1), _t(p2), AugmentationFlags())
    assert none == {}
