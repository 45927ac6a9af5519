"""The port's HostPipeline and prefetcher (peclr_tpu_torch/data/pipeline.py)
against the reference's, batch for batch, on the CPU.

Both pipelines read the same files with the same decoder (the native
decode pool where it loads, else cv2 or PIL), so images are held bit-equal;
labels are computed by the same numpy code, held within 1e-6 of their
scale.  Cases: the FreiHAND layout at canvas 224 on the native whole-batch
path and on the threaded path (native decoder switched off in both
packages), at canvas 64 (standardize_canvas with cv2), and FreiHAND with
YT3DH at canvas 64 (balanced sampling, left-hand mirroring).
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from peclr_tpu.data import native_loader as jax_native
from peclr_tpu.data.freihand import FreihandSource as JaxFreihand
from peclr_tpu.data.pipeline import HostPipeline as JaxPipeline
from peclr_tpu.data.pipeline import standardize_canvas as jax_standardize
from peclr_tpu.data.synthetic import generate_freihand_like
from peclr_tpu.data.youtube import YoutubeSource as JaxYoutube
from peclr_tpu_torch.data import native_loader, pipeline
from peclr_tpu_torch.data.freihand import FreihandSource
from peclr_tpu_torch.data.youtube import YoutubeSource


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    import cv2

    fh = str(tmp_path_factory.mktemp("fh_pipe"))
    generate_freihand_like(fh, num_unique=6, seed=3)
    ytb = str(tmp_path_factory.mktemp("ytb_pipe"))
    rng = np.random.default_rng(4)
    images, annotations = [], []
    for i in range(3):
        name = f"youtube/v/frames/{i:04d}.png"
        path = os.path.join(ytb, name.replace(".png", ".jpg"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        cv2.imwrite(path, rng.integers(0, 255, (240, 320, 3), dtype=np.uint8))
        images.append({"id": i, "name": name, "width": 320, "height": 240})
        verts = np.stack([rng.uniform(90, 200, 778), rng.uniform(60, 170, 778),
                          np.full(778, 7.0)], axis=1)
        annotations.append({"id": i, "image_id": i, "is_left": i % 2,
                            "vertices": verts.tolist()})
    with open(os.path.join(ytb, "youtube_train.json"), "w") as f:
        json.dump({"images": images, "annotations": annotations}, f)
    return fh, ytb


def _no_native(monkeypatch):
    for mod in (jax_native, native_loader):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_checked", True)


def _pipes(roots, canvas, with_youtube=False, **kw):
    fh, ytb = roots
    ref_sources = [JaxFreihand(fh, "train", seed=5, train_ratio=0.75)]
    got_sources = [FreihandSource(fh, "train", seed=5, train_ratio=0.75)]
    if with_youtube:
        ref_sources.append(JaxYoutube(ytb, "train"))
        got_sources.append(YoutubeSource(ytb, "train"))
    ref = JaxPipeline(ref_sources, batch_size=8, canvas=canvas, seed=5,
                      num_threads=2, **kw)
    got = pipeline.HostPipeline(got_sources, batch_size=8, canvas=canvas,
                                seed=5, num_threads=2, **kw)
    return ref, got


def _assert_batches_equal(ref, got, num_batches=3):
    for epoch in (0, 1):
        ref_b = list(ref.batches(num_batches, epoch=epoch))
        got_b = list(got.batches(num_batches, epoch=epoch))
        assert len(got_b) == len(ref_b) == num_batches
        for r, g in zip(ref_b, got_b):
            assert set(g) == set(r)
            np.testing.assert_array_equal(g["image"], r["image"])
            assert g["image"].dtype == np.uint8
            for key in r:
                if key == "image":
                    continue
                assert g[key].shape == r[key].shape, key
                scale = max(float(np.abs(r[key]).max()), 1.0)
                np.testing.assert_allclose(g[key], r[key], rtol=0,
                                           atol=1e-6 * scale, err_msg=key)


@pytest.mark.skipif(not native_loader.available(),
                    reason="native/libpeclr_loader.so does not load here")
def test_canvas_224_native_path(roots):
    ref, got = _pipes(roots, 224)
    _assert_batches_equal(ref, got)
    assert got.decode_paths == {"native": 6}


def test_canvas_224_threaded_path(roots, monkeypatch):
    _no_native(monkeypatch)
    ref, got = _pipes(roots, 224)
    _assert_batches_equal(ref, got)
    assert got.decode_paths == {"threaded": 6}


@pytest.mark.parametrize("shuffle", [True, False])
def test_canvas_64_standardized(roots, shuffle):
    ref, got = _pipes(roots, 64, shuffle=shuffle)
    _assert_batches_equal(ref, got)
    assert got.decode_paths == {"threaded": 6}


def test_balanced_sources_with_left_hands(roots):
    ref, got = _pipes(roots, 64, with_youtube=True)
    assert got.balanced and ref.balanced
    _assert_batches_equal(ref, got, num_batches=4)


def test_standardize_canvas_matches(rng):
    img = rng.integers(0, 256, (240, 320, 3), dtype=np.uint8)
    j25 = np.concatenate([rng.uniform(80, 200, (21, 2)), np.ones((21, 1))],
                         axis=1).astype(np.float32)
    K = np.eye(3, dtype=np.float32)
    for canvas in (64, 224):
        got, ref = (pipeline.standardize_canvas(img, j25, K, canvas),
                    jax_standardize(img, j25, K, canvas))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    same = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    assert pipeline.standardize_canvas(same, j25, K, 64)[0] is same


def _batches(n):
    for i in range(n):
        yield {"image": np.full((2, 4, 4, 3), i, np.uint8),
               "joints25d": np.full((2, 21, 3), i, np.float32)}


def test_device_prefetch_cpu_is_from_numpy():
    got = list(pipeline.device_prefetch(_batches(5), "cpu", buffer_size=2))
    assert len(got) == 5
    for i, batch in enumerate(got):
        assert batch["image"].dtype == torch.uint8
        assert torch.equal(batch["image"], torch.full((2, 4, 4, 3), i,
                                                      dtype=torch.uint8))
        assert batch["joints25d"].device.type == "cpu"


def test_device_prefetch_defaults_to_the_card(monkeypatch):
    """With no device it runs on the card (device.py:resolve_device), as
    the reference puts batches on its default device; without a card it
    raises rather than fall back to the CPU, and starts no producer."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    it = pipeline.device_prefetch(_batches(2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(it)
    assert not _prefetch_threads()


def test_host_to_device_takes_a_tensor_as_it_is():
    """A tensor goes by Tensor.to: on the CPU for the CPU, the same one;
    a numpy array is copied into a new tensor."""
    x = torch.arange(6).reshape(2, 3)
    assert pipeline.host_to_device(x, torch.device("cpu")) is x
    arr = np.arange(6, dtype=np.uint8).reshape(2, 3)
    got = pipeline.host_to_device(arr, torch.device("cpu"))
    assert torch.equal(got, torch.from_numpy(arr))


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "peclr-host-prefetch"]


def test_device_prefetch_reraises_producer_error():
    """The reference's device_prefetch ends the epoch early and silently
    when its producer raises; the port re-raises in the consumer and its
    producer thread ends."""
    def failing():
        yield from _batches(2)
        raise OSError("corrupt JPEG")

    it = pipeline.device_prefetch(failing(), "cpu", buffer_size=1)
    assert next(it)["image"][0, 0, 0, 0] == 0
    assert next(it)["image"][0, 0, 0, 0] == 1
    with pytest.raises(OSError, match="corrupt JPEG"):
        next(it)
    assert not _prefetch_threads()


def test_device_prefetch_close_stops_producer():
    closed = threading.Event()

    def endless():
        try:
            i = 0
            while True:
                yield {"x": np.full((3,), i)}
                i += 1
        finally:
            closed.set()

    it = pipeline.device_prefetch(endless(), "cpu", buffer_size=2)
    assert int(next(it)["x"][0]) == 0
    it.close()
    assert closed.is_set()
    assert not _prefetch_threads()
