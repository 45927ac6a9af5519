"""The port's JPEG decode pool (peclr_tpu_torch/csrc/jpeg_decode.cc through
data/native_loader.py) against libjpeg, byte for byte, on the CPU.

libjpeg is reached two ways: through the reference package's own pool
(peclr_tpu/data/native_loader.py over native/libpeclr_loader.so) and through
cv2.imread.  Every comparison is at tolerance 0.  The images are blurred
noise from a numpy seed, encoded by cv2 at the sizes, qualities, samplings,
restart intervals and table kinds below; a file of a kind the pool refuses
must give None from the pool and the reference's bytes from decode_image.
"""

import os
import shutil
import threading

import cv2
import numpy as np
import pytest

from peclr_tpu.data import native_loader as ref_native
from peclr_tpu.data.pipeline import decode_image as ref_decode_image
from peclr_tpu_torch.data import native_loader, pipeline

FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "fixtures", "torch_freihand_like",
                           "freihand_dataset", "training", "rgb")
SIZES = [(224, 224), (1, 1), (17, 33), (97, 223), (480, 640)]
QUALITIES = [10, 50, 92, 100]
SAMPLING = {
    "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
    "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
    "444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
    "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411,
    "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
}


def blurred_noise(shape, seed, channels=3):
    """Smooth content with fine noise on top, uint8 (H, W, channels)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(128.0, 60.0, shape + (channels,)).astype(np.float32)
    k = max(1, min(shape) // 8) | 1
    x = cv2.GaussianBlur(x, (k, k), 0).reshape(shape + (channels,))
    x = x + rng.normal(0.0, 12.0, x.shape)
    return np.clip(x, 0, 255).astype(np.uint8)


def encode(path, shape=(224, 224), quality=92, sampling="420", restart=0,
           optimize=False, grey=False, progressive=False, seed=0):
    img = blurred_noise(shape, seed, 1 if grey else 3)
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
              cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
              cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)]
    assert cv2.imwrite(str(path), img[..., 0] if grey else img, params)
    return str(path)


def segments(data: bytes):
    """(offset, marker, length) of each marker segment up to SOS."""
    i, out = 2, []
    while data[i] == 0xFF:
        marker = data[i + 1]
        length = int.from_bytes(data[i + 2:i + 4], "big")
        out.append((i, marker, length))
        if marker == 0xDA:
            break
        i += 2 + length
    return out


def assert_equals_libjpeg(path):
    got = native_loader.decode(path)
    ref = ref_native.decode(path)
    assert ref is not None, "libjpeg refused the file"
    assert got is not None, "the port's pool refused the file"
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert np.array_equal(got, ref), int((got != ref).sum())
    via_cv2 = cv2.imread(path, cv2.IMREAD_COLOR)[:, :, ::-1]
    assert np.array_equal(got, via_cv2)
    return got


ENCODER_CASES = (
    [dict(shape=s, quality=q, sampling=f, restart=r)
     for s in SIZES for q in QUALITIES for f in ("420", "422", "444")
     for r in (0, 3)]
    + [dict(shape=s, quality=92, sampling=f, optimize=True)
       for s in SIZES for f in ("420", "422", "444")]
    + [dict(shape=s, quality=q, grey=True) for s in SIZES for q in QUALITIES]
)


def _case_id(case):
    h, w = case["shape"]
    kind = "grey" if case.get("grey") else case["sampling"]
    extra = "opt" if case.get("optimize") else f"rst{case.get('restart', 0)}"
    return f"{h}x{w}-q{case['quality']}-{kind}-{extra}"


@pytest.mark.parametrize("case", ENCODER_CASES, ids=_case_id)
def test_decode_equals_libjpeg(tmp_path, case):
    seed = ENCODER_CASES.index(case)
    path = encode(tmp_path / "case.jpg", seed=seed, **case)
    got = assert_equals_libjpeg(path)
    assert got.shape == tuple(case["shape"]) + (3,)


def test_fixture_frames_equal_libjpeg():
    names = sorted(os.listdir(FIXTURE_DIR))
    assert len(names) == 32
    for name in names:
        assert_equals_libjpeg(os.path.join(FIXTURE_DIR, name))


@pytest.fixture(scope="module")
def mixed_batch(tmp_path_factory):
    """Frames of several sizes and samplings, to exercise the canvas fit."""
    root = tmp_path_factory.mktemp("mixed")
    shapes = [(224, 224), (97, 223), (480, 640), (17, 33), (1, 1), (300, 200)]
    paths = []
    for i, shape in enumerate(shapes * 2):
        paths.append(encode(root / f"{i}.jpg", shape=shape,
                            sampling=("420", "422", "444")[i % 3],
                            grey=i == 7, restart=3 * (i % 2), seed=100 + i))
    return paths


@pytest.mark.parametrize("threads", [1, 3, 8])
@pytest.mark.parametrize("which", ["fixture", "mixed"])
def test_batch_equals_reference_pool(mixed_batch, which, threads):
    if which == "fixture":
        paths = [os.path.join(FIXTURE_DIR, n)
                 for n in sorted(os.listdir(FIXTURE_DIR))]
    else:
        paths = mixed_batch
    for canvas in (224, 64):
        got = native_loader.decode_batch_to_canvas(paths, canvas, threads)
        ref = ref_native.decode_batch_to_canvas(paths, canvas, threads)
        assert got is not None and ref is not None
        assert got.shape == (len(paths), canvas, canvas, 3)
        assert np.array_equal(got, ref)


def test_batch_workers_share_no_state(tmp_path):
    """More workers than cores over many different frames: every frame is
    the one a single worker decodes."""
    paths = [encode(tmp_path / f"{i}.jpg", shape=(64 + i, 96),
                    sampling=("420", "422", "444")[i % 3], restart=i % 4,
                    optimize=bool(i % 2), seed=200 + i) for i in range(24)]
    paths = paths * 8
    serial = native_loader.decode_batch_to_canvas(paths, 96, threads=1)
    result = {}
    worker = threading.Thread(target=lambda: result.update(
        batch=native_loader.decode_batch_to_canvas(paths, 96, threads=64)))
    worker.start()
    worker.join(timeout=120)
    assert not worker.is_alive()
    assert np.array_equal(result["batch"], serial)


@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("cut", ["early", "half", "two_short"])
def test_truncated_file_decodes_as_libjpeg(tmp_path, cut, restart):
    """Data that ends early: libjpeg's fake EOI, zero bits, then mid grey
    (also across restart markers), with the image returned."""
    full = open(encode(tmp_path / "full.jpg", shape=(97, 223), quality=50,
                       restart=restart, seed=7), "rb").read()
    sos = segments(full)[-1][0]
    at = {"early": sos + 40, "half": len(full) // 2,
          "two_short": len(full) - 2}[cut]
    path = tmp_path / "cut.jpg"
    path.write_bytes(full[:at])
    got = assert_equals_libjpeg(str(path))
    if cut != "two_short":
        assert (got[-8:] == 128).all()  # the rows after the data: mid grey


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_scan_decodes_as_libjpeg(tmp_path, seed):
    """Bytes of the scan overwritten (a stray marker included): the same
    bytes as libjpeg, or refused where libjpeg fails."""
    full = open(encode(tmp_path / "full.jpg", quality=92, restart=seed % 2 * 3,
                       seed=seed), "rb").read()
    rng = np.random.default_rng(seed)
    data = bytearray(full)
    sos = segments(full)[-1][0]
    for at in rng.integers(sos + 14, len(full) - 2, 1 + seed):
        data[at] = int(rng.integers(0, 256))
    path = tmp_path / "bad.jpg"
    path.write_bytes(bytes(data))
    ref = ref_native.decode(str(path))
    got = native_loader.decode(str(path))
    assert (got is None) == (ref is None)
    if ref is not None:
        assert np.array_equal(got, ref)


def _rewrite(tmp_path, path, edit):
    data = edit(open(path, "rb").read())
    out = tmp_path / "edited.jpg"
    out.write_bytes(data)
    return str(out)


def _dqt_16bit(data):
    """Every DQT table written again at 16-bit precision, same values."""
    out, last = b"", 0
    for at, marker, length in segments(data):
        if marker != 0xDB:
            continue
        body, tables, i = data[at + 4:at + 2 + length], b"", 0
        while i < len(body):
            assert body[i] >> 4 == 0
            values = body[i + 1:i + 65]
            tables += bytes([0x10 | body[i]]) + b"".join(
                int(v).to_bytes(2, "big") for v in values)
            i += 65
        out += data[last:at] + b"\xff\xdb" + (len(tables) + 2).to_bytes(
            2, "big") + tables
        last = at + 2 + length
    return out + data[last:]


def _drop(marker):
    def edit(data):
        out, last = b"", 0
        for at, m, length in segments(data):
            if m == marker:
                out += data[last:at]
                last = at + 2 + length
        return out + data[last:]
    return edit


def _adobe(transform):
    def edit(data):
        app14 = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, transform])
        return (data[:2] + b"\xff\xee" + (len(app14) + 2).to_bytes(2, "big")
                + app14 + _drop(0xE0)(data)[2:])
    return edit


@pytest.mark.parametrize("name, edit", [
    ("dqt_16bit", _dqt_16bit),
    ("no_app0", _drop(0xE0)),
    ("no_dht_standard_tables", _drop(0xC4)),
    ("adobe_ycc", _adobe(1)),
])
def test_header_variants_equal_libjpeg(tmp_path, name, edit):
    """16-bit DQT, no JFIF marker, the standard Huffman tables that a file
    with no DHT decodes with, an Adobe marker that says YCbCr."""
    src = encode(tmp_path / "src.jpg", shape=(97, 223), quality=10,
                 optimize=False, restart=3)
    path = _rewrite(tmp_path, src, edit)
    assert_equals_libjpeg(path)


def _refused(tmp_path, kind):
    if kind == "progressive":
        return encode(tmp_path / "p.jpg", shape=(97, 223), progressive=True)
    if kind == "adobe_rgb":
        src = encode(tmp_path / "a.jpg", shape=(97, 223), sampling="444")
        return _rewrite(tmp_path, src, _adobe(0))
    return encode(tmp_path / f"{kind}.jpg", shape=(97, 223),
                  sampling=kind[-3:])


@pytest.mark.parametrize("kind", ["progressive", "sampling_411",
                                  "sampling_440", "adobe_rgb"])
def test_refused_kinds_take_the_reference_path(tmp_path, kind):
    """The pool refuses these (libjpeg decodes them); decode_image then
    goes on to cv2 as the reference's does after a failed native decode,
    and gives the reference's bytes; a batch holding one is refused."""
    path = _refused(tmp_path, kind)
    assert native_loader.decode(path) is None
    assert native_loader.decode_batch_to_canvas([path], 64) is None
    assert np.array_equal(pipeline.decode_image(path), ref_decode_image(path))


@pytest.mark.parametrize("kind", ["missing", "empty", "not_a_jpeg",
                                  "header_cut"])
def test_missing_or_corrupt_file_gives_none(tmp_path, kind):
    path = tmp_path / "x.jpg"
    if kind == "empty":
        path.write_bytes(b"")
    elif kind == "not_a_jpeg":
        path.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(100))
    elif kind == "header_cut":
        full = open(encode(tmp_path / "full.jpg"), "rb").read()
        path.write_bytes(full[:segments(full)[2][0] + 10])
    assert ref_native.decode(str(path)) is None
    assert native_loader.decode(str(path)) is None
    batch = native_loader.decode_batch_to_canvas(
        [os.path.join(FIXTURE_DIR, "00000000.jpg"), str(path)], 32)
    assert batch is None
    with pytest.raises(FileNotFoundError):
        pipeline.decode_image(str(path))


def test_image_larger_than_the_buffer_is_refused(tmp_path):
    path = encode(tmp_path / "big.jpg", shape=(480, 640))
    assert native_loader.decode(path, max_side=400) is None
    assert native_loader.decode(path, max_side=640).shape == (480, 640, 3)


def test_pool_is_built_from_the_port_source():
    """The library is the port's own build of csrc/jpeg_decode.cc and links
    no JPEG library."""
    from peclr_tpu_torch import build

    assert native_loader.available()
    path = build.library_path("jpeg_decode")
    assert os.path.exists(path)
    assert os.path.dirname(path) == build.BUILD_DIR
    ldd = shutil.which("ldd")
    if ldd:
        import subprocess

        linked = subprocess.run([ldd, path], capture_output=True,
                                text=True).stdout
        assert "jpeg" not in linked and "opencv" not in linked, linked
