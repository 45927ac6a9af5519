"""The host's JPEG decode rates: the native C++ pool, cv2 and PIL, per
core (port of the reference repository's scripts/bench_decode.py).

    python -m peclr_tpu_torch.scripts.bench_decode [--num-unique 64]
        [--images 192] [--device cuda]

Decodes the same synthetic FreiHAND frames (224² JPEGs written by
data/synthetic.py:generate_freihand_like into a temporary directory):
  * the native pool (`data/native_loader.py`) at THREADS threads, where
    it loads; where it does not (no libjpeg.so.62 on the host), the
    artifact says why under `native_unavailable`;
  * cv2.imread and PIL one image at a time on one thread;
  * the threaded decode of data/pipeline.py:HostPipeline (decode_image in
    a thread pool, cv2 releases the interpreter lock) at THREADS threads,
    with its rate per core.
Only the host works here; the card named in the artifact (--device) is
the one whose host was measured.  One JSON artifact (--out, default
tests/fixtures/torch_bench/decode.json).
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from peclr_tpu_torch import scripts as common

#: the thread counts of the pools (the card's host has 8 cores)
THREADS = (1, 4, 8)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--num-unique", type=int, default=64)
    ap.add_argument("--images", type=int, default=192)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(common.BENCH_DIR,
                                                  "decode.json"))
    return ap.parse_args(argv)


def rate(fn, n: int) -> float:
    """Images a second of fn(), which decodes n images."""
    t0 = time.perf_counter()
    fn()
    return n / (time.perf_counter() - t0)


def per_core(img_s: float, threads: int) -> dict:
    """A pool's rate and its rate per core it could use."""
    return {"img_s": img_s,
            "per_core_img_s": img_s / min(threads, common.cpu_cores())}


def main(argv=None) -> dict:
    from peclr_tpu_torch.data import native_loader
    from peclr_tpu_torch.data.freihand import FreihandSource
    from peclr_tpu_torch.data.pipeline import decode_image
    from peclr_tpu_torch.data.synthetic import generate_freihand_like
    from peclr_tpu_torch.device import resolve_device

    args = parse_args(argv)
    dev = resolve_device(args.device)
    root = tempfile.mkdtemp(prefix="peclr_decode_")
    try:
        generate_freihand_like(root, num_unique=args.num_unique, seed=0)
        src = FreihandSource(root, "train", train_ratio=0.99)
        paths = [src.image_path(i) for i in range(min(args.images, len(src)))]
        n = len(paths)
        for p in paths:  # the files in the page cache for every decoder
            with open(p, "rb") as f:
                f.read()

        record = {"backend": dev.type, "device": common.card_name(dev),
                  "cpu_cores": common.cpu_cores(), "images": n,
                  "image_size": list(src.image_size),
                  "native_loader": native_loader.available()}
        if native_loader.available():
            record["native_img_s"] = {
                str(t): per_core(rate(
                    lambda t=t: native_loader.decode_batch_to_canvas(
                        paths, 224, threads=t), n), t) for t in THREADS}
        else:
            record["native_unavailable"] = native_loader.load_error
        try:
            import cv2
        except ImportError:
            record["cv2_img_s"] = None
        else:
            record["cv2_img_s"] = rate(lambda: [cv2.imread(p) for p in paths],
                                       n)
        try:
            from PIL import Image
        except ImportError:
            record["pil_img_s"] = None
        else:
            def pil():
                for p in paths:
                    with Image.open(p) as im:
                        im.convert("RGB").load()

            record["pil_img_s"] = rate(pil, n)
        threaded = {}
        for t in THREADS:
            with ThreadPoolExecutor(max_workers=t) as pool:
                threaded[str(t)] = per_core(
                    rate(lambda: list(pool.map(decode_image, paths)), n), t)
        record["threaded_img_s"] = threaded
        record["torch"] = torch.__version__
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(record)
    common.write_artifact(args.out, record)
    return record


if __name__ == "__main__":
    main()
