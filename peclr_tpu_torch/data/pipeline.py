"""Host-side input pipeline: decode -> canvas -> batch -> prefetch to the
card (port of peclr_tpu/data/pipeline.py).

The host only decodes JPEGs (whole batches by the port's own C++ decode
pool, csrc/jpeg_decode.cc, or one file at a time in a thread pool) and fits
each frame onto a fixed uint8 canvas; the augmentation runs batched on the
card (ops/augment.py).  `device_prefetch` copies batches to the card on a
side stream ahead of the step.

Canvas standardization: frames whose size differs from the canvas (YT3DH)
are cropped around the hand (side 3.2x the largest keypoint radius,
clamped to the frame) and resized with cv2; joints and K follow the same
affine (K' = T @ K).

The decoder order is the reference's: the native pool (the port's own,
data/native_loader.py, built from its source at first use and linking no
JPEG library), else cv2, else PIL.  A file the pool refuses (progressive,
4:1:1, ...) takes the reference's path for a failed native decode: cv2,
then PIL, and a whole batch goes to the thread pool.

Data parallel (a `mesh`, parallel/mesh.py): every rank makes the same global
order and decodes only its rows of each batch, in shard_batch's layout, and
`device_prefetch` puts them on the rank's device
(parallel/multihost.py:global_batch_from_host_local).
"""

from __future__ import annotations

import collections
import functools
import itertools
import queue
import threading
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from peclr_tpu_torch.data import native_loader
from peclr_tpu_torch.data.sampler import BalancedSampler, EpochSampler
from peclr_tpu_torch.device import DeviceLike, resolve_device
from peclr_tpu_torch.parallel.mesh import Mesh, local_rows
from peclr_tpu_torch.parallel.multihost import global_batch_from_host_local
from peclr_tpu_torch.utils import profiler


def decode_image(path: str) -> np.ndarray:
    """JPEG -> RGB uint8 (H, W, 3)."""
    img = native_loader.decode(path)
    if img is not None:
        return img
    try:
        import cv2
    except ImportError:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"))
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(
            f"could not decode image {path!r} (missing or corrupt file)"
        )
    return img[:, :, ::-1].copy()  # BGR -> RGB


def project_to_25d_np(K: np.ndarray, joints3d: np.ndarray):
    """Host-side numpy twin of geometry.camera.convert_to_2_5d for one
    sample: (joints25d (21, 3) float32, scale float32)."""
    scale = np.linalg.norm(joints3d[2] - joints3d[0])
    uvw = (K @ joints3d.T).T / joints3d[:, 2:3]
    z_rel = (joints3d[:, 2] - joints3d[0, 2]) / scale
    out = np.concatenate([uvw[:, :2], z_rel[:, None]], axis=1)
    return out.astype(np.float32), np.float32(scale)


def standardize_canvas(
    img: np.ndarray, joints25d: np.ndarray, K: np.ndarray, canvas: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fit a frame onto a (canvas, canvas) uint8 image, updating joints and
    K by the applied affine.  A canvas-sized frame passes as it is; any
    other needs cv2."""
    h, w = img.shape[:2]
    if h == canvas and w == canvas:
        return img, joints25d, K
    import cv2

    cx, cy = joints25d[:, 0].mean(), joints25d[:, 1].mean()
    rad = np.sqrt(
        ((joints25d[:, 0] - cx) ** 2 + (joints25d[:, 1] - cy) ** 2)
    ).max()
    side = float(np.clip(3.2 * rad, canvas / 4, min(h, w)))
    ox = float(np.clip(cx - side / 2, 0, max(w - side, 0)))
    oy = float(np.clip(cy - side / 2, 0, max(h - side, 0)))
    s = canvas / side
    T = np.array([[s, 0, -ox * s], [0, s, -oy * s], [0, 0, 1]], np.float32)
    out = cv2.warpAffine(img, T[:2], (canvas, canvas), flags=cv2.INTER_AREA)
    j = joints25d.copy()
    j[:, 0] = joints25d[:, 0] * s - ox * s
    j[:, 1] = joints25d[:, 1] * s - oy * s
    return out, j, (T @ K).astype(np.float32)


class HostPipeline:
    """Fixed-shape numpy batches from one or more sources.

    sources: objects with __len__, image_path(i) and record(i)
    (data/freihand.py, data/youtube.py).  A batch holds image (B, canvas,
    canvas, 3) uint8, joints25d (B, 21, 3), K (B, 3, 3), scale (B,),
    joints_valid (B, 21, 1), joints3d (B, 21, 3), joints_raw (B, 21, 3)
    (original-frame coordinates) and metric_scale (B,).  `decode_paths`
    counts the batches each decode path made ("native" canvas or
    "threaded").

    With a mesh, `batch_size` is the global batch of `accum` microbatches,
    and each batch holds this rank's rows of it (parallel/mesh.py
    :local_rows): every rank draws the same order from the same seed."""

    def __init__(
        self,
        sources: Sequence,
        batch_size: int,
        canvas: int = 224,
        seed: int = 5,
        num_threads: int = 8,
        balanced: Optional[bool] = None,
        shuffle: bool = True,
        mesh: Optional[Mesh] = None,
        accum: int = 1,
    ):
        self.sources = list(sources)
        self.batch_size = batch_size
        self.canvas = canvas
        self.num_threads = num_threads
        if balanced is None:
            balanced = len(self.sources) > 1
        self.balanced = balanced
        self.shuffle = shuffle
        self.seed = seed
        if balanced:
            self.sampler = BalancedSampler([len(s) for s in self.sources], seed)
        else:
            self.sampler = EpochSampler(len(self.sources[0]), seed, shuffle)
        self.decode_paths: collections.Counter = collections.Counter()
        self.rows = (None if mesh is None
                     else local_rows(mesh, batch_size, accum))

    def __len__(self):
        return sum(len(s) for s in self.sources)

    def steps_per_epoch(self) -> int:
        """Whole batches in one pass over the sources (0 when the split
        holds fewer samples than a batch)."""
        return len(self) // self.batch_size

    @staticmethod
    def _labels_from_record(rec) -> Dict[str, np.ndarray]:
        """The label fields of a sample, shared by both decode paths so that
        a field cannot reach only one of them."""
        j25d, scale = project_to_25d_np(rec["K"], rec["joints3d"])
        return {
            "joints25d": j25d,
            "K": rec["K"],
            "scale": scale,
            "joints_valid": rec["joints_valid"],
            "joints3d": rec["joints3d"],
            "joints_raw": rec.get("joints_raw", rec["joints3d"]),
            "metric_scale": rec.get("metric_scale", np.float32(1.0)),
        }

    def _load_one(self, src_id: int, idx: int) -> Dict[str, np.ndarray]:
        source = self.sources[src_id]
        rec = source.record(idx)
        img = decode_image(source.image_path(idx))
        if rec.get("flip"):
            # left hands are mirrored to right, image and joints (the
            # source mirrored the joints)
            img = img[:, ::-1]
        labels = self._labels_from_record(rec)
        img, j25d, K = standardize_canvas(
            img, labels["joints25d"], rec["K"], self.canvas
        )
        labels.update({"joints25d": j25d, "K": K})
        return {"image": np.ascontiguousarray(img), **labels}

    @staticmethod
    def _collate(samples: List[Dict[str, np.ndarray]]):
        return {k: np.stack([s[k] for s in samples]) for k in samples[0]}

    def _native_batch(self, chunk) -> Optional[dict]:
        """Decode a whole batch straight into the canvas with the C++ pool
        (canvas-native sources only); None where the pool is switched off
        or refused a frame."""
        if not native_loader.available():
            return None
        paths = [self.sources[s].image_path(i) for s, i in chunk]
        images = native_loader.decode_batch_to_canvas(
            paths, self.canvas, threads=self.num_threads
        )
        if images is None:
            return None
        labels = []
        for n, (s, i) in enumerate(chunk):
            rec = self.sources[s].record(i)
            if rec.get("flip"):
                # frame == canvas here, so the mirror applies after decode
                images[n] = images[n, :, ::-1].copy()
            labels.append(self._labels_from_record(rec))
        out = {"image": images}
        out.update({k: np.stack([l[k] for l in labels]) for k in labels[0]})
        return out

    def _canvas_native(self) -> bool:
        """True when every source serves canvas-sized frames."""
        return all(getattr(src, "image_size", None) == (self.canvas, self.canvas)
                   for src in self.sources)

    def batches(self, num_batches: int, epoch: int = 0) -> Iterator[dict]:
        """Yield `num_batches` batches; the epoch's order is tiled to fill
        them.  Canvas-native sources decode by the native pool where it
        loads, else (and for other sources) by a thread pool."""
        from concurrent.futures import ThreadPoolExecutor

        if self.balanced:
            draws = self.sampler.draw(num_batches * self.batch_size)
        else:
            order = self.sampler.epoch(epoch)
            reps = int(np.ceil(num_batches * self.batch_size / len(order)))
            order = np.tile(order, max(reps, 1))[: num_batches * self.batch_size]
            draws = [(0, int(i)) for i in order]

        use_native = self._canvas_native()
        with ThreadPoolExecutor(max_workers=self.num_threads) as pool:
            for b in range(num_batches):
                chunk = draws[b * self.batch_size: (b + 1) * self.batch_size]
                if self.rows is not None:
                    chunk = [chunk[i] for i in self.rows]
                if use_native:
                    batch = self._native_batch(chunk)
                    if batch is not None:
                        self.decode_paths["native"] += 1
                        yield batch
                        continue
                samples = list(pool.map(lambda d: self._load_one(*d), chunk))
                self.decode_paths["threaded"] += 1
                yield self._collate(samples)


class _ProducerError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def host_prefetch(gen: Iterable, buffer_size: int = 2) -> Iterator:
    """Run a host-side generator in a producer thread (bounded queue) so its
    work overlaps the card's.

    An exception in the producer re-raises in the consumer.  When the
    consumer stops early (break, exception, close), the producer is told to
    stop, its source is closed, and the thread is joined."""
    q: "queue.Queue" = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in gen:
                if not put(item):
                    return
            put(done)
        except BaseException as e:  # surface the error to the consumer
            put(_ProducerError(e))
        finally:
            close = getattr(gen, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, name="peclr-host-prefetch",
                              daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, _ProducerError):
                raise item.exc
            yield item
    finally:
        stop.set()
        thread.join()


def _mapped(batch_iter: Iterable, fn: Callable) -> Iterator:
    """fn over batch_iter, closing batch_iter when closed itself."""
    try:
        for batch in batch_iter:
            yield fn(batch)
    finally:
        close = getattr(batch_iter, "close", None)
        if close is not None:
            close()


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on `device`.  To the card through pinned
    memory with non_blocking=True: the copy queues behind the work in
    flight instead of making the host wait for it (a copy from pageable
    memory does).  A tensor goes by Tensor.to (as it is where it lies on
    `device` already, `cuda` or `cuda:0` alike).  The bytes it pins are
    counted as `pinned_bytes` (utils/profiler.py:count)."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device, non_blocking=True)
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        profiler.count("pinned_bytes", t.nbytes)
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def cuda_copier(device: DeviceLike, slots: int = 2) -> Callable:
    """Host batch -> (device batch, copy-done event).  Each batch goes
    through one of `slots` sets of pinned buffers, reused in turn once its
    last copy has finished, and is copied with non_blocking=True on a side
    stream.  One copier serves any number of device_prefetch calls, one at
    a time, so its pinned buffers are made once (their bytes counted as
    `pinned_bytes`, utils/profiler.py:count)."""
    device = torch.device(device)
    side = torch.cuda.Stream(device)
    pinned: List[Dict[str, torch.Tensor]] = [{} for _ in range(slots)]
    copied: List[Optional[torch.cuda.Event]] = [None] * slots
    turn = itertools.cycle(range(slots))

    def copy(batch: Dict[str, np.ndarray]):
        slot = next(turn)
        if copied[slot] is not None:
            copied[slot].synchronize()  # the slot's last copy has landed
        bufs = pinned[slot]
        out = {}
        with torch.cuda.device(device), torch.cuda.stream(side):
            for key, value in batch.items():
                host = torch.from_numpy(np.ascontiguousarray(value))
                buf = bufs.get(key)
                if (buf is None or buf.shape != host.shape
                        or buf.dtype != host.dtype):
                    buf = bufs[key] = torch.empty(host.shape, dtype=host.dtype,
                                                  pin_memory=True)
                    profiler.count("pinned_bytes", buf.nbytes)
                buf.copy_(host)
                out[key] = buf.to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        copied[slot] = event
        return out, event

    return copy


def device_prefetch(batch_iter: Iterable, device: DeviceLike = None,
                    buffer_size: int = 2, copier: Optional[Callable] = None,
                    mesh: Optional[Mesh] = None
                    ) -> Iterator[Dict[str, torch.Tensor]]:
    """Host batches as tensors on `device` (the card when None, through
    device.py:resolve_device, which raises without one), made
    `buffer_size` ahead by a producer thread.

    On a CUDA device each batch is staged in pinned memory and copied on a
    side stream by `copier` (a cuda_copier for `device`; a new one when
    None, so a caller that prefetches again passes its own to reuse the
    pinned buffers); the consumer's stream waits on the copy, and each
    tensor is recorded on that stream so that its memory is not reused
    before the consumer's work on it.  On the CPU the tensors are
    torch.from_numpy of the host arrays.  A producer's exception re-raises
    in the consumer; closing the consumer stops the producer and closes
    batch_iter.  With a mesh, `device` is the mesh's, and each batch (this
    rank's rows) goes through global_batch_from_host_local."""
    if mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    if device.type != "cuda":
        if mesh is not None:
            def put(b):
                return global_batch_from_host_local(mesh, b)[0]
        else:
            def put(b):
                return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
        yield from host_prefetch(_mapped(batch_iter, put), buffer_size)
        return
    copier = copier or cuda_copier(device)
    if mesh is not None:
        copier = functools.partial(global_batch_from_host_local, mesh,
                                   copier=copier)
    copies = host_prefetch(_mapped(batch_iter, copier), buffer_size)
    try:
        for batch, event in copies:
            stream = torch.cuda.current_stream(device)
            stream.wait_event(event)
            for tensor in batch.values():
                tensor.record_stream(stream)
            yield batch
    finally:
        copies.close()
