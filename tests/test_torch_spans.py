"""The port's spans and counters (peclr_tpu_torch/utils/profiler.py): a
shared no-op outside a torch.profiler capture; under one, the phases of a
pretrain step, a fine-tune step and a two-pass leaderboard batch, each
inside the span it belongs to, and two `warp.shift` spans a warp.  No span
name holds `::`, which marks torch's own ops in a trace."""

import ast
import collections
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import peclr_tpu_torch
from peclr_tpu_torch.config.defaults import (
    AugmentationFlags,
    AugmentationParams,
    peclr_pretrain_flags,
)
from peclr_tpu_torch.data.pipeline import host_to_device
from peclr_tpu_torch.data.synthetic import seeded_frames, seeded_intrinsics
from peclr_tpu_torch.eval import pred_fh
from peclr_tpu_torch.models import RN25DPose
from peclr_tpu_torch.train.finetune import make_finetune_step
from peclr_tpu_torch.train.optimizer import build_optimizer
from peclr_tpu_torch.train.recipe import (
    build_pretrain_state,
    synthetic_pretrain_batch,
    synthetic_supervised_batch,
)
from peclr_tpu_torch.train.state import TrainState
from peclr_tpu_torch.train.step import make_peclr_train_step
from peclr_tpu_torch.utils import profiler

PACKAGE = os.path.dirname(os.path.abspath(peclr_tpu_torch.__file__))
KINDS = ("pretrain", "finetune", "warp", "pred")
FINETUNE_PHASES = ("augment", "zero_grad", "forward", "loss", "backward",
                   "update")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def captured_spans(run):
    """[(name, parent name or None)] of the program's spans (user
    annotations) in a CPU capture of run(), in order of start; the parent
    is the innermost other span that contains the span."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    spans = sorted(((e.start_ns(), -e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.is_user_annotation()
                    and e.name().partition(".")[0] in KINDS))
    out = []
    for i, (start, neg, name) in enumerate(spans):
        end = start - neg
        parent = None
        for s2, n2, name2 in spans[:i]:
            if s2 <= start and s2 - n2 >= end:
                parent = name2  # the latest started that contains it
        out.append((name, parent))
    return out


def children(spans, parent):
    return collections.Counter(n for n, p in spans if p == parent)


def test_outside_a_capture_span_is_one_shared_no_op():
    before = profiler.counters()
    first = profiler.span("pretrain.step")
    assert profiler.span("warp.shift") is first
    with first, first:
        profiler.count("pinned_bytes", 1 << 20)
    assert profiler.counters() == before


def test_under_a_capture_spans_are_recorded_and_counters_add():
    before = profiler.counters().get("test_bytes", 0)

    def run():
        profiler.count("test_bytes", 5)
        with profiler.span("pred.h2d"):
            pass

    spans = captured_spans(run)
    assert spans == [("pred.h2d", None)]
    assert profiler.counters()["test_bytes"] == before + 5


def test_a_pretrain_step_holds_its_phases():
    model, state, opt = build_pretrain_state("18", batch=4, accum=2,
                                             device="cpu")
    step = make_peclr_train_step(model, opt, peclr_pretrain_flags(),
                                 AugmentationParams(resize_shape=(32, 32)),
                                 accum=2, warp_route="grouped")
    batch = synthetic_pretrain_batch(8, canvas=64, seed=0, device="cpu")
    spans = captured_spans(
        lambda: step(state, batch, torch.Generator().manual_seed(0)))
    assert children(spans, None) == {"pretrain.step": 1}
    assert children(spans, "pretrain.step") == {
        "pretrain.zero_grad": 1, "pretrain.microbatch": 2,
        "pretrain.update": 1}
    assert children(spans, "pretrain.microbatch") == {
        "pretrain.augment": 2, "pretrain.forward": 2, "pretrain.loss": 2,
        "pretrain.backward": 2}
    # one warp a microbatch, two shift passes a warp, then one photometric
    # tail a microbatch
    assert children(spans, "pretrain.augment") == {"warp.shift": 4,
                                                   "warp.photometric": 2}
    assert len(spans) == 3 + 2 * 5 + 4 + 2
    names = [n for n, _ in spans]
    assert names[:3] == ["pretrain.step", "pretrain.zero_grad",
                         "pretrain.microbatch"]
    assert names[-1] == "pretrain.update"


def test_a_finetune_step_holds_its_six_phases():
    model = RN25DPose("18")
    opt, _ = build_optimizer(model, base_lr=1e-4, batch_size=4, accum=1,
                             steps_per_epoch=2, epochs=2, optimizer="adam")
    step = make_finetune_step(
        model, opt, AugmentationFlags(crop=True, rotate=True, resize=True),
        AugmentationParams(resize_shape=(64, 64)))
    batch = synthetic_supervised_batch(4, canvas=96, seed=2, device="cpu")
    spans = captured_spans(lambda: step(TrainState(model, opt), batch,
                                        torch.Generator().manual_seed(0)))
    assert children(spans, None) == {"finetune.step": 1}
    assert [n for n, p in spans if p == "finetune.step"] == [
        f"finetune.{phase}" for phase in FINETUNE_PHASES]
    assert children(spans, "finetune.augment") == {"warp.shift": 2,
                                                   "warp.photometric": 1}


@pytest.mark.parametrize("route", ["grouped", "nhwc", "matmul"])
def test_a_warp_holds_two_shift_spans_on_every_route(route):
    from peclr_tpu_torch.ops.warp_mxu import affine_warp_mxu

    images = torch.from_numpy(seeded_frames(2, 3)[:, :48, :48])
    matrices = torch.eye(3).expand(2, 3, 3).clone()
    matrices[:, 0, 2] = 1.5
    spans = captured_spans(lambda: affine_warp_mxu(images, matrices,
                                                   (32, 32), route=route))
    assert spans == [("warp.shift", None)] * 2


def test_a_pipelined_two_pass_batch_holds_its_phases():
    model = RN25DPose("18").eval()
    frames = seeded_frames(4, 7)
    K = seeded_intrinsics(4, 8)
    batches = [(range(i, i + 2), 0, frames[i:i + 2], K[i:i + 2])
               for i in (0, 2)]

    def predict(images, k):
        return pred_fh.run_two_pass(model, images, k)["kp3d"]

    out = []
    spans = captured_spans(lambda: out.extend(pred_fh.pipelined(
        predict, batches, depth=2, device=torch.device("cpu"))))
    assert len(out) == 2
    assert children(spans, None) == {
        "pred.h2d": 2, "pred.pass1": 2, "pred.refine": 2, "pred.pass2": 2,
        "pred.fetch": 2}
    assert children(spans, "pred.pass1") == {"warp.shift": 4}
    assert children(spans, "pred.pass2") == {"warp.shift": 4}
    top = [n for n, p in spans if p is None]
    assert top[:4] == ["pred.h2d", "pred.pass1", "pred.refine", "pred.pass2"]
    assert top[-2:] == ["pred.fetch", "pred.fetch"]


def _span_names_in_source():
    names = {}
    for folder, _, files in os.walk(PACKAGE):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(folder, fname)
            with open(path) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                if (isinstance(node, ast.Call)
                        and getattr(node.func, "id",
                                    getattr(node.func, "attr", None))
                        == "span"):
                    arg = node.args[0] if node.args else None
                    names.setdefault(path, []).append(
                        arg.value if isinstance(arg, ast.Constant) else None)
    return names


def test_no_program_span_name_holds_a_namespace():
    names = _span_names_in_source()
    every = [n for found in names.values() for n in found]
    # the sites of the tables in utils/profiler.py's users
    assert len(every) >= 25
    for path, found in names.items():
        for name in found:
            assert isinstance(name, str), f"{path}: a span's name is not " \
                "a literal"
            assert "::" not in name, (path, name)
            kind, _, phase = name.partition(".")
            assert kind in KINDS and phase


@pytest.mark.cuda
def test_pinned_bytes_count_what_the_copy_to_the_card_pins():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    frames = np.zeros((3, 8, 8, 3), np.uint8)
    before = profiler.counters().get("pinned_bytes", 0)
    host_to_device(frames, torch.device("cuda"))
    assert profiler.counters().get("pinned_bytes", 0) == before
    with profile(activities=[ProfilerActivity.CPU]):
        host_to_device(frames, torch.device("cuda"))
    assert profiler.counters()["pinned_bytes"] == before + frames.nbytes
