"""The port's measurement scripts (peclr_tpu_torch/scripts: trace_buckets,
profile_step, bench_serving, bench_decode, bench_host_pipeline and
bench_pred_pipeline) on the CPU at a tiny size (RN18, batches of 2-4,
32-px views, one or two iterations, a generated root of a few frames).

What a CPU run can show: each script's main runs end to end and writes
its artifact; the serving, pred-pipeline and host-pipeline artifacts
carry every key of the reference's (bench_artifacts/*.json), and the
port's additions are the ones listed here; the accounting holds (the
buckets sum to the kernel time, busy is the union, bound_by is the
slowest leg, the device bound is batch / busy); the dispatch loop gives
the same kp3d at every depth, the reference's within
tests/test_torch_pred_fh.py's bounds; and the ablations' steps compute
the reference's first loss.  No time here is the card's: the CPU run's
trace has no device events, and says so."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peclr_tpu.config.defaults import AugmentationFlags as JaxFlags
from peclr_tpu.config.defaults import AugmentationParams as JaxParams
from peclr_tpu.config.defaults import peclr_pretrain_flags as jax_flags
from peclr_tpu.eval import pred_fh as jax_pred_fh
from peclr_tpu.models import PeCLRModel as JaxPeCLR
from peclr_tpu.models import RN25DPose as JaxRN25DPose
from peclr_tpu.train import step as jax_step_module
from peclr_tpu.train.optimizer import build_optimizer as jax_build_optimizer
from peclr_tpu.train.state import TrainState as JaxState
from peclr_tpu.train.step import make_peclr_train_step as jax_make_step
from peclr_tpu_torch.data.synthetic import (
    generate_freihand_like,
    seeded_frames,
    seeded_intrinsics,
    seeded_peclr_variables,
    seeded_rn25d_variables,
)
from peclr_tpu_torch.models import RN25DPose
from peclr_tpu_torch.models.port import rn25d_variables_to_state_dict
from peclr_tpu_torch.scripts import (
    bench_decode,
    bench_host_pipeline,
    bench_pred_pipeline,
    bench_serving,
    profile_step,
    trace_buckets,
)
from peclr_tpu_torch.train.recipe import synthetic_pretrain_batch
from tests import test_torch_train_step as parity

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

#: the keys each port artifact adds to the reference's, and why: the host's
#: cores and torch's version beside every number; the leaderboard model's
#: dtype and size, the profiled batch the bound comes from and every
#: loop's rate (their spread); the card's name where the reference's
#: artifact had none
EXTRA_KEYS = {
    "serving_latency": {"cpu_cores", "torch"},
    "pred_pipeline": {"device", "dtype", "resnet", "cpu_cores", "torch",
                      "profile", "repeats_img_per_sec"},
    "host_pipeline": {"backend", "device", "torch"},
}
#: the keys of a profile artifact (it replaces the reference's
#: hlo_stats_*.json.gz, whose layout is XLA's) and of each variant in it
PROFILE_KEYS = {"phase", "backend", "device", "cpu_cores", "torch",
                "precision", "warmup_steps", "config", "variants"}
VARIANT_KEYS = {"ms_per_step", "img_per_s", "images_per_step", "trace"}
#: the keys of a summary of a trace with device events
SUMMARY_KEYS = {"steps", "wall_ms", "host_ops", "kernel_ms", "busy_ms",
                "busy_share", "device_events", "streams", "buckets_ms",
                "idle_gaps", "top_kernels"}


def _reference(name):
    with open(os.path.join(REPO, "bench_artifacts", f"{name}.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One CPU thread a worker (tiny models, several workers at once), and
    one summation order for the comparisons to the bit."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# trace_buckets


def _event(name, ts, dur, cat="kernel", stream=7):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 0, "tid": stream, "args": {"stream": stream}}


#: a two-step capture: host ops 0-100 us; kernels on two streams, two of
#: them overlapping; idle 0-10, 40-50, 55-60 and 90-100
TRACE = {"traceEvents": [
    _event("aten::conv2d", 0, 60, cat="cpu_op"),
    _event("aten::cudnn_convolution", 5, 30, cat="cpu_op"),
    _event("cudaStreamSynchronize", 40, 15, cat="cuda_runtime"),
    _event("aten::add_", 60, 40, cat="cpu_op"),
    _event("sm90_xmma_fprop_implicit_gemm_bf16", 10, 20),
    _event("void at::native::batch_norm_collect_statistics_kernel", 25, 15,
           stream=9),
    _event("Memcpy HtoD (Pinned -> Device)", 50, 5, cat="gpu_memcpy"),
    _event("void shift_lerp_kernel<unsigned char, __nv_bfloat16>", 60, 10),
    _event("void at::native::vectorized_elementwise_kernel<4>", 70, 20),
    _event("ProfilerStep#1", 0, 100, cat="user_annotation"),
    {"ph": "i", "name": "marker", "ts": 3},
]}


def test_trace_buckets_accounting():
    """The buckets sum to the kernel time; busy is the union of the
    intervals (5 us of the two streams overlap); the idle gaps come
    longest (then earliest) first, each with the innermost of the host ops
    that overlap it most;
    every figure is per step."""
    s = trace_buckets.summarize(*trace_buckets.spans_of_chrome_trace(TRACE),
                                steps=2)
    assert SUMMARY_KEYS <= set(s)
    assert s["kernel_ms"] == pytest.approx(70e-3 / 2)
    assert sum(s["buckets_ms"].values()) == pytest.approx(s["kernel_ms"])
    assert s["buckets_ms"] == pytest.approx({
        "convolution": 10e-3, "batchnorm": 7.5e-3, "memcpy": 2.5e-3,
        "shift_lerp_kernel": 5e-3, "elementwise": 10e-3})
    assert s["busy_ms"] == pytest.approx(65e-3 / 2)
    assert s["busy_ms"] <= s["kernel_ms"]
    assert s["wall_ms"] == pytest.approx(100e-3 / 2)
    assert s["busy_share"] == pytest.approx(0.65)
    assert s["streams"] == 2 and s["device_events"] == 2.5
    gaps = [(g["start_ms"], g["ms"], g["host_op"]) for g in s["idle_gaps"]]
    assert gaps == [(0.0, pytest.approx(10e-3), "aten::conv2d"),
                    (0.04, pytest.approx(10e-3), "cudaStreamSynchronize"),
                    (0.09, pytest.approx(10e-3), "aten::add_"),
                    (0.055, pytest.approx(5e-3), "aten::conv2d")]
    top = s["top_kernels"][0]
    assert top["bucket"] == "convolution" and top["calls"] == 0.5


def test_trace_buckets_one_stream_busy_is_the_sum(tmp_path):
    """Kernels of one stream run one at a time: busy equals the sum.  The
    command line reads the newest Chrome trace under a directory."""
    events = [e for e in TRACE["traceEvents"]
              if e.get("args", {}).get("stream") != 9]
    (tmp_path / "trace_1.json").write_text(json.dumps({"traceEvents": events}))
    s = trace_buckets.main([str(tmp_path), "3"])
    assert s["busy_ms"] == pytest.approx(s["kernel_ms"], rel=1e-12)
    assert sum(s["buckets_ms"].values()) == pytest.approx(s["kernel_ms"])
    assert len(s["top_kernels"]) == 3


def _linked(name, ts, dur, link, cat="kernel"):
    event = _event(name, ts, dur, cat=cat)
    event["args"]["External id"] = link
    return event


def test_trace_buckets_goes_by_the_launching_op():
    """A kernel counts in the bucket of the cpu_op it was launched from
    (its "External id"): cuDNN's complex GEMM and FFT kernels of a
    convolution as convolution, cuBLAS's under addmm as GEMM, an
    elementwise kernel of BatchNorm's as BatchNorm; its own name decides
    for the shift kernels, and where the op is of no bucket (a cast's
    copy_) or none is linked."""
    conv = "sm80_xmma_gemm_cf32cf32_cf32f32_f32_nn_n_tilesize32x32x8"
    trace = {"traceEvents": [
        _linked("aten::cudnn_convolution", 0, 50, 1, cat="cpu_op"),
        _linked("aten::addmm", 50, 10, 2, cat="cpu_op"),
        _linked("aten::native_batch_norm", 60, 10, 3, cat="cpu_op"),
        _linked("aten::copy_", 70, 10, 4, cat="cpu_op"),
        _linked("cudaLaunchKernel", 0, 1, 5, cat="cuda_runtime"),
        _linked("void fft2d_r2c_32x32<float>", 0, 10, 1),
        _linked(conv, 10, 20, 1),
        _linked("void shift_lerp_kernel<unsigned char>", 30, 5, 1),
        _linked("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", 50, 8, 2),
        _linked("void at::native::vectorized_elementwise_kernel<4>", 60, 4,
                3),
        _linked("void at::native::unrolled_elementwise_kernel<copy>", 70, 6,
                4),
        _linked("sm90_xmma_gemm_bf16bf16_bf16f32", 80, 3, 5),
    ]}
    device, _ = trace_buckets.spans_of_chrome_trace(trace)
    assert [d.op for d in device] == [
        "aten::cudnn_convolution"] * 3 + ["aten::addmm",
                                          "aten::native_batch_norm",
                                          "aten::copy_", ""]
    s = trace_buckets.summarize(*trace_buckets.spans_of_chrome_trace(trace))
    assert s["op_linked_ms"] == pytest.approx(s["kernel_ms"] - 3e-3)
    assert s["buckets_ms"] == pytest.approx({
        "convolution": 30e-3, "shift_lerp_kernel": 5e-3, "gemm": 11e-3,
        "batchnorm": 4e-3, "elementwise": 6e-3})
    assert {(k["name"][:12], k["bucket"]) for k in s["top_kernels"]} >= {
        (conv[:12], "convolution"), ("sm90_xmma_ge", "gemm")}


class _KinetoEvent:
    """The methods of a torch.profiler kineto event that trace_buckets
    reads."""

    def __init__(self, name, start_us, dur_us, kind, corr=0, link=0,
                 stream=0):
        self._name, self._kind = name, kind
        self._start, self._dur = int(start_us * 1e3), int(dur_us * 1e3)
        self._corr, self._link, self._stream = corr, link, stream

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def device_resource_id(self):
        return self._stream

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._kind == "kernel"
                else torch.autograd.DeviceType.CPU)

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._corr

    def linked_correlation_id(self):
        return self._link


def test_a_live_capture_links_each_kernel_to_its_op():
    """spans_of_profile links a kernel to the op whose correlation id it
    carries, never to a runtime or driver call that has the same number
    (CUPTI's ids), whichever comes first."""
    events = [_KinetoEvent("aten::convolution_backward", 0, 20, "cpu_op",
                           corr=7),
              _KinetoEvent("cudaLaunchKernel", 1, 1, "cuda_runtime", corr=8),
              _KinetoEvent("aten::mm", 20, 10, "cpu_op", corr=8),
              _KinetoEvent("cuLaunchKernelEx", 21, 1, "cuda_driver", corr=7),
              _KinetoEvent("sm80_xmma_gemm_f32f32", 2, 15, "kernel", link=7,
                           stream=7),
              _KinetoEvent("sm80_xmma_gemm_f32f32", 22, 5, "kernel", link=8,
                           stream=7),
              _KinetoEvent("void at::native::reduce_kernel<512>", 28, 1,
                           "kernel", link=0, stream=7)]

    class Prof:
        class profiler:
            class kineto_results:
                @staticmethod
                def events():
                    return events

    device, host = trace_buckets.spans_of_profile(Prof)
    assert [d.op for d in device] == ["aten::convolution_backward",
                                      "aten::mm", ""]
    assert len(host) == 4
    s = trace_buckets.summarize_profile(Prof)
    assert s["buckets_ms"] == pytest.approx({
        "convolution": 15e-3, "gemm": 5e-3, "reduction": 1e-3})


#: (kernel name, the op that launched it or "" for none, its bucket)
@pytest.mark.parametrize("name, op, want", [
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16", "", "convolution"),
    ("cudnn::bn_fw_tr_1C11_kernel_NCHW", "", "batchnorm"),
    ("ampere_bf16_s16816gemm_bf16_128x64_ldg8_f2f_tn", "", "gemm"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>",
     "", "reduction"),
    ("void at::native::vectorized_elementwise_kernel<4, ConvertFunctor>",
     "", "elementwise"),
    ("void shift_lerp_matmul_band<unsigned char>", "",
     "shift_lerp_matmul_band"),
    ("void tap_band<float>", "", "tap_band"),
    ("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "", "nccl"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "", "gemm"),
    ("void fft2d_r2c_16x16<float>(float2*, float const*, int)",
     "", "convolution"),
    ("void at::native::batch_norm_backward_elemt_channels_last_kernel<4>",
     "", "batchnorm"),
    ("Memset (Device)", "", "memset"),
    ("some_kernel_of_no_known_kind", "", "other"),
    ("sm80_xmma_gemm_cf32cf32_cf32f32_f32_nn_n", "aten::cudnn_convolution",
     "convolution"),
    ("void fft2d_c2r_32x32<float, false, 0u, 1u>",
     "aten::convolution_backward", "convolution"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "aten::addmm", "gemm"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "aten::bmm", "gemm"),
    ("void at::native::vectorized_elementwise_kernel<4>",
     "aten::native_batch_norm_backward", "batchnorm"),
    ("void shift_lerp_kernel<unsigned char>", "aten::cudnn_convolution",
     "shift_lerp_kernel"),
    ("Memcpy DtoD (Device -> Device)", "aten::copy_", "memcpy"),
    ("void at::native::vectorized_elementwise_kernel<4, ConvertFunctor>",
     "aten::copy_", "elementwise"),
])
def test_bucket_names(name, op, want):
    assert trace_buckets.bucket(name, op) == want


def test_a_cpu_capture_measures_no_device_time(tmp_path):
    """utils/profiler.py:trace's Chrome trace of a CPU run: the host's
    span and ops, and "not measured" for the card."""
    from peclr_tpu_torch.utils.profiler import trace

    with trace(str(tmp_path)):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    s = trace_buckets.main([str(tmp_path)])
    assert s["host_ops"] > 0 and s["wall_ms"] > 0
    assert s["device_time"].startswith("not measured")
    assert "busy_ms" not in s


# ---------------------------------------------------------------------------
# the artifacts of each script's main at a tiny size


@pytest.fixture(scope="module")
def fh_root(tmp_path_factory):
    return generate_freihand_like(str(tmp_path_factory.mktemp("fh")), 4,
                                  seed=7)


def _main(module, argv, tmp_path, name):
    out = str(tmp_path / f"{name}.json")
    record = module.main(argv + ["--device", "cpu", "--out", out])
    with open(out) as f:
        assert json.load(f) == json.loads(json.dumps(record))
    return record


def _assert_reference_keys(name, record):
    ref = _reference(name)
    assert set(ref) <= set(record), set(ref) - set(record)
    assert set(record) - set(ref) == EXTRA_KEYS[name]
    assert record.get("backend") == "cpu" and record["device"] == "cpu"


def test_serving_artifact(tmp_path):
    record = _main(bench_serving, ["--batches", "1,2", "--iters", "2",
                                   "--image-size", "64", "--resnet", "18"],
                   tmp_path, "serving")
    _assert_reference_keys("serving_latency", record)
    ref_row = set(_reference("serving_latency")["rows"][0])
    assert [r["batch"] for r in record["rows"]] == [1, 2]
    for row in record["rows"]:
        assert set(row) == ref_row
        assert row["sync_ms_p99"] >= row["sync_ms_p50"] > 0
        assert row["chained_img_per_s"] == pytest.approx(
            row["batch"] / (row["chained_ms"] / 1e3))


def test_pred_pipeline_artifact(tmp_path):
    record = _main(bench_pred_pipeline, [
        "--batch", "2", "--num-batches", "2", "--depths", "1,2",
        "--repeats", "1", "--resnet", "18", "--e2e", "3"], tmp_path, "pred")
    _assert_reference_keys("pred_pipeline", record)
    ref = _reference("pred_pipeline")
    assert set(record["depths"]) == {"1", "2"}
    for entry in record["depths"].values():
        assert set(entry) == set(ref["depths"]["1"])
    assert set(record["end_to_end"]) == set(ref["end_to_end"])
    assert record["dtype"] == "float32"
    # the CPU's trace has no device events: no device bound is claimed
    assert record["device_busy_ms_per_batch"] is None
    assert record["device_bound_img_per_sec"] is None
    assert record["profile"]["device_time"].startswith("not measured")


def test_pipeline_record_accounting():
    """The device bound is batch / busy; the best depth, its fraction of
    the bound and its speedup over depth 1 follow from the walls."""
    rec = bench_pred_pipeline.pipeline_record(
        128, 24, {"1": [3.2, 3.0, 3.1], "2": [2.0, 2.2, 2.1],
                  "3": [2.5, 2.6, 2.7]}, busy_ms=80.0)
    assert rec["device_bound_img_per_sec"] == pytest.approx(128 / 0.080)
    assert rec["best_depth"] == 2
    assert rec["depths"]["2"]["img_per_sec"] == pytest.approx(128 * 24 / 2.0)
    assert rec["speedup_vs_serial"] == pytest.approx(1.5)
    assert rec["fraction_of_device_bound"] == pytest.approx(
        128 * 24 / 2.0 / (128 / 0.080))
    assert rec["estimator"] == "min_of_3_loops"
    assert rec["repeats_img_per_sec"]["1"] == pytest.approx(
        [128 * 24 / w for w in (3.2, 3.0, 3.1)])


def test_host_pipeline_artifact(tmp_path, fh_root):
    record = _main(bench_host_pipeline, [
        "--root", fh_root, "--microbatch", "2", "--accum", "2",
        "--resnet", "18", "--view", "32", "--steps", "1", "--threads", "2"],
        tmp_path, "host")
    _assert_reference_keys("host_pipeline", record)
    rates = {"host": record["host_only_img_s"],
             "device": record["device_only_img_s"],
             "transfer": record["transfer_img_s"]}
    assert record["bound_by"] == min(rates, key=rates.get)
    assert record["overlap_efficiency"] == pytest.approx(
        record["sustained_img_s"] / min(rates.values()))
    assert record["host_cores_needed_for_device_rate"] == pytest.approx(
        record["device_only_img_s"] / record["host_per_core_img_s"])
    assert record["config"]["with_stats"] is False
    # host-only, the warm-up and the sustained leg decode one batch each
    assert sum(record["config"]["decode_paths"].values()) == 3


@pytest.mark.parametrize("rates, want", [
    ((3000.0, 1500.0, 9000.0), "host"),
    ((1000.0, 1500.0, 9000.0), "device"),
    ((3000.0, 1500.0, 900.0), "transfer"),
])
def test_bound_by_is_the_slowest_leg(rates, want):
    dev, host, xfer = rates
    got = bench_host_pipeline.balance(dev, host, host / 8, xfer, 800.0)
    assert got["bound_by"] == want
    assert got["overlap_efficiency"] == pytest.approx(800.0 / min(rates))
    assert got["host_cores_needed_for_device_rate"] == pytest.approx(
        dev / (host / 8))


def test_decode_artifact(tmp_path):
    record = _main(bench_decode, ["--num-unique", "4", "--images", "6",
                                  ], tmp_path, "decode")
    assert record["images"] == 6 and record["cpu_cores"] >= 1
    assert set(record["threaded_img_s"]) == {"1", "4", "8"}
    for entry in record["threaded_img_s"].values():
        assert entry["img_s"] > 0 and entry["per_core_img_s"] > 0
    assert record["native_loader"] == ("native_img_s" in record)
    assert record["native_loader"] != ("native_unavailable" in record)
    # the port's own pool by threads, one file at a time, and threaded cv2
    assert set(record["native_img_s"]) == set(record["cv2_threaded_img_s"])
    for entry in (*record["native_img_s"].values(),
                  *record["cv2_threaded_img_s"].values()):
        assert entry["img_s"] > 0 and entry["per_core_img_s"] > 0
    assert record["native_single_img_s"] > 0


@pytest.mark.parametrize("phase, argv, names", [
    ("pretrain", ["--batch", "2", "--accum", "1", "--ablate",
                  "noaug,adam,stats,augonly"],
     ["full", "noaug", "adam", "stats", "augonly"]),
    ("finetune", ["--batch", "2"], ["finetune"]),
    ("pred", ["--batch", "2"], ["pred"]),
])
def test_profile_step_artifact(tmp_path, phase, argv, names):
    record = _main(profile_step, ["--phase", phase, "--resnet", "18",
                                  "--iters", "1", "--view", "32",
                                  "--trace"] + argv,
                   tmp_path, "profile")
    assert set(record) == PROFILE_KEYS
    assert record["phase"] == phase and record["precision"] == "f32"
    assert list(record["variants"]) == names
    for variant in record["variants"].values():
        assert set(variant) == VARIANT_KEYS
        assert variant["img_per_s"] == pytest.approx(
            variant["images_per_step"] / (variant["ms_per_step"] / 1e3))
        assert variant["trace"]["steps"] == 1
        assert variant["trace"]["device_time"].startswith("not measured")


def test_profile_step_default_artifact_names():
    args = profile_step.parse_args(["--route", "nhwc"])
    assert profile_step.default_out(args).endswith(
        os.path.join("torch_bench", "profile_pretrain_nhwc.json"))
    args = profile_step.parse_args(["--ablate", "noaug"])
    assert profile_step.default_out(args).endswith("profile_pretrain_ablate.json")
    args = profile_step.parse_args(["--phase", "pred", "--route", "nhwc"])
    assert profile_step.default_out(args).endswith("profile_pred.json")


@pytest.mark.parametrize("module", [profile_step, bench_serving, bench_decode,
                                    bench_host_pipeline, bench_pred_pipeline])
def test_scripts_need_a_card_unless_told(module, monkeypatch, tmp_path):
    """Each runs on the card by default and raises without one, before any
    work and without writing its artifact."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "a.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--out", str(out)])
    assert not out.exists()


# ---------------------------------------------------------------------------
# against the reference


def test_pipelined_depths_match_the_reference():
    """eval/pred_fh.py:pipelined over batches on the device (two of two
    224² frames, RN18) through bench_pred_pipeline.run_loop: the same kp3d
    to the bit at depths 1, 2 and 3, and the reference's
    make_two_pass_predictor's on the same carried weights and frames
    within rtol 1e-3 (tests/test_torch_pred_fh.py's bound on kp3d)."""
    from peclr_tpu_torch.eval.pred_fh import make_two_pass_predictor

    variables = seeded_rn25d_variables("18", seed=18)
    model = RN25DPose("18")
    model.load_state_dict(rn25d_variables_to_state_dict(variables, "18"),
                          strict=True)
    frames = seeded_frames(4, seed=7)
    K = seeded_intrinsics(2, seed=8)
    predict = make_two_pass_predictor(model, device="cpu")
    batches = [torch.from_numpy(frames[:2]), torch.from_numpy(frames[2:])]
    outs = [bench_pred_pipeline.run_loop(predict, batches,
                                         torch.from_numpy(K), depth, CPU)[1]
            for depth in (1, 2, 3)]
    assert outs[0].shape == (4, 21, 3)
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    ref_predict = jax_pred_fh.make_two_pass_predictor(
        JaxRN25DPose(size="18"), variables)
    ref = np.concatenate([np.asarray(ref_predict(jnp.asarray(f),
                                                 jnp.asarray(K)))
                          for f in (frames[:2], frames[2:])])
    np.testing.assert_allclose(outs[0], ref, rtol=1e-3, atol=1e-5)


def _no_flags(flags_type):
    return flags_type(**{f.name: False for f in dataclasses.fields(
        flags_type)})


def _reference_draws(key, batch, jflags, view):
    """The draws of the reference's step (split(key, accum), augment_pair
    on each microbatch), jitted: the same numbers as op by op."""
    from peclr_tpu.ops.augment import augment_pair as jax_augment_pair

    params = JaxParams(resize_shape=(view, view))
    pair = jax.jit(lambda k, im, jt: [v.params for v in jax_augment_pair(
        k, im, jt, jflags, params)])
    mb = parity.MB
    draws = []
    for i, k in enumerate(jax.random.split(key, parity.ACCUM)):
        sl = slice(i * mb, (i + 1) * mb)
        p1, p2 = pair(k, batch["image"][sl], batch["joints25d"][sl])
        draws.append({n: torch.from_numpy(np.concatenate(
            [np.asarray(p1[n]), np.asarray(p2[n])])) for n in p1})
    return draws


@pytest.fixture(scope="module")
def noaug_run():
    """One step of the reference's make_peclr_train_step built as its
    profile_step builds the noaug ablation (every flag off), and of the
    port's profile_step.build of it, at tests/test_torch_train_step.py's
    dry-run shape (RN18, 64 -> 32 canvases, microbatch 4 x accum 2, f32),
    from the same seeded weights and the reference's draws.  With no flag
    on, the reference's jitted views have no colour-jitter floor to
    move."""
    mb, accum, view = parity.MB, parity.ACCUM, parity.VIEW
    jflags = _no_flags(JaxFlags)
    variables = seeded_peclr_variables("18", seed=0)
    tx, _ = jax_build_optimizer(
        variables["params"], base_lr=1e-4, batch_size=mb, accum=accum,
        steps_per_epoch=1000, epochs=100, warmup_epochs=10, optimizer="LARS")
    jax_state = JaxState.create(jax.tree_util.tree_map(jnp.asarray,
                                                       variables), tx)
    jax_step = jax_make_step(JaxPeCLR(resnet_size="18", dtype=jnp.float32),
                             tx, jflags, JaxParams(resize_shape=(view, view)),
                             accum=accum, with_stats=False, donate=False)
    batch = {k: v.numpy() for k, v in synthetic_pretrain_batch(
        mb * accum, canvas=parity.CANVAS, seed=0, device="cpu").items()}
    key = jax.random.PRNGKey(10)
    _, jax_metrics = jax_step(jax_state, batch, key)
    draws = _reference_draws(key, batch, jflags, view)
    state, step = profile_step.build(
        mb, accum, resnet="18", view=view, device="cpu",
        **dict(profile_step.variants("noaug"))["noaug"])
    torch_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    _, metrics = step(state, torch_batch, None, draws=draws)
    return metrics["loss"].item(), float(jax_metrics["loss"]), torch_batch


def test_noaug_first_loss_matches_the_reference(noaug_run):
    """Within 1e-4 relative, as test_torch_train_step.py::test_loss_matches."""
    got, want, _ = noaug_run
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_adam_and_stats_ablations_give_the_recipe_first_loss(noaug_run):
    """A step's first loss comes before its update and its statistics, so
    the adam and stats variants give the full recipe step's first loss, to
    the bit, on the same draws; test_torch_train_step.py::test_loss_matches
    holds that step's first loss against the reference's recipe step (the
    stats variant, with_stats=True, is the reference's default step, whose
    statistics ::test_projection_stats_match holds too)."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.ops.augment import draw

    mb, accum, view = parity.MB, parity.ACCUM, parity.VIEW
    gen = torch.Generator().manual_seed(3)
    draws = [draw(gen, 2 * mb, peclr_pretrain_flags(),
                  AugmentationParams(resize_shape=(view, view)))
             for _ in range(accum)]
    variants = dict(profile_step.variants("adam,stats"))
    first = {}
    for name in ("full", "adam", "stats"):
        state, step = profile_step.build(mb, accum, resnet="18", view=view,
                                         device="cpu", **variants[name])
        assert state.optimizer.lars is (name != "adam")
        first[name] = step(state, noaug_run[2], None,
                           draws=draws)[1]["loss"].item()
    assert np.isfinite(first["full"])
    assert first["adam"] == first["full"] == first["stats"]
