"""The FreiHAND leaderboard's two-pass predictor (eval/pred_fh.py) as the
leaderboard CLI drives it: one caller, a closed loop, batches of host
frames and their K dispatched through `pipelined` at the traffic's depth.

The model is RN25DPose with the seeded weights, prepared by
make_two_pass_predictor (on the card, eval mode, TF32 off).  Each batch
goes through run_two_pass, whose three outputs (pass 1's kp25d, the
refined affine T2, the final kp3d) come back to the host together, so that
the comparison can follow the passes one by one.  A batch's latency runs
from when `pipelined` takes it (before its copy to the card) until its
answers are on the host.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from benchmark.harness import checks, common, counts, inputs
from benchmark.reference import models, pred

KIND = "pred"
#: batches through the loop in set-up, warming its one shape
WARMUP_BATCHES = 4


def _pack(out):
    b = out["kp3d"].shape[0]
    return torch.cat([out["kp25d_1"].reshape(b, -1), out["T2"].reshape(b, -1),
                      out["kp3d"].reshape(b, -1)], dim=1)


def _unpack(packed):
    p = torch.as_tensor(packed)
    return (p[:, :63].reshape(-1, 21, 3), p[:, 63:72].reshape(-1, 3, 3),
            p[:, 72:].reshape(-1, 21, 3))


class Runner:
    KIND = KIND

    def __init__(self, spec: dict, seed: int, device: torch.device):
        self.spec, self.seed, self.device = spec, seed, device
        self.cfg, self.traffic = spec["config_data"], spec["traffic_data"]
        self.layout = models.rn25d_layout(self.cfg["resnet"])
        self.launch_gap, self.launch_note, self.waits = 0, None, 0

    def setup(self) -> None:
        from peclr_tpu_torch.eval import pred_fh
        from peclr_tpu_torch.models import RN25DPose

        dev, tr = self.device, self.traffic
        model = RN25DPose(self.cfg["resnet"])
        model.load_state_dict(inputs.make_weights(self.layout, self.seed, dev),
                              strict=True)
        pred_fh.make_two_pass_predictor(model, device=dev)
        self.model = model
        b, n_pool = tr["batch"], tr["pool_batches"]
        pool = inputs.pred_batch(b * n_pool, inputs.generator(self.seed,
                                                              "images", dev),
                                 dev)
        self.frames = pool["image"].cpu().numpy().reshape(n_pool, b, 224, 224,
                                                          3)
        self.K = pool["K"].cpu().numpy().reshape(n_pool, b, 3, 3)
        self.answers = {}
        self.next_id = 0
        self._loop(WARMUP_BATCHES, None)
        frames = torch.as_tensor(self.frames[0]).to(dev)
        K = torch.as_tensor(self.K[0]).to(dev)
        common.sync(dev)
        before = common.route_launches()
        waits = common.host_waits(lambda: self.predict(frames, K))
        common.sync(dev)
        after = common.route_launches()
        # two warps a pass on the card; none on the CPU (the plain version)
        due = 4 if dev.type == "cuda" else 0
        self.launch_gap, self.launch_note = common.check_launches(
            before, after, 1, "grouped", due)
        self.waits = len(waits)

    def predict(self, images, K):
        from peclr_tpu_torch.eval import pred_fh

        return _pack(pred_fh.run_two_pass(self.model, images, K))

    def _loop(self, count, seconds):
        """Run batches through pipelined until `count` are taken (or, with
        `seconds`, until that many seconds have passed when the next would
        be taken); returns (batch ids, latencies, seconds)."""
        from peclr_tpu_torch.eval import pred_fh

        n_pool = self.traffic["pool_batches"]
        taken = {}
        lat = []
        common.sync(self.device)
        t0 = time.perf_counter()

        def source():
            i = 0
            while True:
                now = time.perf_counter()
                if (seconds is not None and now - t0 >= seconds) or (
                        seconds is None and i >= count):
                    return
                bid = self.next_id
                self.next_id += 1
                taken[bid] = now
                yield bid, 0, self.frames[bid % n_pool], self.K[bid % n_pool]
                i += 1

        ids = []
        for bid, packed in pred_fh.pipelined(self.predict, source(),
                                             self.traffic["depth"],
                                             self.device):
            lat.append(time.perf_counter() - taken[bid])
            self.answers[bid] = packed
            ids.append(bid)
        return ids, lat, time.perf_counter() - t0

    def window(self, seconds: float) -> dict:
        self.answers = {}
        ids, lat, elapsed = self._loop(None, seconds)
        self.window_ids = ids
        return {"units": len(ids), "images": len(ids) * self.traffic["batch"],
                "seconds": elapsed, "latencies_s": lat}

    def traced(self, units: int):
        return lambda: self._loop(units, None)

    def finish(self) -> None:
        """Nothing once the window has closed: its own answers are the ones
        compared, and set-up watched a batch for waits and launches."""

    def release(self) -> None:
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def sample_ids(self):
        """The window's batches the comparison reads: drawn from the seed,
        with the last."""
        ids = self.window_ids
        k = min(self.traffic["sample_batches"], len(ids))
        rng = np.random.default_rng(inputs.sub_seed(self.seed, "sample"))
        chosen = set(rng.choice(len(ids) - 1, size=k - 1, replace=False)
                     .tolist()) if k > 1 else set()
        return [ids[i] for i in sorted(chosen)] + [ids[-1]]

    def reference_answers(self, precision: str, ids, follow=None):
        """The reference's passes in `precision` for each sampled batch:
        kp25d_1 from the frames, T2 from pass-1 keypoints and kp3d from a
        pass 2 on T2.  With `follow` ({id: {"kp25d_1", "T2"}}, another
        side's answers) T2 and pass 2 start from that side's pass-1
        keypoints and T2, so each stage is judged on its own."""
        dev = self.device
        q = models.Precision(precision)
        p = inputs.make_weights(self.layout, self.seed, dev)
        warp_dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
        size, n_pool = self.cfg["resnet"], self.traffic["pool_batches"]
        out = {}
        for bid in ids:
            frames = torch.as_tensor(self.frames[bid % n_pool]).to(dev)
            K = torch.as_tensor(self.K[bid % n_pool]).to(dev)
            kp1, T1 = pred.pass1(frames, K, p, size, q, warp_dtype)
            src = {"kp25d_1": kp1} if follow is None else {
                k: follow[bid][k].to(dev) for k in ("kp25d_1", "T2")}
            T2 = pred.refine(src["kp25d_1"][..., :2], T1)
            kp3d = pred.pass2(frames, K, src.get("T2", T2), p, size, q,
                              warp_dtype)
            out[bid] = {"kp25d_1": kp1, "T2": T2, "kp3d": kp3d}
        return out

    def _program(self, ids):
        return {bid: dict(zip(("kp25d_1", "T2", "kp3d"),
                              _unpack(self.answers[bid]))) for bid in ids}

    @staticmethod
    def _gaps(run, ref, ids):
        def cat(d, key):
            return torch.cat([d[i][key].cpu() for i in ids])

        p1 = checks.coordinate_gap(cat(run, "kp25d_1"), cat(ref, "kp25d_1"))
        t2 = checks.coordinate_gap(cat(run, "T2")[:, :2, :].reshape(-1, 6),
                                   cat(ref, "T2")[:, :2, :].reshape(-1, 6))
        kp = checks.coordinate_gap(cat(run, "kp3d"), cat(ref, "kp3d"))
        return {"pass1_gap": p1, "pass2_gap": max(t2, kp)}

    def check(self) -> dict:
        ids = self.sample_ids()
        run = self._program(ids)
        return self._gaps(run, self.reference_answers("f32", ids, run), ids)

    def control_readings(self, precision: str) -> dict:
        """The reference in `precision` put in the program's place (its
        own passes), against the reference."""
        ids = self.sample_ids()
        low = self.reference_answers(precision, ids)
        return self._gaps(low, self.reference_answers("f32", ids, low), ids)

    def counts(self) -> dict:
        fwd = counts.rn25d_forward_flops(self.cfg["resnet"], 224)
        b = self.traffic["batch"]
        return {"flops_per_unit": b * 2 * fwd, "peak_flops": counts.PEAK_F32,
                "images_per_unit": b}
