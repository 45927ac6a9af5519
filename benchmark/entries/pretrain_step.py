"""The PeCLR pretrain step (train/step.py:make_peclr_train_step) at the
config's recipe: resident uint8 canvases, the traffic's microbatch x
accumulation, the config's warp route, steps chained state to state with
no wait on the card inside the window.

The model is PeCLRModel with the seeded weights loaded by state dict; the
optimizer is build_optimizer's at the config's schedule.  Everything the
step needs is built here; the step itself is the program's.
"""

from __future__ import annotations

import math

import torch

from benchmark.harness import checks, common, counts, inputs
from benchmark.harness.training import TrainingRunner, augmentation
from benchmark.reference import models, train

KIND = "pretrain"


class Runner(TrainingRunner):
    KIND = KIND

    def build(self):
        from peclr_tpu_torch.models import PeCLRModel
        from peclr_tpu_torch.train import step as step_mod
        from peclr_tpu_torch.train.optimizer import build_optimizer

        cfg, tr = self.cfg, self.traffic
        dims = (cfg["projection_hidden_dim"], cfg["projection_dim"])
        layout = models.peclr_layout(cfg["resnet"], *dims)
        model = PeCLRModel(cfg["resnet"], *dims)
        model.load_state_dict(inputs.make_weights(layout, self.seed,
                                                  self.device), strict=True)
        model.to(self.device)
        o = cfg["optimizer"]
        opt, _ = build_optimizer(
            model, base_lr=o["base_lr"], batch_size=tr["microbatch"],
            accum=tr["accum"], steps_per_epoch=o["steps_per_epoch"],
            epochs=o["epochs"], warmup_epochs=o["warmup_epochs"],
            weight_decay=o["weight_decay"], optimizer=o["name"])
        flags, params = augmentation(cfg)
        step = step_mod.make_peclr_train_step(
            model, opt, flags, params, accum=tr["accum"],
            temperature=cfg["temperature"], warp_route=cfg["route"],
            precision=cfg["precision"]["program"], with_stats=False)
        return model, opt, step, layout

    def make_batches(self, gen, count):
        tr = self.traffic
        return [inputs.pretrain_batch(tr["microbatch"] * tr["accum"],
                                      self.cfg["canvas"], gen, self.device)
                for _ in range(count)]

    def images_per_step(self) -> int:
        return self.traffic["microbatch"] * self.traffic["accum"]

    def launch_check(self, before, after, units):
        """Two passes of the route's kernel a microbatch on the card; none
        on the CPU, where the warp runs its plain version."""
        due = 2 * self.traffic["accum"] if self.device.type == "cuda" else 0
        return common.check_launches(before, after, units, self.cfg["route"],
                                     due)

    def warp_dtype(self):
        """bf16 on the card unless the step runs at precision "f32", which
        warps in f32 too."""
        if self.cfg["precision"]["program"] == "f32":
            return torch.float32
        return super().warp_dtype()

    def stage_readings(self, run, ref):
        """Besides the views: the first microbatch's projections against
        the reference's, and the first step's loss against the reference's
        NT-Xent of the program's own projections (the same number of
        microbatches, or it fails)."""
        out = super().stage_readings(run, ref)
        out["proj_gap"] = checks.relative_gap(run["projs"][0].float(),
                                              ref["projs"][0].float())
        if len(run["projs"]) != len(ref["view_params"]):
            out["ntxent_gap"] = math.inf
        else:
            dev = ref["projs"][0].device
            staged = train.staged_loss([x.to(dev) for x in run["projs"]],
                                       ref["view_params"], self.cfg)
            out["ntxent_gap"] = abs(run["losses"][0] - staged) / max(
                abs(staged), 1e-30)
        return out

    def reference_steps(self, weights, batches, gen, precision, warp_dtype):
        return train.pretrain_steps(weights, batches, gen, self.cfg,
                                    self.traffic, precision, warp_dtype)

    def counts(self) -> dict:
        """FLOPs of a step and the least bytes of its warp passes."""
        cfg, tr = self.cfg, self.traffic
        views = 2 * tr["microbatch"] * tr["accum"]
        fwd = counts.peclr_forward_flops(cfg["resnet"], cfg["view"],
                                         cfg["projection_hidden_dim"],
                                         cfg["projection_dim"])
        params = cfg["augmentation"]["params"]
        rotate = cfg["augmentation"]["flags"].get("rotate")
        sx, sy = counts.recipe_window_bounds(
            cfg["canvas"], cfg["view"],
            max(abs(params["min_angle"]), abs(params["max_angle"]))
            if rotate else 0.0)
        per_mb = counts.warp_pass_bytes(
            2 * tr["microbatch"], (cfg["canvas"], cfg["canvas"]),
            (cfg["view"], cfg["view"]), 3, 1, 2, sx, sy)
        return {"flops_per_unit": views * counts.train_flops(fwd),
                "peak_flops": counts.PEAK_BF16,
                "warp_bytes_per_unit": tr["accum"] * sum(per_mb.values()),
                "images_per_unit": self.images_per_step()}
