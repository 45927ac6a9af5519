"""The RN25D fine-tune step (train/finetune.py:make_finetune_step) at the
fine-tune CLI's defaults: resident 224 x 224 canvases cropped and resized
to the config's crop by the warp, RN25DPose in f32 (TF32 off), the 2D and
z L1 losses, Adam; steps chained state to state with no wait on the card
inside the window."""

from __future__ import annotations

from benchmark.harness import common, counts, inputs
from benchmark.harness.training import TrainingRunner, augmentation
from benchmark.reference import models, train

KIND = "finetune"


class Runner(TrainingRunner):
    KIND = KIND

    def build(self):
        from peclr_tpu_torch.models import RN25DPose
        from peclr_tpu_torch.train import finetune
        from peclr_tpu_torch.train.optimizer import build_optimizer

        cfg, tr = self.cfg, self.traffic
        layout = models.rn25d_layout(cfg["resnet"])
        model = RN25DPose(cfg["resnet"])
        model.load_state_dict(inputs.make_weights(layout, self.seed,
                                                  self.device), strict=True)
        model.to(self.device)
        o = cfg["optimizer"]
        opt, _ = build_optimizer(
            model, base_lr=o["base_lr"], batch_size=tr["batch"], accum=1,
            steps_per_epoch=o["steps_per_epoch"], epochs=o["epochs"],
            warmup_epochs=o["warmup_epochs"], weight_decay=o["weight_decay"],
            optimizer=o["name"])
        step = finetune.make_finetune_step(model, opt, *augmentation(cfg))
        return model, opt, step, layout

    def make_batches(self, gen, count):
        return [inputs.supervised_batch(self.traffic["batch"],
                                        self.traffic["canvas"], gen,
                                        self.device)
                for _ in range(count)]

    def images_per_step(self) -> int:
        return self.traffic["batch"]

    def launch_check(self, before, after, units):
        """Two passes of the grouped route's kernel a step (the fine-tune
        sample's warp) on the card; none on the CPU."""
        due = 2 if self.device.type == "cuda" else 0
        return common.check_launches(before, after, units, "grouped", due)

    def reference_steps(self, weights, batches, gen, precision, warp_dtype):
        return train.finetune_steps(weights, batches, gen, self.cfg,
                                    self.traffic, precision, warp_dtype)

    def counts(self) -> dict:
        crop = self.cfg["augmentation"]["params"]["resize_shape"][0]
        fwd = counts.rn25d_forward_flops(self.cfg["resnet"], crop)
        return {"flops_per_unit": self.traffic["batch"]
                * counts.train_flops(fwd),
                "peak_flops": counts.PEAK_F32,
                "images_per_unit": self.images_per_step()}
