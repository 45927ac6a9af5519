"""What the two training entries share: the set-up that drives the step
from the seed through its first steps, the window of steps chained state to
state, the compared steps once the window has closed (the same model,
optimizer and step rewound in place to the seeded start, so that they go
through the path the window timed), and the comparison with the reference
once the program's state is freed."""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict

import torch

from benchmark.harness import checks, common, inputs

#: steps that set-up takes through the window's call and feed
WARMUP_STEPS = 4
#: steps compared once the window has closed, which the reference follows
CHECK_STEPS = 3


def augmentation(cfg: dict):
    """The program's AugmentationFlags and AugmentationParams of the
    config (its lists as tuples)."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationFlags,
        AugmentationParams,
    )

    aug = cfg["augmentation"]
    params = {k: tuple(v) if isinstance(v, list) else v
              for k, v in aug["params"].items()}
    return AugmentationFlags(**aug["flags"]), AugmentationParams(**params)


class TrainingRunner:
    """Subclasses set KIND, `build()` (returns model, optimizer, step,
    layout), `make_batches(gen, count)` and `reference_steps(...)`."""

    KIND = ""

    def __init__(self, spec: dict, seed: int, device: torch.device):
        self.spec, self.seed, self.device = spec, seed, device
        self.cfg, self.traffic = spec["config_data"], spec["traffic_data"]

    # the program -----------------------------------------------------------
    def setup(self) -> None:
        dev = self.device
        self.model, self.opt, self.step_fn, self.layout = self.build()
        from peclr_tpu_torch.train.state import TrainState

        self.state = TrainState(self.model, self.opt)
        self.batches = self.make_batches(inputs.generator(self.seed, "images",
                                                          dev),
                                         self.traffic["resident_batches"])
        self.gen = inputs.generator(self.seed, "draws", dev)
        self.gen_start = self.gen.get_state()
        self.done = 0
        for _ in range(WARMUP_STEPS):
            self._step()
        common.sync(dev)

    def rewind(self) -> None:
        """The same objects back at the seeded start, in place: the seeded
        weights and BatchNorm statistics copied into the model, the
        optimizer's moments zeroed and its count of updates 0 (its state
        before a first update), the step count 0, the draw generator at
        its first draw and the batches from the first."""
        self.model.load_state_dict(inputs.make_weights(self.layout, self.seed,
                                                       self.device),
                                   strict=True)
        with torch.no_grad():
            for slot in self.opt.state.values():
                for value in slot.values():
                    if torch.is_tensor(value):
                        value.zero_()
        self.opt.count = 0
        self.state.step = 0
        self.gen.set_state(self.gen_start)
        self.done = 0

    def finish(self) -> None:
        """Once the window has closed: rewind, then the CHECK_STEPS compared
        steps through the window's own call and feed, watched for waits on
        the card and for the warp's launches; of the first, the model's
        first input (the augmented views of its first microbatch) and the
        projections of every microbatch are kept."""
        self.rewind()
        seen = {"inputs": [], "projs": []}

        def pre(module, args):
            if not seen["inputs"]:
                seen["inputs"].append(args[0].detach().clone())

        def post(module, args, out):
            if isinstance(out, dict) and "projection" in out:
                seen["projs"].append(out["projection"].detach().clone())

        losses = []

        def steps():
            for i in range(CHECK_STEPS):
                hooks = ([self.model.register_forward_pre_hook(pre),
                          self.model.register_forward_hook(post)]
                         if i == 0 else [])
                losses.append(self._step()["loss"])
                for h in hooks:
                    h.remove()
                if i == 0:
                    b1 = 0.9
                    self.first_grad = {
                        n: (self.opt.state[p]["mu"] / (1.0 - b1)).clone()
                        if p in self.opt.state else torch.zeros_like(p)
                        for n, p in self.model.named_parameters()}

        before = common.route_launches()
        waits = common.host_waits(steps)
        common.sync(self.device)
        self.launch_gap, self.launch_note = self.launch_check(
            before, common.route_launches(), CHECK_STEPS)
        self.waits = len(waits)
        self.after = {n: p.detach().clone()
                      for n, p in self.model.named_parameters()}
        self.running = {n: b.detach().clone().float()
                        for n, b in self.model.named_buffers()
                        if n.endswith(("running_mean", "running_var"))}
        self.losses = [float(x) for x in losses]
        self.views = seen["inputs"][0]
        self.projs = seen["projs"]

    def _step(self):
        batch = self.batches[self.done % len(self.batches)]
        self.state, metrics = self.step_fn(self.state, batch, self.gen)
        self.done += 1
        return metrics

    def launch_check(self, before, after, units):
        """(gap, note) of the warp's launches in `units` steps, as
        harness/common.py:check_launches gives them."""
        raise NotImplementedError

    def window(self, seconds: float) -> dict:
        """Steps chained state to state until `seconds` have passed when
        one is queued; the window ends when the card has done them."""
        n = 0

        def run():
            nonlocal n
            t0 = time.perf_counter()
            while True:
                self._step()
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break

        elapsed = common.chained_seconds(run, self.device)
        return {"units": n, "images": n * self.images_per_step(),
                "seconds": elapsed}

    def traced(self, units: int) -> Callable[[], None]:
        def run():
            for _ in range(units):
                self._step()
        return run

    def release(self) -> None:
        for name in ("model", "opt", "step_fn", "state", "batches", "gen",
                     "gen_start"):
            setattr(self, name, None)
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # the comparison ----------------------------------------------------------
    def reference(self, precision: str) -> dict:
        """The reference's CHECK_STEPS steps in `precision` from the same
        weights, inputs and draws."""
        dev = self.device
        weights = inputs.make_weights(self.layout, self.seed, dev)
        batches = self.make_batches(inputs.generator(self.seed, "images", dev),
                                    self.traffic["resident_batches"])
        batches = [batches[i % len(batches)] for i in range(CHECK_STEPS)]
        gen = inputs.generator(self.seed, "draws", dev)
        return self.reference_steps(weights, batches, gen, precision,
                                    self.warp_dtype())

    def warp_dtype(self) -> torch.dtype:
        """The type the program's warp writes its views in: bf16 on the
        card, f32 on the CPU."""
        return torch.bfloat16 if self.device.type == "cuda" else torch.float32

    def program_result(self) -> dict:
        return {"losses": self.losses, "first_grad": self.first_grad,
                "params": self.after, "running": self.running,
                "views": self.views, "projs": self.projs}

    def start_params(self) -> Dict[str, torch.Tensor]:
        weights = inputs.make_weights(self.layout, self.seed, self.device)
        return {n: w for n, w in weights.items() if n in self.first_grad}

    def readings(self, precision: str = "f32", against: dict = None,
                 details: bool = False) -> dict:
        """The program's readings against the reference (or, with
        `against`, those of that result); with `details`, also the leaves
        behind them under "details"."""
        ref = self.reference(precision)
        run = self.program_result() if against is None else against
        start = self.start_params()
        out = checks.training_readings(run, ref, start)
        out.update(self.stage_readings(run, ref))
        if details:
            out["details"] = checks.training_details(run, ref, start)
        return out

    def stage_readings(self, run: dict, ref: dict) -> Dict[str, float]:
        """Readings of single stages of the first compared step: here the
        augmented views of its first microbatch against the reference's."""
        return {"view_gap": checks.coordinate_gap(run["views"].float(),
                                                  ref["views"].float())}

    def check(self) -> Dict[str, float]:
        return self.readings("f32")

    def images_per_step(self) -> int:
        raise NotImplementedError

    def control_readings(self, precision: str) -> dict:
        """The reference in `precision` put in the program's place, against
        the reference."""
        return self.readings("f32", against=self.reference(precision),
                             details=True)
