"""Cross-process feeding harness (port of the reference repository's
scripts/multihost_harness.py).

Each process of a data-parallel run loads only its own rows of the global
batch (`parallel/multihost.py:global_batch_from_host_local`).  This harness
runs that across a real process boundary, as two hosts of one card each
would see it:

  * the launcher starts two subprocesses with the environment a launcher
    gives each host (MASTER_ADDR, a free MASTER_PORT, WORLD_SIZE=2, RANK,
    LOCAL_RANK=0, LOCAL_WORLD_SIZE=1), so that `make_mesh()` meets through
    env:// as under torch.distributed.run;
  * each worker loads only its rows of the global batch (shard_batch's
    layout, `local_rows`) and puts them on its device through
    `global_batch_from_host_local` (on the card through a `cuda_copier`);
  * both run two chained PeCLR train steps (augmentation, BatchNorm and
    NT-Xent across the ranks, LARS) in f32 with TF32 off, from the same
    seeded state and draws, and write their losses;
  * the launcher runs the same program in one process (a third subprocess,
    started beside the workers) on the whole batch, and compares.

Backend: gloo on the CPU; gloo on one card as well (both processes sit on
it, and NCCL refuses two ranks on one card); NCCL where there are two
cards, each worker seeing its own (CUDA_VISIBLE_DEVICES).  Every process
and collective is bounded by --timeout: a hung or failed worker fails the
run with its output's tail in the artifact.

    python -m peclr_tpu_torch.scripts.multihost_harness [--device cuda]
        [--out tests/fixtures/torch_bench/multihost_crossproc.json]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

GLOBAL_BATCH = 16
ACCUM = 2
CANVAS = 64
VIEW = 32
STEPS = 2  # step 1 has warmup lr 0; step 2 applies a real update
#: the seed of the augmentation draws (the reference's PRNGKey(7))
DRAW_SEED = 7
#: the workers' losses against the one process's, relative
TOLERANCE = 2e-5


def _batch_numpy():
    """The deterministic GLOBAL batch, identical in every process."""
    import numpy as np

    rng = np.random.default_rng(0)
    n = GLOBAL_BATCH * ACCUM
    images = rng.integers(0, 256, size=(n, CANVAS, CANVAS, 3), dtype=np.uint8)
    joints = np.zeros((n, 21, 3), np.float32)
    joints[..., 0] = rng.uniform(16, 48, (n, 21))
    joints[..., 1] = rng.uniform(16, 48, (n, 21))
    return {"image": images, "joints25d": joints}


def _setup(device, mesh=None):
    """The seeded RN18 PeCLR model, LARS and the f32 step (mirrors the
    reference's tiny setup): the same weights in every process."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.data.synthetic import seeded_peclr_variables
    from peclr_tpu_torch.models import PeCLRModel
    from peclr_tpu_torch.models.port import peclr_variables_to_state_dict
    from peclr_tpu_torch.train.optimizer import build_optimizer
    from peclr_tpu_torch.train.state import TrainState
    from peclr_tpu_torch.train.step import make_peclr_train_step

    model = PeCLRModel("18")
    model.load_state_dict(peclr_variables_to_state_dict(
        seeded_peclr_variables("18", 0), "18"), strict=True)
    model.to(device)
    opt, _ = build_optimizer(
        model, base_lr=1e-3, batch_size=GLOBAL_BATCH, accum=ACCUM,
        steps_per_epoch=10, epochs=5, warmup_epochs=1, optimizer="LARS")
    step = make_peclr_train_step(
        model, opt, peclr_pretrain_flags(),
        AugmentationParams(resize_shape=(VIEW, VIEW)), accum=ACCUM,
        precision="f32", mesh=mesh)
    return TrainState(model, opt), step


def _draws(device):
    """Each step's global draws (ACCUM dicts of 2 × GLOBAL_BATCH
    parameters), made on the host from DRAW_SEED: the same in every
    process, whatever its device."""
    import torch

    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.ops.augment import draw

    gen = torch.Generator().manual_seed(DRAW_SEED)
    flags, params = peclr_pretrain_flags(), AugmentationParams(
        resize_shape=(VIEW, VIEW))
    return [[{k: v.to(device) for k, v in draw(
        gen, 2 * GLOBAL_BATCH, flags, params).items()} for _ in range(ACCUM)]
        for _ in range(STEPS)]


def _run_steps(state, step, batch, device):
    losses = []
    for draws in _draws(device):
        state, metrics = step(state, batch, None, draws=draws)
        losses.append(metrics["loss"])
    return [loss.item() for loss in losses]


def worker(args):
    """One process of the two: its rows of the global batch, two steps
    across the processes, its losses to --out."""
    import torch

    from peclr_tpu_torch.data.pipeline import cuda_copier
    from peclr_tpu_torch.parallel.mesh import local_rows, make_mesh
    from peclr_tpu_torch.parallel.multihost import (
        global_batch_from_host_local,
        local_batch_size,
    )

    mesh = make_mesh(device=args.device, backend=args.backend,
                     timeout=args.timeout)
    try:
        assert mesh.size == 2, mesh.size
        state, step = _setup(mesh.device, mesh)
        batch = _batch_numpy()
        # the contract under test: this process loads only its own rows
        n = GLOBAL_BATCH * ACCUM
        rows = local_rows(mesh, n, ACCUM)
        assert len(rows) == local_batch_size(n, mesh)
        local = {k: v[rows] for k, v in batch.items()}
        copier = cuda_copier(mesh.device) if mesh.device.type == "cuda" else None
        tensors, copied = global_batch_from_host_local(mesh, local, copier)
        if copied is not None:
            torch.cuda.current_stream(mesh.device).wait_event(copied)
        for v in tensors.values():
            assert v.shape[0] == n // mesh.size, v.shape  # local rows only
        losses = _run_steps(state, step, tensors, mesh.device)
    finally:
        mesh.close()
    record = {"process_id": mesh.rank, "process_count": mesh.size,
              "local_devices": 1, "global_devices": mesh.size,
              "losses": losses, "backend": mesh.backend,
              "device": str(mesh.device)}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(record, fh)
    print(f"worker {mesh.rank}: losses {losses}", flush=True)
    return record


def single_process_reference(out_path=None, device=None):
    """The same program in one process, on the whole batch, no mesh, on
    `device` (the card unless another is named)."""
    import torch

    from peclr_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    state, step = _setup(dev)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in _batch_numpy().items()}
    losses = _run_steps(state, step, batch, dev)
    if out_path:
        with open(out_path, "w") as fh:
            json.dump({"losses": losses}, fh)
    return losses


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker_cards(dev) -> list:
    """The card each worker sees (CUDA_VISIBLE_DEVICES) where there are two
    to give it, as two hosts of one card each; else [None, None], both on
    the one card or on the CPU."""
    import torch

    if dev.type != "cuda" or torch.cuda.device_count() < 2:
        return [None, None]
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    return (visible.split(",") if visible else ["0", "1"])[:2]


def launch(args):
    """Start the two workers and the one-process run, wait for them within
    --timeout, and write the comparison (module docstring)."""
    from peclr_tpu_torch import scripts as common
    from peclr_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    cards = _worker_cards(dev)
    # NCCL refuses two ranks on one card ("Duplicate GPU detected")
    backend = "gloo" if cards[0] is None else "nccl"
    tmp = args.tmpdir or tempfile.mkdtemp(prefix="peclr_multihost_")
    try:
        record = _run(args, dev, cards, backend, tmp)
    finally:
        if args.tmpdir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    record.update({"backend": dev.type, "device": common.card_name(dev),
                   "cpu_cores": common.cpu_cores()})
    _finish(record, args)
    return record


def _run(args, dev, cards, backend, tmp) -> dict:
    """The three processes and the comparison of their losses."""
    port = _free_port()
    base = dict(os.environ)
    for var in ("TORCHELASTIC_RUN_ID", "GROUP_RANK", "ROLE_RANK"):
        base.pop(var, None)
    base["PYTHONPATH"] = REPO + os.pathsep + base.get("PYTHONPATH", "")
    me = [sys.executable, "-m", "peclr_tpu_torch.scripts.multihost_harness",
          "--device", args.device, "--timeout", str(args.timeout)]
    outs = [os.path.join(tmp, f"multihost_worker{i}.json") for i in range(2)]
    ref_out = os.path.join(tmp, "multihost_ref.json")
    procs = []
    for i in range(2):
        env = dict(base, MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(i), LOCAL_RANK="0",
                   LOCAL_WORLD_SIZE="1")
        if cards[i] is not None:
            env["CUDA_VISIBLE_DEVICES"] = cards[i]
        procs.append(subprocess.Popen(
            me + ["--worker", "--backend", backend, "--out", outs[i]],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, cwd=REPO))
    env = {k: v for k, v in base.items() if k not in (
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
        "LOCAL_WORLD_SIZE")}
    procs.append(subprocess.Popen(me + ["--single-ref", "--out", ref_out],
                                  env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  cwd=REPO))
    logs, codes = [], []
    deadline = time.monotonic() + args.timeout
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
            out += f"\n[launcher] killed after {args.timeout} s"
        logs.append(out)
        codes.append(p.returncode)

    record = {
        "harness": (f"2 processes x 1 device ({dev.type}), {backend} "
                    "collectives, env:// rendezvous"),
        "global_batch": GLOBAL_BATCH, "accum": ACCUM, "steps": STEPS,
        "collective_backend": backend,
        "worker_exit_codes": codes[:2], "single_process_exit_code": codes[2],
    }
    ok = codes == [0, 0, 0] and all(os.path.exists(o)
                                   for o in outs + [ref_out])
    if ok:
        results = []
        for o in outs:
            with open(o) as fh:
                results.append(json.load(fh))
        with open(ref_out) as fh:
            ref = json.load(fh)["losses"]
        record["workers"] = results
        record["single_process_losses"] = ref
        errs = [abs(w - r) / abs(r) for res in results
                for w, r in zip(res["losses"], ref)]
        agree = results[0]["losses"] == pytest_approx_list(
            results[1]["losses"])
        record["max_rel_err"] = max(errs)
        record["tolerance"] = TOLERANCE
        record["ok"] = bool(max(errs) <= TOLERANCE and agree)
    else:
        record["ok"] = False
        record["blocker"] = [log[-4000:] for log in logs]
    return record


def _finish(record, args):
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(record, fh, indent=1)
    print(json.dumps({k: v for k, v in record.items() if k != "blocker"},
                     indent=1), flush=True)
    if not record["ok"]:
        tails = "\n".join(record.get("blocker", []))
        raise RuntimeError(f"multihost harness failed:\n{tails}")


def pytest_approx_list(xs, rel=1e-6):
    class _L(list):
        def __eq__(self, other):
            return len(self) == len(other) and all(
                abs(a - b) <= rel * max(abs(a), abs(b), 1e-12)
                for a, b in zip(self, other)
            )
    return _L(xs)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--single-ref", action="store_true",
                    help="run the one-process reference and write {losses} "
                         "to --out (started by the launcher)")
    ap.add_argument("--backend", default=None,
                    help="a worker's backend (the launcher chooses it)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(
        REPO, "tests", "fixtures", "torch_bench", "multihost_crossproc.json"))
    ap.add_argument("--tmpdir", default=None)
    ap.add_argument("--timeout", type=float, default=600)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.worker or args.single_ref:
        import torch

        # three processes of a tiny model side by side, as spawn's ranks
        torch.set_num_threads(1)
    if args.worker:
        return worker(args)
    if args.single_ref:
        return single_process_reference(out_path=args.out, device=args.device)
    return launch(args)


if __name__ == "__main__":
    main()
