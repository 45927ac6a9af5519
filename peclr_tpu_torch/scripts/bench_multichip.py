"""Multi-card scaling of the PeCLR pretrain step, data-parallel over the
cards (port of the reference repository's scripts/bench_multichip.py).

Weak scaling (the default): the RN50 recipe step
(`train/step.py:make_peclr_train_step(mesh=)`, bf16 unless --precision f32,
the trainer's hot path `with_stats=False`) with a microbatch of --batch
rows a card, so that the global batch a step is batch × accum × world. One
NCCL rank a card: under `torch.distributed.run`, or spawned here
(`--world`, every card by default). Two warm-up steps, then --iters steps
queued back to back and timed with one wait at the end
(`scripts.chained_seconds`). Rank 0 writes ms a step (the slowest rank's),
img/s in all and a card, the world, the backend, the card, the first step's
loss, each rank's kernel launches a step (2 × accum of the route's kernel,
none of the others: checked), and the host's waits inside the timed window
(none expected). At world 1 it also times the same step without a mesh,
from the same state, batch and draws: the cost of the data-parallel
machinery on one card.

    python -m peclr_tpu_torch.scripts.bench_multichip [--world N]
        [--batch 128] [--accum 16] [--route grouped|nhwc|matmul] [--iters 4]
    python -m torch.distributed.run --nproc_per_node N \\
        -m peclr_tpu_torch.scripts.bench_multichip [...]

Scaling table (--scaling_table): the same global batch (--batch is the
GLOBAL microbatch here) on meshes of --mesh_sizes ranks, two chained steps
from the same seeded state, batch and global draws a mesh; the losses must
not depend on the mesh (the global-view NT-Xent and BatchNorm).  The
reference's configuration by default: RN18, microbatch 8, accum 2, 64² to
32², f32 with TF32 off.  A row uses NCCL up to the card count and gloo
beyond it (its ranks share the cards; gloo only on the CPU), and records
its backend.

    python -m peclr_tpu_torch.scripts.bench_multichip --scaling_table
        [--mesh_sizes 1,2,4,8]

On the card by default (`--device cpu` runs gloo ranks on the CPU, whose
times are not a device's).  Writes tests/fixtures/torch_bench/
multichip_weak.json or multichip_scaling.json (--out).
"""

from __future__ import annotations

import argparse
import copy
import math
import os
from concurrent.futures import ThreadPoolExecutor

import torch

from peclr_tpu_torch import scripts as common

#: --batch, --accum, --resnet, --canvas, --view, --precision of each mode:
#: weak scaling at the RN50 recipe, the scaling table at the reference's
#: configuration
DEFAULTS = {
    "weak": dict(batch=128, accum=16, resnet="50", canvas=224, view=128,
                 precision="bf16"),
    "table": dict(batch=8, accum=2, resnet="18", canvas=64, view=32,
                  precision="f32"),
}
#: the seeds of the batch and of the draws' generator: the smoke's pretrain
#: phase's, so that weak scaling's first step at world 1 is that phase's
BATCH_SEED, DRAW_SEED = 7, 8
WARMUP_STEPS = 2
#: the kernel each warp route launches, 2 × accum times a step
ROUTE_KERNEL = {"grouped": "shift_lerp_grouped", "nhwc": "shift_lerp_flat",
                "matmul": "shift_lerp_matmul"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=None,
                    help="microbatch rows a card (the GLOBAL microbatch "
                         "with --scaling_table)")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--resnet", default=None)
    ap.add_argument("--canvas", type=int, default=None)
    ap.add_argument("--view", type=int, default=None)
    ap.add_argument("--precision", choices=("bf16", "f32"), default=None,
                    help="the step's compute precision (f32 with TF32 off)")
    ap.add_argument("--scaling_table", action="store_true",
                    help="loss equality over --mesh_sizes at a fixed global "
                         "batch (--batch is the GLOBAL microbatch)")
    ap.add_argument("--mesh_sizes", default="1,2,4,8")
    ap.add_argument("--route", default="grouped",
                    help="warp route, or routes separated by commas (weak "
                         "scaling runs each in turn in the same ranks): "
                         "grouped, nhwc, matmul")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks to spawn for weak scaling (default: every "
                         "card; 1 on the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=900.0,
                    help="seconds a run of ranks (and each collective) may "
                         "take")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    mode = "table" if args.scaling_table else "weak"
    for key, value in DEFAULTS[mode].items():
        if getattr(args, key) is None:
            setattr(args, key, value)
    if args.out is None:
        args.out = os.path.join(common.BENCH_DIR, (
            "multichip_scaling.json" if args.scaling_table
            else "multichip_weak.json"))
    return args


def kernel_launches() -> dict:
    """Each warp kernel's launches so far in this process."""
    from peclr_tpu_torch.ops.shift_lerp import (
        fused_shift_lerp,
        fused_shift_lerp_grouped,
    )
    from peclr_tpu_torch.ops.shift_lerp_matmul import fused_shift_lerp_matmul

    return {"shift_lerp_grouped": fused_shift_lerp_grouped.launches,
            "shift_lerp_flat": fused_shift_lerp.launches,
            "shift_lerp_matmul": fused_shift_lerp_matmul.launches}


def _config(args) -> dict:
    return {k: getattr(args, k) for k in ("batch", "accum", "resnet",
                                          "canvas", "view", "precision",
                                          "route", "iters")}


def _routes(route: str) -> list:
    routes = route.split(",")
    unknown = [r for r in routes if r not in ROUTE_KERNEL]
    if unknown:
        raise ValueError(f"--route {unknown}: want some of "
                         f"{sorted(ROUTE_KERNEL)}")
    return routes


def _rank_batch(mesh, n: int, canvas: int, accum: int) -> dict:
    """This rank's rows of the seeded global batch of n canvases, on its
    device: made on the host, cut by shard_batch, copied over."""
    from peclr_tpu_torch.data.pipeline import host_to_device
    from peclr_tpu_torch.parallel.mesh import shard_batch
    from peclr_tpu_torch.train.recipe import synthetic_pretrain_batch

    whole = synthetic_pretrain_batch(n, canvas=canvas, seed=BATCH_SEED,
                                     device="cpu")
    return {k: host_to_device(v.contiguous(), mesh.device)
            for k, v in shard_batch(mesh, whole, accum).items()}


def _timed_steps(step, state, batch, gen, iters: int, device) -> dict:
    """The first step's loss, a second warm-up step, then `iters` steps
    queued back to back in one window: seconds, each kernel's launches a
    step in the window, the path of the last launch of kernels 1 and 3,
    and the host's waits in the window."""
    from peclr_tpu_torch.ops.shift_lerp import (
        fused_shift_lerp,
        fused_shift_lerp_grouped,
    )

    state, metrics = step(state, batch, gen)
    loss1 = metrics["loss"]
    for _ in range(WARMUP_STEPS - 1):
        state, metrics = step(state, batch, gen)
    fused_shift_lerp_grouped.last_path = fused_shift_lerp.last_path = None
    before = kernel_launches()
    waits = []

    def steps():
        nonlocal state, metrics
        for _ in range(iters):
            state, metrics = step(state, batch, gen)

    seconds = common.chained_seconds(
        lambda: waits.append(len(common.host_waits(steps))), device)
    after = kernel_launches()
    return {"seconds": seconds, "loss_step1": loss1.item(),
            "launches_per_step": {k: (after[k] - before[k]) / iters
                                  for k in after},
            "last_paths": {"shift_lerp_grouped":
                           fused_shift_lerp_grouped.last_path,
                           "shift_lerp_flat": fused_shift_lerp.last_path},
            "host_waits_in_window": waits[0]}


def weak_rank(mesh, cfg: dict) -> dict:
    """What each rank of weak scaling runs (module docstring): each route
    of cfg["route"] in turn from the seeded state, with the mesh, then (at
    world 1) without it."""
    import torch.distributed as dist

    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.train.recipe import build_pretrain_state
    from peclr_tpu_torch.train.step import make_peclr_train_step

    dev, world = mesh.device, mesh.size
    flags = peclr_pretrain_flags()
    params = AugmentationParams(resize_shape=(cfg["view"], cfg["view"]))
    batch = _rank_batch(mesh, cfg["batch"] * cfg["accum"] * world,
                        cfg["canvas"], cfg["accum"])
    routes = _routes(cfg["route"])
    out = {"rank": mesh.rank, "world": world, "backend": mesh.backend,
           "device": str(dev), "routes": {route: {} for route in routes}}
    for name in ("mesh", "no_mesh") if world == 1 else ("mesh",):
        model, state, opt = build_pretrain_state(
            cfg["resnet"], batch=cfg["batch"] * world, accum=cfg["accum"],
            device=dev)
        start = ({k: v.clone() for k, v in model.state_dict().items()},
                 copy.deepcopy(opt.state_dict()))
        for route in routes:
            model.load_state_dict(start[0])
            opt.load_state_dict(start[1])
            state.step = 0
            step = make_peclr_train_step(
                model, opt, flags, params, accum=cfg["accum"],
                warp_route=route, precision=cfg["precision"],
                with_stats=False, mesh=mesh if name == "mesh" else None)
            gen = torch.Generator(device=dev).manual_seed(DRAW_SEED)
            got = _timed_steps(step, state, batch, gen, cfg["iters"], dev)
            if name == "mesh":
                slowest = torch.tensor([got["seconds"]], device=dev)
                dist.all_reduce(slowest, op=dist.ReduceOp.MAX,
                                group=mesh.group)
                got["slowest_rank_seconds"] = slowest.item()
            out["routes"][route][name] = got
        del model, state, opt, start
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def _route_record(ranks: list, route: str, cfg: dict, images: int) -> dict:
    """One route's numbers, from every rank's; checks each rank's launches
    on the card (2 × accum of the route's kernel, none of the others)."""
    runs = [r["routes"][route] for r in ranks]
    if ranks[0]["device"].startswith("cuda"):
        for rank, got in enumerate(runs):
            for name, timed in got.items():
                want = {k: (2 * cfg["accum"] if k == ROUTE_KERNEL[route]
                            else 0) for k in timed["launches_per_step"]}
                if timed["launches_per_step"] != want:
                    raise AssertionError(
                        f"{route} rank {rank} {name}: kernel launches a step "
                        f"{timed['launches_per_step']}, want {want}")
    mesh = runs[0]["mesh"]
    seconds = mesh["slowest_rank_seconds"] / cfg["iters"]
    out = {
        "ms_per_step": seconds * 1e3,
        "img_per_s": images / seconds,
        "img_per_s_per_card": images / seconds / len(ranks),
        "loss_step1": mesh["loss_step1"],
        "ranks_loss_step1": [g["mesh"]["loss_step1"] for g in runs],
        "launches_per_step_per_rank": [g["mesh"]["launches_per_step"]
                                       for g in runs],
        "last_paths_per_rank": [g["mesh"]["last_paths"] for g in runs],
        "host_waits_in_window": sum(g["mesh"]["host_waits_in_window"]
                                    for g in runs),
    }
    if "no_mesh" in runs[0]:
        base = runs[0]["no_mesh"]
        base_s = base["seconds"] / cfg["iters"]
        out["no_mesh"] = {
            "ms_per_step": base_s * 1e3, "img_per_s": images / base_s,
            "loss_step1": base["loss_step1"],
            "launches_per_step": base["launches_per_step"],
            "last_paths": base["last_paths"],
            "host_waits_in_window": base["host_waits_in_window"]}
        out["mesh_over_no_mesh"] = seconds / base_s
        out["loss_step1_mesh_minus_no_mesh"] = (mesh["loss_step1"]
                                                - base["loss_step1"])
    return out


def weak_record(ranks: list, cfg: dict, dev: torch.device) -> dict:
    """The weak-scaling artifact, from every rank's result."""
    world = ranks[0]["world"]
    images = cfg["batch"] * cfg["accum"] * world
    return {
        "config": {**cfg, "with_stats": False},
        "world": world, "collective_backend": ranks[0]["backend"],
        "global_batch_per_step": images,
        "routes": {route: _route_record(ranks, route, cfg, images)
                   for route in _routes(cfg["route"])},
        "peak_mem_bytes": ranks[0].get("peak_mem_bytes"),
        "backend": dev.type, "device": common.card_name(dev),
        "cpu_cores": common.cpu_cores(), "torch": torch.__version__,
    }


def weak_scaling(args) -> dict:
    """Weak scaling, spawned here or as this rank under
    torch.distributed.run (WORLD_SIZE set)."""
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.parallel.dryrun import spawn
    from peclr_tpu_torch.parallel.mesh import make_mesh

    cfg = _config(args)
    _routes(cfg["route"])
    if "WORLD_SIZE" in os.environ:
        mesh = make_mesh(device=args.device, timeout=args.timeout)
        try:
            rec = weak_rank(mesh, cfg)
            ranks = [None] * mesh.size
            torch.distributed.all_gather_object(ranks, rec, group=mesh.group)
        finally:
            mesh.close()
        if rec["rank"] != 0:
            return rec
        dev = torch.device(rec["device"])
    else:
        dev = resolve_device(args.device)
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        world = args.world or (cards if dev.type == "cuda" else 1)
        if dev.type == "cuda" and world > cards:
            raise ValueError(f"--world {world} on {cards} cards: weak scaling "
                             "runs one rank a card (ranks that share a card "
                             "do not measure speed)")
        ranks = spawn(weak_rank, world, args=(cfg,),
                      device="cuda" if dev.type == "cuda" else "cpu",
                      timeout=args.timeout)
    record = weak_record(ranks, cfg, dev)
    for route, got in record["routes"].items():
        print(f"{route}: world {record['world']} "
              f"({record['collective_backend']}): {got['ms_per_step']:.1f} "
              f"ms/step  {got['img_per_s']:.0f} img/s  "
              f"{got['img_per_s_per_card']:.0f} img/s/card  loss "
              f"{got['loss_step1']:.6f}", flush=True)
    common.write_artifact(args.out, record)
    return record


def table_rank(mesh, cfg: dict) -> list:
    """Two chained steps of the scaling table on this rank's rows: the
    losses of both."""
    from peclr_tpu_torch.config.defaults import (
        AugmentationParams,
        peclr_pretrain_flags,
    )
    from peclr_tpu_torch.train.recipe import build_pretrain_state
    from peclr_tpu_torch.train.step import make_peclr_train_step

    model, state, opt = build_pretrain_state(
        cfg["resnet"], batch=cfg["batch"], accum=cfg["accum"],
        device=mesh.device)
    step = make_peclr_train_step(
        model, opt, peclr_pretrain_flags(),
        AugmentationParams(resize_shape=(cfg["view"], cfg["view"])),
        accum=cfg["accum"], warp_route=cfg["route"],
        precision=cfg["precision"], with_stats=False, mesh=mesh)
    batch = _rank_batch(mesh, cfg["batch"] * cfg["accum"], cfg["canvas"],
                        cfg["accum"])
    gen = torch.Generator(device=mesh.device).manual_seed(DRAW_SEED)
    losses = []
    for _ in range(2):
        state, metrics = step(state, batch, gen)
        losses.append(metrics["loss"])
    return [loss.item() for loss in losses]


def scaling_table(args) -> dict:
    """The same global batch on meshes of each of --mesh_sizes ranks: two
    chained steps' losses a mesh (module docstring)."""
    from peclr_tpu_torch.device import resolve_device
    from peclr_tpu_torch.parallel.dryrun import spawn

    dev = resolve_device(args.device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    sizes = [int(s) for s in args.mesh_sizes.split(",")]
    cfg = _config(args)
    backends = ["nccl" if dev.type == "cuda" and n <= cards else "gloo"
                for n in sizes]

    def mesh_of(n, backend):
        return spawn(table_rank, n, args=(cfg,),
                     device="cuda" if dev.type == "cuda" else "cpu",
                     backend=backend, timeout=args.timeout)

    # the meshes run side by side: their losses, not their times, count
    with ThreadPoolExecutor(len(sizes)) as pool:
        results = list(pool.map(mesh_of, sizes, backends))
    rows = []
    for n, backend, ranks in zip(sizes, backends, results):
        if any(r != ranks[0] for r in ranks):
            raise AssertionError(f"mesh {n}: the ranks' losses differ: {ranks}")
        if not all(math.isfinite(v) for v in ranks[0]):
            raise AssertionError(f"mesh {n}: losses {ranks[0]}")
        rows.append({"mesh": n, "loss_step1": ranks[0][0],
                     "loss_step2": ranks[0][1], "backend": backend,
                     "ranks_a_card": (max(1, math.ceil(n / cards))
                                      if cards else None)})
        print(f"mesh {n} ({backend}): loss1={rows[-1]['loss_step1']:.6f} "
              f"loss2={rows[-1]['loss_step2']:.6f}", flush=True)
    base = rows[0]
    rel = max(abs(r[k] / base[k] - 1.0) for r in rows
              for k in ("loss_step1", "loss_step2"))
    artifact = {
        "config": {
            "global_microbatch": args.batch, "accum": args.accum,
            "resnet": args.resnet, "canvas": args.canvas, "view": args.view,
            "platform": dev.type, "mesh_sizes": sizes, "route": args.route,
            "precision": args.precision, "tf32": False,
        },
        "rows": rows,
        "max_rel_to_mesh1": rel,
        "backend": dev.type,
        "device": common.card_name(dev),
        "cards": cards,
        "cpu_cores": common.cpu_cores(),
        "torch": torch.__version__,
    }
    common.write_artifact(args.out, artifact)
    return artifact


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.scaling_table:
        return scaling_table(args)
    return weak_scaling(args)


if __name__ == "__main__":
    main()
