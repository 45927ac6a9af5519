"""Whether the accuracy curves' step-0 probe repeats across processes, and
where RN152's step-0 probe lands in bf16 and in f32.  A diagnostic kept
beside the curve artifacts it was asked about, not a module of the package:
the determinism and precision switches it sets live in its worker
processes only.  From the root of the repository, on the card:

    PYTHONPATH=. python tests/fixtures/torch_accuracy/step0_probe.py \\
        --out out/step0_probe.json

Each worker does what the curve does before its first step
(peclr_tpu_torch/scripts/accuracy_proxy.py): the probe frames of the seed
(render_batch of default_rng(seed), 4096 frames), the weights
init_as_reference(PeCLRModel(resnet), seed) moved to the card, the
embedding of every frame at view 128 (make_embed: eval mode, bf16
autocast) and linear_probe's EPE over 3072 training frames.  It records an
integer digest of the weights on the card, the SHA-256 of the embedding's
bytes, the EPEs, and the digest of every leaf module's output on the first
256 frames (in the order the modules ran).  The runs:

  concurrent  three workers at once, bf16 (RN50 seed 7, RN152 seeds 5-7)
  pressure    one worker while another process holds about 90% of the
              card's memory
  deterministic  (only when the first two differ) three workers at once
              under torch.use_deterministic_algorithms(True) and
              cudnn.deterministic, set in the workers
  f32         one worker with autocast off and TF32 off, and each RN152
              seed's leaf modules in bf16 against f32 on 16 frames (the
              largest relative differences, in the order they ran)
  spread      RN152 seeds 8-15 in bf16, the step-0 EPE's spread over draws

One JSON report goes to --out, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

CONFIGS = (("50", 7), ("152", 5), ("152", 6), ("152", 7))
SPREAD = tuple(("152", s) for s in range(8, 16))
NUM_IMAGES, PROBE_TRAIN, VIEW, CHUNK = 4096, 3072, 128, 256
COMPARE_FRAMES = 16  # frames of the bf16 against f32 comparison
HOG_SHARE = 0.9  # of the card's memory the pressure run leaves to others
#: the reference's step-0 probe EPE on the TPU (bench_artifacts/
#: accuracy_curves_rn152*.json, accuracy_curves_rn50_seed7.json)
TPU_STEP0 = {("152", 5): 8.423357857855487, ("152", 6): 9.860599885320793,
             ("152", 7): 9.948908453988613, ("50", 7): 10.122468028695913}
WORKER_TIMEOUT_S = 1200


def digest(t: torch.Tensor) -> list:
    """Two integer sums over the bits of t (as chip_smoke.py's
    output_digest): equal for equal bits, moved by any one element."""
    x = t.detach().reshape(-1)
    bits = {8: torch.int64, 4: torch.int32, 2: torch.int16,
            1: torch.uint8}[x.element_size()]
    x = x.view(bits).to(torch.int64)
    return [int(x.sum()), int((x * x).sum())]


def leaf_modules(model):
    return [(n, m) for n, m in model.named_modules()
            if not list(m.children())]


def module_digests(model, run) -> list:
    """[(module, digest)] of every leaf module's output while run() runs."""
    out = []
    hooks = [m.register_forward_hook(
        lambda _m, _i, o, name=name: out.append((name, digest(o))))
        for name, m in leaf_modules(model)]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return out


def make_embed_f32(model):
    """accuracy_proxy.make_embed without its autocast."""
    from peclr_tpu_torch.data.pipeline import host_to_device
    from peclr_tpu_torch.ops.image import normalize_imagenet

    dev = next(model.parameters()).device

    @torch.inference_mode()
    def embed(images_u8):
        model.eval()
        x = normalize_imagenet(host_to_device(images_u8, dev).float() / 255.0)
        return model(x)["embedding"].float()

    return embed


def bf16_against_f32(model, small) -> list:
    """[(module, max |bf16 - f32| / max |f32|)] of every leaf module's output
    on `small` frames, in the order the modules ran."""
    from peclr_tpu_torch.scripts.accuracy_proxy import make_embed

    f32 = {}
    hooks = [m.register_forward_hook(
        lambda _m, _i, o, name=name: f32.__setitem__(name, o.float().clone()))
        for name, m in leaf_modules(model)]
    make_embed_f32(model)(small)
    for h in hooks:
        h.remove()
    rel = []

    def compare(_m, _i, o, name):
        ref = f32[name]
        rel.append((name, ((o.float() - ref).abs().max()
                           / ref.abs().max().clamp_min(1e-30)).item()))

    hooks = [m.register_forward_hook(
        lambda m_, i_, o, name=name: compare(m_, i_, o, name))
        for name, m in leaf_modules(model)]
    make_embed(model)(small)
    for h in hooks:
        h.remove()
    return rel


def worker(spec: dict) -> dict:
    """One worker process's configs (module docstring)."""
    import cv2

    from peclr_tpu_torch.models import PeCLRModel
    from peclr_tpu_torch.scripts import init_as_reference
    from peclr_tpu_torch.scripts.accuracy_proxy import (
        linear_probe,
        make_embed,
        render_batch,
    )

    if spec["deterministic"]:
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    f32 = spec["precision"] == "f32"
    if f32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(spec.get("device", "cuda"))
    frames = {}
    results = []
    for resnet, seed in spec["configs"]:
        t0 = time.time()
        if seed not in frames:
            frames[seed] = render_batch(np.random.default_rng(seed),
                                        NUM_IMAGES)
        imgs, joints = frames[seed]
        model = init_as_reference(PeCLRModel(resnet), seed).to(dev)
        embed = (make_embed_f32 if f32 else make_embed)(model)
        chunks = []

        def recording(x, embed=embed, chunks=chunks):
            e = embed(x)
            chunks.append(e)
            return e

        epe = linear_probe(recording, imgs, joints, VIEW, PROBE_TRAIN, seed)
        emb = torch.cat(chunks).cpu().numpy()
        small = np.stack([cv2.resize(im, (VIEW, VIEW))
                          for im in imgs[:CHUNK]])
        modules = module_digests(model, lambda: embed(small))
        row = {"resnet": resnet, "seed": seed,
               "precision": spec["precision"],
               "deterministic": spec["deterministic"],
               "weights_digest": [sum(v) for v in zip(*(
                   digest(p) for p in model.state_dict().values()))],
               "embedding_sha256": hashlib.sha256(emb.tobytes()).hexdigest(),
               "embedding_abs_max": float(np.abs(emb).max()),
               "probe_epe_px": epe["abs"], "probe_epe_rel_px": epe["rel"],
               "module_digests": modules}
        if spec.get("compare") and resnet == "152":
            row["bf16_against_f32"] = bf16_against_f32(
                model, small[:COMPARE_FRAMES])
        row["seconds"] = time.time() - t0
        results.append(row)
        del model, embed, chunks
        torch.cuda.empty_cache()
    return {"pid": os.getpid(), "results": results}


def hog(ready: str) -> int:
    """Hold HOG_SHARE of the card's memory, written to, until stopped."""
    free, total = torch.cuda.mem_get_info()
    held = torch.empty(int(min(HOG_SHARE * total, free - 2**30)),
                       dtype=torch.uint8, device="cuda").fill_(1)
    torch.cuda.synchronize()
    with open(ready, "w") as fh:
        fh.write(str(held.numel()))
    time.sleep(WORKER_TIMEOUT_S)
    return 0


def spawn(tmp: str, name: str, spec: dict, env: dict):
    path = os.path.join(tmp, name + ".json")
    log = open(os.path.join(tmp, name + ".log"), "w")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--worker", path,
         json.dumps(spec)], stdout=log, stderr=subprocess.STDOUT, env=env)
    return proc, path, log


def collect(runs) -> list:
    out = []
    for proc, path, log in runs:
        rc = proc.wait(timeout=WORKER_TIMEOUT_S)
        log.close()
        if rc != 0:
            with open(log.name) as fh:
                raise RuntimeError(f"worker {path} exit {rc}:\n"
                                   f"{fh.read()[-4000:]}")
        with open(path) as fh:
            out.append(json.load(fh))
    return out


def first_difference(a: dict, b: dict):
    """The first leaf module whose output digest differs between two rows
    of one config, or None."""
    for (name, da), (_, db) in zip(a["module_digests"], b["module_digests"]):
        if da != db:
            return name
    return None


def compare(runs: list) -> dict:
    """For each config: whether the weights, embeddings and EPEs of every
    run are equal to the bit, the EPEs, and the first module that differs
    from the first run."""
    out = {}
    for i, (resnet, seed) in enumerate(CONFIGS):
        rows = [r["results"][i] for r in runs]
        out[f"rn{resnet}_seed{seed}"] = {
            "weights_equal": len({tuple(r["weights_digest"])
                                  for r in rows}) == 1,
            "embeddings_equal": len({r["embedding_sha256"]
                                     for r in rows}) == 1,
            "probe_epe_px": [r["probe_epe_px"] for r in rows],
            "probe_epe_rel_px": [r["probe_epe_rel_px"] for r in rows],
            "first_differing_module": [first_difference(rows[0], r)
                                       for r in rows[1:]],
        }
    return out


def strip(run: dict) -> dict:
    """A run without its module digests (they stay in the comparison)."""
    return {"pid": run["pid"], "results": [
        {k: v for k, v in r.items() if k != "module_digests"}
        for r in run["results"]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("step0_probe: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env = dict(os.environ, PYTHONPATH=repo,
               CUBLAS_WORKSPACE_CONFIG=":4096:8")
    configs = [list(c) for c in CONFIGS]
    bf16 = {"configs": configs, "precision": "bf16", "deterministic": False}
    report = {"card": card, "configs": configs, "tpu_step0_px": {
        f"rn{r}_seed{s}": v for (r, s), v in TPU_STEP0.items()}}
    tmp = tempfile.mkdtemp(prefix="step0_probe_")
    t0 = time.time()
    concurrent = collect([spawn(tmp, f"concurrent{i}", bf16, env)
                          for i in range(3)])
    report["concurrent_seconds"] = time.time() - t0

    ready = os.path.join(tmp, "hog_ready")
    hog_proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--hog", ready], env=env)
    try:
        while not os.path.exists(ready):
            if hog_proc.poll() is not None:
                raise RuntimeError(f"the memory hog exited {hog_proc.poll()}")
            time.sleep(0.2)
        with open(ready) as fh:
            report["hog_bytes"] = int(fh.read())
        pressure = collect([spawn(tmp, "pressure", bf16, env)])
    finally:
        hog_proc.terminate()
        hog_proc.wait(timeout=60)
    runs = concurrent + pressure
    report["bf16"] = compare(runs)
    report["bf16_repeats"] = all(
        c["weights_equal"] and c["embeddings_equal"]
        for c in report["bf16"].values())
    if not report["bf16_repeats"]:
        det = collect([spawn(tmp, f"deterministic{i}",
                             {**bf16, "deterministic": True}, env)
                       for i in range(3)])
        report["deterministic"] = compare(det)
        report["deterministic_runs"] = [strip(r) for r in det]

    f32 = collect([spawn(tmp, "f32", {"configs": configs, "precision": "f32",
                                      "deterministic": False,
                                      "compare": True}, env)])[0]
    report["f32"] = {f"rn{r['resnet']}_seed{r['seed']}": {
        "probe_epe_px": r["probe_epe_px"],
        "probe_epe_rel_px": r["probe_epe_rel_px"],
        "embedding_abs_max": r["embedding_abs_max"],
        "bf16_against_f32_largest": sorted(
            r.get("bf16_against_f32", []), key=lambda kv: -kv[1])[:12],
        "bf16_against_f32_in_order": r.get("bf16_against_f32")}
        for r in f32["results"]}
    spread = collect([spawn(tmp, "spread", {
        "configs": [list(c) for c in SPREAD], "precision": "bf16",
        "deterministic": False}, env)])[0]
    report["spread_rn152_bf16"] = {r["seed"]: r["probe_epe_px"]
                                   for r in spread["results"]}
    report["runs"] = [strip(r) for r in runs]
    report["seconds"] = time.time() - t0
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({k: report[k] for k in (
        "card", "bf16_repeats", "bf16", "spread_rn152_bf16")}))
    print(json.dumps({k: {c: {kk: vv for kk, vv in v.items()
                              if kk != "bf16_against_f32_in_order"}
                          for c, v in report[k].items()}
                      for k in ("f32",)}))
    if "deterministic" in report:
        print(json.dumps({"deterministic": report["deterministic"]}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        result = worker(json.loads(sys.argv[3]))
        with open(sys.argv[2], "w") as fh:
            json.dump(result, fh)
        sys.exit(0)
    if sys.argv[1:2] == ["--hog"]:
        sys.exit(hog(sys.argv[2]))
    sys.exit(main())
