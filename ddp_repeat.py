#!/usr/bin/env python3
"""How far identical training runs part when they share one CUDA card.

    python3 ddp_repeat.py [--rounds 2] [--out record.json]

Each round starts six processes of ``python -m dexiraft_tpu_torch train``
together on one card: two identical 2-rank runs (torchrun's variables,
both ranks on cuda:0, so gloo) and two identical one-process runs, all v1
on B1 (``--corr_impl flash --fused_update``) at the chairs crop, global
batch 4, 4 steps, on chip_smoke.py's synthetic FlyingChairs tree (20
training pairs, 384x512, seed 0). For each pair of twins, and for a 2-rank
run against a one-process run, it prints one JSON line: the per-step
losses' relative differences and the step-4 states' relative L2 (every
floating tensor of the checkpoints). Twins that repeat their steps bit
for bit read 0. The train step takes cuDNN's untimed (mode-B heuristic)
pick of each convolution's algorithm (train/step.py,
``train_arithmetic``); under a timed search, processes that share the
card picked differently from run to run and the twins parted from step
3. Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CLI = ["--stage", "chairs", "--corr_impl", "flash", "--fused_update",
       "--batch_size", "4", "--sum_freq", "1", "--num_workers", "2",
       "--val_freq", "4", "--log_dir", "runs", "--num_steps", "4"]
# name -> world size; the twins differ in name only
RUNS = {"pair_a": 2, "pair_b": 2, "one_a": 1, "one_b": 1}


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(root: str, env: dict, name: str, world: int) -> list:
    port, procs = free_port(), []
    for r in range(world):
        renv = dict(env)
        if world > 1:
            renv.update(RANK=str(r), WORLD_SIZE=str(world),
                        LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world),
                        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "dexiraft_tpu_torch", "train"] + CLI
            + ["--name", name, "--device",
               "cuda:0" if world > 1 else "cuda"],
            cwd=root, env=renv, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def one_round(torch, root: str, env: dict, tag: str) -> dict:
    from dexiraft_tpu_torch.train import checkpoint as ckpt

    names = {f"{tag}{k}": w for k, w in RUNS.items()}
    t0 = time.perf_counter()
    procs = [p for n, w in names.items() for p in launch(root, env, n, w)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            if p.returncode:
                raise SystemExit(f"ddp_repeat: a run exited {p.returncode}: "
                                 f"{out[-1500:]} {err[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    losses, states = {}, {}
    for n in names:
        with open(os.path.join(root, "runs", n, "metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses[n] = {r["step"]: r["loss"] for r in rows if "loss" in r}
        sd = ckpt.load_payload(os.path.join(root, "checkpoints", n),
                               step=4)["model"]
        states[n] = torch.cat([v.double().reshape(-1) for v in sd.values()
                               if v.is_floating_point()])

    def part(a, b):
        a, b = tag + a, tag + b
        return {"loss_rel_diff": {s: abs(losses[a][s] - losses[b][s])
                                  / abs(losses[b][s]) for s in losses[b]},
                "state_rel_l2": float((states[a] - states[b]).norm()
                                      / states[b].norm())}

    return {"seconds": time.perf_counter() - t0,
            "pair_twins": part("pair_a", "pair_b"),
            "one_process_twins": part("one_a", "one_b"),
            "pair_vs_one_process": part("pair_a", "one_a")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None,
                    help="also write every round's record to this JSON file")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ddp_repeat: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from dexiraft_tpu_torch.data.synthetic import write_chairs_tree

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    rounds = []
    with tempfile.TemporaryDirectory(prefix="ddp_repeat_") as root:
        write_chairs_tree(root, n_train=20, n_val=4, hw=(384, 512), seed=0)
        env = dict(os.environ, DEXIRAFT_DATA_DIR=root, OMP_NUM_THREADS="2",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get(
                       "PYTHONPATH", ""))
        for i in range(args.rounds):
            rec = {"round": i, "card": smi,
                   **one_round(torch, root, env, f"r{i}_")}
            rounds.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rounds, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
