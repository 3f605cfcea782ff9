"""Each step's loss of the training launcher for one architecture at full
width and depth, for every learning rate and dtype asked for.

    PYTHONPATH=src python src/repro_torch/launch/train_losses.py \\
        --lr 3e-3 --lr 4e-4 --dtype bfloat16 --dtype float32

Every (lr, dtype) pair is one run of ``launch/train.py``'s ``main`` from
the same initial parameters (seed 0) and batches (remat "full", TF32
off), its parameters and compute in ``dtype``.  Prints the card's
``nvidia-smi`` name and power limit, then one JSON line a run: its losses,
the means of its first and last five, its median step ms after two
warm-up steps and its peak memory.  Runs on the card unless ``--device
cpu``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.launch import train


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama-1.1b")
    ap.add_argument("--lr", type=float, action="append")
    ap.add_argument("--dtype", action="append",
                    choices=("bfloat16", "float32"))
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if card:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    runs = []
    for dtype in args.dtype or ["bfloat16"]:
        for lr in args.lr or [3e-3]:
            cfg = get_config(args.arch).replace(param_dtype=dtype,
                                                compute_dtype=dtype)
            if card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            out = train.main(
                ["--arch", args.arch, "--steps", str(args.steps), "--batch",
                 str(args.batch), "--seq", str(args.seq), "--lr", str(lr),
                 "--log-every", "1", "--device", str(device)], cfg=cfg)
            losses = [e["loss"] for e in out["log"]]
            ts = [e["seconds"] for e in out["log"]]
            step_ms = [1e3 * (b - a) for a, b in zip([0.0] + ts[:-1], ts)]
            run = dict(arch=args.arch, layers=cfg.n_layers, dtype=dtype,
                       lr=lr, batch=args.batch, seq=args.seq,
                       steps=args.steps, remat=cfg.remat, losses=losses,
                       mean_first5=sum(losses[:5]) / 5,
                       mean_last5=sum(losses[-5:]) / 5,
                       median_step_ms=statistics.median(step_ms[2:]),
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9
                       if card else None)
            print(json.dumps(run), flush=True)
            runs.append(run)
            del out
    return runs


if __name__ == "__main__":
    main()
