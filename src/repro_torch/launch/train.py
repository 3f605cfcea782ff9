"""Training launcher: end-to-end driver with checkpoint and restart, as
``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 200 --batch 8 --seq 128 --ckpt-dir ckpt --device cpu

Runs on the card unless ``--device cpu``.  Started under the multi-process
harness (``distributed.multihost.launch_workers``, or any launch that sets
its ``RPCA_*`` variables) it joins the process group, puts every rank on
one ``data`` axis (``multihost.multihost_mesh(("data",))``) and each rank
takes its shard of the global batch; otherwise it runs on one device.
``--robust-agg`` aggregates the gradients by DCF-PCA consensus over the
ranks (it needs them: on one device it raises, as the reference does).

Fault tolerance: resumes from the latest durable checkpoint of ``(params,
optimizer state)`` (the step count is the data cursor) and saves every
``--ckpt-every`` steps and after the last step (once); a killed and
relaunched run ends on the bits of an uninterrupted one.  The loss and metrics are read on the
host only every ``--log-every`` steps.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.distributed import multihost as mh
from repro_torch.distributed.grad_compress import CompressConfig
from repro_torch.distributed.sharding import ShardingRules, rules_for_mesh
from repro_torch.models import get_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.data import SyntheticData, fold_in
from repro_torch.training.train_step import (
    make_robust_train_step, make_train_step,
)

#: The robust step's sketch seed; step i draws from ``fold_in(KEY, i)``.
KEY = 42


def _join_group() -> tuple[bool, bool]:
    """``(ranks, joined_here)``: whether this process runs as one of
    several ranks, and whether this call joined the group."""
    import torch.distributed as dist

    joined = False
    if not dist.is_initialized():
        joined = mh.initialize_from_env()
    ranks = dist.is_initialized() and dist.get_world_size() > 1
    return ranks, joined


def _barrier(ranks: bool) -> None:
    if ranks:
        import torch.distributed as dist

        dist.barrier()


def main(argv=None, *, cfg: ModelConfig | None = None,
         weight_decay: float | None = None) -> dict:
    """Train; returns ``{"final_loss", "steps", "log", "params",
    "opt_state"}`` (``log``: one entry a logged step, its loss, grad norm,
    lr and host seconds since the first step).  ``cfg`` trains that
    config in place of ``--arch``'s (a caller's cut of the depth);
    ``weight_decay`` replaces ``AdamWConfig``'s (at 0 only the gradients
    move the parameters, which a caller's check can then see)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--robust-agg", action="store_true",
                    help="DCF-PCA consensus gradient aggregation (paper "
                         "technique) instead of plain all-reduce")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke \
            else get_config(args.arch)
    model = get_model(cfg)
    ranks, joined = _join_group()
    if ranks:
        import torch.distributed as dist

        mesh = mh.multihost_mesh(("data",), device=device)
        rules = rules_for_mesh(mesh)
        comm = mh.MeshComm(mesh, ("data",))
        lead = dist.get_rank() == 0
        mesh_shape = list(mesh.mesh.shape)
    else:
        mesh, rules, comm, lead, mesh_shape = (None, ShardingRules(), None,
                                               True, None)
    data = SyntheticData(cfg, ShapeSpec("train", args.seq, args.batch,
                                        "train"), device=device)
    ocfg = opt.AdamWConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5),
                           total_steps=args.steps)
    if weight_decay is not None:
        ocfg = dataclasses.replace(ocfg, weight_decay=weight_decay)

    if args.robust_agg:
        step = make_robust_train_step(model, ocfg, mesh, rules,
                                      CompressConfig())
    else:
        step = make_train_step(model, ocfg, rules,
                               microbatches=args.microbatches, comm=comm)

    params = model.init_params(seed=0, device=device)
    state = opt.init(params)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        (named, state), start = ckpt.restore(
            args.ckpt_dir, (dict(params.named_parameters()), state))
        with torch.no_grad():
            for name, p in params.named_parameters():
                p.copy_(named[name])
        print(f"resumed from step {start}")

    def save(at: int) -> int:
        if lead:
            ckpt.save(args.ckpt_dir, at,
                      (dict(params.named_parameters()), state),
                      mesh_shape=mesh_shape)
        _barrier(ranks)
        return at

    saved = None

    t0 = time.time()
    last_loss = float("nan")
    log = []
    for i in range(start, args.steps):
        batch = data.batch_at(i)
        if args.robust_agg:
            params, state, mets = step(params, state, batch, fold_in(KEY, i))
        else:
            params, state, mets = step(params, state, batch)
        if (i + 1) % args.log_every == 0 or i == start:
            last_loss = float(mets["loss"])
            seconds = time.time() - t0
            log.append({"step": i + 1, "loss": last_loss,
                        "grad_norm": float(mets["grad_norm"]),
                        "lr": float(mets["lr"]), "seconds": seconds})
            print(f"step {i + 1:5d} loss={last_loss:.4f} "
                  f"gnorm={log[-1]['grad_norm']:.3f} "
                  f"lr={log[-1]['lr']:.2e} "
                  f"{(i + 1 - start) / max(seconds, 1e-9):.2f} it/s",
                  flush=True)
        if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
            saved = save(i + 1)
    if args.ckpt_dir and saved != args.steps:
        save(args.steps)
    if joined:
        mh.shutdown()
    return {"final_loss": last_loss, "steps": args.steps, "log": log,
            "params": params, "opt_state": state}


if __name__ == "__main__":
    main()
