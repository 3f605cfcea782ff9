"""End-to-end driver on the PyTorch/CUDA port: train a ~100M-parameter LM
on synthetic Markov data, with checkpointing (the counterpart of
``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--tiny]
        [--device cpu] [--ckpt-dir DIR]

The default config is a genuine ~105M-parameter llama-family model (8
layers, d 768, 12 heads / 4 K/V, d_ff 2048, 32k vocab); ``--tiny`` takes
2 layers at d 128 for a seconds-scale smoke of the same driver.  With
``--ckpt-dir`` it saves every 100 steps and at the end, and a rerun
resumes from the latest checkpoint; without it nothing is written.  On the
card by default; ``--device cpu`` runs on the CPU; without a card and
without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import get_model
from repro_torch.models.params import count_params
from repro_torch.training import checkpoint as ckpt
from repro_torch.training import optimizer as opt
from repro_torch.training.data import SyntheticData
from repro_torch.training.train_step import make_train_step


def lm_100m():
    return get_config("tinyllama-1.1b").replace(
        name="llama-100m", n_layers=8, d_model=768, n_heads=12,
        n_kv_heads=4, d_ff=2048, vocab=32000)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = lm_100m()
    if args.tiny:
        cfg = cfg.replace(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                          d_ff=256, vocab=2048)
    model = get_model(cfg)
    nparams = count_params(model.specs())
    print(f"{cfg.name}: {nparams / 1e6:.1f}M params")

    shape = ShapeSpec("train", seq_len=128, global_batch=16, kind="train")
    data = SyntheticData(cfg, shape, device=device)
    ocfg = opt.AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)

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

    step = make_train_step(model, ocfg)
    mets = None
    for i in range(start, args.steps):
        params, state, mets = step(params, state, data.batch_at(i))
        if (i + 1) % 20 == 0 or i == start:
            print(f"step {i + 1:4d} loss={float(mets['loss']):.4f} "
                  f"gnorm={float(mets['grad_norm']):.3f}", flush=True)
        if args.ckpt_dir and (i + 1) % 100 == 0:
            ckpt.save(args.ckpt_dir, i + 1,
                      (dict(params.named_parameters()), state))
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps,
                  (dict(params.named_parameters()), state))
    final = float(mets["loss"]) if mets is not None else float("nan")
    print(f"final loss: {final:.3f}")
    return {"params": nparams, "final_loss": final}


if __name__ == "__main__":
    main()
