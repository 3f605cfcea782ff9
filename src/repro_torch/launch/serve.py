"""Serving launcher: batched generation with random weights, as
``repro/launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --smoke --batch 4 --prompt-len 32 --new-tokens 32 [--device cpu]

The archs whose prefill takes tokens alone: the dense ones,
``mamba2-780m`` (ssm), ``qwen2-moe-a2.7b`` and ``deepseek-v2-236b`` (moe;
at full size deepseek-v2's 236B parameters do not fit one card) and
``jamba-1.5-large-398b`` (hybrid; nor do its 398B: ``--smoke`` on the
CPU).  ``llama-3.2-vision-11b`` and ``whisper-small`` need a context (image
patches or audio frames) that the launcher does not make: they raise
``ValueError``, as the reference's launcher fails at its prefill
(``serving.engine.generate(..., ctx=...)`` serves them).

Weights come from seed 0 and the prompt from seed 1, each a generator on
the device.  ``--flash-attention`` sets the config's ``flash_attention``
field (prefill through the flash kernel).  Runs on the CUDA card unless
``--device cpu``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import CONTEXT_FAMILIES, get_model
from repro_torch.serving.engine import ServeConfig, generate


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="tinyllama-1.1b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--flash-attention", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.family in CONTEXT_FAMILIES:
        raise ValueError(f"{args.arch}: the {cfg.family!r} family needs a "
                         f"ctx, which the launcher does not make")
    if args.flash_attention:
        cfg = cfg.replace(flash_attention=True)
    device = resolve_device(args.device)
    model = get_model(cfg)
    params = model.init_params(seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                           generator=gen, device=device)
    t0 = time.time()
    out = generate(model, params, prompt,
                   ServeConfig(max_new_tokens=args.new_tokens,
                               temperature=args.temperature), generator=gen)
    first = out[0].tolist()  # waits for the device
    dt = time.time() - t0
    tps = args.batch * args.new_tokens / dt
    print(f"generated {tuple(out.shape)} in {dt:.1f}s ({tps:.1f} tok/s, "
          f"incl. compile)")
    print("first row:", first)
    return {"tokens_per_s": tps}


if __name__ == "__main__":
    main()
