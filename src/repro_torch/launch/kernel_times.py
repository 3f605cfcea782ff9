"""Time the redesigned kernels' rows on the card, one JSON line each.

    PYTHONPATH=<tree>/src python src/repro_torch/launch/kernel_times.py

Runs the ``repro_torch`` found on ``PYTHONPATH``, so the same script times
another checkout's kernels (for example the parent commit's, unpacked with
``git archive``) through the same public wrappers at the same shapes; run
the two trees in turns in one session on one card to compare them.  Rows:
``flash_attention`` bf16 at the serving shape (A) and fp32 at three small
shapes (s, a, x); ``huber_contract_v`` at the Fig. 1 client blocks (F), the
one-client plane (C), the compact-plane blocks in fp32 with a dense mask
(D) and in bf16 with a packed mask (D16).  Each row gives the CUDA-event
time per call over 20 calls after 3 of warm-up (``ms``: what a caller
waits, the wrapper's host work included when it exceeds the kernel) and
the profiler's device time of the kernels per call (``device_ms``).
Operands are random from a fixed seed (the kernels' time does not depend
on the values).  Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import json
import subprocess
import sys

import torch

FLASH_ROWS = {  # (B, S_q, S_kv, H, d, causal, dtype)
    "A": (4, 2048, 2048, 32, 128, True, torch.bfloat16),
    "s": (2, 33, 33, 4, 32, True, torch.float32),
    "a": (1, 256, 256, 4, 64, True, torch.float32),
    "x": (2, 64, 200, 2, 64, False, torch.float32),
}
V_ROWS = {  # (E, m, n_i, r, dtype, mask)
    "F": (10, 3000, 300, 150, torch.float32, "none"),
    "C": (1, 3000, 3000, 150, torch.float32, "none"),
    "D": (4, 2048, 512, 64, torch.float32, "dense"),
    "D16": (4, 2048, 512, 64, torch.bfloat16, "packed"),
}
CALLS, WARMUP = 20, 3


def event_ms(fn) -> float:
    for _ in range(WARMUP):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(CALLS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / CALLS


def device_ms(fn) -> float:
    """Summed device time of every kernel the calls launch, per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e3 / CALLS


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import bitmask
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import huber_contract as hc

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tree = repro_torch.__file__
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (b, sq, skv, h, d, causal, dtype) in FLASH_ROWS.items():
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
                   .to(dtype) for s in (sq, skv, skv))

        def run():
            return fa.flash_attention(q, k, v, causal=causal)

        print(json.dumps(dict(tree=tree, row=f"flash_attention/{name}",
                              ms=event_ms(run), device_ms=device_ms(run),
                              card=smi)), flush=True)
    for name, (e, m, n, r, dtype, mode) in V_ROWS.items():
        u = torch.randn(e, m, r, generator=gen, device=dev) / r ** 0.5
        v = torch.randn(e, n, r, generator=gen, device=dev) / r ** 0.5
        mat = (2 * torch.randn(e, m, n, generator=gen, device=dev)).to(dtype)
        w = (torch.rand(e, m, n, generator=gen, device=dev) < 0.7).float()
        w = {"none": None, "dense": w, "packed": bitmask.pack_mask(w)}[mode]
        lam = torch.ones(e, device=dev)

        def run():
            return hc.huber_contract_v(u, v, mat, lam, w)

        print(json.dumps(dict(tree=tree, row=f"huber_contract_v/{name}",
                              ms=event_ms(run), device_ms=device_ms(run),
                              card=smi)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
