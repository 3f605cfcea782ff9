"""Time the redesigned kernels' rows on the card, one JSON line each.

    PYTHONPATH=<tree>/src python src/repro_torch/launch/kernel_times.py

Runs the ``repro_torch`` found on ``PYTHONPATH``, so the same script times
another checkout's kernels (for example the parent commit's, unpacked with
``git archive``) through the same public wrappers at the same shapes; run
the two trees in turns in one session on one card to compare them.  Rows:
``flash_attention`` bf16 at the serving shape (A) and fp32 at three small
shapes (s, a, x) and at TinyLlama-1.1B's prefill (T: B=4, S=2048, H=32,
d=64, causal); ``huber_contract_v`` at the Fig. 1 client blocks (F), the
one-client plane (C), the compact-plane blocks in fp32 with a dense mask
(D) and in bf16 with a packed mask (D16); the row-stripe kernels
``huber_contract_u_diag`` at F, C and D16, ``huber_dual_contract`` at D and
D16, and ``huber_contract_u`` at F; the shrink through its entry point
``kernels.ops.residual_shrink`` (what a solve calls: a tree whose kernel
takes no packed mask unpacks it there) at F, C, D and D16, and
``residual_shrink_psi`` at F and in bf16 without a mask (D16n); and
``huber_contract_v``, ``huber_contract_u_diag`` and the shrink at paper
Table 1's n = 5000 blocks (T5: E=10, m=5000, n_i=500, r=500) and at
``chip_smoke.py``'s wide blocks (T6: E=10, m=4000, n_i=400, r=600; a tree
whose kernels refuse the rank prints the refusal instead), the same three
there with a dense mask (T6d), and ``residual_shrink_psi`` at T5.  The
shrink rows at T5, T6 and T6d also time ``torch.baddbmm(M, U, V^T,
alpha=-1)`` on the same operands (``r_only_ms``: one cuBLAS call that
forms R alone, without the shrink; a yardstick the port never calls).
With
``--only`` a comma-separated list of row-name prefixes picks rows (for
example ``--only residual_shrink,flash_attention/T``).  Each row gives the
CUDA-event time per call over 20 calls after 3 of warm-up (``ms``: what a
caller waits, the wrapper's host work included when it exceeds the
kernel), the profiler's device time of the kernels per call
(``device_ms``, and by kernel name: ``kernels``) and the host's time to
enqueue a call (``host_us``).
Operands are random from a fixed seed (the kernels' time does not depend
on the values).  Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

FLASH_ROWS = {  # (B, S_q, S_kv, H, d, causal, dtype)
    "A": (4, 2048, 2048, 32, 128, True, torch.bfloat16),
    "s": (2, 33, 33, 4, 32, True, torch.float32),
    "a": (1, 256, 256, 4, 64, True, torch.float32),
    "x": (2, 64, 200, 2, 64, False, torch.float32),
    "T": (4, 2048, 2048, 32, 64, True, torch.float32),
}
SHAPES = {  # (E, m, n_i, r, dtype, mask)
    "F": (10, 3000, 300, 150, torch.float32, "none"),
    "C": (1, 3000, 3000, 150, torch.float32, "none"),
    "D": (4, 2048, 512, 64, torch.float32, "dense"),
    "D16": (4, 2048, 512, 64, torch.bfloat16, "packed"),
    "D16n": (4, 2048, 512, 64, torch.bfloat16, "none"),
    # Paper Table 1 at n = 5000 (p = 2r = 500), E = 10: the contractions in
    # a cluster of two rank slices, the shrink in its stream kernel (16
    # slabs of 32 ranks, 3200 tiles of 128 x 64).
    "T5": (10, 5000, 500, 500, torch.float32, "none"),
    # chip_smoke.py's wide phase (n = 4000, p = 600), E = 10: the
    # contractions in a cluster of three rank slices, the shrink in 19
    # slabs (2240 tiles), and with a dense mask.
    "T6": (10, 4000, 400, 600, torch.float32, "none"),
    "T6d": (10, 4000, 400, 600, torch.float32, "dense"),
}
CONTRACT_ROWS = [  # (function, shape)
    ("huber_contract_v", "F"), ("huber_contract_v", "C"),
    ("huber_contract_v", "D"), ("huber_contract_v", "D16"),
    ("huber_contract_u_diag", "F"), ("huber_contract_u_diag", "C"),
    ("huber_contract_u_diag", "D16"), ("huber_dual_contract", "D"),
    ("huber_dual_contract", "D16"), ("huber_contract_u", "F"),
    ("residual_shrink", "F"), ("residual_shrink", "C"),
    ("residual_shrink", "D"), ("residual_shrink", "D16"),
    ("residual_shrink_psi", "F"), ("residual_shrink_psi", "D16n"),
    ("huber_contract_v", "T5"), ("huber_contract_u_diag", "T5"),
    ("residual_shrink", "T5"), ("huber_contract_v", "T6"),
    ("huber_contract_u_diag", "T6"), ("residual_shrink", "T6"),
    ("huber_contract_v", "T6d"), ("huber_contract_u_diag", "T6d"),
    ("residual_shrink", "T6d"), ("residual_shrink_psi", "T5"),
]
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


def host_us(fn) -> float:
    """Microseconds the host takes to enqueue one call (the device's time
    where that is the longer): the median of 5 runs of 20 calls, each
    started on an idle card and not synchronised until it is timed."""
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        runs.append((time.perf_counter() - t0) / CALLS * 1e6)
    torch.cuda.synchronize()
    return sorted(runs)[2]


def device_ms(fn) -> tuple[float, dict[str, float]]:
    """Summed device time of every kernel the calls launch, per call, and
    the same by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    by_name = {ev.key[:80]: ev.self_device_time_total / 1e3 / CALLS
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA}
    return sum(by_name.values()), by_name


def emit(tree: str, row: str, run, smi: str, **extra) -> None:
    ms = event_ms(run)
    total, by_name = device_ms(run)
    print(json.dumps(dict(tree=tree, row=row, ms=ms, device_ms=total,
                          host_us=host_us(run), kernels=by_name, card=smi,
                          **extra)),
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import bitmask, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import huber_contract as hc

    only = None
    if "--only" in sys.argv:
        only = sys.argv[sys.argv.index("--only") + 1].split(",")

    def wanted(row: str) -> bool:
        return only is None or any(row.startswith(p) for p in only)

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tree = repro_torch.__file__
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, (b, sq, skv, h, d, causal, dtype) in FLASH_ROWS.items():
        if not wanted(f"flash_attention/{name}"):
            continue
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev)
                   .to(dtype) for s in (sq, skv, skv))

        def run():
            return fa.flash_attention(q, k, v, causal=causal)

        emit(tree, f"flash_attention/{name}", run, smi)
    for fn, name in CONTRACT_ROWS:
        if not wanted(f"{fn}/{name}"):
            continue
        e, m, n, r, dtype, mode = SHAPES[name]
        u = torch.randn(e, m, r, generator=gen, device=dev) / r ** 0.5
        v = torch.randn(e, n, r, generator=gen, device=dev) / r ** 0.5
        mat = (2 * torch.randn(e, m, n, generator=gen, device=dev)).to(dtype)
        w = (torch.rand(e, m, n, generator=gen, device=dev) < 0.7).float()
        w = {"none": None, "dense": w, "packed": bitmask.pack_mask(w)}[mode]
        lam = torch.ones(e, device=dev)

        def run():
            if fn.startswith("residual_shrink"):
                return getattr(ops, fn)(u, v, mat, lam, w=w)
            return getattr(hc, fn)(u, v, mat, lam, w)

        try:
            run()
        except ValueError as exc:  # a tree whose kernels refuse this rank
            print(json.dumps(dict(tree=tree, row=f"{fn}/{name}",
                                  refused=str(exc), card=smi)), flush=True)
            continue
        extra = {}
        if fn.startswith("residual_shrink") and name.startswith("T"):
            extra["r_only_ms"] = event_ms(
                lambda: torch.baddbmm(mat.float(), u, v.mT, alpha=-1))
        emit(tree, f"{fn}/{name}", run, smi, **extra)
        del u, v, mat, w
    return 0


if __name__ == "__main__":
    sys.exit(main())
