#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DCF-PCA on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, one JSON line each:

0. device  the card, its power limit (nvidia-smi) and the fp32 settings
           (TF32 off for matmuls and cuDNN).
1. build   every kernel compiled from ``src/repro_torch/csrc`` (nvcc, in
           parallel), with the seconds it took.
2. kernel  each ported kernel at the slice's shapes (E=10 clients,
           m=3000, n_i=300, r=150; masked ones with 70% observed), and
           the unmasked ones again at the cf phase's (E=1, m=n=3000),
           held against its plain PyTorch version on the card, and timed
           with CUDA events beside its bound and the plain version's time.
3. dcf     ``repro_torch.rpca.solve(method="dcf")`` on a 3000 x 3000,
           rank-150 problem with 5% corruption, E=10, DCFConfig.tuned(150):
           relative error < 1e-4 and exactly 600 / 200 / 1 launches of the
           unmasked huber_contract_v / huber_contract_u_diag /
           residual_shrink.  Before it, a small check: 5 rounds at
           160 x 160 on the card against the same 5 rounds of the plain
           versions on the CPU, from the same seed.
4. cf      the same problem with method "cf" (one client): same bar, same
           counts.
5. ragged  "dcf" on 3000 x 2995 with E=10 (a padded split behind a mask):
           the masked kernels with the same counts, the same bar.

After each of phases 3-5, once its counts are read, one more solve under
torch.profiler (``<phase>_profile``): the device busy time and its share
of the counted solve's wall, the kernels that take the most device time,
and the host's CUDA runtime calls by count.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises or exits non-zero
before the last line; without a CUDA device, or outside a checkout, it
exits with 2.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"

# The slice: the paper's Fig. 1 setting at its largest size.
M_ROWS, N_COLS, RANK, SPARSITY, CLIENTS = 3000, 3000, 150, 0.05, 10
RAGGED_COLS = 2995
OBSERVED = 0.7
ERR_BAR = 1e-4
# Kernel vs plain version on the card: max|kernel - plain| over max|plain|
# for the planes (fp32 sums of up to 3000 products in another order than
# cuBLAS), relative error for the per-client scalars.
PLANE_TOL, SCALAR_TOL = 1e-4, 1e-5
# Published H100 SXM peaks (fp32 on the CUDA cores, HBM3).
PEAK_FP32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
TIMED_LAUNCHES, WARMUP_LAUNCHES = 20, 3
TOP_KERNELS = 8

REPLACES = {
    "huber_contract_v": "src/repro/kernels/huber_contract.py:82",
    "huber_contract_v_masked": "src/repro/kernels/huber_contract.py:97",
    "huber_contract_u_diag": "src/repro/kernels/huber_contract.py:341",
    "huber_contract_u_diag_masked": "src/repro/kernels/huber_contract.py:341",
    "residual_shrink": "src/repro/kernels/shrinkage.py:41",
    "residual_shrink_masked": "src/repro/kernels/shrinkage.py:57",
}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, launches: int = TIMED_LAUNCHES) -> float:
    """Mean milliseconds per call over ``launches`` calls, after warm-up."""
    import torch

    for _ in range(WARMUP_LAUNCHES):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def bound(name: str, e: int, m: int, n: int, r: int) -> tuple[float, str]:
    """Least time (ms) the card needs for one call: the larger of the
    FLOP of the rank-r products at the fp32 peak (elementwise work not
    counted) and the bytes that must move (each input read once, each
    output written once) at the HBM rate."""
    masked = name.endswith("_masked")
    planes = e * m * n * (2 if masked else 1)  # M (+ W) entries read
    factors = e * m * r + e * n * r + e
    if name.startswith("huber_contract_v"):
        flops, out = 4 * e * m * n * r, e * n * r
    elif name.startswith("huber_contract_u_diag"):
        flops, out = 4 * e * m * n * r, e * m * r + 2 * e
    else:
        flops, out = 2 * e * m * n * r, e * m * n
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = 4 * (planes + factors + out) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def check_kernel(name: str, path: str, operands: tuple) -> dict:
    """One kernel against its plain version on ``operands`` (u, v, M, lam,
    W): the largest error, both times and the bound.  ``path`` names the
    solve phase that gives the kernel these shapes; its launches are read
    from that phase."""
    import torch

    from repro_torch.kernels import huber_contract as hc
    from repro_torch.kernels import shrinkage as sh

    base = name.removesuffix("_masked")
    module = sh if base == "residual_shrink" else hc
    kernel = getattr(module, base)
    plain = getattr(module, base + "_plain")
    u, v, blocks, lam, w = operands
    args = (u, v, blocks, lam, w if name.endswith("_masked") else None)
    got, want = kernel(*args), plain(*args)
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    abs_err, rel_err, ok = 0.0, 0.0, True
    for g, ref in zip(got, want):
        diff = (g - ref).abs().max().item()
        abs_err = max(abs_err, diff)
        if ref.ndim == 1:  # per-client scalars
            rel = (diff / ref.abs().min().item()) if diff else 0.0
            ok &= rel <= SCALAR_TOL
        else:
            rel = diff / ref.abs().max().item()
            ok &= rel <= PLANE_TOL
        rel_err = max(rel_err, rel)
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    e, m, n = blocks.shape
    bound_ms, bound_by = bound(name, e, m, n, RANK)
    row = dict(name=name if path != "cf" else f"{name}@cf", kernel=name,
               path=path, route="cuda",
               source=("src/repro_torch/csrc/shrink.cu"
                       if base == "residual_shrink"
                       else "src/repro_torch/csrc/contract.cu"),
               replaces=REPLACES[name], max_abs_err=abs_err,
               max_rel_err=rel_err, ok=ok, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
               shape=[e, m, n, RANK])
    emit(phase="kernel", **row)
    if not ok:
        raise SystemExit(f"kernel {name} ({path}) disagrees with its plain "
                         f"version: relative error {rel_err:.3e}")
    return row


def check_kernels(device) -> list[dict]:
    """Phase 2: every kernel against its plain version at each shape the
    solve phases give it, with realistic operands (the slice problem, the
    solver's initial factors and calibrated threshold): all six at the
    client blocks of ``dcf`` and ``ragged`` (E=10, m=3000, n_i=300), and
    the three unmasked ones at the single block of ``cf`` (E=1, m=n=3000),
    where their grids differ (``huber_contract_v``: 94 column tiles, 3 row
    ranges; ``huber_contract_u_diag``: 94 blocks, each looping over 94
    column tiles)."""
    import torch

    from repro_torch.core import factorized as fz
    from repro_torch.core import problems as prob

    p = prob.generate_problem(0, M_ROWS, N_COLS, RANK, SPARSITY,
                              device=device)
    lam = fz.robust_lam(p.m_obs)
    blocks = prob.split_columns(p.m_obs, CLIENTS).contiguous()
    e, m, n = blocks.shape
    state = fz.init_state(prob.generator(1), m, n, RANK, device,
                          clients=CLIENTS)
    w = (torch.rand(blocks.shape, generator=prob.generator(2))
         < OBSERVED).to(torch.float32).to(device)
    clients = (state.u.expand(e, m, RANK).contiguous(), state.v, blocks,
               lam.expand(e).contiguous(), w)
    one = fz.init_state(prob.generator(1), M_ROWS, N_COLS, RANK, device)
    single = (one.u[None].contiguous(), one.v[None].contiguous(),
              p.m_obs[None].contiguous(), lam[None].contiguous(), None)
    rows = [check_kernel(name, "ragged" if name.endswith("_masked")
                         else "dcf", clients) for name in REPLACES]
    rows += [check_kernel(name, "cf", single)
             for name in REPLACES if not name.endswith("_masked")]
    return rows


def small_trajectory_check(device) -> dict:
    """5 DCF rounds at 160 x 160 (E=8, r=8) on the card against the same
    rounds of the plain versions on the CPU, from one seed: the consensus
    U must agree to 1e-4 relative."""
    import torch

    from repro_torch.core import dcf_pca
    from repro_torch.core import problems as prob
    from repro_torch.core.factorized import DCFConfig

    cfg = DCFConfig.tuned(8, outer_iters=5)
    p = prob.generate_problem(7, 160, 160, 8, 0.05, device="cpu")
    cpu = dcf_pca.dcf_pca(p.m_obs, cfg, 8, 0, device="cpu")
    gpu = dcf_pca.dcf_pca(p.m_obs, cfg, 8, 0, device=device)
    diff = (torch.linalg.norm(gpu.u.cpu() - cpu.u)
            / torch.linalg.norm(cpu.u)).item()
    return dict(u_rel_diff_vs_cpu=diff, ok=diff <= 1e-4)


def profile_solve(solve) -> dict:
    """Where one solve's time goes on the card: the solve once under
    torch.profiler.  The device busy time is the sum of kernel times (one
    stream, so kernels do not overlap); beside it the kernels that take
    the most of it and the host's CUDA runtime calls, by count."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = sorted((ev for ev in events if ev.device_type == DeviceType.CUDA),
                     key=lambda ev: ev.self_device_time_total, reverse=True)
    return dict(
        wall_ms_profiled=wall * 1e3,
        device_busy_ms=sum(ev.self_device_time_total for ev in kernels) / 1e3,
        top_kernels=[{"name": ev.key[:96], "calls": ev.count,
                      "device_ms": ev.self_device_time_total / 1e3}
                     for ev in kernels[:TOP_KERNELS]],
        runtime_calls={ev.key: ev.count for ev in events
                       if ev.key.startswith("cuda")},
    )


def solve_phase(name: str, device, method: str, n: int, clients: int | None,
                masked: bool) -> dict:
    """Phases 3-5: one solve through the front door, its launch counts
    (zeroed just before, read just after) and its relative error."""
    import torch

    from repro_torch import rpca
    from repro_torch.core import metrics
    from repro_torch.core import problems as prob
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.kernels import ops

    cfg = DCFConfig.tuned(RANK)
    p = prob.generate_problem(0, M_ROWS, n, RANK, SPARSITY, device=device)
    kw = {} if clients is None else {"num_clients": clients}
    # A first solve warms the libraries (cuBLAS, cuSOLVER); the second is
    # the measured, counted run.
    rpca.solve(p.m_obs, method=method, cfg=cfg, device=device, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = rpca.solve(p.m_obs, method=method, cfg=cfg, device=device, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rounds = cfg.outer_iters * cfg.local_iters
    suffix = "_masked" if masked else ""
    other = "" if masked else "_masked"
    want = {f"huber_contract_v{suffix}": rounds * cfg.inner_sweeps,
            f"huber_contract_u_diag{suffix}": rounds,
            f"residual_shrink{suffix}": 1,
            f"huber_contract_v{other}": 0,
            f"huber_contract_u_diag{other}": 0,
            f"residual_shrink{other}": 0}
    err = metrics.relative_error(res.l, res.s, p.l0, p.s0).item()
    finite = bool(torch.isfinite(res.l).all() and torch.isfinite(res.s).all())
    ok = (err < ERR_BAR and finite and counts == want
          and tuple(res.l.shape) == (M_ROWS, n))
    row = dict(phase=name, method=method, m=M_ROWS, n=n, rank=RANK,
               clients=clients, rel_error=err, finite=finite, wall_s=wall,
               launches=counts, expected_launches=want,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, ok=ok)
    emit(**row)
    # After the counts are read: one more solve, under the profiler.
    profiled = profile_solve(
        lambda: rpca.solve(p.m_obs, method=method, cfg=cfg, device=device,
                           **kw))
    emit(phase=f"{name}_profile", wall_ms=wall * 1e3,
         device_busy_share=profiled["device_busy_ms"] / (wall * 1e3),
         **profiled)
    if not ok:
        raise SystemExit(f"phase {name} failed")
    return row


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}; run it from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise SystemExit("TF32 is on for fp32 matmuls")
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    emit(phase="device", kind=kind, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         tf32=False)

    seconds = _build.build_all()
    spills = sum("spill stores" in ln and " 0 bytes spill stores" not in ln
                 for src in _build.sources()
                 for ln in _build.build_log(src.stem).splitlines())
    emit(phase="build", seconds=seconds,
         sources=[src.name for src in _build.sources()],
         kernels_with_spills=spills)

    kernels = check_kernels(device)
    small = small_trajectory_check(device)
    emit(phase="small", **small)
    if not small["ok"]:
        raise SystemExit("the card and the CPU disagree at 160 x 160")
    solves = [
        solve_phase("dcf", device, "dcf", N_COLS, CLIENTS, masked=False),
        solve_phase("cf", device, "cf", N_COLS, None, masked=False),
        solve_phase("ragged", device, "dcf", RAGGED_COLS, CLIENTS, masked=True),
    ]
    # Launches on the main path, each row's from the phase that gives its
    # kernel that row's shapes.
    for row in kernels:
        phase = next(s for s in solves if s["phase"] == row["path"])
        row["launches"] = phase["launches"][row["kernel"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
