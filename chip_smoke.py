#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DCF-PCA on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, one JSON line each:

0. device   the card, its power limit (nvidia-smi) and the fp32 settings
            (TF32 off for matmuls and cuDNN).
1. build    every kernel compiled from ``src/repro_torch/csrc`` (one nvcc
            per source, all started together), with the seconds it took
            and the number of kernels that spill registers.
2. kernel   every kernel function, in each mask mode and data type a solve
            phase gives it, held against its plain PyTorch version on the
            card and timed with CUDA events beside its bound and the plain
            version's time: at the Fig. 1 shapes (E=10 clients, m=3000,
            n_i=300, r=150; masked ones with 70% observed; the unmasked ones
            again at the cf phase's E=1, m=n=3000) and at the compact-plane
            shapes (E=4, m=2048, n_i=512, r=64, 70% observed; fp32 and bf16
            M; dense and bit-packed masks).  Then ``bitexact``: a packed mask
            gives the bits of the dense one, an all-ones mask those of none.
3. small    5 rounds at 160 x 160 on the card against the same rounds of
            the plain versions on the CPU, from one seed, for fused="diag",
            "dual" with a mask, "off", and a packed mask with bf16 M.
4. dcf      ``repro_torch.rpca.solve(method="dcf")`` on a 3000 x 3000,
            rank-150 problem with 5% corruption, E=10, DCFConfig.tuned(150):
            relative error < 1e-4 and exactly 600 / 200 / 1 launches of the
            unmasked huber_contract_v / huber_contract_u_diag /
            residual_shrink.
5. cf       the same problem with method "cf" (one client): same bar, same
            counts.
6. ragged   "dcf" on 3000 x 2995 with E=10 (a padded split behind a mask):
            the masked kernels with the same counts, the same bar.
7. off      the dcf problem and config with fused="off": 600 / 200 / 1
            launches of huber_contract_v / huber_contract_u /
            residual_shrink, and L and S bit-identical to the dcf phase's.
8. dual     "dcf" with E=4 on a 2048 x 2048, rank-64 problem with 10%
            corruption and 70% of the entries observed,
            DCFConfig.masked(64, observed_frac=0.7, fused="dual") (T=429,
            K=2, J=3): exactly 1716 / 858 / 1 launches of
            huber_contract_v_masked / huber_dual_contract_masked /
            residual_shrink_masked, observed completion error < 1e-2.
9. compact  the dual problem with M in bf16 (``RPCASpec.dtype``),
            pack_mask=True and lam_sample=65536: 1716 / 858 / 1 launches of
            huber_contract_v_packed / huber_dual_contract_packed /
            residual_shrink_masked, observed error < max(5 x dual's, 2e-2).

In each of phases 4-9 a first solve warms the libraries, the counts are
zeroed just before the counted solve and read just after it, and one more
solve runs under torch.profiler (``<phase>_profile``): the device busy time
and its share of the counted solve's wall, the kernels that take the most
device time, and the host's CUDA runtime calls by count.

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

# The Fig. 1 slice: the paper's setting at its largest size.
M_ROWS, N_COLS, RANK, SPARSITY, CLIENTS = 3000, 3000, 150, 0.05, 10
RAGGED_COLS = 2995
OBSERVED = 0.7
ERR_BAR = 1e-4
# The compact-plane slice: the reference's own acceptance configuration of
# fused="dual", pack_mask and bf16 M (benchmarks/fused_round_bench.py:94-126).
D_SIZE, D_RANK, D_SPARSITY, D_CLIENTS, D_OBSERVED = 2048, 64, 0.10, 4, 0.7
DUAL_BAR = 1e-2  # benchmarks/masked_rpca_bench.py:6
COMPACT_FLOOR = 2e-2  # tests/test_masked.py:443
LAM_SAMPLE = 1 << 16
# Kernel vs plain version on the card: max|kernel - plain| over max|plain|
# for the planes (fp32 sums of up to 3000 products in another order than
# cuBLAS), relative error for the per-client scalars.  A bf16 M is upcast
# exactly on both sides, so it keeps the same tolerances.
PLANE_TOL, SCALAR_TOL = 1e-4, 1e-5
# Published H100 SXM peaks (fp32 on the CUDA cores, HBM3).
PEAK_FP32_FLOPS, PEAK_BYTES = 67e12, 3.35e12
TIMED_LAUNCHES, WARMUP_LAUNCHES = 20, 3
TOP_KERNELS = 8

TPU = "src/repro/kernels/"
REPLACES = {
    "huber_contract_v": TPU + "huber_contract.py:82",
    "huber_contract_v_masked": TPU + "huber_contract.py:97",
    "huber_contract_v_packed": TPU + "huber_contract.py:341",
    "huber_contract_u": TPU + "huber_contract.py:118",
    "huber_contract_u_masked": TPU + "huber_contract.py:133",
    "huber_contract_u_packed": TPU + "huber_contract.py:341",
    "huber_contract_u_diag": TPU + "huber_contract.py:341",
    "huber_contract_u_diag_masked": TPU + "huber_contract.py:341",
    "huber_contract_u_diag_packed": TPU + "huber_contract.py:341",
    "huber_dual_contract": TPU + "huber_contract.py:341",
    "huber_dual_contract_masked": TPU + "huber_contract.py:341",
    "huber_dual_contract_packed": TPU + "huber_contract.py:341",
    "residual_shrink": TPU + "shrinkage.py:41",
    "residual_shrink_masked": TPU + "shrinkage.py:57",
}
CSRC = "src/repro_torch/csrc/"
SOURCES = {
    "huber_contract_v": CSRC + "contract_v.cu",
    "huber_contract_u": CSRC + "contract_u.cu",
    "huber_contract_u_diag": CSRC + "contract_u_diag.cu",
    "huber_dual_contract": CSRC + "dual.cu",
    "residual_shrink": CSRC + "shrink.cu",
}
SUFFIX = {"none": "", "dense": "_masked", "packed": "_packed"}

# Kernel rows: (function, mask mode, operand set, solve phase that gives
# the kernel these operands or None).  Operand sets: "fig1" (E=10, m=3000,
# n_i=300, r=150), "cf" (E=1, m=n=3000), "d32" / "d16" (E=4, m=2048,
# n_i=512, r=64, fp32 / bf16 M).
ROWS = [
    ("huber_contract_v", "none", "fig1", "dcf"),
    ("huber_contract_v", "dense", "fig1", "ragged"),
    ("huber_contract_u_diag", "none", "fig1", "dcf"),
    ("huber_contract_u_diag", "dense", "fig1", "ragged"),
    ("residual_shrink", "none", "fig1", "dcf"),
    ("residual_shrink", "dense", "fig1", "ragged"),
    ("huber_contract_u", "none", "fig1", "off"),
    ("huber_contract_v", "none", "cf", "cf"),
    ("huber_contract_u_diag", "none", "cf", "cf"),
    ("residual_shrink", "none", "cf", "cf"),
    ("huber_contract_v", "dense", "d32", "dual"),
    ("huber_dual_contract", "dense", "d32", "dual"),
    ("residual_shrink", "dense", "d32", "dual"),
    ("huber_dual_contract", "none", "d32", None),
    ("huber_contract_v", "none", "d32", None),
    ("huber_contract_u_diag", "none", "d32", None),
    ("huber_contract_u_diag", "dense", "d32", None),
    ("huber_contract_u", "none", "d32", None),
    ("huber_contract_u", "dense", "d32", None),
    ("huber_contract_u", "packed", "d32", None),
    ("huber_contract_u_diag", "packed", "d32", None),
    ("huber_contract_v", "packed", "d16", "compact"),
    ("huber_dual_contract", "packed", "d16", "compact"),
    ("residual_shrink", "dense", "d16", "compact"),
    ("huber_contract_v", "none", "d16", None),
    ("huber_contract_v", "dense", "d16", None),
    ("huber_contract_u_diag", "none", "d16", None),
    ("huber_contract_u_diag", "dense", "d16", None),
    ("residual_shrink", "none", "d16", None),
]


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


def bound(fn: str, mode: str, m_bytes: int, e: int, m: int, n: int,
          r: int) -> tuple[float, str]:
    """Least time (ms) the card needs for one call: the larger of the FLOP
    of the rank-r products at the fp32 peak (elementwise work not counted)
    and the bytes that must move (each input read once: M at ``m_bytes``
    per entry, a dense mask at 4 and a packed one at 1 bit per entry; each
    output written once) at the HBM rate."""
    w_bytes = {"none": 0, "dense": 4 * e * m * n,
               "packed": e * m * -(-n // 8)}[mode]
    factors = 4 * (e * m * r + e * n * r + e)
    flops, out = {
        "huber_contract_v": (4 * e * m * n * r, e * n * r),
        "huber_contract_u": (4 * e * m * n * r, e * m * r),
        "huber_contract_u_diag": (4 * e * m * n * r, e * m * r + 2 * e),
        "huber_dual_contract": (6 * e * m * n * r,
                                e * n * r + e * m * r + 2 * e),
        "residual_shrink": (2 * e * m * n * r, e * m * n),
    }[fn]
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = (m_bytes * e * m * n + w_bytes + factors + 4 * out) \
        / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _kernel_fns(fn: str):
    from repro_torch.kernels import huber_contract as hc
    from repro_torch.kernels import shrinkage as sh

    module = sh if fn == "residual_shrink" else hc
    return getattr(module, fn), getattr(module, fn + "_plain")


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def check_kernel(fn: str, mode: str, key: str, path: str | None,
                 operands: dict) -> dict:
    """One kernel against its plain version on ``operands[key]`` (u, v, M,
    lam, W dense, W packed): the largest error, both times and the bound.
    ``path`` names the solve phase that gives the kernel these operands;
    its launches are read from that phase."""
    import torch

    kernel, plain = _kernel_fns(fn)
    u, v, blocks, lam, w, packed = operands[key]
    args = (u, v, blocks, lam, {"none": None, "dense": w,
                                "packed": packed}[mode])
    got, want = _as_tuple(kernel(*args)), _as_tuple(plain(*args))
    torch.cuda.synchronize()
    abs_err, rel_err, ok = 0.0, 0.0, len(got) == len(want)
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
    r = u.shape[-1]
    bound_ms, bound_by = bound(fn, mode, blocks.element_size(), e, m, n, r)
    kernel_name = fn + SUFFIX[mode]
    dtype = "bf16" if blocks.dtype == torch.bfloat16 else "f32"
    row = dict(name=kernel_name if key == "fig1" else f"{kernel_name}@{key}",
               kernel=kernel_name, path=path, route="cuda",
               source=SOURCES[fn], replaces=REPLACES[kernel_name],
               dtype=dtype, max_abs_err=abs_err, max_rel_err=rel_err, ok=ok,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None, shape=[e, m, n, r])
    emit(phase="kernel", **row)
    if not ok:
        raise SystemExit(f"kernel {row['name']} disagrees with its plain "
                         f"version: relative error {rel_err:.3e}")
    return row


def kernel_operands(device) -> dict:
    """Realistic operands for each kernel row: the solve phases' problems,
    the solver's initial factors and calibrated threshold, and a 70%
    observation mask (the dual problem's own, for its shapes)."""
    import torch

    from repro_torch.core import factorized as fz
    from repro_torch.core import problems as prob
    from repro_torch.kernels import bitmask

    def client_set(m_obs, clients, rank, w):
        lam = fz.robust_lam(m_obs, mask=w)
        blocks = prob.split_columns(m_obs, clients).contiguous()
        e, m, n = blocks.shape
        state = fz.init_state(prob.generator(1), m, n, rank, device,
                              clients=clients)
        w_blk = (torch.rand(blocks.shape, generator=prob.generator(2))
                 < OBSERVED).to(torch.float32).to(device) if w is None \
            else prob.split_columns(w, clients).contiguous()
        return (state.u.expand(e, m, rank).contiguous(), state.v, blocks,
                lam.expand(e).contiguous(), w_blk, bitmask.pack_mask(w_blk))

    p = prob.generate_problem(0, M_ROWS, N_COLS, RANK, SPARSITY,
                              device=device)
    d = prob.generate_problem(0, D_SIZE, D_SIZE, D_RANK, D_SPARSITY,
                              observed_frac=D_OBSERVED, device=device)
    sets = {"fig1": client_set(p.m_obs, CLIENTS, RANK, None),
            "cf": client_set(p.m_obs, 1, RANK, None),
            "d32": client_set(d.m_obs, D_CLIENTS, D_RANK, d.mask)}
    u, v, blocks, lam, w, packed = sets["d32"]
    sets["d16"] = (u, v, blocks.to(torch.bfloat16), lam, w, packed)
    return sets


def check_bit_exact(operands: dict) -> dict:
    """At the compact-plane shapes: a packed mask gives the bits of the
    dense one (dual, u_diag, v, u), and an all-ones mask the bits of none
    (u, dual), in fp32 and bf16."""
    import torch

    checks = {}
    for key in ("d32", "d16"):
        u, v, blocks, lam, w, packed = operands[key]
        for fn in ("huber_dual_contract", "huber_contract_u_diag",
                   "huber_contract_v", "huber_contract_u"):
            kernel, _ = _kernel_fns(fn)
            dense = _as_tuple(kernel(u, v, blocks, lam, w))
            pk = _as_tuple(kernel(u, v, blocks, lam, packed))
            checks[f"{fn}@{key}:packed==dense"] = all(
                torch.equal(a, b) for a, b in zip(dense, pk))
        for fn in ("huber_contract_u", "huber_dual_contract"):
            kernel, _ = _kernel_fns(fn)
            none = _as_tuple(kernel(u, v, blocks, lam, None))
            ones = _as_tuple(kernel(u, v, blocks, lam,
                                    torch.ones_like(w)))
            checks[f"{fn}@{key}:ones==none"] = all(
                torch.equal(a, b) for a, b in zip(none, ones))
    row = dict(checks=checks, ok=all(checks.values()))
    emit(phase="bitexact", **row)
    if not row["ok"]:
        raise SystemExit("a bit-exact mask check failed")
    return row


def small_trajectory_check(device) -> dict:
    """5 DCF rounds at 160 x 160 (E=8, r=8) on the card against the same
    rounds of the plain versions on the CPU, from one seed, for each round
    flavour: the consensus U must agree to 1e-4 relative."""
    import torch

    from repro_torch import rpca
    from repro_torch.core import problems as prob
    from repro_torch.core.factorized import DCFConfig

    dense = prob.generate_problem(7, 160, 160, 8, 0.05, device="cpu")
    masked = prob.generate_problem(7, 160, 160, 8, 0.05, observed_frac=0.8,
                                   device="cpu")
    cases = {
        "diag": (dense, DCFConfig.tuned(8, outer_iters=5), None),
        "dual_masked": (masked, DCFConfig.masked(
            8, observed_frac=0.8, outer_iters=5, fused="dual"), None),
        "off": (dense, DCFConfig.tuned(8, outer_iters=5, fused="off"), None),
        "packed_bf16": (masked, DCFConfig.masked(
            8, observed_frac=0.8, outer_iters=5, fused="dual",
            pack_mask=True, lam_sample=LAM_SAMPLE), torch.bfloat16),
    }
    diffs = {}
    for name, (p, cfg, dtype) in cases.items():
        kw = dict(method="dcf", cfg=cfg, num_clients=8, dtype=dtype)
        cpu = rpca.solve(p.m_obs, mask=p.mask, device="cpu", **kw)
        gpu = rpca.solve(p.m_obs.to(device), device=device,
                         mask=None if p.mask is None else p.mask.to(device),
                         **kw)
        diffs[name] = (torch.linalg.norm(gpu.u.cpu() - cpu.u)
                       / torch.linalg.norm(cpu.u)).item()
    return dict(u_rel_diff_vs_cpu=diffs,
                ok=all(d <= 1e-4 for d in diffs.values()))


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


def solve_phase(name: str, device, problem, spec_kw: dict, method: str,
                cfg, want: dict[str, int], error, bar: float):
    """Phases 4-9: one solve through the front door, its launch counts
    (zeroed just before, read just after; every kernel not in ``want``
    must be launched 0 times) and ``error(result)`` against ``bar``.
    Returns the phase's row and its result."""
    import torch

    from repro_torch import rpca
    from repro_torch.kernels import ops

    def solve():
        return rpca.solve(rpca.RPCASpec(problem.m_obs, **spec_kw),
                          method=method, cfg=cfg, device=device)

    # A first solve warms the libraries (cuBLAS, cuSOLVER); the second is
    # the measured, counted run.
    solve()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    expected = {k: want.get(k, 0) for k in counts}
    err = error(res)
    finite = bool(torch.isfinite(res.l).all() and torch.isfinite(res.s).all())
    shape = tuple(problem.m_obs.shape)
    ok = (err < bar and finite and counts == expected
          and tuple(res.l.shape) == shape and res.l.dtype == torch.float32)
    row = dict(phase=name, method=method, m=shape[0], n=shape[1],
               rank=cfg.rank, clients=spec_kw.get("num_clients"),
               fused=cfg.fused, pack_mask=cfg.pack_mask,
               data_dtype=str(res.spec.m_obs.dtype).removeprefix("torch."),
               error=err, bar=bar, finite=finite, wall_s=wall,
               launches={k: c for k, c in counts.items() if c or k in want},
               expected_launches=want,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, ok=ok)
    emit(**row)
    # After the counts are read: one more solve, under the profiler.
    profiled = profile_solve(solve)
    emit(phase=f"{name}_profile", wall_ms=wall * 1e3,
         device_busy_share=profiled["device_busy_ms"] / (wall * 1e3),
         **profiled)
    if not ok:
        raise SystemExit(f"phase {name} failed")
    row["launches"] = counts
    return row, res


def solve_phases(device) -> list[dict]:
    import torch

    from repro_torch.core import metrics
    from repro_torch.core import problems as prob
    from repro_torch.core.factorized import DCFConfig

    def fig1(name, problem, method, clients, masked, fused="diag"):
        cfg = DCFConfig.tuned(RANK, fused=fused)
        rounds = cfg.outer_iters * cfg.local_iters
        suffix = "_masked" if masked else ""
        u_step = "huber_contract_u_diag" if fused == "diag" \
            else "huber_contract_u"
        want = {f"huber_contract_v{suffix}": rounds * cfg.inner_sweeps,
                f"{u_step}{suffix}": rounds,
                f"residual_shrink{suffix}": 1}
        kw = {} if clients is None else {"num_clients": clients}
        return solve_phase(
            name, device, problem, kw, method, cfg, want,
            lambda res: metrics.relative_error(
                res.l, res.s, problem.l0, problem.s0).item(), ERR_BAR)

    def compact(name, problem, bar, **cfg_kw):
        cfg = DCFConfig.masked(D_RANK, observed_frac=D_OBSERVED,
                               fused="dual", **cfg_kw)
        local = cfg.outer_iters * cfg.local_iters
        suffix = "_packed" if cfg.pack_mask else "_masked"
        want = {f"huber_contract_v{suffix}": local * (cfg.inner_sweeps - 1),
                f"huber_dual_contract{suffix}": local,
                "residual_shrink_masked": 1}
        kw = dict(num_clients=D_CLIENTS, mask=problem.mask,
                  dtype=torch.bfloat16 if cfg.pack_mask else None)
        return solve_phase(
            name, device, problem, kw, "dcf", cfg, want,
            lambda res: metrics.completion_errors(
                res.l, problem.l0, problem.mask).observed.item(), bar)

    p = prob.generate_problem(0, M_ROWS, N_COLS, RANK, SPARSITY,
                              device=device)
    dcf, dcf_res = fig1("dcf", p, "dcf", CLIENTS, masked=False)
    rows = [dcf, fig1("cf", p, "cf", None, masked=False)[0]]
    ragged = prob.generate_problem(0, M_ROWS, RAGGED_COLS, RANK, SPARSITY,
                                   device=device)
    rows.append(fig1("ragged", ragged, "dcf", CLIENTS, masked=True)[0])
    off, off_res = fig1("off", p, "dcf", CLIENTS, masked=False, fused="off")
    same = bool(torch.equal(off_res.l, dcf_res.l)
                and torch.equal(off_res.s, dcf_res.s))
    emit(phase="off_vs_dcf", l_and_s_bit_identical=same, ok=same)
    if not same:
        raise SystemExit("fused='off' and fused='diag' gave other L or S")
    rows.append(off)
    del p, ragged, dcf_res, off_res
    d = prob.generate_problem(0, D_SIZE, D_SIZE, D_RANK, D_SPARSITY,
                              observed_frac=D_OBSERVED, device=device)
    dual, _ = compact("dual", d, DUAL_BAR)
    rows.append(dual)
    rows.append(compact("compact", d, max(5 * dual["error"], COMPACT_FLOOR),
                        pack_mask=True, lam_sample=LAM_SAMPLE)[0])
    return rows


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
    from repro_torch.kernels import huber_contract as hc

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
    kernels = sum("Compiling entry function" in ln
                  for src in _build.sources()
                  for ln in _build.build_log(src.stem).splitlines())
    emit(phase="build", seconds=seconds,
         sources=[src.name for src in _build.sources()],
         kernels_compiled=kernels, kernels_with_spills=spills)

    operands = kernel_operands(device)
    rows = [check_kernel(fn, mode, key, path, operands)
            for fn, mode, key, path in ROWS]
    check_bit_exact(operands)
    partial = hc.dual_partial_shape(D_CLIENTS, D_SIZE, D_SIZE // D_CLIENTS,
                                    D_RANK)
    emit(phase="dual_partials", shape=list(partial),
         mb=4 * partial[0] * partial[1] * partial[2] * partial[3] / 1e6)
    del operands
    small = small_trajectory_check(device)
    emit(phase="small", **small)
    if not small["ok"]:
        raise SystemExit("the card and the CPU disagree at 160 x 160")
    solves = solve_phases(device)
    # Launches on the main path, each row's from the phase that gives its
    # kernel that row's operands; null where no phase does.
    for row in rows:
        phase = next((s for s in solves if s["phase"] == row["path"]), None)
        row["launches"] = None if phase is None \
            else phase["launches"][row["kernel"]]
    print(json.dumps({"kernels": rows}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
