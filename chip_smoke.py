#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (DCF-PCA and dense-LM serving) on one CUDA
card and check it.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 and the
CUDA toolkit.  Phases, one JSON line each:

0. device   the card, its power limit (nvidia-smi) and the fp32 settings
            (TF32 off for matmuls and cuDNN).
1. build    every kernel compiled from ``src/repro_torch/csrc`` (one nvcc
            per source, all started together), with the seconds it took
            and the kernels that spill registers, by name.
2. kernel   every kernel function, in each mask mode and data type a solve
            phase gives it, held against its plain PyTorch version on the
            card and timed with CUDA events beside its bound and the plain
            version's time: at the Fig. 1 shapes (E=10 clients, m=3000,
            n_i=300, r=150; masked ones with 70% observed; the unmasked ones
            again at the cf phase's E=1, m=n=3000) and at the compact-plane
            shapes (E=4, m=2048, n_i=512, r=64, 70% observed; fp32 and bf16
            M; dense and bit-packed masks); residual_shrink_psi at fig1
            (none, f32), d32 (dense) and d16 (none, bf16); flash_attention
            bf16 at the serve phase's shape (B=4, S=2048, H=32, d=128,
            causal), f32 at the small_lm phase's shape (2, 33, 4, 32,
            causal), at (1, 256, 4, 64, causal), f32 cross (2, 64 x 200,
            2, 64, full) and f32 at the serve_f32 phase's shape (4, 2048,
            32, 64, causal; row T), each also beside PyTorch's SDPA on the same
            tensors (``library_ms``) and the profiler's device time of the
            kernel alone (``kernel_device_ms``: the CUDA-event ``ms`` of
            back-to-back calls also holds the wrapper's host work where
            that is the longer), its error taken row by row; the fp32 rows
            also state the 3xTF32 tensor-core bound.  Then
            ``bitexact``: a packed mask gives the bits of the dense one, an
            all-ones mask those of none, and the three row-stripe kernels
            share out_u, obj and psi2.
   psi      kernels.ops.residual_shrink_psi, its entry point, on the fig1,
            d32 (dense mask) and d16 (bf16) operands: S + Psi == W R and
            |Psi| <= lam, exactly 2 / 1 launches of residual_shrink_psi /
            residual_shrink_psi_masked.
   dual_scratch  the dual's out_v scratch at the compact-plane shapes (its
            shape and MiB, at most 4) and its row groups (clusters of
            stripes).
   The kernel rows also hold huber_contract_v, huber_contract_u_diag and
   residual_shrink at paper Table 1's n = 5000 blocks (row "t5": E=10,
   m=5000, n_i=500, r=500, two rank halves), with the table1 phase's
   launches, and at the wide phase's blocks (row "t6": E=10, m=4000,
   n_i=400, r=600, three rank chunks), with its launches.
3. small    5 rounds at 160 x 160 on the card against the same rounds of
            the plain versions on the CPU, from one seed, for fused="diag",
            "dual" with a mask, "off", and a packed mask with bf16 M; and
            IALM (60 iterations) and APGM (200) at 160 x 160 on the card
            and on the CPU from one problem: L and S within 1e-5.
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
            residual_shrink_packed, observed error < max(5 x dual's, 2e-2).
   table1   paper Table 1 (benchmarks/table1_upper_rank.py): "dcf" with
            E=10 on the port's n x n problem (seed 0, r = 0.05 n, 5%
            corruption) at the upper-bound rank p = 2r,
            DCFConfig.tuned(p), for n = 1000 (p = 100) and n = 5000
            (p = 500, two rank halves; M is 100 MB): the singular-value
            error under the paper's value (0.0398, 0.1127), rank_gap,
            exactly 600 / 200 / 1 launches, and the same problem solved
            again on the plain route (``impl="ref"``, the same algorithm
            without the kernels) on the card, whose error must agree within
            10%.
   elastic  the fault-tolerant engine on the dcf phase's problem through
            ``rpca.solve(method="dcf")``: DCFConfig.elastic(150,
            participation=0.5) with a rate-0.5 schedule (relative error
            <= 1e-2); FaultPlan.byzantine(T, 10, (1, 5), kind="nan") under
            the weighted mean (L non-finite) and the coordinate median (and
            again with track_objective); kind="corrupt" on client 2 under
            the trimmed mean (both <= 3x the dcf phase's error); a
            checkpointed solve (every 25 rounds) interrupted after its
            first snapshot and resumed, bit-identical to the uninterrupted
            one and to one unsegmented solve.  Exact T·K·J / T·K / 1
            launches in each: dropped clients still run their round.
   wide     ranks above 512: "dcf" with E=10 on the table1 generator at n =
            4000 (r = 300) at p = 600, DCFConfig.tuned(600) (three rank
            chunks; M is 64 MB): the singular-value error and rank_gap
            (the paper gives no value here), exactly 600 / 200 / 1
            launches, the plain route's error within 10%.
   convex   Fig. 1's baselines at n = 1000 (r = 50, 5%) on the card
            through ``rpca.solve``: IALM (60 iterations) and APGM (200)
            under the reference's recovery bars (1e-6, 1e-5), with the
            wall, the time of one SVD at this size and at Fig. 1's largest
            (3000 x 3000), and the host syncs of a solve (counted by
            ``torch.cuda.set_sync_debug_mode``).
   batch    benchmarks/solver_runtime_bench.py's batch at its full setting
            (:35, :122): 16 problems of 500 x 500, rank 8, 5% corruption,
            E=8 (ragged: the masked kernels), DCFConfig.tuned(8), through
            ``rpca.solve`` on a (16, 500, 500) spec: exactly 600 / 200 / 1
            launches for the whole batch, the worst recovery error under
            1e-3; ``batch_vs_serial``: the 16 serial solves' wall against
            the batch's, problems/s of both, max |L_b - L_serial| <= 1e-3;
            ``batch_early``: the benchmark's chunked early exit (tol 5e-4,
            chunks of 10): each problem's rounds, its traces zero past
            them, the launches of the rounds the batch ran.
   batch_fig1 four Fig. 1 problems (seeds 0-3, E=10, DCFConfig.tuned(150))
            in one batch: each under 1e-4, 600 / 200 / 1 launches, busy
            time against 4x the dcf phase's, peak memory, max |L_b -
            L_serial| <= 1e-3, and problem 0's bits unchanged when problems
            1-3 are other seeds'.
   batch_convex  IALM (60 iterations) and APGM (200) on a batch of 4 x
            160 x 160 against the serial solves on the card: L and S within
            1e-5, the walls, the host syncs an iteration.
   wire     the dcf phase's problem under DCFConfig.tuned(150) with
            consensus_delay=1, top-k compression at 0.1, both, and
            topk_frac=1.0: 600 / 200 / 1 launches each, recovery error
            (no bar: the reference states none at this size), wall, busy
            share, the modelled traffic and whether the stale guard
            tripped; ``wire_checks``: two compressed solves bit-identical,
            topk_frac=1.0 against the dense solve, and within 1e-4 of it at
            tests/test_multihost.py's problem.
   The kernel rows also hold the batch phases' shapes: row "bn" (B·E =
   128 clients, m=500, n_i=63, r=8, the padding mask) and row "b4" (40
   clients of 3000 x 300, r=150), with those phases' launches.
   graphs   one captured round replayed against eager rounds
            (``core.runtime.run`` / ``solve_batch`` with ``eager=True``)
            for the dcf phase's solve, the dual phase's, the batch phase's
            and the wire (top-k 0.1, one round stale): every output and
            trace bit for bit, walls, busy shares and peak memory both
            ways, the same launch counts, one capture and T - 1 replays,
            and the replayed solve's launch counters against the
            profiler's device kernels by family.
   compile_cache  ``rpca.solve(method="cf", compile_policy="aot")`` at
            three shapes in two buckets: two entry builds with one capture
            each, then no build and no capture on the repeats; first-call,
            repeat and uncached walls, the entries' bytes, each recovery
            error within the reference's bar of the uncached one.
10. small_lm the llama3-8b smoke config in fp32 (2 layers, d_model 128,
            head dim 32) with flash attention: 2 prompts of 33 tokens, 8
            greedy new tokens through ``serving.engine.generate`` on the
            card (the kernel; the decode step replayed) and on the CPU
            (plain versions): the same tokens, and the card's eager decode
            the same again, prefill logits within 1e-4 of max|logits|,
            exactly 2 flash_attention launches.
11. serve_f32 TinyLlama-1.1B (``configs/tinyllama_1_1b.py``,
            arXiv:2401.02385) at full width and depth (22 layers, d_model
            2048, 32 / 4 heads), fp32, flash attention (its fp32 path),
            random weights from seed 0: ``generate`` for 4 prompts of 2048
            tokens and 16 greedy new tokens, with the gates and numbers of
            serve below (exactly 22 flash_attention launches).
12. serve    Llama-3-8B (``configs/llama3_8b.py``) at full width and depth,
            bf16, flash attention, random weights from a seeded card
            generator: ``generate`` for 4 prompts of 2048 random tokens and
            32 greedy new tokens (s_max 2080): set-up, prefill and decode
            times, tokens/s, peak memory, exactly 32 flash_attention
            launches (one per layer; decode launches none), and the last-
            position logits of the same prefill with the plain attention
            (the config's ``flash_attention`` off) within 5e-2 of
            max|logits|.  The decode step is captured once and replayed
            (one graph launch a step): the replayed ms a step beside an
            eager decode's, and the tokens equal to the eager ones.

In each of phases 4-9, elastic, table1, wide, batch, batch_fig1, wire, 11
and 12 a first run warms the libraries, the counts (kernel launches and
round graphs' captures and replays) are zeroed just before the counted run
and read just after it, and one more run goes under torch.profiler
(``<phase>_profile``): the device busy time and its share of the counted
run's wall, the kernels that take the most device time, and the host's
CUDA runtime calls by count.  Every factorized solve replays one captured
round (``core.runtime``): one capture and T - 1 replays a solve.

Then the ``{"kernels": [...]}`` line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.  Any failure raises or exits non-zero
before the last line; without a CUDA device, or outside a checkout, it
exits with 2.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

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
# Published H100 SXM peaks (fp32 on the CUDA cores, bf16 dense on the
# tensor cores, HBM3).
PEAK_FP32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES = 67e12, 989e12, 3.35e12
# Dense TF32 on the tensor cores (H100 SXM): the bound of a 3xTF32 kernel
# is three TF32 products at this rate.
PEAK_TF32_FLOPS = 494.7e12
# Flash attention vs its plain version in fp32, one query row (b, i) at a
# time: max over (h, d) of |kernel - plain| over max over (h, d) of |plain|
# (causal rows differ in scale ~50x between row 0 and row 2047, so a bar on
# max|plain| of the whole call would not see late rows).  fp32: sums in
# another order, base-2 exponentials.  bf16: the kernel rounds O to bf16
# (at most 2^-8 = 3.9e-3 of the row's max) and P to bf16 for P V (at most
# 2^-8 a weight, a random sum of ~1e-3 of the row's max); 1e-2 leaves about
# twice the ~5e-3 they reach together.
FLASH_TOL = {"f32": 2e-5, "bf16": 1e-2}
# Serve: last-position logits through the kernel vs the plain attention,
# relative to max|logits|.  Every activation is bf16 and the two attentions
# round differently (P in bf16 against fp32 softmax), so the outputs of the
# 32 layers drift apart by some bf16 ulps of the residual stream; 5e-2 is a
# few percent of the logits' range, far below a wrong kernel's error.
SERVE_LOGITS_BAR = 5e-2
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = "llama3-8b", 4, 2048, 32
# The fp32 serving path: TinyLlama-1.1B's prefill at 4 x 2048 (arXiv:
# 2401.02385), the fp32 flash kernel's full-width shape.
F32_ARCH, F32_NEW = "tinyllama-1.1b", 16
SMALL_BATCH, SMALL_PROMPT, SMALL_NEW, SMALL_LOGITS_BAR = 2, 33, 8, 1e-4
# Paper Table 1 (benchmarks/table1_upper_rank.py:5-6): n -> the paper's
# singular-value error, the bar of the solve at p = 2r.  The reference
# meets it at n = 1000 on the CPU (table1_upper_rank.run(sizes=(1000,)):
# 0.00194; ``python tests/test_torch_convex.py`` prints it), so the
# paper's value is the bar there too.
TABLE1 = {1000: 0.0398, 5000: 0.1127}
TABLE1_CLIENTS, TABLE1_SPARSITY = 10, 0.05
# The plain route (impl="ref") of the same solve: its singular-value error
# within this fraction of the kernel route's.
TABLE1_ROUTES_TOL = 0.10
# Ranks above 512 end to end: Table 1's generator at n = 4000 with true rank
# 300 solved at p = 600 (three rank chunks; M is 64 MB).  The paper states
# no value for this size and rank (true rank 0.075 n, not Table 1's
# 0.05 n), so the gate is the plain route's error, within
# TABLE1_ROUTES_TOL, and finite factors; the error itself is reported.
WIDE_N, WIDE_TRUE_RANK, WIDE_RANK = 4000, 300, 600
# The fault-tolerant engine on the dcf phase's problem: the reference's
# bars (tests/test_elastic.py:142-147: 1e-2 at participation 0.5;
# tests/test_faults.py:78-133: robust consensus within 3x the fault-free
# error), and the checkpoint cadence of the resumed solve.
ELASTIC_BAR, CHECKPOINT_EVERY = 1e-2, 25
# Batched solves, benchmarks/solver_runtime_bench.py's full setting (:35,
# :122): B problems of n x n, rank 8, 5% corruption, E = 8 (n % E != 0: a
# padded split behind a mask), DCFConfig.tuned(8), from seeds 1..B; the
# batch against its B serial solves within the reference's batch tolerance
# (tests/test_runtime.py:109-116), the worst recovery error under the
# reference's bar for a batch (tests/test_runtime.py:142); then the
# benchmark's early exit (tol 5e-4, chunks of 10).
BATCH, BATCH_N, BATCH_RANK, BATCH_CLIENTS = 16, 500, 8, 8
BATCH_TOL, BATCH_ERR_BAR, BATCH_KEY = 1e-3, 1e-3, 100
BATCH_EARLY_TOL, BATCH_CHUNK = 5e-4, 10
# Four Fig. 1 problems (seeds 0-3) in one batch, and the seeds that replace
# problems 1-3 for the batch-mate check.
FIG1_BATCH, FIG1_MATES = 4, (4, 5, 6)
# The convex baselines batched: B problems at 160 x 160 (rank 8, 5%), the
# batch against the card's serial solves within tests/test_masked.py:
# 296-298's 1e-5.
CONVEX_BATCH, CONVEX_BATCH_N, CONVEX_BATCH_TOL = 4, 160, 1e-5
# The wire consensus on the dcf phase's problem (top-k fraction of each
# delta); tests/test_multihost.py:124-135's problem (64^2, rank 3, tuned(4),
# E = 4, 40 rounds, seed 1), where topk_frac=1.0 is within 1e-4 of dense.
WIRE_TOPK, WIRE_SMALL, WIRE_SMALL_TOL = 0.1, (64, 3, 4, 4, 40), 1e-4
# The compile cache: cf through compile_policy="aot" (buckets of 64 x 2^k)
# at three shapes in two buckets, (1024, 1024) twice and (2048, 2048), on
# the port's problems (rank 20, 5%), DCFConfig.tuned(20).
CACHE_SHAPES = ((1000, 900), (1000, 1000), (1500, 1200))
CACHE_TRUE_RANK = CACHE_RANK = 20
CACHE_REPEATS = 3
# Fig. 1's convex baselines (benchmarks/fig1_convergence.py) at n = 1000:
# the reference's recovery bars (tests/test_rpca_core.py:38-45), which the
# reference meets at this size on the CPU (1.6e-15, 5.3e-11; printed by
# ``python tests/test_torch_convex.py``).
CONVEX_N, CONVEX_BARS = 1000, {"ialm": 1e-6, "apgm": 1e-5}
CONVEX_ITERS = {"ialm": 60, "apgm": 200}
FIG1_LARGEST = 3000
# The convex solves at 160 x 160, card against CPU: L and S relative.
SMALL_CONVEX_TOL = 1e-5
TIMED_LAUNCHES, WARMUP_LAUNCHES = 20, 3
# The outer rounds of the replayed solves whose launch counters are held
# against the profiler's kernel records: a few thousand records each (the
# trace of a 429-round solve, ~107k records, has lost some at random:
# src/repro_torch/launch/graph_costs.py, PERF.md §7).
GRAPHS_COUNTED_ROUNDS = 12
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
    "residual_shrink_packed": TPU + "shrinkage.py:57",
    "residual_shrink_psi": TPU + "shrinkage.py:48",
    "residual_shrink_psi_masked": TPU + "shrinkage.py:66",
    "residual_shrink_psi_packed": TPU + "shrinkage.py:66",
    "flash_attention": TPU + "flash_attention.py:37",
}
CSRC = "src/repro_torch/csrc/"
SOURCES = {
    "huber_contract_v": CSRC + "contract_v.cu",
    "huber_contract_u": CSRC + "contract_u.cu",
    "huber_contract_u_diag": CSRC + "contract_u_diag.cu",
    "huber_dual_contract": CSRC + "dual.cu",
    "residual_shrink": CSRC + "shrink.cu",
    "residual_shrink_psi": CSRC + "shrink.cu",
    "flash_attention": CSRC + "flash_attention.cu",
}
SUFFIX = {"none": "", "dense": "_masked", "packed": "_packed"}

# Kernel rows: (function, mask mode, operand set, solve phase that gives
# the kernel these operands or None).  Operand sets: "fig1" (E=10, m=3000,
# n_i=300, r=150), "cf" (E=1, m=n=3000), "d32" / "d16" (E=4, m=2048,
# n_i=512, r=64, fp32 / bf16 M), "t5" (E=10, m=5000, n_i=500, r=500),
# "t6" (E=10, m=4000, n_i=400, r=600: three rank chunks), "bn" (the batch
# phase's B·E = 128 clients, m=500, n_i=63, r=8, the padding mask) and "b4"
# (batch_fig1's 4 x 10 = 40 clients, m=3000, n_i=300, r=150).
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
    ("residual_shrink", "packed", "d16", "compact"),
    ("huber_contract_v", "none", "d16", None),
    ("huber_contract_v", "dense", "d16", None),
    ("huber_contract_u_diag", "none", "d16", None),
    ("huber_contract_u_diag", "dense", "d16", None),
    ("residual_shrink", "none", "d16", None),
    ("residual_shrink_psi", "none", "fig1", "psi"),
    ("residual_shrink_psi", "dense", "d32", "psi"),
    ("residual_shrink_psi", "none", "d16", "psi"),
    ("huber_contract_v", "none", "t5", "table1@5000"),
    ("huber_contract_u_diag", "none", "t5", "table1@5000"),
    ("residual_shrink", "none", "t5", "table1@5000"),
    ("huber_contract_v", "none", "t6", "wide"),
    ("huber_contract_u_diag", "none", "t6", "wide"),
    ("residual_shrink", "none", "t6", "wide"),
    ("huber_contract_v", "dense", "bn", "batch"),
    ("huber_contract_u_diag", "dense", "bn", "batch"),
    ("residual_shrink", "dense", "bn", "batch"),
    ("huber_contract_v", "none", "b4", "batch_fig1"),
    ("huber_contract_u_diag", "none", "b4", "batch_fig1"),
]
# Flash rows: (row name, (B, S_q, S_kv, H, d), causal, dtype, phase whose
# launches the row reports or None).
FLASH_ROWS = [
    ("flash_attention",
     (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 128), True, "bf16",
     "serve"),
    ("flash_attention@f32_small_lm",
     (SMALL_BATCH, SMALL_PROMPT, SMALL_PROMPT, 4, 32), True, "f32",
     "small_lm"),
    ("flash_attention@f32", (1, 256, 256, 4, 64), True, "f32", None),
    ("flash_attention@f32_cross", (2, 64, 200, 2, 64), False, "f32", None),
    ("flash_attention@f32_T",
     (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 64), True, "f32",
     "serve_f32"),
]


T0 = time.perf_counter()


def emit(**fields) -> None:
    """One JSON line, with the seconds since the script started."""
    print(json.dumps({**fields, "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, launches: int = TIMED_LAUNCHES,
            warmup: int = WARMUP_LAUNCHES) -> float:
    """Mean milliseconds per call over ``launches`` calls, after
    ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def profiled_ms(fn, match: str, launches: int = TIMED_LAUNCHES) -> float:
    """The profiler's device time per call of the kernels whose name holds
    ``match``, over ``launches`` calls after a warm-up: the kernel alone,
    without the host work that a CUDA-event time of back-to-back calls
    includes when the host is the slower of the two."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(WARMUP_LAUNCHES):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and match in ev.key
               ) / 1e3 / launches


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
        "residual_shrink_psi": (2 * e * m * n * r, 2 * e * m * n),
    }[fn]
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = (m_bytes * e * m * n + w_bytes + factors + 4 * out) \
        / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _kernel_fns(fn: str):
    from repro_torch.kernels import huber_contract as hc
    from repro_torch.kernels import shrinkage as sh

    module = sh if fn.startswith("residual_shrink") else hc
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
    n5 = max(TABLE1)
    t5 = prob.generate_problem(0, n5, n5, n5 // 20, TABLE1_SPARSITY,
                               device=device)
    sets["t5"] = client_set(t5.m_obs, TABLE1_CLIENTS, n5 // 10, None)
    t6 = prob.generate_problem(0, WIDE_N, WIDE_N, WIDE_TRUE_RANK,
                               TABLE1_SPARSITY, device=device)
    sets["t6"] = client_set(t6.m_obs, TABLE1_CLIENTS, WIDE_RANK, None)
    del t5, t6

    def batch_set(seeds, n, clients, rank, ragged):
        """A batch's operands: each problem's client set, the problems'
        clients one after the other (the solver's fold)."""
        parts = []
        for seed in seeds:
            q = prob.generate_problem(seed, n, n, rank, SPARSITY,
                                      device=device)
            w = torch.ones(n, n, device=device) if ragged else None
            parts.append(client_set(q.m_obs, clients, rank, w))
        return tuple(torch.cat(xs) for xs in zip(*parts))

    sets["bn"] = batch_set(range(1, BATCH + 1), BATCH_N, BATCH_CLIENTS,
                           BATCH_RANK, ragged=True)
    sets["b4"] = batch_set(range(FIG1_BATCH), M_ROWS, CLIENTS, RANK,
                           ragged=False)
    return sets


def check_bit_exact(operands: dict) -> dict:
    """At the compact-plane shapes: a packed mask gives the bits of the
    dense one (dual, u_diag, v, u), and an all-ones mask the bits of none
    (u, dual), in fp32 and bf16.  At every operand set (one column range at
    fig1, several at cf, d32 and d16) and mask mode: huber_contract_u's
    out_u, and the dual's out_u, obj and psi2, are u_diag's bit for bit."""
    import torch

    from repro_torch.kernels import huber_contract as hc

    checks = {}
    for key, modes in (("fig1", ("none",)), ("cf", ("none",)),
                       ("d32", ("none", "dense", "packed")),
                       ("d16", ("none", "dense", "packed"))):
        u, v, blocks, lam, w, packed = operands[key]
        for mode in modes:
            wm = {"none": None, "dense": w, "packed": packed}[mode]
            diag = hc.huber_contract_u_diag(u, v, blocks, lam, wm)
            dual = hc.huber_dual_contract(u, v, blocks, lam, wm)
            checks[f"u==u_diag@{key}:{mode}"] = torch.equal(
                hc.huber_contract_u(u, v, blocks, lam, wm), diag[0])
            checks[f"dual==u_diag@{key}:{mode}"] = all(
                torch.equal(a, b) for a, b in zip(dual[1:], diag))
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


def flash_bound(b: int, sq: int, skv: int, h: int, d: int, causal: bool,
                dtype: str, peak: float | None = None,
                products: int = 1) -> tuple[float, str]:
    """Least time (ms) for one attention call: 4 d FLOP per (query, key)
    pair this call's mask keeps (row i sees keys j <= i when causal), times
    ``products``, at ``peak`` (default: the input type's, bf16 tensor cores
    or fp32 CUDA cores), against Q, K, V read once and O written once at
    the HBM rate."""
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    elem = 2 if dtype == "bf16" else 4
    if peak is None:
        peak = PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_FP32_FLOPS
    t_ops = products * 4 * b * h * d * pairs / peak * 1e3
    t_bytes = elem * b * h * d * 2 * (sq + skv) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_row_err(got, want) -> float:
    """The largest error of one query row (b, i) relative to that row:
    max over (h, d) of |got - want| over max over (h, d) of |want|."""
    diff = (got.float() - want.float()).abs().amax(dim=(2, 3))
    return (diff / want.float().abs().amax(dim=(2, 3)).clamp_min(1e-30)
            ).max().item()


def check_flash(name: str, shape: tuple, causal: bool, dtype: str,
                path: str | None, device) -> dict:
    """The flash kernel against its plain version on random (B, S, H, d)
    tensors: the error row by row against the plain version in fp32 on the
    same (exactly upcast) inputs, both times, PyTorch's SDPA on the same tensors in
    (B, H, S, d) (``library_ms``; the port never calls it) and the bound."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa

    b, sq, skv, h, d = shape
    g = torch.Generator(device=device).manual_seed(0)
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=device).to(tdt)
               for s in (sq, skv, skv))
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                    causal=causal)
    again = fa.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    abs_err = (got.float() - want).abs().max().item()
    row_err = flash_row_err(got, want)
    same = bool(torch.equal(got, again))
    ok = row_err <= FLASH_TOL[dtype] and same
    ms = cuda_ms(lambda: fa.flash_attention(q, k, v, causal=causal))
    device_ms = profiled_ms(
        lambda: fa.flash_attention(q, k, v, causal=causal), "flash")
    plain_ms = cuda_ms(lambda: fa.flash_attention_plain(q, k, v,
                                                        causal=causal))
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal))
    bound_ms, bound_by = flash_bound(b, sq, skv, h, d, causal, dtype)
    # The fp32 kernel runs three TF32 products on the tensor cores: its
    # bound there, beside the CUDA-core one of the same fp32 function.
    tc_bound = flash_bound(b, sq, skv, h, d, causal, dtype, PEAK_TF32_FLOPS,
                           3)[0] if dtype == "f32" else None
    row = dict(name=name, kernel="flash_attention", path=path, route="cuda",
               source=SOURCES["flash_attention"],
               replaces=REPLACES["flash_attention"], dtype=dtype,
               causal=causal, max_abs_err=abs_err, max_row_err=row_err,
               tol=FLASH_TOL[dtype], bit_identical_rerun=same, ok=ok, ms=ms,
               kernel_device_ms=device_ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by,
               bound_3xtf32_ms=tc_bound, library_ms=library_ms,
               shape=list(shape))
    emit(phase="kernel", **row)
    if not ok:
        raise SystemExit(f"kernel {name} disagrees with its plain version: "
                         f"row error {row_err:.3e}, rerun identical {same}")
    return row


def psi_phase(operands: dict) -> dict:
    """``kernels.ops.residual_shrink_psi`` through its entry point on the
    fig1 operands (no mask), the d32 ones (dense mask) and the d16 ones
    (bf16 M): S + Psi == W R within 1e-4 of max|W R|, |Psi| <= lam up to
    the rounding of |R| - lam, and exactly 2 / 1 launches."""
    import torch

    from repro_torch.kernels import ops

    cases = [("fig1", False), ("d32", True), ("d16", False)]
    ops.reset_launch_counts()
    outs = []
    for key, masked in cases:
        u, v, blocks, lam, w, _ = operands[key]
        w = w if masked else None
        outs.append((key, ops.residual_shrink_psi(u, v, blocks, lam, w=w)))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = {"residual_shrink_psi": 2, "residual_shrink_psi_masked": 1}
    checks = {}
    for (key, masked), (_, (s_, psi)) in zip(cases, outs):
        u, v, blocks, lam, w, _ = operands[key]
        r = blocks.float() - u @ v.transpose(1, 2)
        if masked:
            r = w * r
        err = ((s_ + psi - r).abs().max() / r.abs().max()).item()
        within = bool((psi.abs() <= lam[:, None, None]
                       + 1e-6 * r.abs()).all())
        checks[key] = dict(identity_rel_err=err, psi_within_lam=within,
                           ok=err <= 1e-4 and within)
    ok = (all(c["ok"] for c in checks.values())
          and counts == {k: want.get(k, 0) for k in counts})
    row = dict(phase="psi", checks=checks,
               launches={k: c for k, c in counts.items() if c or k in want},
               expected_launches=want, ok=ok)
    emit(**row)
    if not ok:
        raise SystemExit("phase psi failed")
    row["launches"] = counts
    return row


def small_trajectory_check(device) -> dict:
    """5 DCF rounds at 160 x 160 (E=8, r=8) on the card against the same
    rounds of the plain versions on the CPU, from one seed, for each round
    flavour: the consensus U must agree to 1e-4 relative.  IALM and APGM
    at 160 x 160, card against CPU: L and S within 1e-5 relative."""
    import torch

    from repro_torch import rpca
    from repro_torch.core import APGMConfig, IALMConfig
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
    # The convex baselines: the same problem on the card and on the CPU.
    convex = {}
    for method, cfg in (("ialm", IALMConfig(iters=CONVEX_ITERS["ialm"])),
                        ("apgm", APGMConfig(iters=CONVEX_ITERS["apgm"]))):
        cpu = rpca.solve(dense.m_obs, method=method, cfg=cfg, device="cpu")
        gpu = rpca.solve(dense.m_obs.to(device), method=method, cfg=cfg,
                         device=device)
        convex[method] = max(
            (torch.linalg.norm(a.cpu() - b) / torch.linalg.norm(b)).item()
            for a, b in ((gpu.l, cpu.l), (gpu.s, cpu.s)))
    return dict(u_rel_diff_vs_cpu=diffs, convex_rel_diff_vs_cpu=convex,
                convex_tol=SMALL_CONVEX_TOL,
                ok=(all(d <= 1e-4 for d in diffs.values())
                    and all(d <= SMALL_CONVEX_TOL
                            for d in convex.values())))


#: The port's kernels by family: the launch counters' names and the
#: substring of the device kernels' names each family launches (one
#: device kernel a wrapper call; the split sums run as sum_partials_kernel).
KERNEL_FAMILIES = {
    "contract_v": (("huber_contract_v",), "contract_v_"),
    "stripe": (("huber_contract_u", "huber_contract_u_diag",
                "huber_dual_contract"), "stripe_"),
    "shrink": (("residual_shrink", "residual_shrink_psi"), "shrink_"),
}


def family_launches(counts: dict[str, int]) -> dict[str, int]:
    """The launch counters summed by kernel family (every mask mode)."""
    return {fam: sum(c for k, c in counts.items()
                     if k.removesuffix("_masked").removesuffix("_packed")
                     in names)
            for fam, (names, _) in KERNEL_FAMILIES.items()}


def profile_run(run, families: bool = False) -> dict:
    """Where one run's time goes on the card: ``run()`` once under
    torch.profiler.  The device busy time is the sum of kernel times (one
    stream, so kernels do not overlap); beside it the kernels that take
    the most of it and the host's CUDA runtime calls, by count
    (``cudaGraphLaunch`` for each replay) and the replays' device period
    (:func:`replay_period_ms`).  With ``families`` also the
    device kernels launched, by :data:`KERNEL_FAMILIES` (CUPTI records the
    kernels a graph replay launches, by name, as any other)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    # The raw trace, summed here: key_averages() builds an operator tree
    # over every event first, ~100 us an event (tens of seconds a solve).
    kernels: dict[str, list] = {}
    runtime: dict[str, int] = {}
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            entry = kernels.setdefault(name, [0, 0])
            entry[0] += 1
            entry[1] += ev.duration_ns()
        elif name.startswith("cuda"):
            runtime[name] = runtime.get(name, 0) + 1
    top = sorted(kernels.items(), key=lambda kv: kv[1][1], reverse=True)
    out = dict(
        wall_ms_profiled=wall * 1e3,
        device_busy_ms=sum(ns for _, ns in kernels.values()) / 1e6,
        top_kernels=[{"name": name[:96], "calls": calls, "device_ms": ns / 1e6}
                     for name, (calls, ns) in top[:TOP_KERNELS]],
        runtime_calls=runtime,
        graph_replays=replay_period_ms(prof),
        profile_read_s=time.perf_counter() - t1,
    )
    if families:
        out["device_kernels"] = {
            fam: sum(calls for name, (calls, _) in kernels.items()
                     if part in name)
            for fam, (_, part) in KERNEL_FAMILIES.items()}
    return out


def graph_fields() -> dict:
    """The round graphs of the run since ``runtime.reset_graph_counts``:
    captures, replays, the host's capture and instantiate ms, and the
    ``cudaMalloc`` calls the captures made (the graph pool growing)."""
    from repro_torch.core import runtime as rt

    g = rt.graph_counts
    return dict(graph_captures=g["captures"], graph_replays=g["replays"],
                capture_ms=g["capture_s"] * 1e3,
                instantiate_ms=g["instantiate_s"] * 1e3,
                capture_mallocs=g["capture_mallocs"])


def solve_phase(name: str, device, problem, spec_kw: dict, method: str,
                cfg, want: dict[str, int], error, bar: float, extra=None,
                run=None, finite: bool = True):
    """Phases 4-9, table1, wide, elastic, the batch phases and wire: one
    solve through the front door (with ``run``; ``problem.m_obs`` (m, n),
    or (B, m, n) for a batch), its launch counts (zeroed just before, read
    just after; every kernel not in ``want`` must be launched 0 times) and
    ``error(result)`` against ``bar``; L and S must be finite (non-finite
    with ``finite=False``); ``extra(result)`` adds fields to the row, as
    do the counted run's round graphs (captures, replays: one capture and
    T - 1 replays for a capturable solver, none for the convex ones).
    Returns the phase's row (with the profiled run's device busy ms) and
    its result."""
    import torch

    from repro_torch import rpca
    from repro_torch.core import runtime as rt
    from repro_torch.kernels import ops

    def solve():
        return rpca.solve(rpca.RPCASpec(problem.m_obs, **spec_kw),
                          method=method, cfg=cfg, run=run, device=device)

    # A first solve warms the libraries (cuBLAS, cuSOLVER); the second is
    # the measured, counted run.
    solve()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rt.reset_graph_counts()
    t0 = time.perf_counter()
    res = solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    graphs = graph_fields()
    expected = {k: want.get(k, 0) for k in counts}
    err = error(res)
    is_finite = bool(torch.isfinite(res.l).all()
                     and torch.isfinite(res.s).all())
    shape = tuple(problem.m_obs.shape)
    ok = (err < bar and is_finite == finite and counts == expected
          and tuple(res.l.shape) == shape and res.l.dtype == torch.float32)
    row = dict(phase=name, method=method, m=shape[-2], n=shape[-1],
               batch=shape[0] if len(shape) == 3 else None,
               rank=getattr(cfg, "rank", None),
               clients=spec_kw.get("num_clients"),
               fused=getattr(cfg, "fused", None),
               pack_mask=getattr(cfg, "pack_mask", None),
               data_dtype=str(res.spec.m_obs.dtype).removeprefix("torch."),
               error=err, bar=None if math.isinf(bar) else bar,
               finite=is_finite, wall_s=wall,
               launches={k: c for k, c in counts.items() if c or k in want},
               expected_launches=want,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               **graphs, ok=ok)
    if extra is not None:
        row.update(extra(res))
    emit(**row)
    # After the counts are read: one more solve, under the profiler.
    profiled = profile_run(solve)
    emit(phase=f"{name}_profile", wall_ms=wall * 1e3,
         device_busy_share=profiled["device_busy_ms"] / (wall * 1e3),
         **profiled)
    if not ok:
        raise SystemExit(f"phase {name} failed")
    row["launches"] = counts
    row["device_busy_ms"] = profiled["device_busy_ms"]
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
                f"residual_shrink{suffix}": 1}
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


def upper_rank_phase(device, name: str, n: int, r: int, p_ub: int,
                     bar: float) -> dict:
    """"dcf" with E=10 at rank ``p_ub`` on the port's n x n problem (seed
    0, true rank ``r``, 5% corruption) through the front door (a row as
    solve_phase's, the error being the singular-value error, under
    ``bar``, the paper's value or none), then the same problem on the
    plain route (``impl="ref"``):
    the two routes' errors within :data:`TABLE1_ROUTES_TOL` of each
    other."""
    import torch

    from repro_torch import rpca
    from repro_torch.core import metrics
    from repro_torch.core import problems as prob
    from repro_torch.core.factorized import DCFConfig

    problem = prob.generate_problem(0, n, n, r, TABLE1_SPARSITY,
                                    device=device)
    cfg = DCFConfig.tuned(p_ub)
    rounds = cfg.outer_iters * cfg.local_iters
    want = {"huber_contract_v": rounds * cfg.inner_sweeps,
            "huber_contract_u_diag": rounds, "residual_shrink": 1}

    def sv_err(res):
        return metrics.singular_value_error(res.l, problem.l0, r).item()

    row, _ = solve_phase(
        name, device, problem, {"num_clients": TABLE1_CLIENTS},
        "dcf", cfg, want, sv_err, bar,
        extra=lambda res: dict(
            paper_sv_err=None if math.isinf(bar) else bar,
            upper_rank=p_ub, true_rank=r,
            rank_gap=metrics.rank_gap(res.l, r).item()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = rpca.solve(problem.m_obs, method="dcf",
                       cfg=DCFConfig.tuned(p_ub, impl="ref"),
                       num_clients=TABLE1_CLIENTS, device=device)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    plain_err = sv_err(plain)
    gap = abs(plain_err - row["error"]) / row["error"]
    routes = dict(phase=f"{name}_routes", n=n, kernel_sv_err=row["error"],
                  plain_sv_err=plain_err, rel_diff=gap,
                  tol=TABLE1_ROUTES_TOL, plain_wall_s=plain_wall,
                  plain_rank_gap=metrics.rank_gap(plain.l, r).item(),
                  ok=gap <= TABLE1_ROUTES_TOL)
    emit(**routes)
    if not routes["ok"]:
        raise SystemExit(f"{name} at n={n}: the kernel and plain routes "
                         f"disagree ({gap:.3e})")
    del problem, plain
    torch.cuda.empty_cache()
    return row


def table1_phase(device) -> list[dict]:
    """Paper Table 1 on the card: for each n of :data:`TABLE1`, p = 2r
    with r = 0.05 n, under the paper's value (:func:`upper_rank_phase`)."""
    rows = []
    for n, paper in TABLE1.items():
        r = max(2, n // 20)
        row = upper_rank_phase(device, "table1", n, r, 2 * r, paper)
        row["phase"] = f"table1@{n}"
        rows.append(row)
    return rows


def wide_phase(device) -> dict:
    """Ranks above 512 end to end: "dcf" with E=10 at p = 600 (three rank
    chunks) on the table1 generator's n = 4000, r = 300 problem, the plain
    route's singular-value error within 10% (:func:`upper_rank_phase`;
    no paper value bounds it)."""
    return upper_rank_phase(device, "wide", WIDE_N, WIDE_TRUE_RANK,
                            WIDE_RANK, math.inf)


def elastic_phase(device, dcf_error: float) -> list[dict]:
    """The fault-tolerant engine on the dcf phase's Fig. 1 problem (E=10)
    through ``rpca.solve(method="dcf")``, each solve as a solve_phase row
    (wall, busy share, peak memory, exact launch counts: dropped and
    faulted clients still run their local round):

    - ``elastic``: DCFConfig.elastic(150, participation=0.5) with a rate-0.5
      schedule, relative error <= :data:`ELASTIC_BAR`;
    - ``nan_mean``: FaultPlan.byzantine(T, 10, (1, 5), kind="nan") under
      the weighted mean: L must come out non-finite (the payloads reach
      the consensus); ``nan_median``: the same plan under the coordinate
      median, within 3x the dcf phase's error (at least 1e-6);
      ``nan_median_tracked``: that solve with track_objective (the
      objective pass of every faulted round, plain PyTorch);
    - ``corrupt_trimmed``: kind="corrupt" on client 2 under the trimmed
      mean (0.25), within the same bar;
    - ``checkpoint``: DCFConfig.tuned(150) with checkpoint_every=25 into a
      temporary directory; the same solve interrupted after its first
      snapshot and resumed gives its L, S, U, V and traces bit for bit,
      and so does one unsegmented solve.
    """
    import dataclasses
    import tempfile

    import torch

    from repro_torch import rpca
    from repro_torch.core import metrics
    from repro_torch.core import problems as prob
    from repro_torch.core import runtime as rt
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.distributed.faults import FaultPlan

    p = prob.generate_problem(0, M_ROWS, N_COLS, RANK, SPARSITY,
                              device=device)

    def err(res):
        return metrics.relative_error(res.l, res.s, p.l0, p.s0).item()

    def want_for(cfg):
        rounds = cfg.outer_iters * cfg.local_iters
        return {"huber_contract_v": rounds * cfg.inner_sweeps,
                "huber_contract_u_diag": rounds, "residual_shrink": 1}

    rows = []
    elastic = DCFConfig.elastic(RANK, participation=0.5)
    rows.append(solve_phase(
        "elastic", device, p, {"num_clients": CLIENTS, "participation": 0.5},
        "dcf", elastic, want_for(elastic), err, ELASTIC_BAR)[0])
    cfg = DCFConfig.tuned(RANK)
    bar = 3.0 * max(dcf_error, 1e-6)
    nan = FaultPlan.byzantine(cfg.outer_iters, CLIENTS, (1, 5), kind="nan")
    rows.append(solve_phase(
        "nan_mean", device, p, {"num_clients": CLIENTS, "faults": nan},
        "dcf", cfg, want_for(cfg), lambda res: 0.0, math.inf,
        finite=False)[0])
    median = dataclasses.replace(cfg, aggregator="coordinate_median")
    rows.append(solve_phase(
        "nan_median", device, p, {"num_clients": CLIENTS, "faults": nan},
        "dcf", median, want_for(cfg), err, bar)[0])
    tracked = dataclasses.replace(median, track_objective=True)
    rows.append(solve_phase(
        "nan_median_tracked", device, p,
        {"num_clients": CLIENTS, "faults": nan}, "dcf", tracked,
        want_for(cfg), err, bar)[0])
    corrupt = FaultPlan.byzantine(cfg.outer_iters, CLIENTS, (2,),
                                  kind="corrupt")
    trimmed = dataclasses.replace(cfg, aggregator="trimmed_mean",
                                  trim_frac=0.25)
    rows.append(solve_phase(
        "corrupt_trimmed", device, p,
        {"num_clients": CLIENTS, "faults": corrupt}, "dcf", trimmed,
        want_for(cfg), err, bar)[0])

    run = rt.RunConfig(mode="scan", checkpoint_every=CHECKPOINT_EVERY)
    with tempfile.TemporaryDirectory() as tmp:
        row, whole = solve_phase(
            "checkpoint", device, p,
            {"num_clients": CLIENTS, "checkpoint_dir": f"{tmp}/whole"},
            "dcf", cfg, want_for(cfg), err, ERR_BAR, run=run)

        class Interrupted(Exception):
            """The solve dies after its first snapshot."""

        def interrupt(t, carry):
            raise Interrupted

        segmented = rt.run_segmented
        rt.run_segmented = lambda *a, **k: segmented(
            *a, save_extra=interrupt, **k)
        try:
            rpca.solve(p.m_obs, method="dcf", cfg=cfg, run=run,
                       num_clients=CLIENTS, checkpoint_dir=f"{tmp}/cut",
                       device=device)
            interrupted = False
        except Interrupted:
            interrupted = True
        finally:
            rt.run_segmented = segmented
        resumed = rpca.solve(p.m_obs, method="dcf", cfg=cfg, run=run,
                             num_clients=CLIENTS, resume_from=f"{tmp}/cut",
                             device=device)
        single = rpca.solve(p.m_obs, method="dcf", cfg=cfg,
                            num_clients=CLIENTS, device=device)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            (a.l, a.s, a.u, a.v, a.stats.objective, a.stats.residual),
            (b.l, b.s, b.u, b.v, b.stats.objective, b.stats.residual)))

    check = dict(phase="checkpoint_resume", interrupted=interrupted,
                 resumed_bit_identical=same(whole, resumed),
                 single_scan_bit_identical=same(whole, single))
    check["ok"] = all(check[k] for k in ("interrupted",
                                         "resumed_bit_identical",
                                         "single_scan_bit_identical"))
    emit(**check)
    if not check["ok"]:
        raise SystemExit("a resumed solve differs from the uninterrupted one")
    rows.append(row)
    return rows


def _stacked(problems):
    """A batch spec's data: the problems' M on a leading axis."""
    import torch

    return SimpleNamespace(m_obs=torch.stack([p.m_obs for p in problems]))


def _errors(res, problems) -> list[float]:
    from repro_torch.core import metrics

    return [metrics.relative_error(res.l[b], res.s[b], p.l0, p.s0).item()
            for b, p in enumerate(problems)]


def _serial(problems, cfg, method="dcf", **kw):
    """Each problem of a batch solved alone (problem b from seed key + b,
    as the batch draws it), timed after one warm-up solve: (results,
    wall seconds)."""
    import torch

    from repro_torch import rpca

    key = kw.pop("key", 0)

    def one(b, p):
        return rpca.solve(p.m_obs, method=method, cfg=cfg, key=key + b, **kw)

    one(0, problems[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = [one(b, p) for b, p in enumerate(problems)]
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _want(cfg, rounds=None, suffix=""):
    """Exact launches of a dcf/cf solve (or batch) of ``rounds`` rounds."""
    local = (cfg.outer_iters if rounds is None else rounds) * cfg.local_iters
    u_step = "huber_contract_u" if cfg.fused == "off" \
        else "huber_contract_u_diag"
    return {f"huber_contract_v{suffix}": local * cfg.inner_sweeps,
            f"{u_step}{suffix}": local, f"residual_shrink{suffix}": 1}


def batch_phase(device) -> list[dict]:
    """benchmarks/solver_runtime_bench.py's batch at its full setting
    (:data:`BATCH` problems of 500 x 500, rank 8, E = 8 ragged,
    DCFConfig.tuned(8)) through ``rpca.solve`` on a (B, m, n) spec: one
    launch of each masked kernel a sweep for the whole batch (T·K·J / T·K /
    1), the wall and busy share against the B serial solves', problems/s,
    the largest |L_b - L_serial| (<= 1e-3) and the worst recovery error;
    then the benchmark's chunked early exit: each problem's rounds, its
    traces zero past them, and the launches of the rounds the batch ran
    (the host reads the done mask once a chunk)."""
    import torch

    from repro_torch import rpca
    from repro_torch.core import problems as prob
    from repro_torch.core import runtime as rt
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.kernels import ops

    problems = [prob.generate_problem(1 + b, BATCH_N, BATCH_N, BATCH_RANK,
                                      SPARSITY, device=device)
                for b in range(BATCH)]
    batch = _stacked(problems)
    cfg = DCFConfig.tuned(BATCH_RANK)
    kw = {"num_clients": BATCH_CLIENTS, "key": BATCH_KEY}
    row, res = solve_phase("batch", device, batch, kw, "dcf", cfg,
                           _want(cfg, suffix="_masked"),
                           lambda r: max(_errors(r, problems)),
                           BATCH_ERR_BAR)
    serial, serial_wall = _serial(problems, cfg, device=device, **kw)
    diff = max((res.l[b] - serial[b].l).abs().max().item()
               for b in range(BATCH))
    versus = dict(
        phase="batch_vs_serial", batch=BATCH, n=BATCH_N,
        batch_wall_s=row["wall_s"],
        batch_busy_share=row["device_busy_ms"] / (row["wall_s"] * 1e3),
        serial_wall_s=serial_wall,
        batch_problems_per_s=BATCH / row["wall_s"],
        serial_problems_per_s=BATCH / serial_wall,
        speedup=serial_wall / row["wall_s"],
        max_abs_diff_vs_serial=diff, tol=BATCH_TOL,
        max_error=max(_errors(res, problems)),
        max_serial_error=max(metrics_err(r, p)
                             for r, p in zip(serial, problems)),
        ok=diff <= BATCH_TOL)
    emit(**versus)
    if not versus["ok"]:
        raise SystemExit("a batched solve differs from its serial solve")

    run = rt.RunConfig(mode="chunk", tol=BATCH_EARLY_TOL,
                       chunk_size=BATCH_CHUNK)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    early = rpca.solve(rpca.RPCASpec(batch.m_obs, **kw), method="dcf",
                       cfg=cfg, run=run, device=device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rounds = early.stats.rounds.tolist()
    ran = min(cfg.outer_iters, -(-max(rounds) // BATCH_CHUNK) * BATCH_CHUNK)
    want = _want(cfg, ran, "_masked")
    resid = early.stats.residual
    frozen = all(bool((resid[b, r:] == 0).all() and (resid[b, :r] > 0).all())
                 for b, r in enumerate(rounds))
    chunk = dict(phase="batch_early", tol=BATCH_EARLY_TOL, chunk=BATCH_CHUNK,
                 rounds=rounds, rounds_run=ran,
                 converged=early.stats.converged.tolist(),
                 traces_zero_past_exit=frozen, wall_s=wall,
                 max_error=max(_errors(early, problems)),
                 launches={k: c for k, c in counts.items() if c or k in want},
                 expected_launches=want,
                 ok=frozen and counts == {k: want.get(k, 0) for k in counts})
    emit(**chunk)
    if not chunk["ok"]:
        raise SystemExit("phase batch_early failed")
    return [row]


def batch_fig1_phase(device, dcf_busy_ms: float) -> list[dict]:
    """Four Fig. 1 problems (3000 x 3000, r = 150, 5%, seeds 0-3, E = 10,
    DCFConfig.tuned(150)) in one scan-mode batch: each under the 1e-4 bar,
    600 / 200 / 1 launches for the batch, the busy time against four
    times the dcf phase's, the peak memory, the largest difference from the
    serial solves; and problem 0's bits unchanged when problems 1-3 are
    other seeds' (its batch-mates)."""
    import torch

    from repro_torch import rpca
    from repro_torch.core import problems as prob
    from repro_torch.core.factorized import DCFConfig

    def fig1(seed):
        return prob.generate_problem(seed, M_ROWS, N_COLS, RANK, SPARSITY,
                                     device=device)

    problems = [fig1(seed) for seed in range(FIG1_BATCH)]
    cfg = DCFConfig.tuned(RANK)
    kw = {"num_clients": CLIENTS}
    row, res = solve_phase("batch_fig1", device, _stacked(problems), kw,
                           "dcf", cfg, _want(cfg),
                           lambda r: max(_errors(r, problems)), ERR_BAR)
    serial, serial_wall = _serial(problems, cfg, device=device, **kw)
    diff = max((res.l[b] - serial[b].l).abs().max().item()
               for b in range(FIG1_BATCH))
    mates = _stacked(problems[:1] + [fig1(seed) for seed in FIG1_MATES])
    other = rpca.solve(mates.m_obs, method="dcf", cfg=cfg, device=device,
                       **kw)
    same = all(torch.equal(x[0], y[0]) for x, y in (
        (res.l, other.l), (res.s, other.s), (res.u, other.u),
        (res.v, other.v), (res.stats.residual, other.stats.residual)))
    versus = dict(phase="batch_fig1_vs_serial", batch=FIG1_BATCH,
                  busy_ms=row["device_busy_ms"],
                  dcf_busy_ms_x4=FIG1_BATCH * dcf_busy_ms,
                  batch_wall_s=row["wall_s"], serial_wall_s=serial_wall,
                  peak_mem_gb=row["peak_mem_gb"],
                  errors=_errors(res, problems),
                  max_abs_diff_vs_serial=diff, tol=BATCH_TOL,
                  mates_leave_bits=same, ok=same and diff <= BATCH_TOL)
    emit(**versus)
    if not versus["ok"]:
        raise SystemExit("phase batch_fig1 failed")
    return [row]


def _sync_count(fn):
    """``fn()`` and the host syncs it made
    (``torch.cuda.set_sync_debug_mode("warn")``), with its wall."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()  # not the solve's: counted off
        wall = time.perf_counter() - t0
    return out, sum("synchroniz" in str(w.message) for w in caught), wall


def batch_convex_phase(device) -> dict:
    """``apgm_batch`` and ``ialm_batch`` (the front door on a (B, m, n)
    spec: one batched SVD an iteration) at :data:`CONVEX_BATCH` x 160^2
    on the card against the card's serial solves: L and S within 1e-5
    relative, the walls, and the host syncs an iteration of each."""
    import torch

    from repro_torch import rpca
    from repro_torch.core import APGMConfig, IALMConfig
    from repro_torch.core import problems as prob

    problems = [prob.generate_problem(10 + b, CONVEX_BATCH_N, CONVEX_BATCH_N,
                                      8, SPARSITY, device=device)
                for b in range(CONVEX_BATCH)]
    mb = _stacked(problems).m_obs
    solves = {}
    for method, cfg_t in (("ialm", IALMConfig), ("apgm", APGMConfig)):
        iters = CONVEX_ITERS[method]
        cfg = cfg_t(iters=iters)
        rpca.solve(mb, method=method, cfg=cfg_t(iters=2), device=device)
        res, syncs, wall = _sync_count(
            lambda: rpca.solve(mb, method=method, cfg=cfg, device=device))
        serial, serial_syncs, serial_wall = _sync_count(
            lambda: [rpca.solve(p.m_obs, method=method, cfg=cfg,
                                device=device) for p in problems])
        rel = max((torch.linalg.norm(a[b] - x) / torch.linalg.norm(x)).item()
                  for b, one in enumerate(serial)
                  for a, x in ((res.l, one.l), (res.s, one.s)))
        solves[method] = dict(
            iters=iters, batch_wall_s=wall, serial_wall_s=serial_wall,
            batch_syncs_per_iter=syncs / iters,
            serial_syncs_per_iter=serial_syncs / (iters * CONVEX_BATCH),
            max_rel_diff_vs_serial=rel, errors=_errors(res, problems),
            ok=rel <= CONVEX_BATCH_TOL and bool(
                torch.isfinite(res.l).all() and torch.isfinite(res.s).all()))
    row = dict(phase="batch_convex", batch=CONVEX_BATCH, n=CONVEX_BATCH_N,
               tol=CONVEX_BATCH_TOL, solves=solves,
               ok=all(v["ok"] for v in solves.values()))
    emit(**row)
    if not row["ok"]:
        raise SystemExit("phase batch_convex failed")
    return row


def wire_phase(device) -> list[dict]:
    """The wire consensus on the dcf phase's problem (E = 10,
    DCFConfig.tuned(150)) through ``rpca.solve``, each case a solve_phase
    row (600 / 200 / 1 launches, recovery error, wall, busy share) with
    the modelled traffic (``consensus_traffic``: bytes a client a round,
    the dense / shipped ratio) and, for the stale cases, whether the guard
    tripped: ``consensus_delay=1``, top-k at :data:`WIRE_TOPK`, both, and
    ``topk_frac=1.0`` beside the dense solve (their difference printed);
    two compressed solves give the same bits.  At tests/test_multihost.py's
    problem, topk_frac=1.0 within 1e-4 of dense on the card."""
    import dataclasses
    import importlib

    import torch

    from repro_torch import rpca
    from repro_torch.core import problems as prob
    from repro_torch.core import runtime as rt
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.distributed import multihost as mh
    from repro_torch.distributed.grad_compress import CompressConfig

    dcf_mod = importlib.import_module("repro_torch.core.dcf_pca")
    p = prob.generate_problem(0, M_ROWS, N_COLS, RANK, SPARSITY,
                              device=device)
    base = DCFConfig.tuned(RANK)
    cases = {
        "wire_delay": dict(consensus_delay=1),
        "wire_topk": dict(consensus_compress=CompressConfig(
            topk_frac=WIRE_TOPK)),
        "wire_topk_delay": dict(consensus_delay=1, consensus_compress=(
            CompressConfig(topk_frac=WIRE_TOPK))),
        "wire_topk_full": dict(consensus_compress=CompressConfig(
            topk_frac=1.0)),
    }
    rows, results = [], {}
    for name, kw in cases.items():
        cfg = dataclasses.replace(base, **kw)
        mh.consensus_traffic(reset=True)

        def extra(res, cfg=cfg):
            traffic = mh.consensus_traffic()
            out = dict(bytes_per_round=traffic["bytes_per_round"],
                       traffic_ratio=traffic["achieved_ratio"],
                       model=mh.consensus_wire_model(
                           M_ROWS, RANK, CLIENTS, cfg.consensus_compress))
            if cfg.consensus_delay:
                problem = dcf_mod.make_problem(p.m_obs, cfg, CLIENTS, 0,
                                               device=device)
                carry, _ = rt.run(dcf_mod.make_solver(cfg), problem,
                                  cfg.outer_iters)
                out["guard_tripped"] = bool(carry["sync"])
                out["guard"] = float(carry["guard"])
            return out

        row, res = solve_phase(
            name, device, p, {"num_clients": CLIENTS}, "dcf", cfg,
            _want(cfg), lambda r: metrics_err(r, p), math.inf, extra=extra)
        rows.append(row)
        results[name] = res
    again = rpca.solve(p.m_obs, method="dcf", num_clients=CLIENTS,
                       cfg=dataclasses.replace(base, **cases["wire_topk"]),
                       device=device)
    first = results["wire_topk"]
    same = all(torch.equal(x, y) for x, y in (
        (first.l, again.l), (first.s, again.s), (first.u, again.u),
        (first.stats.residual, again.stats.residual)))
    dense = rpca.solve(p.m_obs, method="dcf", num_clients=CLIENTS, cfg=base,
                       device=device)
    full = results["wire_topk_full"]
    full_diff = (full.l - dense.l).abs().max().item()
    m, r_gen, r_fit, e, rounds = WIRE_SMALL
    q = prob.generate_problem(0, m, m, r_gen, SPARSITY, device=device)
    small_cfg = DCFConfig.tuned(r_fit, outer_iters=rounds)
    small = [rpca.solve(q.m_obs, method="dcf", num_clients=e, key=1,
                        device=device, cfg=c) for c in (
        small_cfg, dataclasses.replace(small_cfg, consensus_compress=(
            CompressConfig(topk_frac=1.0))))]
    small_diff = (small[0].l - small[1].l).abs().max().item()
    check = dict(phase="wire_checks", topk_runs_bit_identical=same,
                 full_k_vs_dense_max_abs=full_diff,
                 full_k_vs_dense_rel=(torch.linalg.norm(full.l - dense.l)
                                      / torch.linalg.norm(dense.l)).item(),
                 dense_error=metrics_err(dense, p),
                 small_full_k_vs_dense_max_abs=small_diff,
                 small_tol=WIRE_SMALL_TOL,
                 ok=same and small_diff <= WIRE_SMALL_TOL)
    emit(**check)
    if not check["ok"]:
        raise SystemExit("phase wire failed")
    return rows


def graphs_phase(device) -> list[dict]:
    """One captured round replayed against eager rounds on the card, at
    ``core.runtime``'s level (the front door has no eager switch): the dcf
    phase's Fig. 1 solve, the dual phase's, the batch phase's 16 x 500^2
    batch and the wire (top-k 0.1 and one-round stale, Fig. 1).  Each:
    every output and trace bit for bit, the walls and busy shares of both
    ways, the same launch counts, one capture and T - 1 replays, and the
    launch counters of a replayed solve of the same configuration cut to
    :data:`GRAPHS_COUNTED_ROUNDS` rounds against the profiler's device
    kernels by family (the replays' kernels, as CUPTI records them), held
    equal at the first attempt.  The full solve's profiled kernels by
    family stand beside them, not held (its trace has lost the last
    rounds' records before)."""
    import dataclasses
    import importlib

    import torch

    from repro_torch.core import problems as prob
    from repro_torch.core import runtime as rt
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.distributed.grad_compress import CompressConfig
    from repro_torch.kernels import ops

    dcf = importlib.import_module("repro_torch.core.dcf_pca")
    fig1 = prob.generate_problem(0, M_ROWS, N_COLS, RANK, SPARSITY,
                                 device=device)
    tuned = DCFConfig.tuned(RANK)
    wire = dataclasses.replace(tuned, consensus_delay=1,
                               consensus_compress=CompressConfig(
                                   topk_frac=WIRE_TOPK))
    dual_cfg = DCFConfig.masked(D_RANK, observed_frac=D_OBSERVED,
                                fused="dual")
    dual = prob.generate_problem(0, D_SIZE, D_SIZE, D_RANK, D_SPARSITY,
                                 observed_frac=D_OBSERVED, device=device)

    def build(name, rounds=None):
        """The cell's (config, problem), cut to ``rounds`` outer rounds."""
        def cut(cfg):
            return cfg if rounds is None else dataclasses.replace(
                cfg, outer_iters=rounds)
        if name in ("dcf", "wire"):
            cfg = cut(tuned if name == "dcf" else wire)
            return cfg, dcf.make_problem(fig1.m_obs, cfg, CLIENTS, 0,
                                         device=device)
        if name == "dual":
            cfg = cut(dual_cfg)
            return cfg, dcf.make_problem(dual.m_obs, cfg, D_CLIENTS, 0,
                                         mask=dual.mask, device=device)
        cfg = cut(DCFConfig.tuned(BATCH_RANK))
        ms = torch.stack([prob.generate_problem(
            1 + b, BATCH_N, BATCH_N, BATCH_RANK, SPARSITY,
            device=device).m_obs for b in range(BATCH)])
        return cfg, dcf.make_batch(ms, cfg, BATCH_CLIENTS, BATCH_KEY,
                                   device=device)

    def solver_run(cfg, problem, batch):
        """``solve(eager)`` of one cell: its finalize output and stats."""
        solver = dcf.make_solver(cfg)
        t = cfg.outer_iters

        def solve(eager):
            if batch:
                out, _, stats = rt.solve_batch(solver, problem, t,
                                               eager=eager)
                return out, stats
            carry, stats = rt.run(solver, problem, t, eager=eager)
            return solver.finalize(problem, carry), stats

        return solve

    rows = []
    for name in ("dcf", "dual", "batch", "wire"):
        cfg, problem = build(name)
        t = cfg.outer_iters
        solve = solver_run(cfg, problem, name == "batch")
        solve(True)
        solve(False)
        way = {}
        for eager in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            rt.reset_graph_counts()
            t0 = time.perf_counter()
            out = solve(eager)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            way[eager] = dict(out=out, wall_s=wall,
                              counts=ops.launch_counts(),
                              peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                              **graph_fields())
        same = all(torch.equal(a, b) for a, b in zip(
            rt.leaves(way[True]["out"]), rt.leaves(way[False]["out"]),
            strict=True))
        prof = {True: profile_run(lambda: solve(True)),
                False: profile_run(lambda: solve(False), families=True)}
        del problem, solve
        # The counters against the trace on the cut solve (one attempt).
        short_cfg, short_problem = build(name, GRAPHS_COUNTED_ROUNDS)
        short = solver_run(short_cfg, short_problem, name == "batch")
        short(False)
        ops.reset_launch_counts()
        short(False)
        counted = family_launches(ops.launch_counts())
        seen = profile_run(lambda: short(False),
                           families=True)["device_kernels"]
        del short_problem, short
        g = way[False]
        row = dict(
            phase=f"graphs_{name}", rounds=t, bit_identical=same,
            eager_wall_s=way[True]["wall_s"], replay_wall_s=g["wall_s"],
            eager_busy_ms=prof[True]["device_busy_ms"],
            replay_busy_ms=prof[False]["device_busy_ms"],
            eager_busy_share=(prof[True]["device_busy_ms"]
                              / (way[True]["wall_s"] * 1e3)),
            replay_busy_share=(prof[False]["device_busy_ms"]
                               / (g["wall_s"] * 1e3)),
            eager_peak_gb=way[True]["peak_gb"], replay_peak_gb=g["peak_gb"],
            graph_captures=g["graph_captures"],
            graph_replays=g["graph_replays"], capture_ms=g["capture_ms"],
            instantiate_ms=g["instantiate_ms"],
            graph_launches=prof[False]["runtime_calls"].get(
                "cudaGraphLaunch", 0),
            eager_kernel_launches=prof[True]["runtime_calls"].get(
                "cudaLaunchKernel", 0),
            replay_kernel_launches=prof[False]["runtime_calls"].get(
                "cudaLaunchKernel", 0),
            launches={k: c for k, c in g["counts"].items() if c},
            counted_rounds=GRAPHS_COUNTED_ROUNDS,
            counters_by_family=counted, profiler_kernels_by_family=seen,
            full_counters_by_family=family_launches(g["counts"]),
            full_profiler_kernels_by_family=prof[False]["device_kernels"])
        row["ok"] = (same and g["counts"] == way[True]["counts"]
                     and counted == seen and g["graph_captures"] == 1
                     and g["graph_replays"] == t - 1)
        emit(**row)
        if not row["ok"]:
            raise SystemExit(f"phase graphs_{name}: replay != eager")
        rows.append(row)
        del way, prof
        torch.cuda.empty_cache()
    return rows


def compile_cache_phase(device) -> dict:
    """``rpca.solve(method="cf", compile_policy="aot")`` at
    :data:`CACHE_SHAPES` (three shapes in two buckets of the AOT policy's
    grid): two entry builds, each with one capture, then every shape again
    with no build and no capture (:data:`CACHE_REPEATS` rounds of the
    three); the first-call and repeat walls of each shape beside the
    uncached solve's, each entry's bytes, every cached result bit for bit
    the eager solve of the same padded problem without the cache (a replay
    that kept anything of an earlier admission would differ), and each
    cached recovery error within 1.5x the uncached one (the reference's
    factor, tests/test_compile_cache.py:206, without its 1e-3 term: the
    errors read ~1e-10 here)."""
    import torch

    from repro_torch import rpca
    from repro_torch.core import compile_cache as cc
    from repro_torch.core import metrics
    from repro_torch.core import problems as prob
    from repro_torch.core import runtime as rt
    from repro_torch.core.factorized import DCFConfig

    cache = cc.default_cache()
    cache.clear()
    cfg = DCFConfig.tuned(CACHE_RANK)
    entry = rpca.get_solver("cf")

    def padded_eager(p):
        """(l, s) of the cache's padded problem, solved eagerly without
        the cache, finalized and trimmed."""
        spec = rpca.RPCASpec(p.m_obs)
        resolved = entry.aot.resolve_cfg(cfg, spec)
        m, n = spec.shape
        mb, nb = cc.bucket_shape(m, n, cc.AOT)
        solver, iters, make_problem = entry.aot.program(resolved, rt.FIXED)
        problem = make_problem(*cc._admit(entry.aot, spec, resolved, m, n,
                                          mb, nb, device))
        carry, _ = rt.run(solver, problem, iters, rt.FIXED, eager=True)
        l, s = solver.finalize(problem, carry)[:2]
        return l[:m, :n], s[:m, :n]

    problems = [prob.generate_problem(0, m, n, CACHE_TRUE_RANK, SPARSITY,
                                      device=device)
                for m, n in CACHE_SHAPES]

    def timed(p, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = rpca.solve(p.m_obs, method="cf", cfg=cfg, device=device, **kw)
        torch.cuda.synchronize()
        err = metrics.relative_error(res.l, res.s, p.l0, p.s0).item()
        return res, time.perf_counter() - t0, err

    timed(problems[0])  # warm the libraries
    start = cache.stats.snapshot()
    rt.reset_graph_counts()
    shapes = []
    firsts = []
    for p in problems:
        res, first, err = timed(p, compile_policy="aot")
        firsts.append(res)
        shapes.append(dict(shape=list(p.m_obs.shape),
                           bucket=list(cc.bucket_shape(*p.m_obs.shape,
                                                       cc.AOT)),
                           first_wall_s=first, error=err))
    built = cache.stats.compiles - start.compiles
    captures = rt.graph_counts["captures"]
    entry_bytes = cache.nbytes
    rt.reset_graph_counts()
    lasts = [None] * len(problems)
    for _ in range(CACHE_REPEATS):
        for i, (p, row) in enumerate(zip(problems, shapes)):
            lasts[i], again, err = timed(p, compile_policy="aot")
            row.setdefault("repeat_walls_s", []).append(again)
            row.update(repeat_error=err, shape_ok=tuple(lasts[i].l.shape)
                       == tuple(p.m_obs.shape))
    repeats = dict(rt.graph_counts)
    rebuilt = cache.stats.compiles - start.compiles - built
    for p, row, first, last in zip(problems, shapes, firsts, lasts):
        _, plain, plain_err = timed(p)
        l, s = padded_eager(p)
        same = all(bool(torch.equal(res.l, l) and torch.equal(res.s, s))
                   for res in (first, last))
        row.update(uncached_wall_s=plain, uncached_error=plain_err,
                   bit_identical_to_padded_eager=same,
                   ok=(row.pop("shape_ok") and same
                       and row["error"] <= 1.5 * plain_err
                       and row["repeat_error"] <= 1.5 * plain_err))
    row = dict(phase="compile_cache", method="cf", rank=CACHE_RANK,
               policy=dict(bucket_min=cc.AOT.bucket_min,
                           bucket_ratio=cc.AOT.bucket_ratio),
               shapes=shapes, entry_builds=built, captures_first=captures,
               builds_on_repeats=rebuilt,
               captures_on_repeats=repeats["captures"],
               replays_on_repeats=repeats["replays"],
               entries=len(cache), entries_bytes=entry_bytes,
               cache_stats=cache.stats.as_dict())
    row["ok"] = (built == 2 and captures == 2 and rebuilt == 0
                 and repeats["captures"] == 0
                 and all(r["ok"] for r in shapes))
    emit(**row)
    if not row["ok"]:
        raise SystemExit("phase compile_cache failed")
    cache.clear()
    return row


def metrics_err(res, p) -> float:
    """Relative recovery error (Eq. 30) of one solve."""
    from repro_torch.core import metrics

    return metrics.relative_error(res.l, res.s, p.l0, p.s0).item()


def svd_ms(x) -> float:
    """Milliseconds of one ``core.ops.svt`` of ``x``: CUDA events over 3
    calls after one of warm-up."""
    from repro_torch.core import ops as core_ops

    return cuda_ms(lambda: core_ops.svt(x, 1.0), launches=3, warmup=1)


def convex_phase(device) -> dict:
    """Fig. 1's convex baselines at n = 1000 on the card through the front
    door: recovery under the reference's bars, the wall, one SVD's time at
    this size and at Fig. 1's largest, and the host syncs of the solve
    (``torch.cuda.set_sync_debug_mode("warn")`` over it)."""
    import warnings

    import torch

    from repro_torch import rpca
    from repro_torch.core import APGMConfig, IALMConfig, metrics
    from repro_torch.core import problems as prob

    p = prob.generate_problem(0, CONVEX_N, CONVEX_N, CONVEX_N // 20, 0.05,
                              device=device)
    svd = {str(n): svd_ms(torch.randn(n, n, device=device,
                                      generator=torch.Generator(
                                          device=device).manual_seed(n)))
           for n in (CONVEX_N, FIG1_LARGEST)}
    solves = {}
    for method, cfg_t in (("ialm", IALMConfig), ("apgm", APGMConfig)):
        iters = CONVEX_ITERS[method]
        rpca.solve(p.m_obs, method=method, cfg=cfg_t(iters=2),
                   device=device)  # warms cuSOLVER and cuBLAS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # Each host sync of the solve warns once (a few microseconds
        # against ~100 ms an iteration).
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                t0 = time.perf_counter()
                res = rpca.solve(p.m_obs, method=method,
                                 cfg=cfg_t(iters=iters), device=device)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()  # not the solve's: counted off
            wall = time.perf_counter() - t0
        syncs = sum("synchroniz" in str(w.message) for w in caught)
        err = metrics.relative_error(res.l, res.s, p.l0, p.s0).item()
        finite = bool(torch.isfinite(res.l).all()
                      and torch.isfinite(res.s).all())
        solves[method] = dict(
            iters=iters, error=err, bar=CONVEX_BARS[method], finite=finite,
            wall_s=wall, ms_per_iter=wall * 1e3 / iters, host_syncs=syncs,
            syncs_per_iter=syncs / iters,
            peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
            ok=finite and err < CONVEX_BARS[method])
    row = dict(phase="convex", n=CONVEX_N, rank=CONVEX_N // 20,
               solves=solves, svt_ms=svd,
               ok=all(v["ok"] for v in solves.values()))
    emit(**row)
    if not row["ok"]:
        raise SystemExit("phase convex failed")
    return row


def small_lm_phase(device) -> dict:
    """Phase 10: the llama3-8b smoke config in fp32 through ``generate`` on
    the card and on the CPU, from the same weights and prompts."""
    import copy

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.serving.engine import ServeConfig, generate

    cfg = get_smoke_config(SERVE_ARCH).replace(
        param_dtype="float32", compute_dtype="float32", flash_attention=True)
    model = get_model(cfg)
    params = model.init_params(seed=0, device="cpu")
    card = copy.deepcopy(params).to(device)
    prompt = torch.randint(0, cfg.vocab, (SMALL_BATCH, SMALL_PROMPT),
                           generator=torch.Generator().manual_seed(1))
    scfg = ServeConfig(max_new_tokens=SMALL_NEW)
    want = generate(model, params, prompt, scfg)
    ops.reset_launch_counts()
    got = generate(model, card, prompt.to(device), scfg).cpu()
    counts = ops.launch_counts()
    eager = generate(model, card, prompt.to(device), scfg, eager=True).cpu()
    cpu_logits, _ = model.prefill(params, prompt)
    logits, _ = model.prefill(card, prompt.to(device))
    rel = ((logits.cpu() - cpu_logits).abs().max()
           / cpu_logits.abs().max()).item()
    want_counts = {"flash_attention": cfg.n_layers}
    ok = (bool(torch.equal(got, want)) and rel <= SMALL_LOGITS_BAR
          and bool(torch.equal(got, eager))
          and counts == {k: want_counts.get(k, 0) for k in counts})
    row = dict(phase="small_lm", arch=cfg.name, dtype="float32",
               batch=SMALL_BATCH, prompt=SMALL_PROMPT, new_tokens=SMALL_NEW,
               tokens_equal=bool(torch.equal(got, want)),
               replayed_tokens_equal_eager=bool(torch.equal(got, eager)),
               logits_rel_diff_vs_cpu=rel, bar=SMALL_LOGITS_BAR,
               launches={k: c for k, c in counts.items() if c},
               expected_launches=want_counts, ok=ok)
    emit(**row)
    if not ok:
        raise SystemExit("phase small_lm failed")
    row["launches"] = counts
    return row


class _EventTimedModel:
    """The model as ``generate`` calls it, keeping the last prefill's
    logits (held against the plain attention's), with a CUDA event
    recorded before and after the prefill and, with ``step_events``, after
    every decode step: the prefill ms of any run, and the decode ms a step
    of an eager one (a replayed run calls ``decode_step`` only to capture
    it, where no event may be recorded)."""

    def __init__(self, model, step_events: bool = False):
        self.model = model
        self.step_events = step_events
        self.events = []
        self.prefill_logits = None

    def _event(self):
        import torch

        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)

    def init_cache(self, *args):
        self.events = []
        return self.model.init_cache(*args)

    def prefill(self, *args):
        self._event()
        self.prefill_logits, caches = self.model.prefill(*args)
        self._event()
        return self.prefill_logits, caches

    def decode_step(self, *args):
        out = self.model.decode_step(*args)
        if self.step_events:
            self._event()
        return out

    def prefill_ms(self) -> float:
        """The last generate's prefill ms; call after a synchronize."""
        return self.events[0].elapsed_time(self.events[1])

    def step_ms(self) -> float:
        """The last eager generate's decode ms a step (sampling included);
        call after a synchronize."""
        return (self.events[1].elapsed_time(self.events[-1])
                / (len(self.events) - 2))


def replay_period_ms(prof) -> dict:
    """The graph replays of a profiled run, from the trace: the device ms
    from one replay's first kernel to the next one's (the mean over the
    run: what a replayed step takes on the card, idle gaps included) and
    the kernel ms a replay.  A kernel that a graph launches carries its
    ``cudaGraphLaunch``'s correlation id."""
    from torch.autograd import DeviceType

    launches, first, busy = set(), {}, {}
    events = list(prof.profiler.kineto_results.events())
    for ev in events:
        if ev.device_type() != DeviceType.CUDA \
                and ev.name() == "cudaGraphLaunch":
            launches.add(ev.correlation_id())
    for ev in events:
        c = ev.correlation_id()
        if ev.device_type() == DeviceType.CUDA and c in launches:
            first[c] = min(first.get(c, ev.start_ns()), ev.start_ns())
            busy[c] = busy.get(c, 0) + ev.duration_ns()
    starts = sorted(first.values())
    return dict(
        replays_traced=len(starts),
        period_ms=((starts[-1] - starts[0]) / (len(starts) - 1) / 1e6
                   if len(starts) > 1 else None),
        kernel_ms_per_replay=(sum(busy.values()) / len(busy) / 1e6
                              if busy else None))


def serve_phase(device, name: str = "serve", arch: str = SERVE_ARCH,
                new_tokens: int = SERVE_NEW, fp32: bool = False) -> dict:
    """Phases 11 and 12: ``arch`` at full width and depth through
    ``generate`` (in fp32 when ``fp32``, else its bf16), 4 prompts of 2048
    tokens and ``new_tokens`` greedy tokens: the decode step captured once
    and replayed.  The prefill ms (CUDA events around it), the replayed
    decode ms a step (the profiled run's replay period on the device,
    :func:`replay_period_ms`), the tokens equal to an eager decode's (its
    ms a step beside, from CUDA events after every step), one graph launch
    a replayed step (the profiler's ``cudaGraphLaunch`` count)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import runtime as rt
    from repro_torch.kernels import ops
    from repro_torch.models import get_model
    from repro_torch.models.layers import padded_vocab
    from repro_torch.serving.engine import ServeConfig, generate

    cfg = get_config(arch).replace(flash_attention=True)
    if fp32:
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(seed=0, device=device)
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           generator=torch.Generator(device=device)
                           .manual_seed(1), device=device)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    scfg = ServeConfig(max_new_tokens=new_tokens)

    kept = _EventTimedModel(model)
    eager_timed = _EventTimedModel(model, step_events=True)

    def serve(eager=False):
        return generate(eager_timed if eager else kept, params, prompt, scfg,
                        eager=eager)

    # Warm the libraries (cuBLAS handles and heuristics) with a short run.
    generate(model, params, prompt, ServeConfig(max_new_tokens=3))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rt.reset_graph_counts()
    t0 = time.perf_counter()
    tokens = serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    graphs = graph_fields()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    logits = kept.prefill_logits
    prefill_ms = kept.prefill_ms()
    eager_tokens = serve(eager=True)
    torch.cuda.synchronize()
    eager_step_ms = eager_timed.step_ms()
    same = bool(torch.equal(tokens, eager_tokens))
    # The same weights and prompt with the config's flash switch off: the
    # plain (chunked, fp32 softmax) attention of every layer.
    ref_logits, _ = get_model(cfg.replace(flash_attention=False)).prefill(
        params, prompt)
    rel = ((logits.float() - ref_logits.float()).abs().max()
           / ref_logits.float().abs().max()).item()
    finite = bool(torch.isfinite(logits.float()).all())
    want = {"flash_attention": cfg.n_layers}
    in_vocab = bool((tokens >= 0).all()
                    and (tokens < padded_vocab(cfg.vocab)).all())
    replays = new_tokens - 2
    del ref_logits
    profiled = profile_run(serve)
    ok = (tuple(tokens.shape) == (SERVE_BATCH, new_tokens) and in_vocab
          and finite and rel <= SERVE_LOGITS_BAR and same
          and graphs["graph_captures"] == 1
          and graphs["graph_replays"] == replays
          and counts == {k: want.get(k, 0) for k in counts})
    row = dict(phase=name, arch=cfg.name, layers=cfg.n_layers,
               d_model=cfg.d_model, dtype=cfg.compute_dtype,
               batch=SERVE_BATCH, prompt=SERVE_PROMPT, new_tokens=new_tokens,
               setup_s=setup_s, weights_gb=weights_gb, wall_s=wall,
               tokens_per_s=SERVE_BATCH * new_tokens / wall,
               prefill_ms=prefill_ms,
               decode_ms_per_step=profiled["graph_replays"]["period_ms"],
               decode_kernel_ms_per_step=profiled["graph_replays"][
                   "kernel_ms_per_replay"],
               eager_decode_ms_per_step=eager_step_ms,
               tokens_equal_eager=same, **graphs,
               peak_mem_gb=peak_gb, logits_rel_diff_vs_plain=rel,
               bar=SERVE_LOGITS_BAR, finite=finite,
               launches={k: c for k, c in counts.items() if c},
               expected_launches=want, ok=ok)
    emit(**row)
    emit(phase=f"{name}_profile", wall_ms=wall * 1e3,
         device_busy_share=profiled["device_busy_ms"] / (wall * 1e3),
         graph_launches_per_replayed_step=profiled["runtime_calls"].get(
             "cudaGraphLaunch", 0) / replays,
         **profiled)
    if not ok:
        raise SystemExit(f"phase {name} failed")
    row["launches"] = counts
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
    spilling = []
    for src in _build.sources():
        entry = None
        for ln in _build.build_log(src.stem).splitlines():
            if "Compiling entry function" in ln:
                entry = ln.split("'")[1] if "'" in ln else ln
            elif ("spill stores" in ln
                  and " 0 bytes spill stores" not in ln):
                spilling.append(f"{src.name}:{entry}")
    kernels = sum("Compiling entry function" in ln
                  for src in _build.sources()
                  for ln in _build.build_log(src.stem).splitlines())
    emit(phase="build", seconds=seconds,
         sources=[src.name for src in _build.sources()],
         kernels_compiled=kernels, kernels_with_spills=len(spilling),
         spilling=spilling)

    operands = kernel_operands(device)
    rows = [check_kernel(fn, mode, key, path, operands)
            for fn, mode, key, path in ROWS]
    rows += [check_flash(name, shape, causal, dtype, path, device)
             for name, shape, causal, dtype, path in FLASH_ROWS]
    check_bit_exact(operands)
    phases = [psi_phase(operands)]
    d_cols = D_SIZE // D_CLIENTS
    scratch = hc.dual_scratch_shape(D_CLIENTS, d_cols, D_RANK)
    mib = 0 if scratch is None else 4 * math.prod(scratch) / 2 ** 20
    plan = hc.dual_plan(D_CLIENTS, D_SIZE, d_cols, D_RANK)
    emit(phase="dual_scratch", shape=scratch, mib=mib,
         plan=None if plan is None else dict(zip(("cluster", "groups"),
                                                 plan)), ok=mib <= 4)
    if mib > 4:
        raise SystemExit("the dual's out_v scratch passes 4 MiB")
    del operands
    small = small_trajectory_check(device)
    emit(phase="small", **small)
    if not small["ok"]:
        raise SystemExit("the card and the CPU disagree at 160 x 160")
    phases += solve_phases(device)
    dcf_error = next(ph["error"] for ph in phases if ph["phase"] == "dcf")
    phases += elastic_phase(device, dcf_error)
    dcf_busy = next(ph["device_busy_ms"] for ph in phases
                    if ph["phase"] == "dcf")
    phases += batch_phase(device)
    phases += batch_fig1_phase(device, dcf_busy)
    phases.append(batch_convex_phase(device))
    phases += wire_phase(device)
    phases += graphs_phase(device)
    phases.append(compile_cache_phase(device))
    phases += table1_phase(device)
    phases.append(wide_phase(device))
    phases.append(convex_phase(device))
    phases.append(small_lm_phase(device))
    phases.append(serve_phase(device, "serve_f32", F32_ARCH, F32_NEW,
                              fp32=True))
    torch.cuda.empty_cache()
    phases.append(serve_phase(device))
    # Launches on the main path, each row's from the phase that gives its
    # kernel that row's operands; null where no phase does.
    for row in rows:
        phase = next((s for s in phases if s["phase"] == row["path"]), None)
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
