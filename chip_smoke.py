#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (DCF-PCA, LM serving of every family,
dense-LM training) on one CUDA card and check it.

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
            card and timed with CUDA events beside its bound
            (``repro_torch.roofline``: ``bound``, ``flash_bound``) and the plain
            version's time: at the Fig. 1 shapes (E=10 clients, m=3000,
            n_i=300, r=150; masked ones with 70% observed; the unmasked ones
            again at the cf phase's E=1, m=n=3000) and at the compact-plane
            shapes (E=4, m=2048, n_i=512, r=64, 70% observed; fp32 and bf16
            M; dense and bit-packed masks); residual_shrink_psi at fig1
            (none, f32), d32 (dense) and d16 (none, bf16); flash_attention
            bf16 at the serve phase's shape (B=4, S=2048, H=32, d=128,
            causal; row @tp, serve_tp's per-rank (4, 2048, 16, 128), also
            serve_vlm_tp's self layers'; row @moe_tp, serve_moe_tp's
            per-rank (4, 2048, 8, 128); rows @hybrid_tp and @whisper_tp,
            serve_hybrid_tp's (4, 2048, 32, 128) and serve_encdec_tp's
            (4, 416, 6, 64)),
            f32 at the small_lm phase's shape (2, 33, 4, 32,
            causal), at (1, 256, 4, 64, causal), f32 cross (2, 64 x 200,
            2, 64, full) and f32 at the serve_f32 phase's shape (4, 2048,
            32, 64, causal; row T), and bf16 at serve_moe's (4, 2048, 16,
            128), serve_hybrid's (4, 2048, 64, 128) and serve_encdec's
            (4, 416, 12, 64) prefill shapes (rows @moe, @hybrid,
            @whisper; serve_vlm's self layers run row A's), each also
            beside PyTorch's SDPA on the same tensors (``library_ms``)
            and the profiler's device time of the kernel alone
            (``kernel_device_ms``: the CUDA-event ``ms`` of
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
   m=5000, n_i=500, r=500: the contractions in clusters of two rank
   slices, the shrink in its stream kernel's 16 slabs of 32 ranks), with
   the table1 phase's launches, and at the wide phase's blocks (row "t6":
   E=10, m=4000, n_i=400, r=600: clusters of three slices, 19 slabs), with
   its launches, and huber_contract_v, huber_contract_u_diag and
   residual_shrink with a dense mask at t6 and residual_shrink_psi at t5
   (no phase); the rows at r > 256 within NEW_PLANE_TOL.  The shrink rows
   at t5 and t6 also time ``torch.baddbmm(M, U, V^T, alpha=-1)``
   (``r_only_ms``: one cuBLAS call that forms R alone, without the
   shrink; a yardstick the port never calls).  The
   contract_v_plan and stripe_plan lines give huber_contract_v's and the
   row-stripe kernels' launch plans at t5 and t6 and the card's resident
   clusters of each cluster kernel by size beside the table its splits are
   costed with; the shrink_plan line the shrink's plans there and the
   card's resident blocks of each stream kernel instance beside the
   planned two.
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
            (p = 500, rank slices and halves; M is 100 MB): the singular-value
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
   sharded  the sharded engine (``method="dcf_sharded"``, one rank a
            process, ``distributed.multihost.launch_workers``; the kernels
            are built before any worker starts and each phase's M, L0 and
            S0 are written once to ``.npy`` files every rank loads): the
            dcf phase's problem over 10 gloo ranks sharing the card (CUDA
            tensors; one client of 3000 x 300 a rank): the dense solve
            (error < 1e-4, within 1e-6 of the dcf phase's and within 1% of
            it relatively), the wire (top-k 0.1, one round stale; within
            2x dense), the coordinate median with client 1 NaN and client
            5 corrupt in every round (finite, within 3x dense), and a
            solve snapshotting every 25 rounds, resumed from its first
            snapshot (rank 0 deletes the later ones, standing in for a
            kill): its L, S, U and V the uninterrupted solve's bytes.
            Each line: the ranks, the backend, the slowest rank's wall (the
            ranks time-slice one card: a correctness run, not a speed), the
            error, each rank's launches (exactly 600 / 200 / 1; the resumed
            solve 450 / 150 / 1), peak memory and ms a round in
            collectives, and whether every rank's U has the same SHA-256
            (it must).
            ``sharded_rows``: the same problem over data 2 x model 2
            (blocks of 1500 x 1500), error < 1e-4, the same counts.
            ``sharded_nccl1``: one NCCL rank (world size 1) on the cf
            problem: error within 1e-6 of the cf phase's and within 1% of
            it relatively, whether its L has the cf phase's bits, whether
            its round was captured (then one capture and T - 1 graph
            replays).  The kernel rows also hold
            the ranks' blocks: "sh" (1, 3000, 300, 150) and "sr" (1, 1500,
            1500, 150), with those phases' launches a rank.
   convex   Fig. 1's baselines at n = 1000 (r = 50, 5%) on the card
            through ``rpca.solve``: IALM (60 iterations) and APGM (200)
            under the reference's recovery bars (1e-6, 1e-5), with the
            wall, the time of one SVD at this size and at Fig. 1's largest
            (3000 x 3000), and the host syncs of a solve (counted by
            ``torch.cuda.set_sync_debug_mode``).
   quickstart ``examples/torch_quickstart.py`` on the card (its dcf
            recovery error under 1e-4), launches counted.
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
            and the exact launch check (``launch_check``) on the solve cut
            to 12 rounds: the launch counters by family equal the captured
            graph's kernel nodes (read from the graph at its capture)
            times its replays plus the eager first round; the profiler's
            records beside, a shortfall reported as
            ``trace_lost_by_family``, a surplus a failure.  The full
            solve's replays are held to the graph's nodes the same way.
   sanitize a scan-mode dcf solve at Fig. 1's size under the strict
            sanitizer (``repro_torch.debug``: the sync debug mode at
            "error"): nothing raises, the bits of an unsanitized solve,
            600 / 200 launches, the mode restored.
   compile_cache  ``rpca.solve(method="cf", compile_policy="aot")`` at
            three shapes in two buckets: two entry builds with one capture
            each, then no build and no capture on the repeats; first-call,
            repeat and uncached walls, the entries' bytes, each recovery
            error within the reference's bar of the uncached one.
   service  the slot service (``serving.RPCAService``): 32 problems of
            500 x 500 (rank 8, 5%, the batch phase's generator), 16 slots,
            DCFConfig.tuned(8), 8 rounds a tick, 200 at most, drained by
            ``solve_all``.  A first service builds the lane's tick (one
            capture); the counted drain runs on a second service of the
            same geometry, which captures nothing: each tick is 8 replays
            of the captured slot-table round, exactly J·K masked
            contract_v and K masked u_diag launches a replay and one masked
            shrink a poll; problems/s against the serial and the batched
            ``rpca.solve`` of the same problems (the service's tolerance),
            each recovery error under 1e-4, the admission's ms (median and
            p90) split into ``robust_lam``, the fingerprints and the rest,
            the tick's ms, peak memory, busy share, the exact launch
            check over 12 replayed rounds, the replayed drain bit
            for bit an eager one, a poisoned slot's neighbour bit for bit
            a solo run, and IALM / APGM lanes at 160^2 (eager ticks) within
            1e-5 of serial solves.
   service_fig1  four Fig. 1 problems through a 4-slot ``cf`` service:
            problems/s against serial solves, each error under 1e-4, a warm
            refresh's rounds (under a third of the cold ones), the
            admission's split.
   gateway  ``benchmarks/gateway_bench.py``'s full mix (m = 512, n_max =
            256, rank 8, pages of 32 columns, 4 slots a width class) through
            ``serving.RPCAGateway``: the padded-byte reduction (>= 2), the
            width classes' captures, then a timed gateway that captures
            nothing: wall, solves/s, p50 / p99 latency, each error under
            5e-2.
   The kernel rows also hold the service phase's shapes: row "sv" (its 16
   slots as clients, m = n = 500, r = 8, the all-ones mask) and "s1" (one
   slot: the shrink of a poll), with that phase's launches.
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
    serve_tp Llama-3-8B as serve, over a (1, 2) ("data", "model") mesh:
            2 gloo ranks sharing the card (``multihost.launch_workers``),
            tensor parallel (``models.parallel``), each drawing serve's
            weights from serve's seed and keeping its slices: the weight
            and KV-cache GB a rank (about half of serve's), exactly 32
            flash_attention launches a rank at 16 heads in ``generate``
            (decode eager: gloo runs its collectives on the host, and
            ``generate`` says so), the same tokens on both ranks, and,
            fed serve's tokens, the prefill's and every decode step's
            logits within 8e-2 of serve's and the greedy tokens equal to
            serve's wherever serve's top-2 margin passes 0.16; prefill and
            decode ms and the collectives' calls, bytes and seconds a
            prefill and a step (``multihost.wire_counts``).
            Every serve phase first emits ``dryrun_<phase>``: the meta
            device dry run (``launch/dryrun.py``) of its configuration
            and cut, its weight bytes equal to the materialised model's
            sum of numel x element_size, the allocator's GB beside.
    serve_ssm, serve_moe, serve_hybrid  the SSM, MoE and hybrid families
            through the same path and gates, bf16, full width, random
            weights from seed 0, 4 x 2048 prompts, 32 new tokens:
            mamba2-780m (arXiv:2405.21060, 48 SSD layers; 0 flash
            launches), qwen2-moe-a2.7b (Qwen1.5-MoE-A2.7B, 24 layers of 60
            experts top-4 and a shared expert of 5632; 24 flash launches)
            and jamba-1.5-large-398b at full width cut to n_layers 2,
            attn_period 2 (one SSD + MLP layer and one attention + MoE
            layer of 16 experts of 24576; 1 flash launch): its period of 8
            layers would be ~90 GB of bf16 weights.  Every decode step
            routes, gathers its experts and updates the SSM states inside
            the captured graph.  Each family's serve phase keeps its
            prompt, tokens, logits, context and its routing ids a layer
            and a step for its model-axis phase
            (``SERVE_TP_DIR/<phase>.pt``), with the logits of the fp32
            model of the same weights (upcast in place, last, freeing the
            bf16 ones) fed its tokens under its routing, and its own
            distance to them (``logits_vs_fp32_model``).
    serve_moe_tp qwen2-moe-a2.7b as serve_moe, over the same (1, 2) mesh
            on 2 gloo ranks sharing the card: the experts split by ff
            columns (704 of 1408 a rank), the shared expert by columns,
            attention on 8 of 16 heads; each rank's weights 0.45-0.55 of
            serve_moe's, exactly 24 flash_attention launches a rank at
            (4, 2048, 8, 128), the decode eager and saying why (gloo), the
            same tokens on both ranks, the routing ids identical on both
            ranks at every layer and step (a hash), one all-reduce an MoE
            layer (the collective counters) and the collective bytes a
            forward; fed serve_moe's tokens and held to its routing (each
            layer takes serve_moe's expert ids of that call, weighted by
            its own probabilities, as RoutingHold does), every step's
            logits within 8e-2 of the fp32 model's, or past that bound by
            no more than serve_moe's own logits are (TP_FP32_GATE; the
            distance to serve_moe's logits beside), and the greedy token
            serve_moe's wherever its top-2 margin passes 0.16; the free
            run's routing flips against serve_moe beside, not gated.  The
            same cohort serves a 16-expert moe_ep variant of the qwen2-moe
            smoke config in fp32 (8 whole experts a rank): its prefill and
            decode logits within 1e-4 of the same config's single-rank
            run on the card and its tokens the same.
    serve_mla, serve_vlm, serve_encdec  the MLA, cross-attention and
            encoder-decoder families likewise: deepseek-v2-236b at full
            width cut to n_layers 4 (the dense first layer and three MoE
            layers of 160 experts of 1536, top-6, 2 shared; its MLA is
            plain: 0 flash launches, so the flash-vs-plain gate compares
            two plain prefills), llama-3.2-vision-11b at full width
            and depth (40 layers, 8 groups: 32 self layers, 32 flash
            launches; 8 cross layers, plain, their gates set to 0.5; a 4 x
            1601 x 4096 context) and whisper-small whole
            (4 x 416 prompts, 32 new tokens; a 4 x 1500 x 768 context
            through the 12-layer encoder, plain, inside the prefill; 12
            flash launches).  Another context must move the logits.  The
            cross layers' context K/V sit in the caches, read by the
            captured decode step.
    serve_ssm_tp, serve_hybrid_tp, serve_mla_tp, serve_vlm_tp,
    serve_encdec_tp  right after each serve phase, its model (cut, gates
            and context alike) over the same (1, 2) mesh on 2 gloo ranks
            sharing the card, through serve_moe_tp's worker and gates
            (the fp32-model logits gate, greedy tokens over the margin,
            routing held and equal on both ranks in jamba's and
            deepseek-v2's MoE layers, one all-reduce an MoE layer, weights
            0.45-0.55 of the serve phase's): mamba2 on 24 of 48 SSD heads
            a rank (B and C whole, the gated norm's sum of squares
            all-reduced), the jamba cut on 64 of 128 SSD heads (4 of 8 B/C
            groups) and 32 of 64 attention heads (1 flash launch at (4,
            2048, 32, 128)), deepseek-v2 on 64 of 128 MLA heads over the
            whole latent, llama-3.2-vision on 16 of 32 heads in its self
            and cross layers (32 flash launches at (4, 2048, 16, 128)),
            whisper on 6 of 12 heads in its encoder and decoder (12 flash
            launches at (4, 416, 6, 64)).  One device computes what 2
            ranks split by the halves that they hold (the SSD heads,
            attention heads, MLP columns, vocabulary; not MoE experts or
            MLA), so serve_tp, serve_ssm_tp, serve_vlm_tp and
            serve_encdec_tp give their serve phase's logits bit for bit
            (0.0 in forced_logits_abs_err_max).  Each line gives the
            collectives of the prefill and of a decode step, the prefill
            and eager
            decode ms, tokens/s, the weights and peak a rank; decode is
            eager because a gloo collective runs on the host and cannot be
            captured.  A model-axis phase that fails is reported and the
            run goes on; after its last phase it then names the failed
            phases and exits with code 1, printing no kernels line and no
            result.

13. train_parity the smoke TinyLlama in fp32: one ``make_train_step`` step
            on the card against the same step on the CPU (loss within 1e-5
            relative, parameters within 1e-5 of max |p|), four microbatches
            against one on the card within 5e-5.
14. train    ``launch/train.py``'s ``main``: TinyLlama-1.1B at full width
            and depth, bf16, remat full, 8 x 2048 tokens, 12 steps, flash
            attention on in its config: every loss finite and the last
            five's mean under the first five's, the median step ms after
            two warm-up steps, tokens/s, peak memory, no kernel launched
            (training never takes the flash kernel); ``train_profile``:
            one more step under the profiler.
    probe    the trained model's hidden states after layer 11 of one batch
            (2048 x 16384 in fp32) through ``training.probes.
            activation_probe`` (rank 8, 8 clients, 40 rounds): exactly
            240 / 80 / 1 launches; tests/test_probes.py's planted
            structure under its bars.
    train_resume  launcher children under deterministic algorithms at
            TinyLlama's widths cut to 2 layers: one ends itself after its
            first checkpoint and is relaunched; its final parameters and
            optimizer state have the uninterrupted run's SHA-256.
    train_robust  ``--robust-agg`` under ``multihost.launch_workers``: 4
            gloo ranks sharing the card, 4 layers, 8 x 512, 3 steps,
            weight decay 0: exactly 8 / 4 huber_contract_v /
            huber_contract_u_diag launches a 2-D gradient leaf a step (30
            leaves; counted by leaf shape too), the parameters moved, one
            parameter hash, each rank's step ms, collective ms and bytes
            and peak;
            tests/test_multidevice.py's Byzantine aggregation on CUDA
            tensors (4 workers) under its bars.
   The kernel rows also hold the probe's blocks ("pr": 8 clients of 2048 x
   2048, r = 8) and two gradient leaves of train_robust ("gr": 2048 x
   5632, "gr_emb": 32000 x 2048, one client, r = 8), with the launches
   those phases made at that shape.

In each of phases 4-9, elastic, table1, wide, batch, batch_fig1, wire, 11,
12 and the families' serve phases a first run warms the libraries, the counts (kernel launches and
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

import hashlib
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
# serve's and serve_moe's prompts, tokens and logits (and serve_moe's
# routing) for the workers of serve_tp and serve_moe_tp (gitignored).
SERVE_TP_DIR = Path(__file__).resolve().parent / "build" / "serve_tp"

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
# The kernels' rows at r > 256 (t5, t6): planes within 2e-5.
NEW_PLANE_TOL = 2e-5
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
# few percent of the logits' range, far below a wrong kernel's error.  In a
# model with MoE layers the plain prefill is routed as the flash one was
# (RoutingHold): a near-tie top-k choice flips on such ulps.
SERVE_LOGITS_BAR = 5e-2
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = "llama3-8b", 4, 2048, 32
# serve_tp: serve's model over SERVE_TP_RANKS model ranks.  Its logits,
# fed serve's tokens, against serve's, entry by entry within rtol = atol =
# 8e-2 (|tp - serve| <= 8e-2 + 8e-2 |serve|), the bf16 tolerance of
# tests/test_torch_lm.py (tests/test_models_smoke.py:100).  A rank's
# products have other shapes than serve's (h/t heads, ff/t columns, the
# row-parallel wo and w_down summed over the ranks in fp32), so bf16
# outputs round differently and the 32 layers' residual stream drifts by
# bf16 ulps: at most 0.086 from serve's on the H100 (0.102 with the
# partial sums rounded to bf16 before the all-reduce, past the bound;
# PERF.md §6), beside serve's own flash-vs-plain 0.0196 of max
# |logits|.  A greedy token is held to serve's where serve's top-2 margin
# passes twice the atol.
SERVE_TP_RANKS, SERVE_TP_BAR = 2, 8e-2
SERVE_TP_MARGIN = 2 * SERVE_TP_BAR
SERVE_TP_TIMEOUT = 600
# serve_moe_tp: serve_moe's model over the same ranks, under the same bars,
# fed serve_moe's tokens and held to its routing (RoutingHold).  Beside it
# the expert-parallel layout, which no config served over the model axis
# takes at full width (qwen's 60 experts are not a multiple of TP_SIZE;
# deepseek-v2 and jamba, whose are, wait for MLA and the hybrid over the
# model axis): the qwen2-moe smoke config with 16 experts and moe_ep in
# fp32, held to its single-rank run on the card within the fp32 LM
# tolerance (tests/test_torch_lm.py), its tokens exactly.
# TP_FP32_GATE: serve_moe's own bf16 logits are as far from the fp32 model
# of its weights (the same tokens and routing, every product and
# activation in fp32) as two bf16 runs of other GEMM shapes are from each
# other: on an NVIDIA H100 80GB HBM3 at 700 W serve_moe's logits miss
# rtol = atol = 8e-2 against it by 0.0049 (max |diff| 0.0985 at max
# |logits| 4.94), serve_moe_tp's meet it (0.0976, 0.0006 inside) and miss
# serve_moe's by 0.0128 (0.1016; PERF.md §6).  The bar against
# serve_moe's logits is below the bf16 noise of a 24-layer MoE, so
# serve_moe_tp is held to the fp32 model: within SERVE_TP_BAR of it, or
# past it by no more than serve_moe is.  The comparison with serve_moe's
# logits is reported beside it.
EP_EXPERTS, EP_BATCH, EP_PROMPT, EP_NEW, EP_TOL = 16, 2, 64, 8, 1e-4
# The token gate of every model-axis phase: a greedy token is held to the
# serve phase's wherever the serve phase's top-2 margin passes
# SERVE_TP_MARGIN.  Beside it, not gated: where the fp32 model's own
# margin passes it, how many of the rank's and of the serve phase's greedy
# tokens differ from the fp32 model's.  mamba2-780m's 48 SSD layers in
# bf16 lie up to 1.21 from its fp32 model on an NVIDIA H100 80GB HBM3 at
# 700 W (mean 0.117), as the JAX reference's own bf16 does on the CPU
# (tools/ssm_bf16_drift.py), and one bit that differs in an early layer
# grows to that distance, so two bf16 runs that differ in their sums part
# over the margin.  One device computes what 2 ranks split by their
# halves (ssm._head_parts, attention._halves, mlp.mlp, layers.logits), so
# serve_ssm_tp's logits are serve_ssm's bits (tools/tp_bits.py; PERF.md
# §6), as are serve_tp's, serve_vlm_tp's and serve_encdec_tp's.
# The fp32 serving path: TinyLlama-1.1B's prefill at 4 x 2048 (arXiv:
# 2401.02385), the fp32 flash kernel's full-width shape.
F32_ARCH, F32_NEW = "tinyllama-1.1b", 16
# The other families through the same serve path, bf16, full width:
# (phase, arch, config cut, prompt length).  Jamba-1.5-Large's period of 8
# layers at full width is ~45B parameters (~90 GB in bf16), past the card's
# 80 GB: its cut keeps every width and both layer kinds of a period (SSD +
# MLP, attention + MoE) at n_layers 2, attn_period 2.  DeepSeek-V2's 60
# layers are ~236B parameters (~472 GB): its cut keeps the dense first
# layer and three MoE layers (160 experts of 1536, top-6, 2 shared) at
# n_layers 4, ~13.3B parameters.  llama-3.2-vision-11b runs whole (8
# groups of 4 self and 1 cross layer, 40 layers) with a context of 1601
# patches; whisper-small whole (12
# encoder and 12 decoder layers) with 1500 frames and 4 x 416 prompts, so
# that prompt and 32 new tokens fill Whisper's decoder context of 448
# tokens (n_text_ctx, arXiv:2212.04356).
WHISPER_PROMPT = 448 - SERVE_NEW
FAMILY_SERVES = [
    ("serve_ssm", "mamba2-780m", {}, SERVE_PROMPT),
    ("serve_moe", "qwen2-moe-a2.7b", {}, SERVE_PROMPT),
    ("serve_hybrid", "jamba-1.5-large-398b",
     {"n_layers": 2, "attn_period": 2}, SERVE_PROMPT),
    ("serve_mla", "deepseek-v2-236b", {"n_layers": 4}, SERVE_PROMPT),
    ("serve_vlm", "llama-3.2-vision-11b", {}, SERVE_PROMPT),
    ("serve_encdec", "whisper-small", {}, WHISPER_PROMPT),
]
# The serve phases whose prompt, tokens and eager logits (and routing,
# context and, but for serve's, the fp32 model's logits) a model-axis
# phase is held to: phase -> file under SERVE_TP_DIR.
TP_YARDSTICKS = {name: f"{name}.pt" for name in (
    "serve", "serve_moe", "serve_ssm", "serve_hybrid", "serve_mla",
    "serve_vlm", "serve_encdec")}
# Each family's model-axis phase, right after its serve phase: the same
# config, cut and prompt over SERVE_TP_RANKS gloo ranks sharing the card,
# fed the serve phase's tokens (and context), held to its routing and
# gated on the fp32 model of its weights (TP_FP32_GATE), as serve_moe_tp.
FAMILY_TP = {"serve_ssm": "serve_ssm_tp", "serve_moe": "serve_moe_tp",
             "serve_hybrid": "serve_hybrid_tp", "serve_mla": "serve_mla_tp",
             "serve_vlm": "serve_vlm_tp", "serve_encdec": "serve_encdec_tp"}
# Every cross layer's gate after init_params: the reference initialises it
# to 0, and tanh(0) = 0 would take the cross path out of the logits.
SERVE_CROSS_GATE = 0.5
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
# The sharded engine (method="dcf_sharded", one client a process): Fig. 1's
# dcf problem over SHARDED_RANKS gloo ranks sharing the card, the rows
# layout over data 2 x model 2 and one NCCL rank; the sharded error within
# SHARDED_MATCH of the simulated engine's (tests/test_multidevice.py:46-48)
# and, since errors here are ~2e-10 and pass that bar whatever they are,
# within SHARDED_REL_MATCH of it relatively (the same problem and initial
# factors: a sharded solve that departs from the simulated one fails).
SHARDED_RANKS, SHARDED_MATCH, SHARDED_TIMEOUT = 10, 1e-6, 600
SHARDED_REL_MATCH = 0.01
# LM training.  ``train``: the training launcher's default arch, TinyLlama-
# 1.1B (configs/tinyllama_1_1b.py, arXiv:2401.02385) at full width and
# depth, bf16, remat "full", a global batch of 8 x 2048 tokens (its
# pretraining context), 12 steps on one rank; the step ms is the median
# after two warm-up steps.  The learning rate is TinyLlama's published peak,
# 4e-4: at the launcher's default 3e-3 (sized for the smoke model) the
# 22-layer model's loss rose over the 12 steps, in bf16 and in fp32 alike
# (src/repro_torch/launch/train_losses.py; PERF.md §6).  Its config
# turns flash attention on, so the phase shows that training never takes
# the kernel (0 launches).
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = (
    "tinyllama-1.1b", 8, 2048, 12, 4e-4)
TRAIN_WARMUP = 2
# ``train_parity``: the smoke config in fp32, one step on the card against
# the same step on the CPU: loss within 1e-5 relative, parameters within
# 1e-5 of max |p| at lr 1e-4 and eps 1e-6 (tests/test_torch_train.py's
# STEP_OCFG: Adam divides each gradient entry's fp32 noise by |g| + eps);
# four microbatches against one on the card within the reference's 5e-5
# (tests/test_train_loop.py:36-57, its lr 1e-3), on a batch of 8 x 32.
PARITY_TOL, PARITY_MB_TOL, PARITY_SHAPE = 1e-5, 5e-5, (32, 8)
# ``train_resume``: two launcher children under deterministic algorithms at
# TinyLlama's widths cut to RESUME_LAYERS layers (a checkpoint of the 22
# layers' parameters and fp32 moments is 11 GB to write; 2 layers hold
# the embeddings, 2.6 GB with them), RESUME_STEPS steps of 4 x 512, a
# checkpoint every RESUME_EVERY.
RESUME_LAYERS, RESUME_STEPS, RESUME_EVERY, RESUME_SHAPE = 2, 4, 2, (512, 4)
# ``train_robust``: the launcher's --robust-agg under launch_workers, 4 gloo
# ranks sharing the card, TinyLlama's widths cut to 4 layers (four copies
# of the 22-layer AdamW state, 13.2 GB each, and their activations do not
# fit in 80 GB), a global batch of 8 x 512, 3 steps, CompressConfig()'s
# defaults: rounds 4, K 1, J 2, so 8 huber_contract_v and 4
# huber_contract_u_diag launches a 2-D leaf a step.  In the same cohort
# tests/test_multidevice.py:138-179's Byzantine case on CUDA tensors with 4
# workers in place of 8.
ROBUST_RANKS, ROBUST_LAYERS, ROBUST_STEPS, ROBUST_SHAPE = 4, 4, 3, (512, 8)
# The gradient leaves whose launches the kernel rows "gr" / "gr_emb"
# report (``train_robust@gr``, ``@gr_emb``): the MLP's w_gate and w_up, two
# a layer, and the embedding table.
ROBUST_LEAF_ROWS = {"gr": ((2048, 5632), 2 * ROBUST_LAYERS),
                    "gr_emb": ((32000, 2048), 1)}
ROBUST_TIMEOUT = 900
BYZ = dict(m=256, k=128, r=4, spike=1e4, frac=0.02, rank=8, rounds=6)
# ``probe``: the hidden states after layer PROBE_LAYER (0-based) of one
# training batch (8 x 2048 tokens, d_model 2048) through
# training.probes.activation_probe: rank 8, 8 clients (2048 x 2048 blocks),
# 40 rounds of DCFConfig.tuned (K 2, J 3): 240 / 80 / 1 launches.  Then
# tests/test_probes.py's planted structure, under its bars.
PROBE_LAYER, PROBE_RANK, PROBE_CLIENTS, PROBE_ROUNDS = 11, 8, 8, 40
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
# The slot service (serving.rpca_service) on the batch phase's problems:
# SERVICE_PROBLEMS of BATCH_N^2 (rank 8, 5%, seeds 1..) drained through
# SERVICE_SLOTS slots, DCFConfig.tuned(8), the reference's RPCAServiceConfig
# defaults but for the slots (8 rounds a tick, 200 at most, tol 5e-4); each
# recovery error under tests/test_runtime.py:186's bar; the convex lanes at
# CONVEX_BATCH_N^2 within tests/test_masked.py:296-298's 1e-5 of serial
# solves.
SERVICE_PROBLEMS, SERVICE_SLOTS = 32, 16
SERVICE_ROUNDS_PER_TICK, SERVICE_MAX_ROUNDS = 8, 200
SERVICE_BAR, SERVICE_CONVEX_TOL = 1e-4, 1e-5
# The gateway: benchmarks/gateway_bench.py's run() at its full mix (m = 512,
# n_max = 256, rank 8, 4 slots a width class, pages of n_max / 8), its
# acceptance gate on the padded-byte reduction (>= 2) and the reference
# test's recovery bar for paged lanes (tests/test_gateway.py:189).
GATEWAY_M, GATEWAY_N_MAX, GATEWAY_RANK, GATEWAY_SLOTS = 512, 256, 8, 4
GATEWAY_MIX = (1 / 8, 1 / 8, 1 / 4, 1 / 4, 3 / 8, 3 / 8, 1 / 2, 1.0)
GATEWAY_MIN_REDUCTION, GATEWAY_BAR = 2.0, 5e-2
# The kernel rows of the gateway's narrowest and widest width classes: the
# widths of the tenants in each slot of the class's table (a class of w
# columns admits page spans of w; a narrower tenant is padded behind
# mask-zero columns), and the ragged slot whose poll the shrink row takes.
GATEWAY_CLASS_TENANTS = {32: (32, 32, 25, 9), 256: (256, 256, 240, 229)}
GATEWAY_RAGGED_SLOT = 2
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
# "t6" (E=10, m=4000, n_i=400, r=600: three rank slices), "bn"
# (the batch phase's B·E = 128 clients, m=500, n_i=63, r=8, the padding
# mask), "b4" (batch_fig1's 4 x 10 = 40 clients, m=3000, n_i=300, r=150),
# "sv" (the service phase's slot table: 16 slots, m=n=500, r=8, the
# all-ones mask),
# "s1" (one slot of it: a poll's finalize), "f4" / "f1" (service_fig1's
# table: 4 slots, m=n=3000, r=150, all-ones mask; one slot), "g32" /
# "g256" (the gateway's narrowest and widest width classes: 4 slots, m=512,
# r=8, ragged tenants behind mask-zero columns) and "g32_1" / "g256_1" (the
# ragged slot of each: a poll's finalize), "sh" (one rank of the sharded
# phase: one client of 3000 x 300, r=150), "sr" (one rank of the
# sharded_rows phase: a 1500 x 1500 block, r=150), "pr" (the probe phase's
# 8 clients of a 2048 x 16384 hidden-state matrix, r=8) and "gr" /
# "gr_emb" (train_robust's gradient leaves, one client a rank, r=8: an MLP
# matrix (2048, 5632) and the embedding table (32000, 2048)).
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
    ("huber_contract_v", "dense", "t6", None),
    ("huber_contract_u_diag", "dense", "t6", None),
    ("residual_shrink", "dense", "t6", None),
    ("residual_shrink_psi", "none", "t5", None),
    ("huber_contract_v", "dense", "bn", "batch"),
    ("huber_contract_u_diag", "dense", "bn", "batch"),
    ("residual_shrink", "dense", "bn", "batch"),
    ("huber_contract_v", "none", "b4", "batch_fig1"),
    ("huber_contract_u_diag", "none", "b4", "batch_fig1"),
    ("huber_contract_v", "dense", "sv", "service"),
    ("huber_contract_u_diag", "dense", "sv", "service"),
    ("residual_shrink", "dense", "s1", "service"),
    ("huber_contract_v", "dense", "f4", "service_fig1"),
    ("huber_contract_u_diag", "dense", "f4", "service_fig1"),
    ("residual_shrink", "dense", "f1", "service_fig1"),
    ("huber_contract_v", "dense", "g32", "gateway@32"),
    ("huber_contract_u_diag", "dense", "g32", "gateway@32"),
    ("residual_shrink", "dense", "g32_1", "gateway@32"),
    ("huber_contract_v", "dense", "g256", "gateway@256"),
    ("huber_contract_u_diag", "dense", "g256", "gateway@256"),
    ("residual_shrink", "dense", "g256_1", "gateway@256"),
    ("huber_contract_v", "none", "sh", "sharded"),
    ("huber_contract_u_diag", "none", "sh", "sharded"),
    ("residual_shrink", "none", "sh", "sharded"),
    ("huber_contract_v", "none", "sr", "sharded_rows"),
    ("huber_contract_u_diag", "none", "sr", "sharded_rows"),
    ("residual_shrink", "none", "sr", "sharded_rows"),
    ("huber_contract_v", "none", "pr", "probe"),
    ("huber_contract_u_diag", "none", "pr", "probe"),
    ("residual_shrink", "none", "pr", "probe"),
    ("huber_contract_v", "none", "gr", "train_robust@gr"),
    ("huber_contract_u_diag", "none", "gr", "train_robust@gr"),
    ("huber_contract_v", "none", "gr_emb", "train_robust@gr_emb"),
    ("huber_contract_u_diag", "none", "gr_emb", "train_robust@gr_emb"),
]
# Flash rows: (row name, (B, S_q, S_kv, H, d), causal, dtype, phase whose
# launches the row reports or None).
FLASH_ROWS = [
    ("flash_attention",
     (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 128), True, "bf16",
     "serve"),
    # serve_tp's prefill on a rank: Llama-3-8B's 32 heads over 2 ranks;
    # serve_moe_tp's: qwen2-moe-a2.7b's 16 heads over 2 ranks.
    ("flash_attention@tp",
     (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32 // SERVE_TP_RANKS, 128),
     True, "bf16", "serve_tp"),
    ("flash_attention@moe_tp",
     (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16 // SERVE_TP_RANKS, 128),
     True, "bf16", "serve_moe_tp"),
    ("flash_attention@f32_small_lm",
     (SMALL_BATCH, SMALL_PROMPT, SMALL_PROMPT, 4, 32), True, "f32",
     "small_lm"),
    ("flash_attention@f32", (1, 256, 256, 4, 64), True, "f32", None),
    ("flash_attention@f32_cross", (2, 64, 200, 2, 64), False, "f32", None),
    ("flash_attention@f32_T",
     (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 32, 64), True, "f32",
     "serve_f32"),
    # qwen2-moe-a2.7b's prefill (16 heads of 128) and the jamba cut's (64
    # heads of 128, GQA 8 with K/V repeated).
    ("flash_attention@moe",
     (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 16, 128), True, "bf16",
     "serve_moe"),
    ("flash_attention@hybrid",
     (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 64, 128), True, "bf16",
     "serve_hybrid"),
    # whisper-small's decoder self-attention (12 heads of 64; 416 rows end
    # in a part tile).  llama-3.2-vision's self layers run row A's shape.
    ("flash_attention@whisper",
     (SERVE_BATCH, WHISPER_PROMPT, WHISPER_PROMPT, 12, 64), True, "bf16",
     "serve_encdec"),
    # The same prefills on one of 2 model ranks: the jamba cut's 32 of 64
    # heads (GQA 8: its 4 KV heads repeated) and whisper's 6 of 12.
    # llama-3.2-vision's self layers there run @tp's shape (16 heads).
    ("flash_attention@hybrid_tp",
     (SERVE_BATCH, SERVE_PROMPT, SERVE_PROMPT, 64 // SERVE_TP_RANKS, 128),
     True, "bf16", "serve_hybrid_tp"),
    ("flash_attention@whisper_tp",
     (SERVE_BATCH, WHISPER_PROMPT, WHISPER_PROMPT, 12 // SERVE_TP_RANKS, 64),
     True, "bf16", "serve_encdec_tp"),
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

    from repro_torch.roofline import bound

    kernel, plain = _kernel_fns(fn)
    u, v, blocks, lam, w, packed = operands[key]
    args = (u, v, blocks, lam, {"none": None, "dense": w,
                                "packed": packed}[mode])
    got, want = _as_tuple(kernel(*args)), _as_tuple(plain(*args))
    torch.cuda.synchronize()
    plane_tol = NEW_PLANE_TOL if u.shape[-1] > 256 else PLANE_TOL
    abs_err, rel_err, ok = 0.0, 0.0, len(got) == len(want)
    for g, ref in zip(got, want):
        diff = (g - ref).abs().max().item()
        abs_err = max(abs_err, diff)
        if ref.ndim == 1:  # per-client scalars
            rel = (diff / ref.abs().min().item()) if diff else 0.0
            ok &= rel <= SCALAR_TOL
        else:
            rel = diff / ref.abs().max().item()
            ok &= rel <= plane_tol
        rel_err = max(rel_err, rel)
    ms = cuda_ms(lambda: kernel(*args))
    plain_ms = cuda_ms(lambda: plain(*args))
    r_only_ms = None
    if fn.startswith("residual_shrink") and key in ("t5", "t6"):
        r_only_ms = cuda_ms(lambda: torch.baddbmm(blocks, u, v.mT, alpha=-1))
    e, m, n = blocks.shape
    r = u.shape[-1]
    bound_ms, bound_by = bound(fn, mode, blocks.element_size(), e, m, n, r)
    kernel_name = fn + SUFFIX[mode]
    dtype = "bf16" if blocks.dtype == torch.bfloat16 else "f32"
    row = dict(name=kernel_name if key == "fig1" else f"{kernel_name}@{key}",
               kernel=kernel_name, path=path, route="cuda",
               source=SOURCES[fn], replaces=REPLACES[kernel_name],
               dtype=dtype, max_abs_err=abs_err, max_rel_err=rel_err,
               plane_tol=plane_tol, ok=ok,
               ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by=bound_by, library_ms=None, r_only_ms=r_only_ms,
               shape=[e, m, n, r])
    emit(phase="kernel", **row)
    if not ok:
        raise SystemExit(f"kernel {row['name']} disagrees with its plain "
                         f"version: relative error {rel_err:.3e}")
    return row


def cluster_plans(device) -> list[dict]:
    """The launch plans of huber_contract_v (``contract_v_plan``: cluster,
    rank slice, row splits, grid) and of the row-stripe kernels
    (``stripe_plan``: column splits) at the t5 and t6 shapes, each with the
    card's resident clusters of its cluster kernel by size
    (cudaOccupancyMaxActiveClusters) beside the counts its splits are
    costed with (``cluster_slots``); and the shrink's (``shrink_plan``:
    route, tile, slabs, grid, waves) with the card's resident blocks of
    each stream kernel instance beside the planned ones."""
    from repro_torch.kernels import _launch
    from repro_torch.kernels import huber_contract as hc
    from repro_torch.kernels import shrinkage as sh

    sms = _launch.sm_count(device)
    shapes = {"t5": (TABLE1_CLIENTS, max(TABLE1), max(TABLE1) // 10,
                     max(TABLE1) // 10),
              "t6": (TABLE1_CLIENTS, WIDE_N, WIDE_N // TABLE1_CLIENTS,
                     WIDE_RANK)}
    rows = []
    for phase, plan, on_device in (
            ("contract_v_plan", hc.v_plan, hc.v_cluster_slots_on_device),
            ("stripe_plan", hc.u_plan, hc.u_cluster_slots_on_device)):
        card = {c: on_device(device, c)
                for c in range(2, _launch.CLUSTER_MAX + 1)}
        by_table = {c: hc.cluster_slots(c, sms) for c in card}
        row = dict(phase=phase, sms=sms,
                   plans={k: plan(*s, sms)._asdict()
                          for k, s in shapes.items()},
                   cluster_slots_card=card, cluster_slots_costed=by_table,
                   slots_as_costed=card == by_table)
        emit(**row)
        rows.append(row)
    card = {f"dtype{d}/mask{mk}/psi{int(psi)}":
            sh.stream_resident_on_device(device, d, mk, psi)
            for d in (0, 1) for mk in (0, 1, 2) for psi in (False, True)}
    row = dict(phase="shrink_plan", sms=sms,
               plans={k: sh.shrink_plan(*s, sms)._asdict()
                      for k, s in shapes.items()},
               resident_card=card, resident_planned=sh.STREAM_RESIDENT,
               resident_as_planned=set(card.values()) == {sh.STREAM_RESIDENT})
    emit(**row)
    rows.append(row)
    return rows


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
    sets["sh"] = tuple(x[:1].contiguous() for x in sets["fig1"])
    half = M_ROWS // 2
    sets["sr"] = client_set(p.m_obs[:half, :half].contiguous(), 1, RANK,
                            None)
    del p
    # Low rank plus sparse at the probe's and the gradients' shapes (their
    # rank 8 is the probe's and CompressConfig's).
    for key, (m, n, clients) in {
            "pr": (2048, TRAIN_BATCH * TRAIN_SEQ, PROBE_CLIENTS),
            "gr": (2048, 5632, 1), "gr_emb": (32000, 2048, 1)}.items():
        q = prob.generate_problem(0, m, n, PROBE_RANK, SPARSITY,
                                  device=device)
        sets[key] = client_set(q.m_obs, clients, PROBE_RANK, None)
        del q

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
    sets["sv"] = batch_set(range(1, SERVICE_SLOTS + 1), BATCH_N, 1,
                           BATCH_RANK, ragged=True)
    sets["s1"] = tuple(x[:1].contiguous() for x in sets["sv"])
    sets["f4"] = batch_set(range(FIG1_BATCH), M_ROWS, 1, RANK, ragged=True)
    sets["f1"] = tuple(x[:1].contiguous() for x in sets["f4"])

    def gateway_set(width, n_reqs):
        """A gateway width class's slot table: tenants of ``n_reqs``
        columns (seeds 0..), each padded to ``width`` behind mask-zero
        columns as the service pads a ragged one."""
        parts = []
        for seed, n_req in enumerate(n_reqs):
            obs = torch.from_numpy(gateway_tenant(n_req, seed)[1])
            m_obs = torch.zeros(GATEWAY_M, width, device=device)
            m_obs[:, :n_req] = obs.to(device)
            w = torch.zeros_like(m_obs)
            w[:, :n_req] = 1.0
            parts.append(client_set(m_obs, 1, GATEWAY_RANK, w))
        return tuple(torch.cat(xs) for xs in zip(*parts))

    ragged = slice(GATEWAY_RAGGED_SLOT, GATEWAY_RAGGED_SLOT + 1)
    for width, n_reqs in GATEWAY_CLASS_TENANTS.items():
        sets[f"g{width}"] = gateway_set(width, n_reqs)
        sets[f"g{width}_1"] = tuple(x[ragged].contiguous()
                                    for x in sets[f"g{width}"])
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
    from repro_torch.roofline import PEAK_TF32_FLOPS, flash_bound

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


def profile_run(run, families: bool = False) -> dict:
    """Where one run's time goes on the card: ``run()`` once under
    torch.profiler.  The device busy time is the sum of kernel times (one
    stream, so kernels do not overlap); beside it the kernels that take
    the most of it and the host's CUDA runtime calls, by count
    (``cudaGraphLaunch`` for each replay) and the replays' device period
    (:func:`replay_period_ms`).  With ``families`` also the
    device kernels the trace recorded, by ``kernels.ops.KERNEL_FAMILIES``
    (CUPTI records the kernels a graph replay launches, by name, as any
    other, and may drop records)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

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
        out["device_kernels"] = ops.kernels_by_family(
            {name: calls for name, (calls, _) in kernels.items()})
    return out


def graph_fields() -> dict:
    """The round graphs of the run since ``runtime.reset_graph_counts``:
    captures, replays, the host's capture, instantiate and kernel-node read
    ms, and the ``cudaMalloc`` calls the captures made (the graph pool
    growing)."""
    from repro_torch.core import runtime as rt

    g = rt.graph_counts
    return dict(graph_captures=g["captures"], graph_replays=g["replays"],
                capture_ms=g["capture_s"] * 1e3,
                instantiate_ms=g["instantiate_s"] * 1e3,
                node_read_ms=g["nodes_s"] * 1e3,
                capture_mallocs=g["capture_mallocs"])


def launch_check(run) -> dict:
    """The exact launch check of one window: ``run()`` once under the
    profiler, the launch counters and the round graphs' tallies zeroed just
    before.  Held exactly, by family (``kernels.ops.KERNEL_FAMILIES``): the
    counters equal the kernel nodes of the replayed graphs times their
    replays (``runtime.replayed_kernels["nodes"]``: read from each graph at
    its capture, a count nothing can drop) plus the eager launches of the
    window (the counters less what the replays added to them, the first
    round of a solve and anything outside its rounds).  The profiler's
    records stand beside: a shortfall is reported as
    ``trace_lost_by_family`` (CUPTI drops records), a surplus fails (a
    record cannot come from nothing)."""
    from repro_torch.core import runtime as rt
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    rt.reset_graph_counts()
    seen = profile_run(run, families=True)["device_kernels"]
    counted = ops.family_launches(ops.launch_counts())
    nodes = {fam: rt.replayed_kernels["nodes"].get(fam, 0)
             for fam in counted}
    eager = {fam: n - rt.replayed_kernels["counted"].get(fam, 0)
             for fam, n in counted.items()}
    lost = {fam: counted[fam] - seen[fam] for fam in counted
            if counted[fam] > seen[fam]}
    surplus = {fam: seen[fam] - counted[fam] for fam in counted
               if seen[fam] > counted[fam]}
    exact = all(counted[fam] == nodes[fam] + eager[fam] and eager[fam] >= 0
                for fam in counted)
    return dict(counters_by_family=counted,
                graph_kernel_nodes_by_family=nodes,
                eager_launches_by_family=eager,
                window_graph_replays=rt.graph_counts["replays"],
                profiler_kernels_by_family=seen,
                trace_lost_by_family=lost, trace_surplus_by_family=surplus,
                launches_exact=exact and not surplus
                and sum(nodes.values()) > 0)


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

    def fig1(name, problem, method, clients, masked, fused="diag",
             extra=None):
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
                res.l, res.s, problem.l0, problem.s0).item(), ERR_BAR,
            extra=extra)

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
    rows = [dcf, fig1("cf", p, "cf", None, masked=False,
                      extra=lambda res: {"l_sha256": hashlib.sha256(
                          res.l.cpu().numpy().tobytes()).hexdigest()})[0]]
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


# The sharded engine's workers (``launch_workers`` runs this in every rank
# of a cohort; the kernels are built before any worker starts, so each
# loads the same libraries).  Every rank loads the phase's problem from the
# files the script wrote, solves it through ``rpca.solve(method=
# "dcf_sharded")`` and prints one ``SHARDED`` JSON line a solve.
SHARDED_WORKER = r"""
import hashlib, json, os, shutil, time
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import rpca
from repro_torch.core import metrics
from repro_torch.core import runtime as rt
from repro_torch.core.factorized import DCFConfig
from repro_torch.distributed.faults import CORRUPT, FaultPlan
from repro_torch.distributed.grad_compress import CompressConfig
from repro_torch.kernels import ops

torch.backends.cuda.matmul.allow_tf32 = False
_mh.SYNC_TIMING = True  # collective seconds without the solve's queue
phase, data = os.environ["SHARDED_PHASE"], os.environ["SHARDED_DIR"]
device = torch.device(os.environ.get("SHARDED_DEVICE", "cuda"))
rank, world = dist.get_rank(), dist.get_world_size()
m_obs, l0, s0 = (torch.from_numpy(np.load(os.path.join(data, f + ".npy")))
                 .to(device) for f in ("m", "l0", "s0"))
rank_r = int(os.environ["SHARDED_RANK"])
if phase == "sharded_rows":
    mesh = _mh.multihost_mesh(("data", "model"), (world // 2, 2),
                              device=device)
    model_axis = "model"
else:
    mesh = _mh.multihost_mesh(("data",), device=device)
    model_axis = None


def sha(x):
    return hashlib.sha256(x.detach().cpu().numpy().tobytes()).hexdigest()


def solve(tag, cfg, run=None, **spec):
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rt.reset_graph_counts()
    _mh.wire_counts(reset=True)
    dist.barrier()
    t0 = time.perf_counter()
    res = rpca.solve(rpca.RPCASpec(m_obs, mesh=mesh, model_axis=model_axis,
                                   **spec),
                     method="dcf_sharded", cfg=cfg, run=run, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    wire = _mh.wire_counts()
    rounds = int(res.stats.rounds)
    # A replayed round's collectives are not timed on the host: the ms a
    # round are over the rounds that ran eagerly.
    eager = rounds - int(rt.graph_counts["replays"])
    print("SHARDED " + json.dumps(dict(
        tag=tag, rank=rank, backend=str(dist.get_backend()), wall_s=wall,
        error=metrics.relative_error(res.l, res.s, l0, s0).item(),
        finite=bool(torch.isfinite(res.l).all()
                    and torch.isfinite(res.s).all()),
        launches={k: c for k, c in ops.launch_counts().items() if c},
        peak_mem_gb=(torch.cuda.max_memory_allocated() / 1e9
                     if device.type == "cuda" else None),
        rounds=rounds, eager_rounds=eager,
        collective_ms_per_round=wire["seconds"] * 1e3 / max(eager, 1),
        wire={k: v for k, v in wire.items() if v},
        graph_captures=int(rt.graph_counts["captures"]),
        graph_replays=int(rt.graph_counts["replays"]),
        sha={k: sha(getattr(res, k)) for k in ("l", "s", "u", "v")},
        shape=list(res.l.shape))), flush=True)
    return res


cfg = DCFConfig.tuned(rank_r)
solve("dense", cfg)
if phase == "sharded":
    solve("wire", DCFConfig.tuned(
        rank_r, consensus_compress=CompressConfig(
            topk_frac=float(os.environ["SHARDED_TOPK"])),
        consensus_delay=1))
    codes = FaultPlan.byzantine(cfg.outer_iters, world, (1,),
                                kind="nan").codes.copy()
    codes[:, 5] = CORRUPT
    solve("robust", DCFConfig.tuned(rank_r, aggregator="coordinate_median"),
          faults=FaultPlan(codes))
    ckdir = os.path.join(data, "ckpt")
    run = rt.RunConfig(checkpoint_every=int(os.environ["SHARDED_EVERY"]))
    solve("snapshots", cfg, run, checkpoint_dir=ckdir)
    dist.barrier()
    if rank == 0:  # a kill after the first snapshot: the later ones go
        steps = sorted(x for x in os.listdir(ckdir) if x.startswith("step_"))
        for s in steps[1:]:
            shutil.rmtree(os.path.join(ckdir, s))
        with open(os.path.join(ckdir, "LATEST"), "w") as f:
            f.write(str(int(steps[0].split("_")[1])))
    dist.barrier()
    solve("resumed", cfg, run, resume_from=ckdir)
"""


def _sharded_cohort(phase: str, ranks: int, backend: str, files: str,
                    device) -> dict[str, list[dict]]:
    """Run one cohort of the sharded engine's workers; their rows by solve
    tag, one a rank in rank order."""
    from repro_torch.distributed import multihost as mh

    outs = mh.launch_workers(
        SHARDED_WORKER, num_processes=ranks, backend=backend,
        timeout=SHARDED_TIMEOUT,
        extra_env={"SHARDED_PHASE": phase, "SHARDED_DIR": files,
                   "SHARDED_DEVICE": str(device),
                   "SHARDED_RANK": str(RANK),
                   "SHARDED_TOPK": str(WIRE_TOPK),
                   "SHARDED_EVERY": str(CHECKPOINT_EVERY)})
    rows: dict[str, list[dict]] = {}
    for out in outs:
        for ln in out.splitlines():
            if ln.startswith("SHARDED "):
                row = json.loads(ln[len("SHARDED "):])
                rows.setdefault(row["tag"], []).append(row)
    return rows


def _sharded_row(phase: str, tag: str, rows: list[dict], want: dict,
                 bar: float, info: dict | None = None, **checks) -> dict:
    """One solve of a cohort as one JSON line: the ranks, the backend, the
    slowest rank's wall, the error (every rank's the same), each rank's
    launches and peak memory, the ms a round each rank spent in
    collectives, whether every rank's L, S, U and V have the same SHA-256;
    ``want`` is each rank's exact launch counts, ``checks`` further gates
    and ``info`` fields that are reported only."""
    errors = {r["error"] for r in rows}
    same = {k: len({r["sha"][k] for r in rows}) == 1
            for k in ("l", "s", "u", "v")}
    launches_ok = all(r["launches"] == want for r in rows)
    err = rows[0]["error"]
    ok = (len(errors) == 1 and err < bar and all(r["finite"] for r in rows)
          and all(same.values()) and launches_ok and all(checks.values()))
    row = dict(
        phase=phase, solve=tag, ranks=len(rows), backend=rows[0]["backend"],
        wall_s=max(r["wall_s"] for r in rows), error=err,
        bar=None if math.isinf(bar) else bar,
        launches_per_rank=[r["launches"] for r in rows],
        expected_launches_per_rank=want,
        peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in rows],
        collective_ms_per_round=[r["collective_ms_per_round"]
                                 for r in rows],
        wire_per_rank=rows[0]["wire"], rounds=rows[0]["rounds"],
        eager_rounds=rows[0]["eager_rounds"],
        graph_captures=rows[0]["graph_captures"],
        graph_replays=rows[0]["graph_replays"],
        same_u_sha256=same["u"], same_lsv_sha256=same["l"] and same["s"]
        and same["v"], u_sha256=rows[0]["sha"]["u"],
        note="ranks share one card: walls are correctness runs, not speed",
        **(info or {}), **checks, ok=ok)
    emit(**row)
    if not ok:
        raise SystemExit(f"phase {phase} ({tag}) failed")
    return row


def sharded_phases(device, dcf_error: float, cf_row: dict) -> list[dict]:
    """The sharded engine (``method="dcf_sharded"``) on the card, one rank
    a process (``distributed.multihost.launch_workers``), each rank given
    the whole problem from files written here once:

    - ``sharded``: Fig. 1's dcf problem over :data:`SHARDED_RANKS` gloo
      ranks sharing the card (CUDA tensors; one client of 3000 x 300 a
      rank): the dense solve (error < 1e-4, within :data:`SHARDED_MATCH`
      of the dcf phase's and within :data:`SHARDED_REL_MATCH` of it
      relatively), the wire (top-k 0.1, one round stale; within 2x
      dense), the coordinate median with client 1 NaN and client 5 corrupt
      every round (finite, within 3x dense), and a solve snapshotting every
      25 rounds, resumed from its first snapshot (rank 0 deletes the later
      ones, standing in for a kill after the first): the resumed L, S, U
      and V have the bytes of the uninterrupted dense solve;
    - ``sharded_rows``: the same problem over data 2 x model 2 (blocks of
      1500 x 1500), error < 1e-4;
    - ``sharded_nccl1``: one NCCL rank (world size 1) on the cf problem,
      its error within :data:`SHARDED_MATCH` of the cf phase's (and
      :data:`SHARDED_REL_MATCH` relatively), whether its
      L has the cf phase's bits, and whether its rounds were captured
      (one capture, T - 1 graph replays).

    Each rank launches exactly J K T huber_contract_v, K T
    huber_contract_u_diag and one residual_shrink a solve (the resumed
    one: the rounds after its snapshot); every rank's U has the same
    bytes.  The phase rows carry rank 0's dense launches for the kernel
    rows."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core import problems as prob
    from repro_torch.core.factorized import DCFConfig

    cfg = DCFConfig.tuned(RANK)
    rounds = cfg.outer_iters * cfg.local_iters

    def want(r=rounds):
        return {"huber_contract_v": r * cfg.inner_sweeps,
                "huber_contract_u_diag": r, "residual_shrink": 1}

    files = tempfile.mkdtemp(prefix="sharded_")
    try:
        p = prob.generate_problem(0, M_ROWS, N_COLS, RANK, SPARSITY,
                                  device=device)
        for name, x in (("m", p.m_obs), ("l0", p.l0), ("s0", p.s0)):
            np.save(f"{files}/{name}.npy", x.cpu().numpy())
        del p
        out = []
        by = _sharded_cohort("sharded", SHARDED_RANKS, "gloo", files, device)
        e_sh = by["dense"][0]["error"]
        dense = _sharded_row(
            "sharded", "dense", by["dense"], want(), ERR_BAR,
            matches_dcf=abs(e_sh - dcf_error) < SHARDED_MATCH,
            near_dcf_rel=abs(e_sh - dcf_error)
            <= SHARDED_REL_MATCH * dcf_error)
        e_d = dense["error"]
        _sharded_row("sharded", "wire", by["wire"], want(), 2 * e_d)
        _sharded_row("sharded", "robust", by["robust"], want(),
                     3 * max(e_d, 1e-6))
        _sharded_row("sharded", "snapshots", by["snapshots"], want(),
                     ERR_BAR, bits_of_dense=by["snapshots"][0]["sha"]
                     == by["dense"][0]["sha"])
        every = CHECKPOINT_EVERY * cfg.local_iters
        _sharded_row("sharded", "resumed", by["resumed"],
                     want(rounds - every), ERR_BAR,
                     bits_of_dense=by["resumed"][0]["sha"]
                     == by["dense"][0]["sha"])
        out.append(dict(dense, launches=by["dense"][0]["launches"]))
        rows = _sharded_cohort("sharded_rows", 4, "gloo", files, device)
        out.append(dict(_sharded_row("sharded_rows", "dense", rows["dense"],
                                     want(), ERR_BAR),
                        launches=rows["dense"][0]["launches"]))
        one = _sharded_cohort("sharded_nccl1", 1, "nccl", files,
                              device)["dense"]
        captured = one[0]["graph_captures"] == 1
        row = _sharded_row(
            "sharded_nccl1", "dense", one, want(), ERR_BAR,
            info={"captured": captured,
                  "l_bits_of_cf": one[0]["sha"]["l"] == cf_row["l_sha256"]},
            matches_cf=abs(one[0]["error"] - cf_row["error"])
            < SHARDED_MATCH,
            near_cf_rel=abs(one[0]["error"] - cf_row["error"])
            <= SHARDED_REL_MATCH * cf_row["error"],
            replays_t_minus_1=not captured
            or one[0]["graph_replays"] == cfg.outer_iters - 1)
        out.append(dict(row, launches=one[0]["launches"]))
        return out
    finally:
        shutil.rmtree(files, ignore_errors=True)


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
                              replayed={k: dict(v) for k, v in
                                        rt.replayed_kernels.items()},
                              **graph_fields())
        same = all(torch.equal(a, b) for a, b in zip(
            rt.leaves(way[True]["out"]), rt.leaves(way[False]["out"]),
            strict=True))
        prof = {True: profile_run(lambda: solve(True)),
                False: profile_run(lambda: solve(False), families=True)}
        del problem, solve
        # The counters against the graph's nodes (and the trace) on the cut
        # solve.
        short_cfg, short_problem = build(name, GRAPHS_COUNTED_ROUNDS)
        short = solver_run(short_cfg, short_problem, name == "batch")
        short(False)
        check = launch_check(lambda: short(False))
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
            node_read_ms=g["node_read_ms"],
            graph_launches=prof[False]["runtime_calls"].get(
                "cudaGraphLaunch", 0),
            eager_kernel_launches=prof[True]["runtime_calls"].get(
                "cudaLaunchKernel", 0),
            replay_kernel_launches=prof[False]["runtime_calls"].get(
                "cudaLaunchKernel", 0),
            launches={k: c for k, c in g["counts"].items() if c},
            counted_rounds=GRAPHS_COUNTED_ROUNDS, **check,
            full_counters_by_family=ops.family_launches(g["counts"]),
            full_graph_kernel_nodes_by_family=g["replayed"]["nodes"],
            full_replays_counted_by_family=g["replayed"]["counted"],
            full_profiler_kernels_by_family=prof[False]["device_kernels"])
        row["ok"] = (same and g["counts"] == way[True]["counts"]
                     and check["launches_exact"]
                     and check["window_graph_replays"]
                     == GRAPHS_COUNTED_ROUNDS - 1
                     and g["replayed"]["nodes"] == g["replayed"]["counted"]
                     and g["graph_captures"] == 1
                     and g["graph_replays"] == t - 1)
        emit(**row)
        if not row["ok"]:
            raise SystemExit(f"phase graphs_{name}: replay != eager")
        rows.append(row)
        del way, prof
        torch.cuda.empty_cache()
    return rows


def sanitize_phase(device) -> dict:
    """A scan-mode ``dcf`` solve at Fig. 1's size under the strict
    sanitizer (``repro_torch.debug``: ``torch.cuda.set_sync_debug_mode``
    at "error", the NaN check after the replays): the problem is built
    and the result read outside it, and the rounds (one eager, T - 1
    replays of the captured round) make no host sync, so nothing raises;
    the carry keeps the bits of an unsanitized solve, the launches are
    exactly T·K·J / T·K, and ``disable`` restores the sync debug mode."""
    import importlib

    import torch

    from repro_torch import debug
    from repro_torch.core import problems as prob
    from repro_torch.core import runtime as rt
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.kernels import ops

    dcf = importlib.import_module("repro_torch.core.dcf_pca")
    p = prob.generate_problem(0, M_ROWS, N_COLS, RANK, SPARSITY,
                              device=device)
    cfg = DCFConfig.tuned(RANK)
    problem = dcf.make_problem(p.m_obs, cfg, CLIENTS, 0, device=device)
    solver = dcf.make_solver(cfg)
    t = cfg.outer_iters
    want, _ = rt.run(solver, problem, t)
    torch.cuda.synchronize()
    before = torch.cuda.get_sync_debug_mode()
    ops.reset_launch_counts()
    rt.reset_graph_counts()
    error = None
    t0 = time.perf_counter()
    debug.enable("strict")
    try:
        got, _ = rt.run(solver, problem, t)
    except RuntimeError as e:  # a host sync under strict
        got, error = None, repr(e)[:500]
    finally:
        debug.disable()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    graphs = graph_fields()
    restored = torch.cuda.get_sync_debug_mode() == before
    same = got is not None and all(torch.equal(a, b) for a, b in zip(
        rt.leaves(got), rt.leaves(want), strict=True))
    res = solver.finalize(problem, got if got is not None else want)
    err = metrics_err(SimpleNamespace(l=res[0], s=res[1]), p)
    want_counts = {k: c for k, c in _want(cfg).items()
                   if not k.startswith("residual_shrink")}
    row = dict(phase="sanitize", mode="strict", rounds=t, wall_s=wall,
               error=err, raised=error, bit_identical=same,
               sync_debug_mode_restored=restored,
               launches={k: c for k, c in counts.items() if c},
               expected_launches=want_counts, **graphs)
    row["ok"] = (error is None and same and restored and err < ERR_BAR
                 and counts == {k: want_counts.get(k, 0) for k in counts}
                 and graphs["graph_captures"] == 1
                 and graphs["graph_replays"] == t - 1)
    emit(**row)
    if not row["ok"]:
        raise SystemExit("phase sanitize failed")
    return row


def quickstart_phase(device) -> dict:
    """``examples/torch_quickstart.py`` on the card through its ``main``:
    the dcf solve (its recovery error asserted under 1e-4), the convex
    swap, ``auto``, the early stop and the warm refresh; the launch counts
    zeroed just before and read just after."""
    import importlib.util

    from repro_torch.kernels import ops

    path = Path(__file__).resolve().parent / "examples" / \
        "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = module.main([])
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    row = dict(phase="quickstart", wall_s=wall, **out,
               launches={k: c for k, c in counts.items() if c})
    row["ok"] = (out["error"] < ERR_BAR
                 and counts.get("huber_contract_v", 0) > 0
                 and counts.get("residual_shrink", 0) > 0)
    emit(**row)
    if not row["ok"]:
        raise SystemExit("phase quickstart failed")
    row["launches"] = counts
    return row


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


def _percentile(xs, q) -> float | None:
    import numpy as np

    return float(np.percentile(np.asarray(xs) * 1e3, q)) if xs else None


def _same_response(a, b) -> bool:
    """Two service responses bit for bit (fields, verdicts, planes)."""
    import torch

    if (a.method, a.rounds, a.converged, a.diverged) != (
            b.method, b.rounds, b.converged, b.diverged):
        return False
    return all((x is None and y is None) or bool(torch.equal(x, y))
               for x, y in ((a.l, b.l), (a.s, b.s), (a.u, b.u), (a.v, b.v)))


def _drain_timed(svc, mats, **kw):
    """``svc.solve_all(mats, **kw)``, synchronised: (responses, wall s)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = svc.solve_all(mats, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _instrumented_drain(svc, mats) -> dict:
    """One drain with each admission, its ``robust_lam`` calibration, its
    fingerprints and each tick timed on their own (synchronised before and
    after each, so the drain's wall is not the counted one's): medians and
    90th percentiles in ms."""
    import torch

    from repro_torch.core import factorized as fz
    from repro_torch.serving import rpca_service as svc_mod

    times = {"admit": [], "robust_lam": [], "fingerprint": [], "tick": []}

    def timer(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            return out
        return timed

    real_lam, real_fp = fz.robust_lam, svc_mod._fingerprint
    fz.robust_lam = timer("robust_lam", real_lam)
    svc_mod._fingerprint = timer("fingerprint", real_fp)
    svc.try_submit = timer("admit", svc.try_submit)
    svc.tick = timer("tick", svc.tick)
    try:
        svc.solve_all(mats)
    finally:
        fz.robust_lam, svc_mod._fingerprint = real_lam, real_fp
        del svc.try_submit, svc.tick
    rest = [a - b for a, b in zip(times["admit"], times["robust_lam"])]
    out = {}
    for name, xs in (("admission", times["admit"]),
                     ("robust_lam", times["robust_lam"]),
                     ("admission_rest", rest),
                     ("fingerprints", [a + b for a, b in zip(
                         times["fingerprint"][::2],
                         times["fingerprint"][1::2])]),
                     ("tick", times["tick"])):
        out[f"{name}_ms_median"] = _percentile(xs, 50)
        out[f"{name}_ms_p90"] = _percentile(xs, 90)
    out["admissions"] = len(times["admit"])
    out["ticks"] = len(times["tick"])
    return out


def _tick_launches(cfg, replays: int, polls: int) -> dict[str, int]:
    """The launches a ``cf`` lane's replays and polls make: J·K masked
    contract_v and K masked u_diag a round, one masked shrink a poll."""
    return {"huber_contract_v_masked": replays * cfg.local_iters
            * cfg.inner_sweeps,
            "huber_contract_u_diag_masked": replays * cfg.local_iters,
            "residual_shrink_masked": polls}


def _launches_by_width(run):
    """``run()`` with every ``RPCAService.tick`` and ``poll`` counted by
    the service's width (a gateway's width class): the kernel launches and
    graph replays each call added, and the responses it handed back.  The
    counters are host-side, so each call's share is exact."""
    from repro_torch.core import runtime as rt
    from repro_torch.kernels import ops
    from repro_torch.serving import RPCAService

    by = {}
    real = {name: getattr(RPCAService, name) for name in ("tick", "poll")}

    def counted(name):
        def call(self, *args, **kwargs):
            before, replays = ops.launch_counts(), rt.graph_counts["replays"]
            out = real[name](self, *args, **kwargs)
            c = by.setdefault(self.n, {"launches": {}, "replays": 0,
                                       "responses": 0})
            for k, v in ops.launch_counts().items():
                if v != before[k]:
                    c["launches"][k] = c["launches"].get(k, 0) + v - before[k]
            c["replays"] += rt.graph_counts["replays"] - replays
            c["responses"] += name == "poll" and out is not None
            return out
        return call

    for name in real:
        setattr(RPCAService, name, counted(name))
    try:
        return run(), by
    finally:
        for name, fn in real.items():
            setattr(RPCAService, name, fn)


def service_phase(device) -> dict:
    """The slot service (``serving.RPCAService``) on the batch phase's
    problems: :data:`SERVICE_PROBLEMS` of 500 x 500 (rank 8, 5%, seeds 1..),
    DCFConfig.tuned(8), :data:`SERVICE_SLOTS` slots, 8 rounds a tick, 200 at
    most, drained by ``solve_all`` (continuous refill).  A first service
    builds the lane's tick (one capture) and warms the libraries; the
    counted drain runs on a second service of the same geometry, which
    captures nothing: each tick is 8 replays of the captured slot-table
    round, with exactly J·K masked contract_v and K masked u_diag launches
    a replay and one masked shrink a poll.  Beside it: problems/s against
    the serial ``rpca.solve(method="cf")`` solves and the batched solve of
    the same problems (both with the service's tolerance), each recovery
    error under :data:`SERVICE_BAR`, the admission's time split into
    ``robust_lam``, the fingerprints and the rest, the tick's time, peak
    memory, the profiled drain's busy share, the launch counters of 12
    rounds against the profiler's kernels, the replayed drain bit for bit
    an eager one, a poisoned slot's neighbour bit for bit a solo run, and
    an IALM / APGM lane at 160^2 within 1e-5 of serial solves."""
    import torch

    from repro_torch import rpca
    from repro_torch.core import APGMConfig, IALMConfig
    from repro_torch.core import compile_cache as cc
    from repro_torch.core import problems as prob
    from repro_torch.core import runtime as rt
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import RPCAService, RPCAServiceConfig

    cc.default_cache().clear()
    problems = [prob.generate_problem(1 + b, BATCH_N, BATCH_N, BATCH_RANK,
                                      SPARSITY, device=device)
                for b in range(SERVICE_PROBLEMS)]
    mats = [p.m_obs for p in problems]
    cfg = DCFConfig.tuned(BATCH_RANK)
    scfg = RPCAServiceConfig(slots=SERVICE_SLOTS,
                             rounds_per_tick=SERVICE_ROUNDS_PER_TICK,
                             max_rounds=SERVICE_MAX_ROUNDS)

    def service(eager=False, rounds_per_tick=None):
        s = scfg if rounds_per_tick is None else RPCAServiceConfig(
            slots=SERVICE_SLOTS, rounds_per_tick=rounds_per_tick,
            max_rounds=SERVICE_MAX_ROUNDS)
        return RPCAService(BATCH_N, BATCH_N, cfg, s, key=BATCH_KEY,
                           device=device, eager=eager)

    rt.reset_graph_counts()
    t0 = time.perf_counter()
    first = service()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build = graph_fields()
    first.solve_all(mats[:2])  # warms the libraries
    del first

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rt.reset_graph_counts()
    resps, wall = _drain_timed(service(), mats)
    counts = ops.launch_counts()
    graphs = graph_fields()
    peak = torch.cuda.max_memory_allocated() / 1e9
    replays = graphs["graph_replays"]
    want = _tick_launches(cfg, replays, SERVICE_PROBLEMS)
    errors = [metrics_err(r, p) for r, p in zip(resps, problems)]
    rounds = [r.rounds for r in resps]
    profiled = profile_run(lambda: service().solve_all(mats))

    early = rt.RunConfig(mode="while", tol=scfg.tol)
    serial, serial_wall = _serial(problems, cfg, method="cf", run=early,
                                  key=BATCH_KEY, device=device)
    chunked = rt.RunConfig(mode="chunk", tol=scfg.tol,
                           chunk_size=SERVICE_ROUNDS_PER_TICK)
    stacked = _stacked(problems).m_obs

    def batched():
        return rpca.solve(stacked, method="cf", cfg=cfg, run=chunked,
                          key=BATCH_KEY, device=device)

    batched()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_res = batched()
    torch.cuda.synchronize()
    batch_wall = time.perf_counter() - t0
    timing = _instrumented_drain(service(), mats)

    eager, eager_wall = _drain_timed(service(eager=True), mats)
    replay_is_eager = all(_same_response(a, b)
                          for a, b in zip(resps, eager, strict=True))

    # A poisoned tenant beside a healthy one, against the healthy alone.
    solo = service().solve_all(mats[:1])[0]
    poison = mats[1].clone()
    poison[3, 5] = float("nan")
    mixed = service().solve_all([mats[0], poison])
    neighbour_same = _same_response(mixed[0], solo)
    quarantined = mixed[1].diverged and not mixed[1].converged

    # Launch counters against the profiler's kernels over 12 rounds (three
    # ticks of 4 rounds: a lane of its own, one capture).
    short = service(rounds_per_tick=GRAPHS_COUNTED_ROUNDS // 3)
    for m_obs in mats[:SERVICE_SLOTS]:
        short.try_submit(m_obs)
    short.tick()

    def three_ticks():
        for _ in range(3):
            short.tick()

    check = launch_check(three_ticks)
    del short

    # The convex lanes: two IALM and two APGM tenants at 160^2, eager ticks.
    convex = [prob.generate_problem(10 + b, CONVEX_BATCH_N, CONVEX_BATCH_N,
                                    8, SPARSITY, device=device)
              for b in range(4)]
    methods = {0: "ialm", 1: "ialm", 2: "apgm", 3: "apgm"}
    lanes = RPCAService(CONVEX_BATCH_N, CONVEX_BATCH_N,
                        DCFConfig.tuned(BATCH_RANK),
                        RPCAServiceConfig(slots=4, rounds_per_tick=8,
                                          max_rounds=SERVICE_MAX_ROUNDS),
                        cfgs={"ialm": IALMConfig(), "apgm": APGMConfig()},
                        device=device)
    rt.reset_graph_counts()
    convex_resps, convex_wall = _drain_timed(
        lanes, [p.m_obs for p in convex], methods=methods)
    convex_captures = rt.graph_counts["captures"]
    convex_rows = []
    for b, (p, r) in enumerate(zip(convex, convex_resps)):
        cfg_t = IALMConfig if methods[b] == "ialm" else APGMConfig
        one = rpca.solve(p.m_obs, method=methods[b],
                         cfg=cfg_t(iters=r.rounds), device=device)
        rel = max((torch.linalg.norm(a - x) / torch.linalg.norm(x)).item()
                  for a, x in ((r.l, one.l), (r.s, one.s)))
        convex_rows.append(dict(method=methods[b], rounds=r.rounds,
                                converged=r.converged,
                                rel_diff_vs_serial=rel))
    cc.default_cache().clear()

    row = dict(
        phase="service", method="cf", problems=SERVICE_PROBLEMS, m=BATCH_N,
        n=BATCH_N, rank=BATCH_RANK, slots=SERVICE_SLOTS,
        rounds_per_tick=SERVICE_ROUNDS_PER_TICK,
        max_rounds=SERVICE_MAX_ROUNDS, tol=scfg.tol,
        lane_build_s=build_s, lane_build_captures=build["graph_captures"],
        lane_capture_ms=build["capture_ms"], wall_s=wall,
        problems_per_s=SERVICE_PROBLEMS / wall,
        serial_wall_s=serial_wall,
        serial_problems_per_s=SERVICE_PROBLEMS / serial_wall,
        batched_wall_s=batch_wall,
        batched_problems_per_s=SERVICE_PROBLEMS / batch_wall,
        batched_rounds=batch_res.stats.rounds.tolist(),
        serial_rounds=[int(r.stats.rounds) for r in serial],
        rounds=rounds, converged=all(r.converged for r in resps),
        errors_max=max(errors), serial_errors_max=max(
            metrics_err(r, p) for r, p in zip(serial, problems)),
        bar=SERVICE_BAR, **timing,
        peak_mem_gb=peak, device_busy_ms=profiled["device_busy_ms"],
        device_busy_share=profiled["device_busy_ms"] / (wall * 1e3),
        top_kernels=profiled["top_kernels"][:4],
        runtime_calls=profiled["runtime_calls"],
        **graphs, graph_replays_per_tick=SERVICE_ROUNDS_PER_TICK,
        launches={k: c for k, c in counts.items() if c or k in want},
        expected_launches=want,
        counted_rounds=GRAPHS_COUNTED_ROUNDS, **check,
        eager_wall_s=eager_wall, replay_is_eager=replay_is_eager,
        poisoned_neighbour_bit_identical=neighbour_same,
        poisoned_slot_quarantined=quarantined,
        convex_lanes=convex_rows, convex_wall_s=convex_wall,
        convex_captures=convex_captures, convex_tol=SERVICE_CONVEX_TOL)
    row["ok"] = (graphs["graph_captures"] == 0 and replays > 0
                 and replays % SERVICE_ROUNDS_PER_TICK == 0
                 and build["graph_captures"] == 1
                 and counts == {k: want.get(k, 0) for k in counts}
                 and row["converged"] and max(errors) < SERVICE_BAR
                 and check["launches_exact"]
                 and check["window_graph_replays"] == GRAPHS_COUNTED_ROUNDS
                 and replay_is_eager
                 and neighbour_same and quarantined
                 and convex_captures == 0
                 and all(r["rel_diff_vs_serial"] <= SERVICE_CONVEX_TOL
                         for r in convex_rows))
    emit(**row)
    if not row["ok"]:
        raise SystemExit("phase service failed")
    row["launches"] = counts
    return row


def service_fig1_phase(device) -> dict:
    """Four Fig. 1 problems (3000 x 3000, r = 150, 5%, seeds 0-3,
    DCFConfig.tuned(150)) through a 4-slot ``cf`` service: the lane's
    build (one capture), the drain's problems/s against the serial
    ``rpca.solve(method="cf")`` solves with the service's tolerance, each
    recovery error under the Fig. 1 bar, the drain's launches (no capture;
    exactly J·K masked contract_v and K masked u_diag a replay, one masked
    shrink a poll), a warm refresh of problem 0 (its data plus 1% noise,
    its factors): rounds and wall; and the admission's time split as in
    the service phase (a drain of its own)."""
    import torch

    from repro_torch import rpca
    from repro_torch.core import compile_cache as cc
    from repro_torch.core import problems as prob
    from repro_torch.core import runtime as rt
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import RPCAService, RPCAServiceConfig

    cc.default_cache().clear()
    problems = [prob.generate_problem(seed, M_ROWS, N_COLS, RANK, SPARSITY,
                                      device=device)
                for seed in range(FIG1_BATCH)]
    cfg = DCFConfig.tuned(RANK)
    scfg = RPCAServiceConfig(slots=FIG1_BATCH,
                             rounds_per_tick=SERVICE_ROUNDS_PER_TICK,
                             max_rounds=SERVICE_MAX_ROUNDS)
    rt.reset_graph_counts()
    t0 = time.perf_counter()
    svc = RPCAService(M_ROWS, N_COLS, cfg, scfg, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    captures = rt.graph_counts["captures"]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rt.reset_graph_counts()
    resps, wall = _drain_timed(svc, [p.m_obs for p in problems])
    counts = ops.launch_counts()
    replays = rt.graph_counts["replays"]
    drain_captures = rt.graph_counts["captures"]
    want = _tick_launches(cfg, replays, FIG1_BATCH)
    peak = torch.cuda.max_memory_allocated() / 1e9
    errors = [metrics_err(r, p) for r, p in zip(resps, problems)]
    early = rt.RunConfig(mode="while", tol=scfg.tol)
    serial, serial_wall = _serial(problems, cfg, method="cf", run=early,
                                  device=device)
    g = torch.Generator(device=device).manual_seed(99)
    noisy = problems[0].m_obs + 0.01 * torch.randn(
        problems[0].m_obs.shape, generator=g, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slot = svc.try_submit(noisy, warm=(resps[0].u, resps[0].v))
    while svc.pending():
        svc.tick()
    refresh = svc.poll(slot)
    torch.cuda.synchronize()
    refresh_wall = time.perf_counter() - t0
    svc.release(slot)
    del svc
    timing = _instrumented_drain(
        RPCAService(M_ROWS, N_COLS, cfg, scfg, device=device),
        [p.m_obs for p in problems])
    cc.default_cache().clear()
    row = dict(phase="service_fig1", method="cf", problems=FIG1_BATCH,
               m=M_ROWS, n=N_COLS, rank=RANK, slots=FIG1_BATCH,
               lane_build_s=build_s, lane_build_captures=captures,
               wall_s=wall, problems_per_s=FIG1_BATCH / wall,
               serial_wall_s=serial_wall,
               serial_problems_per_s=FIG1_BATCH / serial_wall,
               rounds=[r.rounds for r in resps],
               serial_rounds=[int(r.stats.rounds) for r in serial],
               errors=errors, bar=ERR_BAR, peak_mem_gb=peak,
               drain_captures=drain_captures, graph_replays=replays,
               launches={k: c for k, c in counts.items() if c or k in want},
               expected_launches=want, refresh_rounds=refresh.rounds,
               refresh_converged=refresh.converged,
               refresh_wall_s=refresh_wall,
               cold_rounds_third=resps[0].rounds // 3, **timing)
    row["ok"] = (captures == 1 and drain_captures == 0 and replays > 0
                 and replays % SERVICE_ROUNDS_PER_TICK == 0
                 and counts == {k: want.get(k, 0) for k in counts}
                 and all(r.converged for r in resps)
                 and max(errors) < ERR_BAR and refresh.converged
                 and refresh.rounds < resps[0].rounds // 3)
    emit(**row)
    if not row["ok"]:
        raise SystemExit("phase service_fig1 failed")
    row["launches"] = counts
    return row


def gateway_tenant(n_cols: int, seed: int):
    """``benchmarks/gateway_bench.py``'s tenant: a rank-GATEWAY_RANK
    GATEWAY_M x ``n_cols`` plane plus 5% spikes of 3.0, as (truth,
    observation) in fp32 numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    low = rng.standard_normal((GATEWAY_M, GATEWAY_RANK)) @ \
        rng.standard_normal((GATEWAY_RANK, n_cols))
    sparse = (rng.random((GATEWAY_M, n_cols)) < 0.05) * 3.0
    return low.astype(np.float32), (low + sparse).astype(np.float32)


def gateway_phase(device) -> list[dict]:
    """``benchmarks/gateway_bench.py``'s ``run()`` at its full mix on the
    card: m = 512, n_max = 256, rank 8, pages of 32 columns, 4 slots a
    width class, 8 rounds a tick, 200 at most; eight tenants of 1/8 to 1
    of n_max.  The padded-byte reduction of the paged width classes
    against one homogeneous table (the benchmark's model, gated at >= 2),
    then the mix through ``RPCAGateway.solve_all``: a first gateway builds
    the width classes' lanes (a capture each), the second is timed: wall,
    solves/s, the gateway's p50 / p99 submit-to-result latency, rounds/s,
    the largest live homogeneous-to-paged byte ratio (a metrics snapshot
    each tick), and each response's low-rank error against its truth (the
    reference test's 5e-2, tests/test_gateway.py:189).  The timed run's
    launches are counted by width class (a ``gateway@<width>`` line each):
    no capture, and exactly J·K masked contract_v and K masked u_diag a
    replay and one masked shrink a poll in every class."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.core import compile_cache as cc
    from repro_torch.core import runtime as rt
    from repro_torch.core.factorized import DCFConfig
    from repro_torch.kernels import ops
    from repro_torch.serving import GatewayConfig, RPCAGateway

    m, n_max, rank = GATEWAY_M, GATEWAY_N_MAX, GATEWAY_RANK
    page = n_max // 8
    widths = [max(1, int(round(f * n_max))) for f in GATEWAY_MIX]
    paged = sum(min(n_max, -(-w // page) * page) * 4 * m for w in widths)
    homog = len(widths) * n_max * 4 * m
    reduction = homog / paged

    truths, mats = zip(*(gateway_tenant(w, i) for i, w in enumerate(widths)))
    cfg = DCFConfig.tuned(rank=rank)
    gcfg = GatewayConfig(page_cols=page, pool_pages=4 * len(widths),
                         max_queue=2 * len(widths), slots=GATEWAY_SLOTS,
                         rounds_per_tick=SERVICE_ROUNDS_PER_TICK,
                         max_rounds=SERVICE_MAX_ROUNDS)
    cc.default_cache().clear()
    rt.reset_graph_counts()
    t0 = time.perf_counter()
    RPCAGateway(m, n_max, cfg, gcfg, device=device).solve_all(list(mats))
    torch.cuda.synchronize()
    first_wall = time.perf_counter() - t0
    captures = rt.graph_counts["captures"]
    homog_seen = []
    gw = RPCAGateway(m, n_max, cfg,
                     dataclasses.replace(gcfg, snapshot_every=1),
                     device=device,
                     snapshot_hook=lambda mets: homog_seen.append(
                         mets["padding"]["homogeneous_ratio"]))
    ops.reset_launch_counts()
    rt.reset_graph_counts()
    t0 = time.perf_counter()
    resps, by_width = _launches_by_width(lambda: gw.solve_all(list(mats)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    mets = gw.metrics()
    classes = []
    for width in sorted(by_width):
        c = by_width[width]
        want = _tick_launches(cfg, c["replays"], c["responses"])
        launches = {k: c["launches"].get(k, 0) for k in counts}
        tenants = sum(gw._width_for(w) == width for w in widths)
        cls = dict(phase=f"gateway@{width}", width=width, tenants=tenants,
                   responses=c["responses"], graph_replays=c["replays"],
                   launches={k: x for k, x in launches.items() if x},
                   expected_launches=want)
        cls["ok"] = (c["replays"] > 0
                     and c["replays"] % SERVICE_ROUNDS_PER_TICK == 0
                     and c["responses"] == tenants
                     and launches == {k: want.get(k, 0) for k in counts})
        emit(**cls)
        cls["launches"] = launches
        classes.append(cls)
    summed = {k: sum(cls["launches"][k] for cls in classes) for k in counts}
    errors = [float(np.linalg.norm(r.l.cpu().numpy() - t)
                    / np.linalg.norm(t)) for r, t in zip(resps, truths)]
    shapes_ok = all(tuple(r.l.shape) == x.shape
                    for r, x in zip(resps, mats))
    cc.default_cache().clear()
    row = dict(phase="gateway", m=m, n_max=n_max, rank=rank,
               page_cols=page, widths=widths,
               width_classes=sorted(gw._services),
               paged_plane_bytes=paged, homog_plane_bytes=homog,
               reduction=reduction, min_reduction=GATEWAY_MIN_REDUCTION,
               live_homogeneous_ratio_max=max(homog_seen, default=None),
               first_wall_s=first_wall, first_captures=captures,
               wall_s=wall, solves_per_s=len(mats) / wall,
               captures=rt.graph_counts["captures"],
               replays=rt.graph_counts["replays"],
               rounds_total=mets["rounds_total"],
               rounds_per_s=mets["rounds_total"] / wall,
               p50_ms=mets["latency"]["p50_ms"],
               p99_ms=mets["latency"]["p99_ms"], shed=mets["shed"],
               rounds=[r.rounds for r in resps], errors=errors,
               bar=GATEWAY_BAR)
    row["ok"] = (reduction >= GATEWAY_MIN_REDUCTION and shapes_ok
                 and captures == len(row["width_classes"])
                 and row["captures"] == 0 and mets["shed"] == 0
                 and all(r.converged for r in resps)
                 and max(errors) < GATEWAY_BAR
                 and sorted(by_width) == row["width_classes"]
                 and all(cls["ok"] for cls in classes) and counts == summed
                 and row["replays"] == sum(c["replays"]
                                           for c in by_width.values()))
    emit(**row)
    if not row["ok"]:
        raise SystemExit("phase gateway failed")
    return [row, *classes]


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

    def __init__(self, model, step_events: bool = False,
                 keep_steps: bool = False):
        self.model = model
        self.step_events = step_events
        self.keep_steps = keep_steps
        self.events = []
        self.prefill_logits = None
        self.step_logits = []

    def _event(self):
        import torch

        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append(event)

    def tensor_parallel(self, rules=None):
        return self.model.tensor_parallel(rules)

    def init_cache(self, *args, **kw):
        self.events = []
        self.step_logits = []
        return self.model.init_cache(*args, **kw)

    def prefill(self, *args, **kw):
        self._event()
        self.prefill_logits, caches = self.model.prefill(*args, **kw)
        self._event()
        return self.prefill_logits, caches

    def decode_step(self, *args, **kw):
        out = self.model.decode_step(*args, **kw)
        if self.step_events:
            self._event()
        if self.keep_steps:
            self.step_logits.append(out[0].clone())
        return out

    def prefill_ms(self) -> float:
        """The last generate's prefill ms; call after a synchronize."""
        return self.events[0].elapsed_time(self.events[1])

    def step_ms(self) -> float:
        """The last eager generate's decode ms a step (sampling included);
        call after a synchronize."""
        return (self.events[1].elapsed_time(self.events[-1])
                / (len(self.events) - 2))


def _rel_diff(got, want) -> float:
    """max |got - want| over max |want|, in fp32."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


class RoutingHold:
    """Holds the MoE layers' routing across two runs: inside
    :meth:`record` every ``models.moe._route`` call keeps its expert ids,
    in call order (``ids``, or given: another process's, as serve_moe_tp's
    workers load serve_moe's); inside :meth:`replay` each call takes the
    recorded ids of its turn (the weights renormalised from this call's
    own probabilities), inside :meth:`compare` it keeps its own; both
    count the tokens whose expert set differs from the recorded one and
    keep every call's own ids (``seen``, hashed by :meth:`digest`).

    A top-k choice is discrete: where two experts' probabilities nearly
    tie, a bf16 ulp of the residual stream (the flash kernel rounds P and
    O to bf16; the plain attention keeps its softmax in fp32) sends the
    token to another expert, and that token's hidden state then moves by
    far more than rounding.  Holding the routing leaves the two runs
    apart by their numerics alone, which a logits bar judges; the free
    comparison and the flips are reported beside it."""

    def __init__(self, ids=None):
        self.ids = [] if ids is None else list(ids)
        self.seen = []
        self.flips = self.last_flips = self.decisions = 0

    def _patched(self, route):
        import contextlib

        from repro_torch.models import moe

        @contextlib.contextmanager
        def ctx():
            self.seen = []
            self.flips = self.last_flips = self.decisions = 0
            real = moe._route
            moe._route = lambda params, x, cfg: route(real, params, x, cfg)
            try:
                yield self
            finally:
                moe._route = real
        return ctx()

    def record(self):
        def route(real, params, x, cfg):
            w, ids, aux = real(params, x, cfg)
            self.ids.append(ids)
            return w, ids, aux
        return self._patched(route)

    def _routed(self, hold: bool):
        import torch

        turn = iter(self.ids)

        def route(real, params, x, cfg):
            w, ids, aux = real(params, x, cfg)
            self.seen.append(ids)
            held = next(turn, None)
            if held is None:
                return w, ids, aux
            held = held.to(ids.device, torch.int64)
            moved = (ids.sort(-1).values != held.sort(-1).values).any(-1)
            self.flips += int(moved.sum())
            self.last_flips += int(moved[:, -1].sum())
            self.decisions += moved.numel()
            if not hold:
                return w, ids, aux
            probs = torch.softmax(x.float() @ params.router, dim=-1)
            w = probs.gather(-1, held)
            w = w / torch.clamp_min(w.sum(-1, keepdim=True), 1e-9)
            return w.to(x.dtype), held, aux
        return self._patched(route)

    def replay(self):
        return self._routed(hold=True)

    def compare(self):
        return self._routed(hold=False)

    def digest(self) -> str:
        """A hash of every call's own ids since the last replay or
        compare began, in call order."""
        import hashlib

        import torch

        h = hashlib.sha256()
        for ids in self.seen:
            h.update(ids.to(torch.int64).cpu().numpy().tobytes())
        return h.hexdigest()

    def stats(self) -> dict:
        """Tokens (summed over MoE layers) whose expert set differed
        from the recorded one, and how many of them at the last position
        (the one the prefill's logits read)."""
        return dict(tokens_rerouted=self.flips,
                    last_position_rerouted=self.last_flips,
                    token_decisions=self.decisions, calls=len(self.seen))


def fp32_model_logits(cfg, params, prompt, tokens, ids,
                      ctx=None) -> "torch.Tensor":
    """The fp32 model of a served run: the same weights, upcast to fp32 in
    place (each bf16 tensor is freed as its copy is made, so the card
    holds the fp32 weights alone: ~50 GB for the jamba and deepseek-v2
    cuts), every activation and product in fp32 (TF32 off; the flash
    kernel's fp32 path), fed the run's tokens and context and held to its
    routing ``ids`` (a call each): the prefill's and every decode step's
    logits, (steps, B, V) fp32 on the host.  ``params`` are fp32 after."""
    import torch

    from repro_torch.models import get_model

    with torch.no_grad():
        for p in params.parameters():
            p.data = p.data.float()
    torch.cuda.empty_cache()
    model = get_model(cfg.replace(compute_dtype="float32"))
    b, s = prompt.shape
    new = tokens.shape[1]
    with RoutingHold(ids).replay():
        caches = model.init_cache(b, s + new, prompt.device)
        logits, _ = model.prefill(params, prompt, caches,
                                  ctx=None if ctx is None else ctx.float())
        out = [logits.float().cpu()]
        for i in range(new - 1):
            step, _ = model.decode_step(params, tokens[:, i:i + 1], caches,
                                        s + i)
            out.append(step.float().cpu())
    return torch.stack(out)


def allclose_excess(got, want, bar: float) -> dict:
    """How far ``got`` (a list or stack of logits) is past the allclose
    bound |got - want| <= bar + bar |want| (<= 0 passes): the largest
    excess, the largest and the mean |got - want|."""
    excess, big, mean = [], 0.0, 0.0
    for g, w in zip(got, want, strict=True):
        g, w = g.float(), w.float()
        d = (g - w).abs()
        excess.append(float((d - bar * w.abs()).max()) - bar)
        big = max(big, float(d.max()))
        mean += float(d.mean()) / len(want)
    return dict(excess=max(excess), abs_max=big, abs_mean=mean)


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


def dryrun_row(name: str, cfg, cut, params, weights_gb: float,
               s_max: int) -> dict:
    """The dry run (``launch/dryrun.py``: the model built on the meta
    device) of a serve cell's configuration and cut, held to the model the
    phase materialised: the meta pass's weight bytes equal its parameters'
    sum of numel x element_size exactly; the allocator's ``weights_gb``
    and the meta pass's caches at the cell's batch and length beside."""
    from repro_torch.launch import dryrun
    from repro_torch.models import get_model
    from repro_torch.models.params import count_params

    made = sum(p.numel() * p.element_size() for p in params.parameters())
    meta = dryrun.weight_bytes(cfg)
    cache = dryrun.cache_bytes(cfg, SERVE_BATCH, s_max)
    row = dict(phase=f"dryrun_{name}", arch=cfg.name, cut=cut or None,
               param_dtype=cfg.param_dtype,
               params=count_params(get_model(cfg).specs()),
               meta_weight_bytes=meta, materialised_weight_bytes=made,
               weights_gb_allocated=weights_gb,
               meta_cache_bytes=cache, batch=SERVE_BATCH, s_max=s_max,
               fits_card=meta + cache <= dryrun.CARD_BYTES,
               ok=meta == made)
    emit(**row)
    if not row["ok"]:
        raise SystemExit(f"phase dryrun_{name}: meta weights != the model's")
    return row


def serve_phase(device, name: str = "serve", arch: str = SERVE_ARCH,
                new_tokens: int = SERVE_NEW, fp32: bool = False,
                cut: dict | None = None,
                prompt_len: int = SERVE_PROMPT) -> dict:
    """Phases 11 and 12 and the families' serve phases: ``arch`` at full
    width (and full depth unless ``cut`` replaces config fields) through
    ``generate`` (in fp32 when ``fp32``, else its bf16), 4 prompts of
    ``prompt_len`` tokens and ``new_tokens`` greedy tokens: the decode step
    captured once and replayed.  A ``vlm`` or ``encdec`` model gets a
    context (standard normal from a seeded generator on the card) and its
    cross layers' gates are set to :data:`SERVE_CROSS_GATE`; another
    context must move its prefill's logits.  The prefill ms (CUDA events
    around it), the replayed decode ms a step (the profiled run's replay
    period on the device, :func:`replay_period_ms`), the tokens equal to
    an eager decode's (its ms a step beside, from CUDA events after every
    step), one graph launch a replayed step (the profiler's
    ``cudaGraphLaunch`` count), and one flash_attention launch per
    self-attention layer (none for MLA, cross layers or an encoder)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import runtime as rt
    from repro_torch.kernels import ops
    from repro_torch.models import CONTEXT_FAMILIES, get_model
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.lm import ctx_len
    from repro_torch.serving.engine import ServeConfig, generate

    cfg = get_config(arch).replace(flash_attention=True, **(cut or {}))
    if fp32:
        cfg = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model = get_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init_params(seed=0, device=device)
    gates = [layer.gate for layer in params.layers if hasattr(layer, "gate")]
    with torch.no_grad():
        for gate in gates:
            gate.fill_(SERVE_CROSS_GATE)
    gen = torch.Generator(device=device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (SERVE_BATCH, prompt_len),
                           generator=gen, device=device)
    ctx = other_ctx = None
    if cfg.family in CONTEXT_FAMILIES:
        ctx, other_ctx = (torch.randn(
            (SERVE_BATCH, ctx_len(cfg), cfg.d_model), generator=gen,
            device=device).to(cfg.cdtype) for _ in range(2))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    weights_gb = torch.cuda.memory_allocated() / 1e9
    param_gb = dryrun_row(name, cfg, cut, params, weights_gb,
                          prompt_len + new_tokens)[
        "materialised_weight_bytes"] / 1e9
    scfg = ServeConfig(max_new_tokens=new_tokens)

    kept = _EventTimedModel(model)
    yardstick = TP_YARDSTICKS.get(name)
    eager_timed = _EventTimedModel(model, step_events=True,
                                   keep_steps=yardstick is not None)

    def serve(eager=False):
        return generate(eager_timed if eager else kept, params, prompt, scfg,
                        eager=eager, ctx=ctx)

    # Warm the libraries (cuBLAS handles and heuristics) with a short run.
    generate(model, params, prompt, ServeConfig(max_new_tokens=3), ctx=ctx)
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
    # The eager run's routing ids, a call each (a model with MoE layers):
    # what serve_moe_tp's ranks are held to.
    eager_routing = RoutingHold()
    with eager_routing.record():
        eager_tokens = serve(eager=True)
    torch.cuda.synchronize()
    eager_step_ms = eager_timed.step_ms()
    same = bool(torch.equal(tokens, eager_tokens))
    # The same weights and prompt with the config's flash switch off: the
    # plain (chunked, fp32 softmax) attention of every layer.
    plain = get_model(cfg.replace(flash_attention=False))
    ref_logits, _ = plain.prefill(params, prompt, ctx=ctx)
    rel = rel_free = _rel_diff(logits, ref_logits)
    routing = None
    if cfg.moe is not None:
        # Routed layers: the gate compares the plain prefill routed as the
        # flash one was (RoutingHold); the free comparison is reported.
        hold = RoutingHold()
        with hold.record():
            flash_logits, _ = model.prefill(params, prompt, ctx=ctx)
        with hold.replay():
            held_logits, _ = plain.prefill(params, prompt, ctx=ctx)
        rel = _rel_diff(flash_logits, held_logits)
        routing = hold.stats()
        del flash_logits, held_logits
    # The context reaches the logits (through nonzero gates in a VLM).
    ctx_moved = None
    if ctx is not None:
        moved_logits, _ = model.prefill(params, prompt, ctx=other_ctx)
        ctx_moved = _rel_diff(moved_logits, logits)
        del moved_logits
    finite = bool(torch.isfinite(logits.float()).all())
    # One flash launch a self-attention layer of the decoder.
    attention_layers = sum(m == "attn" for m, _ in model.layer_plan())
    want = {"flash_attention": attention_layers}
    in_vocab = bool((tokens >= 0).all()
                    and (tokens < padded_vocab(cfg.vocab)).all())
    replays = new_tokens - 2
    del ref_logits
    profiled = profile_run(serve)
    vs_fp32 = None
    if yardstick is not None:  # a model-axis phase's yardstick
        SERVE_TP_DIR.mkdir(parents=True, exist_ok=True)
        fed = [logits.cpu()] + [x.cpu() for x in eager_timed.step_logits]
        eager_timed.step_logits = []
        saved = dict(prompt=prompt.cpu(), tokens=tokens.cpu(),
                     prefill=fed[0], steps=torch.stack(fed[1:]),
                     routes=[ids.to(torch.int16).cpu()
                             for ids in eager_routing.ids],
                     ctx=None if ctx is None else ctx.cpu(),
                     weights_gb=weights_gb)
        if name != "serve":
            # Last: the fp32 model takes the weights (upcast in place).
            saved["fp32"] = fp32_model_logits(cfg, params, prompt, tokens,
                                              eager_routing.ids, ctx)
            vs_fp32 = allclose_excess(fed, saved["fp32"], SERVE_TP_BAR)
            saved["fp32_excess"] = vs_fp32["excess"]
        torch.save(saved, SERVE_TP_DIR / yardstick)
        del fed, saved
    del eager_routing
    gate_values = [float(g) for g in gates]
    ok = (tuple(tokens.shape) == (SERVE_BATCH, new_tokens) and in_vocab
          and finite and rel <= SERVE_LOGITS_BAR and same
          and all(g != 0 for g in gate_values)
          and (ctx_moved is None or ctx_moved > 0)
          and graphs["graph_captures"] == 1
          and graphs["graph_replays"] == replays
          and counts == {k: want.get(k, 0) for k in counts})
    row = dict(phase=name, arch=cfg.name, family=cfg.family,
               layers=cfg.n_layers, attention_layers=attention_layers,
               cut=cut or None, d_model=cfg.d_model, dtype=cfg.compute_dtype,
               batch=SERVE_BATCH, prompt=prompt_len, new_tokens=new_tokens,
               ctx_tokens=None if ctx is None else ctx.shape[1],
               cross_gates=gate_values or None,
               logits_rel_moved_by_other_ctx=ctx_moved,
               setup_s=setup_s, weights_gb=weights_gb, param_gb=param_gb,
               wall_s=wall,
               tokens_per_s=SERVE_BATCH * new_tokens / wall,
               prefill_ms=prefill_ms,
               decode_ms_per_step=profiled["graph_replays"]["period_ms"],
               decode_kernel_ms_per_step=profiled["graph_replays"][
                   "kernel_ms_per_replay"],
               eager_decode_ms_per_step=eager_step_ms,
               tokens_equal_eager=same, **graphs,
               peak_mem_gb=peak_gb, logits_rel_diff_vs_plain=rel,
               bar=SERVE_LOGITS_BAR,
               logits_rel_diff_vs_plain_free_routing=rel_free,
               routing_vs_plain=routing, finite=finite,
               logits_vs_fp32_model=vs_fp32,
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


SERVE_TP_WORKER = r"""
import contextlib, dataclasses, json, os, sys, time
import torch
sys.path.insert(0, os.environ["SERVE_TP_ROOT"])
from chip_smoke import RoutingHold
from repro_torch import configs
from repro_torch.distributed.sharding import rules_for_mesh
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.models import get_model
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import head_layout, mla_heads
from repro_torch.models.ssm import head_split
from repro_torch.serving.engine import ServeConfig, generate

torch.backends.cuda.matmul.allow_tf32 = False
_mh.SYNC_TIMING = True  # collective seconds without the step's queue
env = json.loads(os.environ["SERVE_TP_ENV"])
device = torch.device("cuda")
mesh = _mh.multihost_mesh(("data", "model"), (1, env["ranks"]),
                          device=device)
rules = rules_for_mesh(mesh)
cfg = configs.get_config(env["arch"]).replace(flash_attention=True,
                                              **env["cut"])
model = get_model(cfg)
tp = model.tensor_parallel(rules)
torch.cuda.reset_peak_memory_stats()
t0 = time.perf_counter()
params = model.init_params(seed=0, device=device, rules=rules)
with torch.no_grad():
    for layer in params.layers:
        if hasattr(layer, "gate"):  # as the serve phase set them
            layer.gate.fill_(env["gate"])
torch.cuda.synchronize()
setup_s = time.perf_counter() - t0
weights_gb = sum(p.numel() * p.element_size()
                 for p in params.parameters()) / 1e9
# The rank's heads: attention's (query, KV), the SSD mixer's (heads, B/C
# groups), MLA's.
layout = {}
if cfg.ssm is not None:
    ssd = head_split(cfg, tp.size, tp.index)
    layout["ssd"] = dict(heads=ssd.heads, h0=ssd.h0, groups=ssd.groups)
if cfg.mla is not None:
    layout["mla"] = dict(heads=mla_heads(cfg, tp.size))
elif cfg.family != "ssm":
    att = head_layout(cfg, tp.size, tp.index)
    layout["attn"] = dict(heads=att.heads, kv_heads=att.kv_heads)
serve = torch.load(env["serve"])
prompt = serve["prompt"].to(device)
# The serve phase's tokens, env["new"] of them.
served = serve["tokens"][:, :env["new"]].to(device)
ctx = None if serve.get("ctx") is None else serve["ctx"].to(device)
b, s = prompt.shape
new = served.shape[1]


def event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


moe = cfg.moe is not None
hold = RoutingHold(serve.get("routes"))


def routing():
    return dict(**hold.stats(), hash=hold.digest())


moe_all_reduces = []
real_ffn = moe_mod.moe_ffn


def moe_ffn(*args, **kw):
    # The all-reduces one MoE layer makes (the collective counters).
    before = _mh.wire_counts()["all_reduce_calls"]
    out = real_ffn(*args, **kw)
    moe_all_reduces.append(_mh.wire_counts()["all_reduce_calls"] - before)
    return out


moe_mod.moe_ffn = moe_ffn
# Fed serve's tokens (this run also warms the libraries), held to its
# routing where the model routes (chip_smoke's RoutingHold on the ids
# the serve phase recorded): the prefill's and every decode step's
# logits against the serve phase's, and the greedy tokens.  The
# collectives of the prefill and of the decode steps apart.
with hold.replay() if moe else contextlib.nullcontext():
    caches = model.init_cache(b, s + new, device, rules=rules)
    cache_gb = sum(x.numel() * x.element_size()
                   for c in caches for x in c) / 1e9
    _mh.wire_counts(reset=True)
    logits, _ = model.prefill(params, prompt, caches, ctx=ctx, rules=rules)
    prefill_wire = _mh.wire_counts(reset=True)
    forced = [logits.cpu()]
    for i in range(new - 1):
        step, _ = model.decode_step(params, served[:, i:i + 1], caches,
                                    s + i, rules=rules)
        forced.append(step.cpu())
    step_wire = _mh.wire_counts(reset=True)
held = routing() if moe else None
wants = [serve["prefill"]] + list(serve["steps"][:new - 1])
abs_err, rel_err, excess = [], [], []
held_tokens, differ, served_argmax = 0, 0, True
fp32_held = fp32_differ = serve_fp32_differ = 0
fp32 = None if "fp32" not in serve else serve["fp32"][:new]
for col, (got, want) in enumerate(zip(forced, wants, strict=True)):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    abs_err.append(float(diff.max()))
    rel_err.append(abs_err[-1] / float(want.abs().max()))
    # Past the allclose bound |diff| <= bar + bar |want|: <= 0 passes.
    excess.append(float((diff - env["bar"] * want.abs()).max()) - env["bar"])
    top = want.topk(2, dim=-1).values
    sure = (top[:, 0] - top[:, 1]) > env["margin"]
    argmax = want.argmax(-1)
    served_argmax &= bool((argmax == serve["tokens"][:, col]).all())
    held_tokens += int(sure.sum())
    differ += int((sure & (got.argmax(-1) != argmax)).sum())
    # Where the fp32 model's own top-2 margin passes the margin, this
    # rank's and the serve phase's greedy tokens against the fp32 model's
    # (reported, not gated).
    if fp32 is not None:
        ftop = fp32[col].topk(2, dim=-1)
        fsure = (ftop.values[:, 0] - ftop.values[:, 1]) > env["margin"]
        fmax = ftop.indices[:, 0]
        fp32_held += int(fsure.sum())
        fp32_differ += int((fsure & (got.argmax(-1) != fmax)).sum())
        serve_fp32_differ += int((fsure & (argmax != fmax)).sum())
finite = all(bool(torch.isfinite(x.float()).all()) for x in forced)
# Against the fp32 model of the same weights, tokens and routing, where the
# serve phase made one (every phase's but serve's): this rank's logits and,
# beside them, the serve phase's own.
vs_fp32 = serve_vs_fp32 = None
if fp32 is not None:
    vs_fp32, serve_vs_fp32 = [], []
    for got, ref, want in zip(forced, wants, fp32, strict=True):
        for out, x in ((vs_fp32, got), (serve_vs_fp32, ref)):
            d = (x.float() - want).abs()
            out.append(dict(
                excess=float((d - env["bar"] * want.abs()).max())
                - env["bar"], abs_max=float(d.max()),
                abs_mean=float(d.mean())))
del forced, caches


class Timed:
    # generate's model, with CUDA events around the prefill and after
    # every (eager) decode step.
    def __init__(self):
        self.events = []

    def tensor_parallel(self, rules=None):
        return model.tensor_parallel(rules)

    def init_cache(self, *args, **kw):
        return model.init_cache(*args, **kw)

    def prefill(self, *args, **kw):
        self.events.append(event())
        out = model.prefill(*args, **kw)
        self.events.append(event())
        return out

    def decode_step(self, *args, **kw):
        out = model.decode_step(*args, **kw)
        self.events.append(event())
        return out


shapes = set()
real_flash = fa.flash_attention


def flash(q, k, v, **kw):
    shapes.add(tuple(q.shape))
    return real_flash(q, k, v, **kw)


fa.flash_attention = flash
moe_all_reduces.clear()
timed = Timed()
# The free run's routing: every call's own ids, compared with serve's.
with hold.compare() if moe else contextlib.nullcontext():
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    _mh.wire_counts(reset=True)
    t0 = time.perf_counter()
    tokens, info = generate(timed, params, prompt,
                            ServeConfig(max_new_tokens=new), ctx=ctx,
                            rules=rules, return_info=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: c for k, c in ops.launch_counts().items() if c}
    wire = _mh.wire_counts(reset=True)
fa.flash_attention = real_flash
free = routing() if moe else None
ev = timed.events
steps = len(ev) - 2
row = dict(
    rank=tp.index, ranks=tp.size, layout=layout,
    setup_s=setup_s, weights_gb=weights_gb, cache_gb=cache_gb,
    peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
    launches=counts, flash_shapes=sorted(shapes), info=info,
    tokens=tokens.cpu().tolist(), wall_s=wall,
    prefill_ms=ev[0].elapsed_time(ev[1]),
    decode_ms_per_step=ev[1].elapsed_time(ev[-1]) / steps,
    wire=wire, prefill_wire=prefill_wire, step_wire=step_wire,
    forced_abs_err=abs_err, forced_rel_err=rel_err,
    serve_vs_fp32=serve_vs_fp32,
    forced_excess=excess,
    margin_held=held_tokens, margin_differ=differ,
    fp32_tokens=dict(held=fp32_held, differ=fp32_differ,
                     serve_differ=serve_fp32_differ),
    served_tokens_are_argmax=served_argmax, finite=finite,
    vs_fp32=vs_fp32, held_routing=held, free_routing=free,
    moe_all_reduces=sorted(set(moe_all_reduces)),
    moe_layer_calls=len(moe_all_reduces))
del params
torch.cuda.empty_cache()

if env.get("ep"):
    # Expert parallelism: the smoke config with 16 experts and moe_ep in
    # fp32, 8 whole experts a rank, against the same config on one rank
    # (the whole weights, drawn from the same seed) on the card.
    base = configs.get_smoke_config(env["arch"])
    ecfg = base.replace(
        param_dtype="float32", compute_dtype="float32",
        flash_attention=True, moe_ep=True,
        moe=dataclasses.replace(base.moe, num_experts=env["ep"]["experts"]))
    emodel = get_model(ecfg)
    one = emodel.init_params(seed=0, device=device)
    mine = emodel.init_params(seed=0, device=device, rules=rules)
    eb, es, en = env["ep"]["batch"], env["ep"]["prompt"], env["ep"]["new"]
    eprompt = torch.randint(0, ecfg.vocab, (eb, es),
                            generator=torch.Generator().manual_seed(3)
                            ).to(device)

    def fed(params, **kw):
        caches = emodel.init_cache(eb, es + en, device, **kw)
        logits, _ = emodel.prefill(params, eprompt, caches, **kw)
        out = [logits]
        for i in range(en - 1):
            step, _ = emodel.decode_step(params, want_tokens[:, i:i + 1],
                                         caches, es + i, **kw)
            out.append(step)
        return torch.stack(out).float()

    # The one-rank run unrecorded: its decode is captured, and a capture
    # must not keep the ids it allocates alive.
    want_tokens = generate(emodel, one, eprompt,
                           ServeConfig(max_new_tokens=en))
    want = fed(one)
    hold = RoutingHold()
    with hold.compare():
        got_tokens = generate(emodel, mine, eprompt,
                              ServeConfig(max_new_tokens=en), rules=rules)
    ep_routing = routing()
    got = fed(mine, rules=rules)
    row["ep"] = dict(
        experts=ecfg.moe.num_experts,
        experts_per_rank=tuple(mine.layers[0].ffn.w_gate.shape)[0],
        abs_err=float((got - want).abs().max()),
        excess=float(((got - want).abs() - env["ep"]["tol"]
                      * want.abs()).max()) - env["ep"]["tol"],
        tokens_equal=bool(torch.equal(got_tokens, want_tokens)),
        routing=ep_routing)
print("SERVE_TP " + json.dumps(row), flush=True)
"""


def serve_tp_phase(device, serve_row: dict, name: str = "serve_tp",
                   arch: str = SERVE_ARCH, cut: dict | None = None) -> dict:
    """``serve_tp`` and each family's model-axis phase (:data:`FAMILY_TP`):
    :data:`SERVE_TP_WORKER` on :data:`SERVE_TP_RANKS` gloo ranks sharing
    the card (``multihost.launch_workers``), each serving the serve
    phase's model (``serve_row``: ``arch`` with its ``cut``, the cross
    gates at :data:`SERVE_CROSS_GATE`) over a (1, 2) ("data", "model")
    mesh from its weights seed, fed its prompt and context
    (``SERVE_TP_DIR`` / :data:`TP_YARDSTICKS`, written by it).  Gates:
    every rank's weights about half of the serve phase's, exactly one
    flash_attention launch a self-attention layer at h/t heads in
    ``generate`` (none for the SSD mixer, MLA, cross-attention or the
    whisper encoder), the decode eager (gloo) and saying so, the same
    in-vocabulary tokens on every rank; fed the serve phase's tokens (and,
    for an MoE model, held to its routing), every step's logits within
    :data:`SERVE_TP_BAR` of the serve phase's logits (serve_tp) or of the
    fp32 model of its weights, tokens and routing, or past that by no more
    than the serve phase's own (TP_FP32_GATE: every other phase), and the
    greedy token its token wherever its top-2 margin passes
    :data:`SERVE_TP_MARGIN`.  An MoE model also: the routing ids identical
    on every rank at every layer and step (a hash of each run's) and one
    all-reduce an MoE layer; serve_moe_tp also the expert-parallel smoke
    cohort (:data:`EP_EXPERTS` experts, ``moe_ep``) within :data:`EP_TOL`
    of its single-rank run with its tokens.  The prefill ms, eager decode
    ms a step, tokens/s and the collectives of the prefill and of a decode
    step beside the serve phase's.  A failed phase is emitted with ``ok``
    false and returned: ``main`` fails the run after its last phase."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.distributed import multihost as mh
    from repro_torch.models import get_model
    from repro_torch.models.attention import head_layout
    from repro_torch.models.layers import padded_vocab

    cfg = get_config(arch).replace(**(cut or {}))
    moe = cfg.moe is not None
    plan = get_model(cfg).layer_plan()
    yardstick = SERVE_TP_DIR / TP_YARDSTICKS[serve_row["phase"]]
    prompt_len = serve_row["prompt"]
    torch.cuda.empty_cache()
    env = dict(arch=arch, cut=cut or {}, ranks=SERVE_TP_RANKS,
               serve=str(yardstick), gate=SERVE_CROSS_GATE, new=SERVE_NEW,
               margin=SERVE_TP_MARGIN, bar=SERVE_TP_BAR,
               ep=dict(experts=EP_EXPERTS, batch=EP_BATCH, prompt=EP_PROMPT,
                       new=EP_NEW, tol=EP_TOL)
               if name == "serve_moe_tp" else None)
    t0 = time.perf_counter()
    outs = mh.launch_workers(SERVE_TP_WORKER, num_processes=SERVE_TP_RANKS,
                             backend="gloo", timeout=SERVE_TP_TIMEOUT,
                             extra_env={"SERVE_TP_ENV": json.dumps(env),
                                        "SERVE_TP_ROOT": str(ROOT)})
    wall = time.perf_counter() - t0
    rows = sorted((json.loads(ln[len("SERVE_TP "):]) for out in outs
                   for ln in out.splitlines()
                   if ln.startswith("SERVE_TP ")),
                  key=lambda r: r["rank"])
    # One flash launch a self-attention layer of the decoder, on the
    # rank's query heads.
    attention_layers = sum(m == "attn" for m, _ in plan)
    want = {"flash_attention": attention_layers} if attention_layers else {}
    shapes = ([[SERVE_BATCH, prompt_len,
                head_layout(cfg, SERVE_TP_RANKS, 0).heads, cfg.hd]]
              if attention_layers else [])
    pv = padded_vocab(cfg.vocab)
    same_tokens = len({json.dumps(r["tokens"]) for r in rows}) == 1
    in_vocab = all(0 <= t < pv for r in rows for ln in r["tokens"]
                   for t in ln)
    # Parameter bytes against parameter bytes (the serve phase's
    # allocator figure also holds its context and prompt).
    weight_share = [r["weights_gb"] / serve_row["param_gb"] for r in rows]
    saved = torch.load(yardstick)
    served = saved["tokens"].tolist()
    new = env["new"]
    steps = new - 1
    # The logits gate.  Without an fp32 model (serve's): every step within
    # the bar of the serve phase's logits.  With one: within the bar of
    # the fp32 model, or past it by no more than the serve phase's own
    # bf16 logits are; beside it the comparison with the serve phase's
    # logits (TP_FP32_GATE).
    fp32_bar = None if "fp32" not in saved else max(0.0,
                                                    saved["fp32_excess"])

    def logits_gate(r) -> str | None:
        """The clause that passes ``r``'s logits, or None."""
        if fp32_bar is None:
            return "bar" if max(r["forced_excess"]) <= 0 else None
        if max(x["excess"] for x in r["vs_fp32"]) <= fp32_bar:
            return "fp32 model"
        return None

    ok = (len(rows) == SERVE_TP_RANKS and same_tokens and in_vocab
          and all(r["launches"] == want
                  and r["flash_shapes"] == shapes
                  and r["info"]["decode"] == "eager"
                  and "gloo" in r["info"]["why"]
                  and logits_gate(r) is not None
                  and r["margin_differ"] == 0 and r["finite"]
                  and r["served_tokens_are_argmax"] for r in rows)
          and all(0.45 <= x <= 0.55 for x in weight_share))
    r0 = rows[0] if rows else {}
    wire = r0.get("wire", {})
    moe_fields = {}
    if moe:
        # One routing a call on both ranks, in the held run and the free
        # one (calls: a prefill and 31 steps, each MoE layer).
        calls = sum(ffn == "moe" for _, ffn in plan) * new
        routing_same = all(
            len({r[run]["hash"] for r in rows}) == 1
            and all(r[run]["calls"] == calls for r in rows)
            for run in ("held_routing", "free_routing"))
        one_reduce = all(r["moe_all_reduces"] == [1]
                         and r["moe_layer_calls"] == calls for r in rows)
        ok = ok and routing_same and one_reduce
        moe_fields = dict(
            experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
            expert_ff_per_rank=cfg.moe.d_ff_expert // SERVE_TP_RANKS,
            routing_identical_on_ranks=routing_same,
            routing_hash_held=[r["held_routing"]["hash"][:16] for r in rows],
            routing_hash_free=[r["free_routing"]["hash"][:16] for r in rows],
            routing_calls=calls,
            held_run_own_choice_flips=[r["held_routing"]["tokens_rerouted"]
                                       for r in rows],
            free_run_flips_vs_yardstick=[r["free_routing"]["tokens_rerouted"]
                                         for r in rows],
            token_decisions=r0["free_routing"]["token_decisions"],
            all_reduces_per_moe_layer=r0["moe_all_reduces"],
            one_all_reduce_per_moe_layer=one_reduce)
    if env["ep"] is not None:
        ep = [r["ep"] for r in rows]
        ep_ok = (len({e["routing"]["hash"] for e in ep}) == 1
                 and all(e["excess"] <= 0 and e["tokens_equal"]
                         and e["experts_per_rank"]
                         == EP_EXPERTS // SERVE_TP_RANKS for e in ep))
        ok = ok and ep_ok
        moe_fields["ep_cohort"] = dict(
            arch=f"{arch} smoke", dtype="float32", experts=EP_EXPERTS,
            batch=EP_BATCH, prompt=EP_PROMPT, new_tokens=EP_NEW, tol=EP_TOL,
            per_rank=ep, ok=ep_ok)

    def per_call(w: dict, calls: int) -> dict:
        """A wire snapshot over ``calls`` forwards, per forward."""
        return dict(
            all_reduce_calls=w.get("all_reduce_calls", 0) / calls,
            all_reduce_bytes=w.get("all_reduce_bytes", 0) / calls,
            all_gather_bytes=w.get("all_gather_bytes", 0) / calls,
            seconds=w.get("seconds", 0) / calls)

    row = dict(
        phase=name, arch=arch, family=cfg.family, cut=cut or None,
        ranks=len(rows), mesh={"data": 1, "model": SERVE_TP_RANKS},
        backend="gloo", layers=cfg.n_layers,
        layout_per_rank=[r["layout"] for r in rows],
        batch=SERVE_BATCH, prompt=prompt_len, new_tokens=new,
        ctx_tokens=serve_row.get("ctx_tokens"),
        weights_gb_per_rank=[r["weights_gb"] for r in rows],
        serve_weights_gb=serve_row["weights_gb"],
        weight_share_of_serve=weight_share,
        cache_gb_per_rank=[r["cache_gb"] for r in rows],
        peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in rows],
        setup_s_per_rank=[r["setup_s"] for r in rows], wall_s=wall,
        generate_wall_s_per_rank=[r["wall_s"] for r in rows],
        tokens_per_s_per_rank=[SERVE_BATCH * new / r["wall_s"]
                               for r in rows],
        prefill_ms_per_rank=[r["prefill_ms"] for r in rows],
        eager_decode_ms_per_step_per_rank=[r["decode_ms_per_step"]
                                           for r in rows],
        serve_prefill_ms=serve_row["prefill_ms"],
        serve_decode_ms_per_step=serve_row["decode_ms_per_step"],
        serve_eager_decode_ms_per_step=serve_row["eager_decode_ms_per_step"],
        decode=r0.get("info"),
        collectives_in_generate=wire,
        all_reduce_calls_per_forward=wire.get("all_reduce_calls", 0)
        / new,
        collective_bytes_per_forward=(wire.get("all_reduce_bytes", 0)
                                      + wire.get("all_gather_bytes", 0))
        / new,
        collective_s_per_rank=[r["wire"]["seconds"] for r in rows],
        collectives_per_prefill=per_call(r0.get("prefill_wire", {}), 1),
        collectives_per_decode_step=per_call(r0.get("step_wire", {}),
                                             steps),
        flash_shapes=r0.get("flash_shapes"),
        launches_per_rank=[r["launches"] for r in rows],
        expected_launches_per_rank=want,
        forced_logits_abs_err_max=[max(r["forced_abs_err"]) for r in rows],
        forced_logits_rel_err_max=[max(r["forced_rel_err"]) for r in rows],
        forced_allclose_excess_max=[max(r["forced_excess"]) for r in rows],
        forced_logits_abs_err_by_step=r0.get("forced_abs_err"),
        logits_gate="fp32 model" if fp32_bar is not None else name[:-3],
        logits_gate_clause_per_rank=[logits_gate(r) for r in rows],
        serve_vs_fp32_model_abs_max=None if fp32_bar is None
        else max(x["abs_max"] for x in r0["serve_vs_fp32"]),
        serve_vs_fp32_model_abs_mean=None if fp32_bar is None
        else sum(x["abs_mean"] for x in r0["serve_vs_fp32"])
        / len(r0["serve_vs_fp32"]),
        serve_vs_fp32_model_excess=None if fp32_bar is None
        else saved["fp32_excess"],
        forced_vs_fp32_model_excess_max=None if fp32_bar is None
        else [max(x["excess"] for x in r["vs_fp32"]) for r in rows],
        forced_vs_fp32_model_abs_max=None if fp32_bar is None
        else [max(x["abs_max"] for x in r["vs_fp32"]) for r in rows],
        forced_vs_fp32_model_abs_mean=None if fp32_bar is None
        else [sum(x["abs_mean"] for x in r["vs_fp32"]) / len(r["vs_fp32"])
              for r in rows],
        bar=SERVE_TP_BAR, margin=SERVE_TP_MARGIN,
        tokens_held_by_margin=[r["margin_held"] for r in rows],
        tokens_differing_where_held=[r["margin_differ"] for r in rows],
        tokens_against_the_fp32_model_not_gated=[r["fp32_tokens"]
                                                 for r in rows],
        free_tokens_equal_serve=bool(rows) and rows[0]["tokens"] == [
            ln[:new] for ln in served],
        same_tokens_on_ranks=same_tokens, decode_steps=steps, **moe_fields,
        note="2 ranks share one card and meet through gloo on the host, "
             "so the decode runs eagerly (a gloo collective cannot be "
             "captured): walls are correctness runs, not speed", ok=ok)
    emit(**row)
    row["launches"] = rows[0]["launches"] if rows else {}
    return row


# ---------------------------------------------------------------------------
# LM training
# ---------------------------------------------------------------------------
def _step_seconds(log: list[dict]) -> list[float]:
    """Each logged step's host seconds (the launcher logs every step here
    and each log reads the loss, which waits for the step)."""
    ts = [entry["seconds"] for entry in log]
    return [b - a for a, b in zip([0.0] + ts[:-1], ts)]


def train_phase(device) -> tuple[dict, object]:
    """``train``: ``launch/train.py``'s ``main`` for TinyLlama-1.1B at full
    width and depth (bf16, remat full, flash attention on in the config),
    8 x 2048 tokens, lr :data:`TRAIN_LR`, 12 steps, logged every step:
    every loss,
    the median step ms after two warm-up steps, tokens/s, peak memory, no
    kernel launch of the port (training takes the chunked attention, never
    the flash kernel); then one more step under the profiler (its busy
    share and top kernels).  Returns the row and the trained parameters."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import get_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticData
    from repro_torch.training.train_step import make_train_step

    cfg = get_config(TRAIN_ARCH).replace(flash_attention=True)
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
            str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--lr", str(TRAIN_LR),
            "--log-every", "1", "--device", str(device)]
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train.main(argv, cfg=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [entry["loss"] for entry in out["log"]]
    steps_ms = [x * 1e3 for x in _step_seconds(out["log"])]
    step_ms = statistics.median(steps_ms[TRAIN_WARMUP:])
    params, state = out["params"], out["opt_state"]

    # One more step, profiled: the launcher's step on the next batch.
    model = get_model(cfg)
    data = SyntheticData(cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH,
                                        "train"), device=device)
    ocfg = opt.AdamWConfig(lr=TRAIN_LR, warmup_steps=min(
        20, TRAIN_STEPS // 5), total_steps=TRAIN_STEPS)
    step = make_train_step(model, ocfg)
    batch = data.batch_at(TRAIN_STEPS)
    profiled = profile_run(lambda: step(params, state, batch))
    first5, last5 = losses[:5], losses[-5:]
    finite = all(math.isfinite(x) for x in losses)
    ok = (finite and len(losses) == TRAIN_STEPS
          and sum(last5) / 5 < sum(first5) / 5
          and not any(counts.values()))
    tokens = TRAIN_BATCH * TRAIN_SEQ
    row = dict(phase="train", arch=cfg.name, layers=cfg.n_layers,
               d_model=cfg.d_model, dtype=cfg.compute_dtype,
               param_dtype=cfg.param_dtype, remat=cfg.remat,
               batch=TRAIN_BATCH, seq=TRAIN_SEQ, steps=TRAIN_STEPS,
               lr=TRAIN_LR, wall_s=wall, losses=losses,
               grad_norms=[entry["grad_norm"] for entry in out["log"]],
               step_ms=steps_ms,
               median_step_ms=step_ms, tokens_per_s=tokens / step_ms * 1e3,
               peak_mem_gb=peak_gb, finite=finite,
               mean_first5=sum(first5) / 5, mean_last5=sum(last5) / 5,
               launches={k: c for k, c in counts.items() if c},
               expected_launches={}, ok=ok)
    emit(**row)
    emit(phase="train_profile", wall_ms=profiled["wall_ms_profiled"],
         device_busy_share=profiled["device_busy_ms"]
         / profiled["wall_ms_profiled"], **profiled)
    if not ok:
        raise SystemExit("phase train failed")
    row["launches"] = counts
    return row, params


def train_parity_phase(device) -> dict:
    """``train_parity``: the smoke TinyLlama in fp32; one ``make_train_step``
    step on the card against the same step of the plain path on the CPU
    from the same parameters and batch; then four microbatches against one
    on the card."""
    import copy

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import get_model
    from repro_torch.training import optimizer as opt
    from repro_torch.training.data import SyntheticData
    from repro_torch.training.train_step import make_train_step

    cfg = get_smoke_config(TRAIN_ARCH).replace(
        param_dtype="float32", compute_dtype="float32")
    model = get_model(cfg)
    cpu_params = model.init_params(seed=0, device="cpu")
    batch = SyntheticData(cfg, ShapeSpec("t", *PARITY_SHAPE, "train"),
                          device="cpu").batch_at(0)
    card_batch = {k: x.to(device) for k, x in batch.items()}

    def one_step(params, batch, microbatches=1, **ocfg):
        step = make_train_step(model, opt.AdamWConfig(
            warmup_steps=1, total_steps=10, **ocfg),
            microbatches=microbatches)
        params, _, mets = step(params, opt.init(params), batch)
        return params, mets

    card0 = copy.deepcopy(cpu_params).to(device)
    got, got_m = one_step(copy.deepcopy(card0), card_batch, lr=1e-4,
                          eps=1e-6)
    want, want_m = one_step(copy.deepcopy(cpu_params), batch, lr=1e-4,
                            eps=1e-6)
    loss_rel = abs(float(got_m["loss"]) - float(want_m["loss"])) / abs(
        float(want_m["loss"]))
    param_rel = max(
        float((a.detach().cpu() - b.detach()).abs().max()
              / b.detach().abs().max())
        for a, b in zip(got.parameters(), want.parameters()))
    one, one_m = one_step(copy.deepcopy(card0), card_batch, lr=1e-3)
    four, four_m = one_step(copy.deepcopy(card0), card_batch, 4, lr=1e-3)
    mb_diff = max(float((a - b).detach().abs().max())
                  for a, b in zip(one.parameters(), four.parameters()))
    mb_loss = abs(float(one_m["loss"]) - float(four_m["loss"]))
    ok = (loss_rel <= PARITY_TOL and param_rel <= PARITY_TOL
          and mb_diff < PARITY_MB_TOL and mb_loss < 1e-4)
    row = dict(phase="train_parity", arch=cfg.name, dtype="float32",
               seq=PARITY_SHAPE[0], batch=PARITY_SHAPE[1],
               loss_rel_diff_vs_cpu=loss_rel,
               param_rel_diff_vs_cpu=param_rel, bar=PARITY_TOL,
               microbatch4_max_param_diff=mb_diff,
               microbatch4_loss_diff=mb_loss, microbatch_bar=PARITY_MB_TOL,
               ok=ok)
    emit(**row)
    if not ok:
        raise SystemExit("phase train_parity failed")
    return row


def probe_phase(device, params) -> dict:
    """``probe``: the hidden states after layer :data:`PROBE_LAYER` of one
    training batch (8 x 2048 tokens of the trained TinyLlama, no
    gradients, bf16 -> fp32) through ``activation_probe(rank 8, 8
    clients, 40 rounds)``: its statistics, wall and exactly 240 / 80 / 1
    launches; then tests/test_probes.py's planted structure on the card
    under its bars."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.core import runtime as rt
    from repro_torch.kernels import ops
    from repro_torch.models import blocks
    from repro_torch.models.layers import embed
    from repro_torch.training.data import SyntheticData
    from repro_torch.training.probes import activation_probe

    cfg = get_config(TRAIN_ARCH)
    data = SyntheticData(cfg, ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH,
                                        "train"), device=device)
    tokens = data.batch_at(TRAIN_STEPS + 1)["tokens"]
    with torch.no_grad():
        positions = torch.arange(TRAIN_SEQ, device=device).expand(
            TRAIN_BATCH, TRAIN_SEQ)
        x = embed(params.embed, tokens, cfg)
        for layer in params.layers[:PROBE_LAYER + 1]:
            x, _, _ = blocks.layer_apply(layer, x, cfg=cfg, mode="train",
                                         positions=positions)
    hidden = x.to(torch.float32)
    del x

    def probe():
        return activation_probe(hidden, rank=PROBE_RANK,
                                num_clients=PROBE_CLIENTS,
                                outer_iters=PROBE_ROUNDS)

    probe()  # warm the libraries (cuBLAS, the solver's capture)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    rt.reset_graph_counts()
    t0 = time.perf_counter()
    stats = probe()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    graphs = graph_fields()
    per_round = PROBE_ROUNDS * 2  # DCFConfig.tuned: K = 2 local iterations
    want = {"huber_contract_v": per_round * 3,
            "huber_contract_u_diag": per_round, "residual_shrink": 1}
    values = {k: (v.tolist() if k == "top_outlier_channels" else float(v))
              for k, v in stats.items()}
    finite = all(math.isfinite(v) for k, v in values.items()
                 if k != "top_outlier_channels")

    # tests/test_probes.py's planted structure (a rank-3 (4, 64, 32) stack
    # plus 50 at 1% of the entries), drawn by a CPU generator from seed 0
    # (the same input on any machine), probed on the card.
    gen = torch.Generator().manual_seed(0)
    h = torch.randn(4, 64, 32, generator=gen)
    u = torch.randn(32, 3, generator=gen)
    outliers = torch.where(torch.rand(h.shape, generator=gen) < 0.01, 50.0,
                           0.0)
    planted = activation_probe((h @ u @ u.T + outliers).to(device), rank=4,
                               num_clients=4, outer_iters=30)
    planted = {k: (v.tolist() if k == "top_outlier_channels" else float(v))
               for k, v in planted.items()}
    planted_ok = (planted["energy_low_rank"] > 0.7
                  and abs(planted["outlier_fraction"] - 0.01) < 0.01
                  and planted["residual"] < 0.1
                  and len(planted["top_outlier_channels"]) == 8)
    ok = (finite and counts == {k: want.get(k, 0) for k in counts}
          and planted_ok and len(values["top_outlier_channels"]) == 8)
    row = dict(phase="probe", arch=cfg.name, layer=PROBE_LAYER,
               matrix=[cfg.d_model, TRAIN_BATCH * TRAIN_SEQ],
               rank=PROBE_RANK, clients=PROBE_CLIENTS, rounds=PROBE_ROUNDS,
               wall_s=wall, peak_mem_gb=torch.cuda.max_memory_allocated()
               / 1e9, stats=values, **graphs,
               launches={k: c for k, c in counts.items() if c},
               expected_launches=want, planted=planted,
               planted_ok=planted_ok, ok=ok)
    emit(**row)
    if not ok:
        raise SystemExit("phase probe failed")
    row["launches"] = counts
    return row


RESUME_CHILD = r"""
import hashlib, json, os, sys
os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
import torch
torch.use_deterministic_algorithms(True)
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.training import checkpoint

argv, layers, stop = json.loads(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
if stop == "stop":  # end the process right after its first checkpoint
    save = checkpoint.save

    def save_then_exit(*args, **kw):
        save(*args, **kw)
        sys.stdout.flush()
        os._exit(17)

    checkpoint.save = save_then_exit
out = train.main(argv, cfg=get_config(sys.argv[4]).replace(n_layers=layers))
h = hashlib.sha256()
state = out["opt_state"]
tensors = [p for _, p in out["params"].named_parameters()]
tensors += [state.step] + [state.m[k] for k in sorted(state.m)]
tensors += [state.v[k] for k in sorted(state.v)]
for t in tensors:
    h.update(t.detach().cpu().reshape(-1).view(torch.uint8).numpy()
             .tobytes())
print("RESUME " + json.dumps({"sha": h.hexdigest(),
                              "final_loss": out["final_loss"]}), flush=True)
"""


def _resume_child(argv: list[str], stop: bool) -> subprocess.Popen:
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-c", RESUME_CHILD, json.dumps(argv),
         str(RESUME_LAYERS), "stop" if stop else "run", TRAIN_ARCH],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(proc: subprocess.Popen) -> tuple[int, str]:
    try:
        out, _ = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
    return proc.returncode, out


def train_resume_phase(device) -> dict:
    """``train_resume``: the launcher in child processes under
    ``torch.use_deterministic_algorithms(True)`` (``CUBLAS_WORKSPACE_CONFIG``
    set before CUDA starts), TinyLlama's widths at
    :data:`RESUME_LAYERS` layers: one run ends itself right after its first
    checkpoint and is relaunched to finish from it; another runs
    uninterrupted.  The final parameters and optimizer state must have the
    same SHA-256."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="train_resume_")
    seq, batch = RESUME_SHAPE
    base = ["--arch", TRAIN_ARCH, "--steps", str(RESUME_STEPS), "--batch",
            str(batch), "--seq", str(seq), "--lr", str(TRAIN_LR),
            "--ckpt-every", str(RESUME_EVERY), "--log-every", "1",
            "--device", str(device)]
    t0 = time.perf_counter()
    try:
        # The stopped run and the uninterrupted one side by side on the
        # card (deterministic algorithms: neither's bits depend on the
        # other), then the relaunch of the stopped one.
        stopped = _resume_child(base + ["--ckpt-dir", f"{root}/a"], True)
        whole = _resume_child(base + ["--ckpt-dir", f"{root}/b"], False)
        rc_stop, out_stop = _finish(stopped)
        rc_a, out_a = _finish(_resume_child(
            base + ["--ckpt-dir", f"{root}/a"], False))
        rc_b, out_b = _finish(whole)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def result(out):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESUME ")]
        return json.loads(lines[-1][len("RESUME "):]) if lines else None

    a, b = result(out_a), result(out_b)
    resumed_at = f"resumed from step {RESUME_EVERY}" in out_a
    ok = (rc_stop == 17 and rc_a == 0 and rc_b == 0
          and a is not None and b is not None and resumed_at
          and a["sha"] == b["sha"])
    row = dict(phase="train_resume", arch=TRAIN_ARCH, layers=RESUME_LAYERS,
               seq=seq, batch=batch, steps=RESUME_STEPS,
               checkpoint_every=RESUME_EVERY, deterministic=True,
               stopped_rc=rc_stop, resumed_rc=rc_a,
               uninterrupted_rc=rc_b, resumed_from_checkpoint=resumed_at,
               sha_resumed=a and a["sha"], sha_uninterrupted=b and b["sha"],
               bits_equal=bool(a and b and a["sha"] == b["sha"]),
               wall_s=time.perf_counter() - t0, ok=ok)
    emit(**row)
    if not ok:
        for name, out in (("stopped", out_stop), ("resumed", out_a),
                          ("uninterrupted", out_b)):
            print(f"--- train_resume {name} child ---\n{out[-4000:]}",
                  file=sys.stderr)
        raise SystemExit("phase train_resume failed")
    return row


ROBUST_WORKER = r"""
import hashlib, json, os, time
import torch
import torch.distributed as dist
from repro_torch.configs import get_config
from repro_torch.distributed import grad_compress as gcomp
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import get_model

torch.backends.cuda.matmul.allow_tf32 = False
_mh.SYNC_TIMING = True  # collective seconds without the step's queue
env = json.loads(os.environ["ROBUST_ENV"])
device = torch.device(env["device"])
rank = dist.get_rank()
cfg = get_config(env["arch"]).replace(n_layers=env["layers"])
card = device.type == "cuda"
if card:
    torch.cuda.reset_peak_memory_stats()
# Each aggregated leaf's launches by its shape (host-side counters, so
# each call's share is exact).
by_shape = {}
real_leaf = gcomp.aggregate_leaf


def counted_leaf(g, *args, **kwargs):
    before = ops.launch_counts()
    agg = real_leaf(g, *args, **kwargs)
    c = by_shape.setdefault("x".join(map(str, g.shape)),
                            {"calls": 0, "launches": {}})
    c["calls"] += 1
    for k, v in ops.launch_counts().items():
        if v != before[k]:
            c["launches"][k] = c["launches"].get(k, 0) + v - before[k]
    return agg


gcomp.aggregate_leaf = counted_leaf
ops.reset_launch_counts()
_mh.wire_counts(reset=True)
dist.barrier()
try:
    # No weight decay: a parameter moves only by its aggregated gradient.
    out = train.main(env["argv"], cfg=cfg, weight_decay=0.0)
finally:
    gcomp.aggregate_leaf = real_leaf
if card:
    torch.cuda.synchronize()
counts = {k: c for k, c in ops.launch_counts().items() if c}
wire = _mh.wire_counts()
ccfg = gcomp.CompressConfig()
leaves = sum(1 for p in out["params"].parameters()
             if p.ndim >= 2 and min(p.shape[-2:]) >= ccfg.min_dim
             and ccfg.rank < min(p.shape[-2:]))
h = hashlib.sha256()
for p in out["params"].parameters():
    h.update(p.detach().cpu().reshape(-1).view(torch.uint8).numpy()
             .tobytes())
with torch.no_grad():
    moved = max(float((p.to(torch.float32) - q.to(torch.float32)).abs().max())
                for p, q in zip(out["params"].parameters(),
                                get_model(cfg).init_params(
                                    0, device).parameters()))
steps = env["steps"]
ts = [e["seconds"] for e in out["log"]]
step_ms = [1e3 * (b - a) for a, b in zip([0.0] + ts[:-1], ts)]
row = dict(rank=rank, backend=str(dist.get_backend()),
           losses=[e["loss"] for e in out["log"]], step_ms=step_ms,
           launches=counts, by_shape=by_shape, leaves_2d=leaves,
           sha=h.hexdigest(),
           params_moved=moved,
           peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9 if card
           else None,
           collective_ms_per_step=wire["seconds"] * 1e3 / steps,
           collective_bytes_per_step=(wire["all_reduce_bytes"]
                                      + wire["all_gather_bytes"]) / steps,
           wire={k: v for k, v in wire.items() if v})
del out

# tests/test_multidevice.py:138-179's Byzantine case on CUDA tensors.
byz = env["byz"]
gen = torch.Generator().manual_seed(0)
m, k, r, e = byz["m"], byz["k"], byz["r"], dist.get_world_size()
u0 = torch.randn(m, r, generator=gen)
vs = torch.randn(e, k, r, generator=gen)
grads = torch.einsum("mr,ekr->emk", u0, vs)
grads += 0.01 * torch.randn(grads.shape, generator=gen)
clean = grads.mean(0)
grads[0] += (torch.rand(m, k, generator=gen) < byz["frac"]) * byz["spike"]
comm = _mh.MeshComm(_mh.multihost_mesh(("data",), device=device), ("data",))
ops.reset_launch_counts()
robust = gcomp.consensus_compress(
    grads[comm.client].to(device), comm,
    gcomp.CompressConfig(rank=byz["rank"], rounds=byz["rounds"]),
    torch.Generator(device=device).manual_seed(7)).cpu()
row["byz_launches"] = {k: c for k, c in ops.launch_counts().items() if c}
row["byz_err_robust"] = float((robust - clean).norm() / clean.norm())
row["byz_err_plain"] = float((grads.mean(0) - clean).norm() / clean.norm())
row["byz_sha"] = hashlib.sha256(robust.numpy().tobytes()).hexdigest()
print("ROBUST " + json.dumps(row), flush=True)
"""


def train_robust_phase(device) -> list[dict]:
    """``train_robust``: ``launch/train.py --robust-agg`` under
    ``multihost.launch_workers``: :data:`ROBUST_RANKS` gloo ranks sharing
    the card (CUDA tensors), TinyLlama's widths at
    :data:`ROBUST_LAYERS` layers, 8 x 512 tokens, 3 steps,
    ``CompressConfig()``, weight decay 0: each rank's step ms, ms and
    bytes in collectives a step (``multihost.wire_counts``), peak memory
    and launches (exactly 8 / 4 huber_contract_v / huber_contract_u_diag a
    2-D leaf a step, counted by leaf shape: one row a shape of
    :data:`ROBUST_LEAF_ROWS`, and the shapes' sum is the phase's count),
    every loss finite, the parameters moved, one parameter hash over the
    ranks; the Byzantine aggregation's errors (err_robust < 0.2 and < 0.2
    x err_plain)."""
    import torch

    from repro_torch.distributed import multihost as mh
    from repro_torch.distributed.grad_compress import CompressConfig

    torch.cuda.empty_cache()
    seq, batch = ROBUST_SHAPE
    argv = ["--arch", TRAIN_ARCH, "--steps", str(ROBUST_STEPS), "--batch",
            str(batch), "--seq", str(seq), "--lr", str(TRAIN_LR),
            "--robust-agg", "--log-every", "1", "--device", str(device)]
    env = dict(arch=TRAIN_ARCH, layers=ROBUST_LAYERS, argv=argv,
               steps=ROBUST_STEPS, byz=BYZ, device=str(device))
    t0 = time.perf_counter()
    outs = mh.launch_workers(ROBUST_WORKER, num_processes=ROBUST_RANKS,
                             backend="gloo", timeout=ROBUST_TIMEOUT,
                             extra_env={"ROBUST_ENV": json.dumps(env)})
    wall = time.perf_counter() - t0
    rows = []
    for out in outs:
        for ln in out.splitlines():
            if ln.startswith("ROBUST "):
                rows.append(json.loads(ln[len("ROBUST "):]))
    rows.sort(key=lambda r: r["rank"])
    leaves = rows[0]["leaves_2d"] if rows else 0
    cc = CompressConfig()
    per_leaf = cc.rounds * cc.local_iters
    want = {"huber_contract_v": per_leaf * cc.inner_sweeps * leaves
            * ROBUST_STEPS,
            "huber_contract_u_diag": per_leaf * leaves * ROBUST_STEPS}
    byz_want = {"huber_contract_v": BYZ["rounds"] * cc.local_iters
                * cc.inner_sweeps,
                "huber_contract_u_diag": BYZ["rounds"] * cc.local_iters}
    finite = all(math.isfinite(x) for r in rows for x in r["losses"])
    same_sha = len({r["sha"] for r in rows}) == 1
    same_losses = len({tuple(r["losses"]) for r in rows}) == 1
    launches_ok = all(r["launches"] == want for r in rows)

    def shape_want(shape, calls):
        big = (len(shape) >= 2 and min(shape[-2:]) >= cc.min_dim
               and cc.rank < min(shape[-2:]))
        return {"huber_contract_v": per_leaf * cc.inner_sweeps * calls,
                "huber_contract_u_diag": per_leaf * calls} if big else {}

    by_shape_ok = all(
        c["launches"] == shape_want(tuple(map(int, key.split("x"))),
                                    c["calls"])
        for r in rows for key, c in r["by_shape"].items())
    summed_ok = all(
        {k: sum(c["launches"].get(k, 0) for c in r["by_shape"].values())
         for k in want} == want for r in rows)
    shape_rows = []
    for tag, (shape, n_leaves) in ROBUST_LEAF_ROWS.items():
        key = "x".join(map(str, shape))
        per_rank = [r["by_shape"].get(key, {"calls": 0, "launches": {}})
                    for r in rows]
        calls = per_rank[0]["calls"] if rows else 0
        swant = shape_want(shape, n_leaves * ROBUST_STEPS)
        srow = dict(phase=f"train_robust@{tag}", shape=list(shape),
                    leaves=n_leaves, calls_per_rank=calls,
                    launches=per_rank[0]["launches"] if rows else {},
                    expected_launches=swant)
        srow["ok"] = bool(rows) and all(
            c["calls"] == n_leaves * ROBUST_STEPS and c["launches"] == swant
            for c in per_rank)
        emit(**srow)
        shape_rows.append(srow)
    err_r = rows[0]["byz_err_robust"] if rows else float("inf")
    err_p = rows[0]["byz_err_plain"] if rows else 0.0
    byz_ok = (err_r < 0.2 and err_r < 0.2 * err_p
              and len({r["byz_sha"] for r in rows}) == 1
              and all(r["byz_launches"] == byz_want for r in rows))
    moved = all(r["params_moved"] > 0 for r in rows)
    ok = (len(rows) == ROBUST_RANKS and leaves == 30 and finite and same_sha
          and same_losses and launches_ok and byz_ok and moved
          and by_shape_ok and summed_ok
          and all(srow["ok"] for srow in shape_rows))
    row = dict(phase="train_robust", arch=TRAIN_ARCH, layers=ROBUST_LAYERS,
               ranks=len(rows), backend=rows[0]["backend"] if rows else None,
               seq=seq, batch=batch, steps=ROBUST_STEPS, wall_s=wall,
               leaves_2d=leaves, losses=rows[0]["losses"] if rows else None,
               step_ms_per_rank=[r["step_ms"] for r in rows],
               median_step_ms=statistics.median(
                   [x for r in rows for x in r["step_ms"][1:]])
               if rows else None,
               collective_ms_per_step=[r["collective_ms_per_step"]
                                       for r in rows],
               collective_bytes_per_step=rows[0]["collective_bytes_per_step"]
               if rows else None,
               wire_per_rank=rows[0]["wire"] if rows else None,
               peak_mem_gb_per_rank=[r["peak_mem_gb"] for r in rows],
               launches_per_rank=[r["launches"] for r in rows],
               expected_launches_per_rank=want,
               launches_by_shape=rows[0]["by_shape"] if rows else None,
               by_shape_ok=by_shape_ok, shapes_sum_to_phase=summed_ok,
               weight_decay=0.0, finite=finite,
               params_moved=moved, same_param_sha256=same_sha, same_losses=same_losses,
               byz_err_robust=err_r, byz_err_plain=err_p,
               byz_launches=rows[0]["byz_launches"] if rows else None,
               byz_ok=byz_ok,
               note="ranks share one card: walls are correctness runs, "
                    "not speed", ok=ok)
    emit(**row)
    if not ok:
        raise SystemExit("phase train_robust failed")
    row["launches"] = rows[0]["launches"]
    for srow in shape_rows:
        srow["launches"] = {k: srow["launches"].get(k, 0) for k in want}
    return [row] + shape_rows


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

    cluster_plans(device)
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
    phases += sharded_phases(device, dcf_error,
                             next(ph for ph in phases if ph["phase"] == "cf"))
    dcf_busy = next(ph["device_busy_ms"] for ph in phases
                    if ph["phase"] == "dcf")
    phases += batch_phase(device)
    phases += batch_fig1_phase(device, dcf_busy)
    phases.append(batch_convex_phase(device))
    phases += wire_phase(device)
    phases += graphs_phase(device)
    phases.append(sanitize_phase(device))
    phases.append(compile_cache_phase(device))
    phases.append(service_phase(device))
    phases.append(service_fig1_phase(device))
    phases += gateway_phase(device)
    phases += table1_phase(device)
    phases.append(wide_phase(device))
    phases.append(convex_phase(device))
    phases.append(quickstart_phase(device))
    phases.append(small_lm_phase(device))
    phases.append(serve_phase(device, "serve_f32", F32_ARCH, F32_NEW,
                              fp32=True))
    torch.cuda.empty_cache()
    phases.append(serve_phase(device))
    torch.cuda.empty_cache()
    phases.append(serve_tp_phase(device, phases[-1]))
    for name, arch, cut, prompt_len in FAMILY_SERVES:
        phases.append(serve_phase(device, name, arch, cut=cut,
                                  prompt_len=prompt_len))
        torch.cuda.empty_cache()
        phases.append(serve_tp_phase(device, phases[-1], FAMILY_TP[name],
                                     arch, cut))
    failed = [p["phase"] for p in phases
              if p["phase"].endswith("_tp") and not p["ok"]]
    if failed:
        emit(phase="model_axis_failed", failed=failed)
    phases.append(train_parity_phase(device))
    row, trained = train_phase(device)
    phases.append(row)
    phases.append(probe_phase(device, trained))
    del trained, row
    torch.cuda.empty_cache()
    phases.append(train_resume_phase(device))
    phases += train_robust_phase(device)
    if failed:
        raise SystemExit(f"phases failed: {', '.join(failed)}")
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
