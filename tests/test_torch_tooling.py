"""The port's tooling against the JAX reference, on the CPU: the sanitizer
(``repro_torch.debug`` beside ``repro.debug``), the bound model
(``repro_torch.roofline``), the parameter and model-FLOP counts, the dry
run on the meta device, and the kernel-family map that the card's exact
launch check reads from a captured graph's nodes.

Tolerances: the counts are integers and equal exactly; the model FLOP
within 1e-12 relative (a float sum over the same parameters in another
order); the bounds of PERF.md's kernel table to the digits printed there.
The reference's model FLOP come from one subprocess for the module:
importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices
(its lines 11-15), which would change every later test of the worker.
"""
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro import debug as jdebug
from repro.configs import get_config as jget_config
from repro.models import get_model as jget_model
from repro.models import params as jparams
from repro_torch import debug, rpca
from repro_torch import roofline as rl
from repro_torch.configs import ARCH_IDS, SHAPES, get_config, get_smoke_config
from repro_torch.core import runtime as rt
from repro_torch.core import problems as prob
from repro_torch.core.factorized import DCFConfig
from repro_torch.kernels import ops
from repro_torch.launch import dryrun
from repro_torch.models import get_model
from repro_torch.models.params import count_params, named_specs, shape_tree

cf = importlib.import_module("repro_torch.core.cf_pca")
ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


# ---------------------------------------------------------------------------
# The sanitizer (tests/test_sanitize.py:16-70, on the port's terms)
# ---------------------------------------------------------------------------
@pytest.fixture
def no_sanitizer():
    """Each test starts and ends with the sanitizer off."""
    debug.disable()
    yield
    debug.disable()


@pytest.mark.parametrize("raw", ["", "0", "1", "true", "on", "yes",
                                 "strict", " STRICT ", "off"])
def test_sanitize_mode_agrees_with_the_reference(monkeypatch, raw):
    monkeypatch.setenv("RPCA_SANITIZE", raw)
    assert debug.sanitize_mode() == jdebug.sanitize_mode()


def test_sanitize_mode_unset_is_none(monkeypatch):
    monkeypatch.delenv("RPCA_SANITIZE", raising=False)
    assert debug.sanitize_mode() is None is jdebug.sanitize_mode()


def test_enable_disable_roundtrip(no_sanitizer):
    """On a CPU-only PyTorch there is no device to guard: the saved state
    says so, and disable leaves the sanitizer off."""
    saved = debug.enable("log")
    assert debug.active()
    assert saved == {"mode": "log", "sync_debug_mode": None}
    debug.disable()
    assert not debug.active()
    debug.disable()  # no-op when inactive
    assert not debug.active()


def test_enable_is_idempotent(no_sanitizer):
    first = debug.enable("strict")
    second = debug.enable("log")
    assert first is second and first["mode"] == "strict"


def test_enable_rejects_an_unknown_mode(no_sanitizer):
    with pytest.raises(ValueError, match="mode"):
        debug.enable("loud")
    assert not debug.active()


def test_enable_from_env(monkeypatch, no_sanitizer):
    monkeypatch.delenv("RPCA_SANITIZE", raising=False)
    assert debug.enable_from_env() is False
    assert not debug.active()
    monkeypatch.setenv("RPCA_SANITIZE", "1")
    assert debug.enable_from_env() is True
    assert debug.active()


def _cf_rounds(graph=False, rounds=5):
    p = prob.generate_problem(0, 48, 40, 4, 0.05, device=CPU)
    cfg = DCFConfig.tuned(4)
    problem = cf.make_problem(p.m_obs, cfg, 0, device=CPU)
    solver = cf.make_solver(cfg)
    state = rt.single_state(solver, problem, rounds)
    return rt.Rounds(rt.single_body(solver, problem), state, CPU, graph)


def test_eager_solve_is_nan_free_under_the_sanitizer(no_sanitizer):
    p = prob.generate_problem(0, 48, 40, 4, 0.05, device=CPU)
    plain = rpca.solve(p.m_obs, method="cf", cfg=DCFConfig.tuned(4),
                       device="cpu")
    debug.enable("strict")
    got = rpca.solve(p.m_obs, method="cf", cfg=DCFConfig.tuned(4),
                     device="cpu")
    assert torch.equal(got.l, plain.l) and torch.equal(got.s, plain.s)
    assert torch.isfinite(got.l).all()


def test_a_nan_in_the_carry_raises_naming_the_round(no_sanitizer):
    rounds = _cf_rounds()
    rounds.advance(2)
    carry = rounds.state["carry"]
    carry.u[3, 1] = float("nan")
    debug.enable("log")
    with pytest.raises(FloatingPointError, match="after round 3"):
        rounds.advance(2)


def test_a_nan_is_let_through_without_the_sanitizer(no_sanitizer):
    rounds = _cf_rounds()
    rounds.state["carry"].u[0, 0] = float("nan")
    rounds.advance(2)
    assert torch.isnan(rounds.state["carry"].u).any()


class _EagerCapture:
    """``CapturedRound`` with each replay an eager call of the round."""

    def __init__(self, fn, device):
        fn()
        self.fn = fn

    def replay(self):
        self.fn()


def test_the_captured_path_checks_once_after_its_replays(monkeypatch,
                                                         no_sanitizer):
    monkeypatch.setattr(rt, "CapturedRound", _EagerCapture)
    rounds = _cf_rounds(graph=True)
    rounds.state["carry"].u[0, 0] = float("nan")
    debug.enable("log")
    with pytest.raises(FloatingPointError, match=r"rounds 1-4 \(replayed\)"):
        rounds.advance(4)


# ---------------------------------------------------------------------------
# The bound model: every "Bound ms" of PERF.md's kernel table
# ---------------------------------------------------------------------------
# Case -> (M bytes an entry, E, m, n_i, r), chip_smoke.py's operands.
CASES = {
    "F": (4, 10, 3000, 300, 150), "C": (4, 1, 3000, 3000, 150),
    "D": (4, 4, 2048, 512, 64), "D16": (2, 4, 2048, 512, 64),
    "T5": (4, 10, 5000, 500, 500), "T6": (4, 10, 4000, 400, 600),
    "SH": (4, 1, 3000, 300, 150), "SR": (4, 1, 1500, 1500, 150),
    "PR": (4, 8, 2048, 2048, 8), "GR": (4, 1, 2048, 5632, 8),
    "GE": (4, 1, 32000, 2048, 8), "Bn": (4, 128, 500, 63, 8),
    "B4": (4, 40, 3000, 300, 150), "SV": (4, 16, 500, 500, 8),
    "S1": (4, 1, 500, 500, 8), "F4": (4, 4, 3000, 3000, 150),
    "F1": (4, 1, 3000, 3000, 150), "G32": (4, 4, 512, 32, 8),
    "G256": (4, 4, 512, 256, 8), "G32_1": (4, 1, 512, 32, 8),
    "G256_1": (4, 1, 512, 256, 8),
}
V, U, UD, DU = ("huber_contract_v", "huber_contract_u",
                "huber_contract_u_diag", "huber_dual_contract")
SH, PSI = "residual_shrink", "residual_shrink_psi"
# (function, mask mode, case, bound as PERF.md prints it, bound by).
KERNEL_BOUNDS = [
    (V, "none", "F", "0.0806", "operations"),
    (V, "none", "C", "0.0806", "operations"),
    (V, "none", "T5", "0.7463", "operations"),
    (V, "none", "T6", "0.5731", "operations"),
    (V, "none", "B4", "0.3224", "operations"),
    (V, "none", "SH", "0.0081", "operations"),
    (V, "none", "SR", "0.0201", "operations"),
    (V, "none", "PR", "0.0405", "bytes"),
    (V, "none", "GR", "0.0139", "bytes"),
    (V, "none", "GE", "0.0786", "bytes"),
    (V, "dense", "F", "0.0806", "operations"),
    (V, "dense", "D", "0.0160", "operations"),
    (V, "dense", "SV", "0.0098", "bytes"),
    (V, "dense", "F4", "0.3224", "operations"),
    (V, "dense", "G32", "0.0002", "bytes"),
    (V, "dense", "G256", "0.0013", "bytes"),
    (V, "dense", "Bn", "0.0104", "bytes"),
    (U, "none", "F", "0.0806", "operations"),
    (U, "dense", "D", "0.0160", "operations"),
    (DU, "none", "D", "0.0240", "operations"),
    (DU, "dense", "D", "0.0240", "operations"),
    (DU, "packed", "D16", "0.0240", "operations"),
    (UD, "none", "F", "0.0806", "operations"),
    (UD, "none", "C", "0.0806", "operations"),
    (UD, "none", "T5", "0.7463", "operations"),
    (UD, "none", "T6", "0.5731", "operations"),
    (UD, "none", "B4", "0.3224", "operations"),
    (UD, "none", "SH", "0.0081", "operations"),
    (UD, "none", "SR", "0.0201", "operations"),
    (UD, "none", "PR", "0.0405", "bytes"),
    (UD, "none", "GR", "0.0139", "bytes"),
    (UD, "none", "GE", "0.0789", "bytes"),
    (UD, "dense", "F", "0.0806", "operations"),
    (UD, "packed", "D", "0.0160", "operations"),
    (UD, "dense", "Bn", "0.0109", "bytes"),
    (UD, "dense", "SV", "0.0098", "bytes"),
    (UD, "dense", "F4", "0.3224", "operations"),
    (UD, "dense", "G32", "0.0002", "bytes"),
    (UD, "dense", "G256", "0.0013", "bytes"),
    (V, "packed", "D16", "0.0160", "operations"),
    (U, "packed", "D", "0.0160", "operations"),
    (SH, "none", "F", "0.0403", "operations"),
    (SH, "none", "C", "0.0403", "operations"),
    (SH, "none", "T5", "0.3731", "operations"),
    (SH, "none", "T6", "0.2866", "operations"),
    (SH, "dense", "T6", "0.2866", "operations"),
    (SH, "none", "SH", "0.0040", "operations"),
    (SH, "none", "SR", "0.0101", "operations"),
    (SH, "none", "PR", "0.0804", "bytes"),
    (SH, "dense", "F", "0.0403", "operations"),
    (SH, "dense", "D", "0.0158", "bytes"),
    (SH, "dense", "Bn", "0.0151", "bytes"),
    (SH, "dense", "S1", "0.0009", "bytes"),
    (SH, "dense", "F1", "0.0403", "operations"),
    (SH, "dense", "G32_1", "0.00006", "bytes"),
    (SH, "dense", "G256_1", "0.0005", "bytes"),
    (SH, "packed", "D16", "0.0085", "bytes"),
    (PSI, "none", "F", "0.0403", "operations"),
    (PSI, "none", "T5", "0.3731", "operations"),
    (PSI, "none", "D16", "0.0133", "bytes"),
    (PSI, "dense", "D", "0.0208", "bytes"),
]
# Flash rows: (row, (B, S_q, S_kv, H, d), causal, dtype, bound as printed,
# bound by, the 3xTF32 bound as printed or None).
FLASH_BOUNDS = [
    ("A", (4, 2048, 2048, 32, 128), True, "bf16", "0.1390", "operations",
     None),
    ("s", (2, 33, 33, 4, 32), True, "f32", "0.00004", "bytes", None),
    ("a", (1, 256, 256, 4, 64), True, "f32", "0.0005", "operations",
     "0.0003"),
    ("x", (2, 64, 200, 2, 64), False, "f32", "0.0002", "operations",
     "0.0002"),
    ("T", (4, 2048, 2048, 32, 64), True, "f32", "1.0262", "operations",
     "0.4169"),
    ("M", (4, 2048, 2048, 16, 128), True, "bf16", "0.0695", "operations",
     None),
    ("J", (4, 2048, 2048, 64, 128), True, "bf16", "0.2781", "operations",
     None),
    ("W", (4, 416, 416, 12, 64), True, "bf16", "0.0031", "bytes", None),
]


def _printed(value: float, like: str) -> str:
    return f"{value:.{len(like.split('.')[1])}f}"


@pytest.mark.parametrize("fn, mode, case, printed, by", KERNEL_BOUNDS,
                         ids=[f"{f}-{m}-{c}" for f, m, c, _, _ in
                              KERNEL_BOUNDS])
def test_kernel_bound_reproduces_the_table(fn, mode, case, printed, by):
    ms, got_by = rl.bound(fn, mode, *CASES[case])
    assert (_printed(ms, printed), got_by) == (printed, by)


@pytest.mark.parametrize("row, shape, causal, dtype, printed, by, tc",
                         FLASH_BOUNDS, ids=[r[0] for r in FLASH_BOUNDS])
def test_flash_bound_reproduces_the_table(row, shape, causal, dtype, printed,
                                          by, tc):
    ms, got_by = rl.flash_bound(*shape, causal, dtype)
    assert (_printed(ms, printed), got_by) == (printed, by)
    if tc is not None:
        three = rl.flash_bound(*shape, causal, dtype, rl.PEAK_TF32_FLOPS, 3)
        assert _printed(three[0], tc) == tc


def test_roofline_terms_and_bottleneck():
    """tests/test_roofline.py:75-87's record at the H100's peaks: 10 ms of
    compute, 2 ms of memory and 4 ms of collectives at a caller's link
    rate; 80% of the compiled FLOP are the model's."""
    link = 25e9  # the caller's rate; the module assumes none
    r = rl.Roofline(
        arch="x", shape="y", mesh="1", n_devices=256,
        flops_per_device=rl.PEAK_BF16_FLOPS * 0.010,
        bytes_per_device=rl.PEAK_BYTES * 0.002,
        coll_bytes_per_device=link * 0.004, coll_breakdown={},
        model_flops_global=rl.PEAK_BF16_FLOPS * 256 * 0.008,
        peak_memory_per_device=1e9, link_bytes_per_s=link)
    assert abs(r.t_compute - 0.010) < 1e-12
    assert abs(r.t_memory - 0.002) < 1e-12
    assert abs(r.t_collective - 0.004) < 1e-12
    assert r.bottleneck == "compute"
    assert abs(r.useful_flops_ratio - 0.8) < 1e-9
    assert abs(r.roofline_fraction - 0.8) < 1e-9
    d = r.to_dict()
    assert d["bottleneck"] == "compute" and d["roofline_time"] == r.t_compute


def test_no_tpu_peak_in_the_port():
    """TPU v5e's 197 TFLOP/s, 819 GB/s and 50 GB/s ICI
    (repro/roofline/analysis.py:22-25) appear nowhere in the port."""
    pattern = ("197e12", "819e9", "50e9")
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        text = path.read_text()
        assert not any(p in text for p in pattern), path


# ---------------------------------------------------------------------------
# Parameter counts and model FLOP against the reference
# ---------------------------------------------------------------------------
_REFERENCE_FLOPS = """
import json
from repro.configs import ARCH_IDS, SHAPES, get_config
from repro.launch.dryrun import model_flops_global
from repro.models import get_model
print(json.dumps({a: {s: model_flops_global(get_config(a),
                                            get_model(get_config(a)),
                                            SHAPES[s]) for s in SHAPES}
                  for a in ARCH_IDS}))
"""


@pytest.fixture(scope="module")
def reference_flops():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src") + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", _REFERENCE_FLOPS], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_matches_the_reference(arch):
    want = jparams.count_params(jget_model(jget_config(arch)).specs())
    specs = get_model(get_config(arch)).specs()
    assert count_params(specs) == want
    meta = shape_tree(specs)
    assert all(t.device.type == "meta" for t in meta.values())
    assert sum(t.numel() for t in meta.values()) == want


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_the_reference(reference_flops, arch, shape):
    cfg = get_config(arch)
    got = rl.model_flops_global(cfg, get_model(cfg), SHAPES[shape])
    want = reference_flops[arch][shape]
    assert abs(got - want) <= 1e-12 * want


def test_named_specs_are_the_parameters_names():
    cfg = get_smoke_config("qwen2-moe-a2.7b")
    model = get_model(cfg)
    params = model.empty_params("meta")
    assert ({n: s.shape for n, s in named_specs(model.specs())}
            == {n: tuple(p.shape) for n, p in params.named_parameters()})


# ---------------------------------------------------------------------------
# The dry run on the meta device
# ---------------------------------------------------------------------------
def test_dry_run_bytes_match_a_materialised_model():
    """The meta pass's weight and cache bytes equal those of the same
    (smoke) model and caches made on the CPU."""
    for arch in ("llama3-8b", "jamba-1.5-large-398b", "whisper-small"):
        cfg = get_smoke_config(arch)
        model = get_model(cfg)
        params = model.init_params(seed=0, device="cpu")
        assert dryrun.weight_bytes(cfg) == sum(
            p.numel() * p.element_size() for p in params.parameters())
        caches = model.init_cache(2, 24, "cpu")
        assert dryrun.cache_bytes(cfg, 2, 24) == sum(
            x.numel() * x.element_size() for c in caches for x in c)


def test_dry_run_weights_match_the_reference_specs():
    """deepseek-v2 cut to 4 layers (the serve_mla cell): the meta pass's
    parameters and weight bytes equal the reference's specs'."""
    cfg = get_config("deepseek-v2-236b").replace(n_layers=4)
    row = dryrun.cell(cfg, SHAPES["prefill_32k"])
    jspecs = jget_model(jget_config("deepseek-v2-236b").replace(
        n_layers=4)).specs()
    import jax
    import numpy as np

    leaves = jax.tree.leaves(jspecs, is_leaf=jparams.is_spec)
    assert row["params"] == jparams.count_params(jspecs)
    assert row["weight_bytes"] == sum(
        int(np.prod(p.shape)) * np.dtype(p.dtype).itemsize for p in leaves)
    assert row["fits_card"]


def test_dry_run_shows_the_serve_cuts(tmp_path):
    """jamba at one period of 8 layers does not fit 80 GB (~90 GB of
    weights); the serve_hybrid cut (2 layers of period 2) does.  --out
    writes the printed lines."""
    out = tmp_path / "cells.jsonl"
    rows = dryrun.main(["--arch", "jamba-1.5-large-398b", "--shape",
                        "decode_32k", "--n-layers", "8", "--attn-period",
                        "8", "--out", str(out)])
    assert len(rows) == 1 and not rows[0]["fits_card"]
    assert 90e9 < rows[0]["weight_bytes"] < 91e9
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == rows
    cut = dryrun.main(["--arch", "jamba-1.5-large-398b", "--shape",
                       "prefill_32k", "--n-layers", "2", "--attn-period",
                       "2"])
    assert cut[0]["fits_card"] and cut[0]["n_layers"] == 2


def test_dry_run_skips_unsupported_shapes(capsys):
    rows = dryrun.main(["--arch", "llama3-8b", "--shape", "long_500k"])
    assert rows == []
    assert "skipped" in json.loads(capsys.readouterr().out.splitlines()[-1])


# ---------------------------------------------------------------------------
# The kernel-family map (graph nodes and profiler records)
# ---------------------------------------------------------------------------
KERNEL_NAMES = [
    ("_ZN5repro12_GLOBAL__N_117contract_v_kernelILi3EEEvPKfS3_S3_S3_Pfiii",
     "contract_v"),
    ("void repro::(anonymous namespace)::contract_v_wide_kernel<12>(float "
     "const*)", "contract_v"),
    ("_ZN5repro13stripe_kernelILi5EfLi0ELb1ELb0EEEvPKfS2_S2_",
     "stripe"),
    ("void repro::stripe_kernel<5, float, 0, true, false>(float const*)",
     "stripe"),
    ("_ZN5repro12_GLOBAL__N_113shrink_kernelILi3EfLi1EEEvPKf", "shrink"),
    ("_ZN5repro19sum_partials_kernelENS_7SumJobsE", None),
    ("_ZN5repro12_GLOBAL__N_118flash_wgmma_kernelILi128EEEv", None),
    ("_ZN2at6native17softshrink_kernelERNS_18TensorIteratorBaseE", None),
    ("_Z22batch_trsm_left_kernelIfLi64ELi4ELi3ELb0ELb0ELb0EEv", None),
    ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize32x32x8_cublas", None),
]


# The kernels above r = 256: the contractions' cluster kernels (mangled, as
# a graph node names them, and demangled, as the profiler does) and chunk
# kernels, and the shrink's stream kernel.
RANK_ROUTE_KERNEL_NAMES = [
    ("_ZN5repro12_GLOBAL__N_125contract_v_cluster_kernelILi8EfLi0EEEvPKf",
     "contract_v"),
    ("void repro::(anonymous namespace)::contract_v_chunk_kernel<float, 0>"
     "(float const*)", "contract_v"),
    ("_ZN5repro21stripe_cluster_kernelILi8EfLi0ELb1ELb0EEEvPKfS2_S2_",
     "stripe"),
    ("void repro::stripe_cluster_kernel<7, __nv_bfloat16, 2, true, true>"
     "(float const*)", "stripe"),
    ("_ZN5repro19stripe_chunk_kernelIfLi1ELb0ELb0EEEvPKfS2_S2_", "stripe"),
    ("void repro::stripe_chunk_kernel<float, 0, true, false>(float const*)",
     "stripe"),
    ("_ZN5repro41_GLOBAL__N__eabbe2f4_9_shrink_cu_b032f06a20shrink_stream_"
     "kernelIfLi0ELb0EEEv10CUtensorMapS3_iPKfS5_PKT_PKvS5_PfSB_iii",
     "shrink"),
    ("void repro::(anonymous namespace)::shrink_stream_kernel<__nv_bfloat16,"
     " 2, true>(CUtensorMap, CUtensorMap, int, float const*)", "shrink"),
]


@pytest.mark.parametrize("name, family",
                         KERNEL_NAMES + RANK_ROUTE_KERNEL_NAMES)
def test_kernel_family_of_a_device_kernel(name, family):
    assert ops.kernel_family(name) == family


def test_family_sums():
    counts = {"huber_contract_v": 6, "huber_contract_v_masked": 2,
              "huber_contract_u_diag_packed": 3, "huber_dual_contract": 1,
              "residual_shrink_psi_masked": 1, "flash_attention": 4}
    assert ops.family_launches(counts) == {"contract_v": 8, "stripe": 4,
                                           "shrink": 1}
    names = {name: 2 for name, _ in KERNEL_NAMES}
    assert ops.kernels_by_family(names) == {"contract_v": 4, "stripe": 4,
                                            "shrink": 2}


def test_reset_clears_the_replayed_kernels():
    rt.replayed_kernels["nodes"]["stripe"] = 3
    rt.replayed_kernels["counted"]["stripe"] = 3
    rt.reset_graph_counts()
    assert rt.replayed_kernels == {"nodes": {}, "counted": {}}
