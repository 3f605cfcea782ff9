"""The port's sharded engine (``method="dcf_sharded"``: one client a
``torch.distributed`` rank) against the reference's SPMD engine, on the CPU.

The test process draws the problems (``repro_torch.core.problems.
generate_problem``, seeded, on the CPU) and writes them; then two
module-scoped runs, started together, give every test here its numbers:

* one JAX subprocess with ``--xla_force_host_platform_device_count=4``
  writes the reference's initial factors (``U0 = normal(k_u) r^-1/2``,
  ``V_i = normal(fold_in(k_v, i)) r^-1/2``, ``repro/core/dcf_pca.py:
  982-999``) and its drawn participation schedule, then solves every case
  with ``dcf_pca_sharded`` and writes the results;
* one cohort of 4 gloo ranks (``repro_torch.distributed.multihost.
  launch_workers``) reads those factors as soon as they are written,
  solves the same cases from them (carried by
  ``convert.sharded_problem_from_reference``), and rank 0 writes the
  results; every rank prints a SHA-256 of each case's U.

The same two runs hold the robust gradient aggregation
(``distributed.grad_compress.consensus_compress``, tests/test_multidevice.py:
138-179 with 4 workers in place of 8): the reference draws the sketch
``Omega`` from ``PRNGKey(7)`` and writes it with the factors; every rank
aggregates its worker's gradient from it, the reference in a
``shard_map`` over its 4 devices.  The reference also writes its smoke
LM's fp32 parameters (from ``PRNGKey(0)``) and a batch, and every rank
takes three steps from them (:data:`LM_STEPS`):

* ``robust_step``: ``training.train_step.make_robust_train_step`` as
  tests/test_multidevice.py:182-213 sets it (consensus on the large
  leaves) with no weight decay, so a parameter moves only by its
  aggregated gradient; its loss is held to the plain full-batch loss
  computed here;
* ``robust_median``: the same step with ``CompressConfig(min_dim=10**6)``,
  which sends every leaf through the coordinate-wise median and draws no
  sketch, held to the reference's ``make_robust_train_step`` (a
  ``shard_map`` over its 4 devices) from the same parameters and batch;
* ``dp_step``: ``make_train_step(comm=...)``, the plain data-parallel
  step (each rank's shard, the gradients averaged by all-reduce), held to
  the one-process step on the whole batch computed here.

Then the ranks run ``launch/train.py`` without ``--robust-agg``
(:data:`LAUNCH_ARGV`), its losses held to the same run in one process.

The all-ones mask and all-ones schedule cases are tracked against the
reference's solve without them (:data:`REFERENCE_OF`): the reference holds
those pairs equal bit for bit itself (tests/test_multidevice.py:74-90,
:101-118), so it solves each pair once.

The reference's tests (tests/test_multidevice.py) use 8 devices; this file
uses 4 (a (4,) data mesh and a (2, 2) data x model mesh) to spare tier-1's
time, at the reference tests' problem sizes.  Bars: U and V within 1e-4
relative of the reference's in every case (tests/test_torch_solve.py's
tracking bar, fp32 sums in another order; the 60-round top-k solve over
its first 30 rounds, see :data:`TRACKED`), the reference tests' recovery
bars on the port's solves, U's bytes equal on every rank, a second solve
in the same process equal byte for byte, the bit-exact pairs (all-ones
mask == none, all-ones schedule == none, snapshotting == plain, resumed ==
uninterrupted), and the sharded error within 1e-6 of the port's simulated
engine at E = 4 from the same factors.
"""
import hashlib
import importlib
import inspect
import json
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch import rpca
from repro_torch.core import metrics, problems
from repro_torch.core.factorized import DCFConfig
from repro_torch.distributed import grad_compress as gcomp
from repro_torch.distributed import multihost as mh

dcf_pca = importlib.import_module("repro_torch.core.dcf_pca")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: The reference's subprocess: 4 host devices, and XLA's backend
#: optimisation off, which saves a fifth of its compile time (a dozen
#: distinct solves) and moves its results by ~1e-6 relative (fp32 sums in
#: another order), a hundredth of the tracking bar.
XLA_FLAGS = ("--xla_force_host_platform_device_count=4 "
             "--xla_backend_optimization_level=0")
E = 4
TRACK_TOL = 1e-4
#: The Byzantine aggregation case (tests/test_multidevice.py:144-158): a
#: rank-4 (256, 128) signal a worker plus 0.01 noise, worker 0 spiked by
#: 1e4 at 2% of its entries; CompressConfig(rank=8, rounds=6).
BYZ = dict(m=256, k=128, r=4, spike=1e4, frac=0.02, rank=8, rounds=6)
#: The LM steps: the smoke LM in fp32, a global batch of 8 x 32 (tests/
#: test_multidevice.py:182-213).  ``robust_step`` takes that test's
#: CompressConfig(rank=4, rounds=2, min_dim=32) and AdamW (lr 1e-3, one
#: warm-up step) at weight decay 0; the steps held to another step's
#: parameters take lr 1e-4 and eps 1e-6 (:data:`LM_OCFG`, the
#: ``STEP_OCFG`` of tests/test_torch_train.py, which says why).
LM_ARCH, LM_SHAPE = "tinyllama-1.1b", (32, 8)
LM_OCFG = dict(lr=1e-4, eps=1e-6, warmup_steps=1, total_steps=10)
LM_STEPS = ("robust_step", "robust_median", "dp_step")
#: ``launch/train.py`` over the 4 ranks and in one process: two logged
#: steps of the smoke LM (lr 1e-4: the step held to another step's).
LAUNCH_ARGV = ["--smoke", "--steps", "2", "--batch", "8", "--seq", "32",
               "--lr", "1e-4", "--log-every", "1", "--device", "cpu"]

#: Problems: (seed, n, rank, observed_frac), all with m = 128 and 5%
#: corruption (the reference tests' sizes).
PROBLEMS = {"p42": (42, 160, 6, None), "p3": (3, 128, 5, None),
            "p5": (5, 128, 5, 0.7), "p3r": (3, 150, 6, None)}
#: Cases: (problem, preset, preset arguments, mesh, solve options).
#: ``topk`` in the arguments is ``CompressConfig(topk_frac=...)``.
CASES = {
    "dense": ("p42", "tuned", {"rank": 6, "outer_iters": 60}, "4", {}),
    "rows": ("p3", "tuned", {"rank": 5, "outer_iters": 60}, "2x2",
             {"model_axis": "model"}),
    "mask_none": ("p5", "tuned", {"rank": 5, "outer_iters": 60}, "4",
                  {"full": True}),
    "mask_ones": ("p5", "tuned", {"rank": 5, "outer_iters": 60}, "4",
                  {"full": True, "ones": True}),
    "masked": ("p5", "masked", {"rank": 5, "observed_frac": 0.7}, "4",
               {"mask": True}),
    "sched_ones": ("p42", "tuned", {"rank": 6, "outer_iters": 60}, "4",
                   {"participation": "ones"}),
    "ragged": ("p3r", "tuned", {"rank": 6, "outer_iters": 60}, "4", {}),
    "elastic": ("p42", "elastic", {"rank": 6, "participation": 0.5,
                                   "outer_iters": 300}, "4",
                {"participation": 0.5}),
    "topk": ("p42", "tuned", {"rank": 6, "outer_iters": 60, "topk": 0.1},
             "4", {}),
    "topk30": ("p42", "tuned", {"rank": 6, "outer_iters": 30, "topk": 0.1},
               "4", {}),
    "fullk": ("p42", "tuned", {"rank": 6, "outer_iters": 60, "topk": 1.0},
              "4", {}),
    "stale": ("p42", "tuned", {"rank": 6, "outer_iters": 60,
                               "consensus_delay": 1}, "4", {}),
    "robust_base": ("p3", "tuned", {"rank": 5, "outer_iters": 60}, "4", {}),
    "robust": ("p3", "tuned", {"rank": 5, "outer_iters": 60,
                               "aggregator": "coordinate_median"}, "4",
               {"faults": True}),
    "ckpt": ("p3", "tuned", {"rank": 5, "outer_iters": 24, "topk": 0.5},
             "4", {}),
}
#: The cases held to another case's reference solve: the reference holds
#: an all-ones mask equal to none and an all-ones schedule equal to none,
#: bit for bit (tests/test_multidevice.py:74-90, :101-118).
REFERENCE_OF = {"mask_ones": "mask_none", "sched_ones": "dense"}
#: The cases the reference solves: all but those and the 60-round top-k
#: solve (not tracked, see :data:`TRACKED`).
REFERENCE_SOLVES = sorted(set(CASES) - set(REFERENCE_OF) - {"topk"})

def nest(flat, prefix):
    """The tree of numpy arrays written flat under ``prefix`` (the
    reference's ``flat``: keys ``prefix/<path>``), digit keys as ints, so
    that ``tree["segments"][0]`` indexes it as it does the reference's."""
    tree = {}
    for key, x in flat.items():
        if key.startswith(prefix + "/"):
            node = tree
            *parts, last = [int(k) if k.isdigit() else k
                            for k in key[len(prefix) + 1:].split("/")]
            for part in parts:
                node = node.setdefault(part, {})
            node[last] = x
    return tree


#: Shared by both scripts: the presets from plain data, a case's solve
#: inputs from the written problems, and :func:`nest`.
_COMMON = f"""
import json, os, sys, time
import numpy as np
PROBLEMS = {PROBLEMS!r}
CASES = {CASES!r}
REFERENCE_SOLVES = {REFERENCE_SOLVES!r}
E = {E}
BYZ = {BYZ!r}
LM_ARCH, LM_SHAPE, LM_OCFG = {LM_ARCH!r}, {LM_SHAPE!r}, {LM_OCFG!r}
LAUNCH_ARGV = {LAUNCH_ARGV!r}


def make_cfg(Config, Compress, kind, kw):
    kw = dict(kw)
    rank = kw.pop("rank")
    topk = kw.pop("topk", None)
    if topk is not None:
        kw["consensus_compress"] = Compress(topk_frac=topk)
    return getattr(Config, kind)(rank, **kw)


def wait_for(path, seconds=300):
    deadline = time.time() + seconds
    while not os.path.exists(path):
        if time.time() > deadline:
            raise SystemExit("no inputs at " + path)
        time.sleep(0.05)
    return np.load(path)
""" + inspect.getsource(nest)

_REFERENCE = _COMMON + r"""
import importlib, tempfile
import jax, jax.numpy as jnp
from repro.core import runtime as jrt
from repro.core.factorized import DCFConfig
from repro.distributed.faults import CORRUPT, FaultPlan
from repro.distributed.grad_compress import CompressConfig
from repro.launch.mesh import make_compat_mesh

jdcf = importlib.import_module("repro.core.dcf_pca")
problems_path, inputs_path, results_path = sys.argv[1:4]
MESH = {"4": make_compat_mesh((E,), ("data",)),
        "2x2": make_compat_mesh((2, 2), ("data", "model"))}
KEY = jax.random.PRNGKey(0)



def factors(m, n, r, clients):
    k_u, k_v = jax.random.split(KEY)
    scale = 1.0 / float(jnp.sqrt(float(r)))
    ni = -(-n // clients)
    u = jax.random.normal(k_u, (m, r), jnp.float32) * scale
    v = [jax.random.normal(jax.random.fold_in(k_v, i), (ni, r),
                           jnp.float32) * scale for i in range(clients)]
    return np.asarray(u), np.asarray(jnp.concatenate(v))


problems = np.load(problems_path)
P = {name: {f: (jnp.asarray(problems[f"{name}/{f}"])
                if f"{name}/{f}" in problems else None)
            for f in ("m_obs", "l0", "s0", "mask")} for name in PROBLEMS}
inputs = {}
codes = FaultPlan.byzantine(60, E, (1,), kind="nan").codes.copy()
codes[:, 3] = CORRUPT
inputs["codes"] = codes
cfgs = {}
for case, (pname, kind, kw, mesh, opts) in CASES.items():
    cfgs[case] = cfg = make_cfg(DCFConfig, CompressConfig, kind, kw)
    clients = 2 if mesh == "2x2" else E
    inputs[f"{case}/u0"], inputs[f"{case}/v0"] = factors(
        128, P[pname]["m_obs"].shape[1], cfg.rank, clients)
    if isinstance(opts.get("participation"), float):
        inputs[f"{case}/sched"] = np.asarray(jdcf._resolve_participation(
            opts["participation"], cfg.outer_iters, E, KEY))
inputs["byz/omega"] = np.asarray(jax.random.normal(
    jax.random.PRNGKey(7), (BYZ["k"], BYZ["rank"]), jnp.float32))


def flat(prefix, tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join([prefix] + keys)] = np.asarray(leaf)
    return out


from repro import configs as jconfigs
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import get_model as jget_model, params as jpm
from repro.training import data as jdata

lm_cfg = jconfigs.get_smoke_config(LM_ARCH).replace(
    param_dtype="float32", compute_dtype="float32")
lm_model = jget_model(lm_cfg)
lm_params = jpm.materialize(lm_model.specs(), KEY)
lm_batch = jdata.SyntheticData(
    lm_cfg, JShapeSpec("t", *LM_SHAPE, "train")).batch_at(0)
inputs.update(flat("lm", lm_params))
inputs.update(flat("lm_batch", lm_batch))
np.savez(inputs_path + ".tmp.npz", **inputs)
os.replace(inputs_path + ".tmp.npz", inputs_path)

results, msgs = {}, {}
for case, (pname, kind, kw, mesh, opts) in CASES.items():
    if case not in REFERENCE_SOLVES:
        continue
    p, cfg, kw = P[pname], cfgs[case], {}
    m = p["l0"] + p["s0"] if opts.get("full") else p["m_obs"]
    if opts.get("ones"):
        kw["mask"] = jnp.ones_like(m)
    if opts.get("mask"):
        kw["mask"] = p["mask"]
    if opts.get("participation") == "ones":
        kw["participation"] = jnp.ones((cfg.outer_iters, E))
    elif "participation" in opts:
        kw["participation"] = opts["participation"]
    if opts.get("faults"):
        kw["faults"] = FaultPlan(codes)
    res = jdcf.dcf_pca_sharded(m, cfg, MESH[mesh],
                               model_axis=opts.get("model_axis"), **kw)
    for f in ("l", "s", "u", "v"):
        results[f"{case}/{f}"] = np.asarray(getattr(res, f))
try:
    jdcf.dcf_pca_sharded(P["p5"]["m_obs"], DCFConfig.masked(5, pack_mask=True),
                         MESH["4"], mask=P["p5"]["mask"])
except ValueError as e:
    msgs["pack_mask"] = str(e)
try:
    jdcf.dcf_pca_sharded(
        P["p3"]["m_obs"], cfgs["rows"], MESH["2x2"], model_axis="model",
        run=jrt.RunConfig(mode="scan", checkpoint_every=9),
        checkpoint_dir=tempfile.mkdtemp())
except ValueError as e:
    msgs["segmented_model"] = str(e)
results["messages"] = np.array(json.dumps(msgs))

from jax.sharding import PartitionSpec as Pspec
from repro.compat import shard_map_compat
from repro.distributed.grad_compress import consensus_compress


def aggregate(g):
    out = consensus_compress(g[0], ("data",), CompressConfig(
        rank=BYZ["rank"], rounds=BYZ["rounds"]), jax.random.PRNGKey(7))
    return out[None]


results["byz/robust"] = np.asarray(jax.jit(shard_map_compat(
    aggregate, MESH["4"], (Pspec("data", None, None),),
    Pspec("data", None, None)))(jnp.asarray(problems["byz/grads"])))[0]

# The robust train step with every leaf on the coordinate-wise median.
from repro.distributed.sharding import ShardingRules
from repro.training import optimizer as jopt
from repro.training.train_step import make_robust_train_step

step = make_robust_train_step(
    lm_model, jopt.AdamWConfig(**LM_OCFG), MESH["4"],
    ShardingRules(dp=("data",)), CompressConfig(min_dim=10 ** 6))
with MESH["4"]:
    lm_after, _, lm_mets = jax.jit(step)(lm_params, jopt.init(lm_params),
                                         lm_batch, jax.random.PRNGKey(1))
results.update(flat("robust_median", lm_after))
results["robust_median/loss"] = np.asarray(lm_mets["loss"])
np.savez(results_path, **results)
"""

_PORT = _COMMON + r"""
import hashlib, shutil
import torch
import torch.distributed as dist
from repro_torch import convert
from repro_torch.core import runtime as rt
from repro_torch.core.factorized import DCFConfig
from repro_torch.distributed import multihost as mh
from repro_torch.distributed import grad_compress as gcomp
from repro_torch.distributed.faults import FaultPlan
from repro_torch.distributed.grad_compress import CompressConfig
import importlib

torch.set_num_threads(1)
dcf = importlib.import_module("repro_torch.core.dcf_pca")
MESH = {"4": mh.multihost_mesh(("data",), device="cpu"),
        "2x2": mh.multihost_mesh(("data", "model"), (2, 2), device="cpu")}
rank = dist.get_rank()

# The mesh's groups and the byte counter, while the reference starts.
comm = mh.MeshComm(MESH["2x2"], ("data",), "model")
r = float(rank)
before = mh.wire_counts()
g = comm.all_gather(torch.tensor([r, r]))
s_model = comm.all_reduce(torch.tensor(r), "model")
s_all = comm.all_reduce(torch.tensor(r), "all")
med = gcomp.median_aggregate(torch.tensor([r, 3 * r]), comm)
after = mh.wire_counts()
print("COMM", comm.client, comm.model_index, comm.clients, comm.model_size,
      json.dumps(g[:, 0].tolist(), separators=(",", ":")), float(s_model),
      float(s_all), json.dumps(med.tolist(), separators=(",", ":")),
      *(after[k] - before[k] for k in ("all_gather_bytes",
                                       "all_reduce_bytes")), flush=True)

inp = dict(np.load(os.environ["SHARDED_PROBLEMS"]))
inp.update(wait_for(os.environ["SHARDED_INPUTS"]))
out_path, ckdir = os.environ["SHARDED_RESULTS"], os.environ["SHARDED_CKPT"]
results, msgs = {}, {}


def t(x):
    return torch.from_numpy(np.array(x))


def solve(case, tag=None, cfg=None, **kw):
    pname, kind, ckw, mesh, opts = CASES[case]
    cfg = cfg or make_cfg(DCFConfig, CompressConfig, kind, ckw)
    comm = mh.MeshComm(MESH[mesh], ("data",), opts.get("model_axis"))
    m = t(inp[pname + "/m_obs"])
    if opts.get("full"):
        m = t(inp[pname + "/l0"]) + t(inp[pname + "/s0"])
    mask = torch.ones_like(m) if opts.get("ones") else (
        t(inp[pname + "/mask"]) if opts.get("mask") else None)
    part = opts.get("participation")
    if part == "ones":
        part = np.ones((cfg.outer_iters, E), np.float32)
    faults = FaultPlan(inp["codes"]) if opts.get("faults") else None
    problem, layout = dcf.make_sharded_problem(
        m, cfg, comm, 0, mask=mask, participation=part, faults=faults,
        device="cpu")
    problem = convert.sharded_problem_from_reference(
        problem, layout, inp[case + "/u0"], inp[case + "/v0"],
        inp.get(case + "/sched"))
    res = dcf.solve_sharded_problem(problem, layout, cfg, kw.pop("run", None),
                                    **kw)
    tag = tag or case
    for f in ("l", "s", "u", "v"):
        results[f"{tag}/{f}"] = getattr(res, f).numpy()
    results[tag + "/residual"] = res.stats.residual.numpy()
    print("HASH", tag, hashlib.sha256(res.u.numpy().tobytes()).hexdigest(),
          flush=True)
    return res


for case in CASES:
    solve(case)
solve("dense", "dense_again")

# Snapshots every 9 rounds; then the kill after the first: the later
# snapshots go (rank 0, while the others wait) and the solve resumes.
run = rt.RunConfig(mode="scan", checkpoint_every=9)
solve("ckpt", "ckpt_full", run=run, checkpoint_dir=ckdir)
dist.barrier()
if rank == 0:
    steps = sorted(x for x in os.listdir(ckdir) if x.startswith("step_"))
    for s in steps[1:]:
        shutil.rmtree(os.path.join(ckdir, s))
    with open(os.path.join(ckdir, "LATEST"), "w") as f:
        f.write(str(int(steps[0].split("_")[1])))
    results["snapshots"] = np.array(len(steps))
dist.barrier()
solve("ckpt", "ckpt_resumed", run=run, resume_from=ckdir)
rows_cfg = make_cfg(DCFConfig, CompressConfig, *CASES["rows"][1:3])
for name, kw in (("mesh", {"resume_from": ckdir}),
                 ("segmented_model", {"checkpoint_dir": ckdir + "_rows"})):
    try:
        solve("rows", "refused", cfg=rows_cfg, run=run, **kw)
    except ValueError as e:
        msgs[name] = str(e)

# One round's collective bytes: a 2-round solve less a 1-round one.
for case in ("dense", "topk"):
    pname, kind, ckw, mesh, opts = CASES[case]
    per = []
    for rounds in (1, 2):
        cfg = make_cfg(DCFConfig, CompressConfig, kind,
                       dict(ckw, outer_iters=rounds))
        before = mh.wire_counts()
        solve(case, "bytes", cfg=cfg)
        after = mh.wire_counts()
        per.append({k: after[k] - before[k] for k in after
                    if k.endswith("_bytes")})
    results[case + "/round_bytes"] = np.array(json.dumps(
        {k: per[1][k] - per[0][k] for k in per[0]}))
# Robust gradient aggregation from the reference's sketch, and the three
# steps on the smoke LM from the reference's parameters and batch.
from repro_torch import configs
from repro_torch.distributed.sharding import rules_for_mesh
from repro_torch.models import get_model
from repro_torch.training import optimizer as opt
from repro_torch.training.train_step import (
    make_robust_train_step, make_train_step)

comm4 = mh.MeshComm(MESH["4"], ("data",))
robust = gcomp.consensus_compress(
    t(inp["byz/grads"][comm4.client]), comm4,
    CompressConfig(rank=BYZ["rank"], rounds=BYZ["rounds"]),
    omega=t(inp["byz/omega"]))
print("HASH byz", hashlib.sha256(robust.numpy().tobytes()).hexdigest(),
      flush=True)
results["byz/robust"] = robust.numpy()
cfg = configs.get_smoke_config(LM_ARCH).replace(
    param_dtype="float32", compute_dtype="float32")
model = get_model(cfg)
batch = {k: t(x) for k, x in nest(inp, "lm_batch").items()}
rules = rules_for_mesh(MESH["4"])
steps = {
    "robust_step": make_robust_train_step(
        model, opt.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10,
                               weight_decay=0.0),
        MESH["4"], rules, CompressConfig(rank=4, rounds=2, min_dim=32)),
    "robust_median": make_robust_train_step(
        model, opt.AdamWConfig(**LM_OCFG), MESH["4"], rules,
        CompressConfig(min_dim=10 ** 6)),
    "dp_step": make_train_step(model, opt.AdamWConfig(**LM_OCFG),
                               rules, comm=comm4),
}
for tag, step in steps.items():
    params = convert.lm_params_from_reference(nest(inp, "lm"), cfg, "cpu")
    before = [p.detach().clone() for p in params.parameters()]
    args = (params, opt.init(params), batch) + (
        (1,) if tag.startswith("robust") else ())
    params, state, mets = step(*args)
    flat = torch.cat([p.detach().reshape(-1) for p in params.parameters()])
    print("HASH", tag, hashlib.sha256(flat.numpy().tobytes()).hexdigest(),
          flush=True)
    results[tag + "/loss"] = mets["loss"].numpy()
    results[tag + "/moved"] = np.array(max(
        float((p.detach() - b).abs().max())
        for p, b in zip(params.parameters(), before)))
    for name, p in params.named_parameters():
        results[f"{tag}/{name}"] = p.detach().numpy()

# The launcher's data-parallel path (no --robust-agg) over the 4 ranks.
from repro_torch.launch import train as launch_train

log = launch_train.main(LAUNCH_ARGV)["log"]
results["launcher/losses"] = np.array([e["loss"] for e in log])
if rank == 0:
    results["messages"] = np.array(json.dumps(msgs))
    np.savez(out_path, **results)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One torch thread beside JAX's (tests/test_torch_convex.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's 4-rank cohort, started
    together: ``(inputs, reference, port, worker outputs)``."""
    d = tmp_path_factory.mktemp("sharded")
    paths = {k: str(d / f"{k}.npz")
             for k in ("problems", "inputs", "ref", "port")}
    np.savez(paths["problems"], **_problems())
    env = dict(os.environ)
    env.pop(mh.ENV_COORDINATOR, None)
    env.update(XLA_FLAGS=XLA_FLAGS, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(REPO, "src"))
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, paths["problems"],
         paths["inputs"], paths["ref"]],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    cohort: dict = {}

    def port():
        try:
            cohort["outs"] = mh.launch_workers(
                _PORT, num_processes=E, timeout=600, backend="gloo",
                extra_env={"SHARDED_PROBLEMS": paths["problems"],
                           "SHARDED_INPUTS": paths["inputs"],
                           "SHARDED_RESULTS": paths["port"],
                           "SHARDED_CKPT": str(d / "ckpt"),
                           "OMP_NUM_THREADS": "1"})
        except BaseException as e:  # reported on the test's thread
            cohort["error"] = e

    worker = threading.Thread(target=port, daemon=True)
    worker.start()
    ref_out, _ = ref.communicate(timeout=600)
    if ref.returncode != 0:
        # The cohort waits on the reference's inputs: end it first.
        raise AssertionError(f"reference run failed:\n{ref_out}")
    worker.join()
    if "error" in cohort:
        raise cohort["error"]
    inputs = dict(np.load(paths["problems"]))
    inputs.update(np.load(paths["inputs"]))
    return (inputs, np.load(paths["ref"]), np.load(paths["port"]),
            cohort["outs"])


def _problems() -> dict:
    """Every problem of :data:`PROBLEMS` as numpy arrays, by
    ``name/field``: m = 128, 5% corruption."""
    out = {}
    for name, (seed, n, r, frac) in PROBLEMS.items():
        p = problems.generate_problem(seed, 128, n, r, 0.05,
                                      observed_frac=frac or 1.0,
                                      device="cpu")
        for f in ("m_obs", "l0", "s0", "mask"):
            if getattr(p, f) is not None:
                out[f"{name}/{f}"] = getattr(p, f).numpy()
    out.update(_byzantine_grads())
    return out


def _byzantine_grads() -> dict:
    """:data:`BYZ`'s E worker gradients (E, m, k), worker 0 corrupted, and
    their clean mean, from numpy's generator."""
    rng = np.random.default_rng(0)
    m, k, r = BYZ["m"], BYZ["k"], BYZ["r"]
    u0 = rng.standard_normal((m, r))
    vs = rng.standard_normal((E, k, r))
    grads = np.einsum("mr,ekr->emk", u0, vs)
    grads += 0.01 * rng.standard_normal(grads.shape)
    clean = grads.mean(0)
    grads[0] += (rng.random((m, k)) < BYZ["frac"]) * BYZ["spike"]
    return {"byz/grads": grads.astype(np.float32),
            "byz/clean": clean.astype(np.float32)}


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(x):
    return torch.from_numpy(np.array(x))


def _err(runs, tag, case=None):
    inputs, _, port, _ = runs
    pname = CASES[case or tag][0]
    return float(metrics.relative_error(
        _t(port[tag + "/l"]), _t(port[tag + "/s"]),
        _t(inputs[pname + "/l0"]), _t(inputs[pname + "/s0"])))


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------
#: Every case but the 60-round top-k solve, whose trajectory parts from
#: the reference's after round 50: the two packages' error-feedback
#: residuals differ in their last bits (fp32 sums in another order) and
#: one entry's top-k choice flips, after which the U's are 1.4e-4 apart
#: (relative) by round 60, against 2.5e-7 at round 30 and 3.5e-7 at round
#: 50.  Its first 30 rounds (``topk30``) are tracked; the whole solve is
#: held to the reference's recovery bar and, bit for bit, to the port's
#: simulated wire engine, which takes the same choices.
TRACKED = sorted(set(CASES) - {"topk"})


@pytest.mark.parametrize("case", TRACKED)
def test_factors_track_the_reference(runs, case):
    """U and V within 1e-4 relative of the reference's, at the reference's
    shapes (ragged: L (128, 150), V (150, r))."""
    _, ref, port, _ = runs
    want = REFERENCE_OF.get(case, case)
    for f in ("u", "v"):
        assert port[f"{case}/{f}"].shape == ref[f"{want}/{f}"].shape
        assert _rel(port[f"{case}/{f}"], ref[f"{want}/{f}"]) < TRACK_TOL, f
    assert port[case + "/l"].shape == ref[want + "/l"].shape


def test_ragged_shapes(runs):
    """tests/test_multidevice.py:123: the padding is trimmed."""
    _, _, port, _ = runs
    assert port["ragged/l"].shape == (128, 150)
    assert port["ragged/v"].shape == (150, 6)


@pytest.mark.parametrize("case", ["dense", "rows", "ragged"])
def test_recovers(runs, case):
    """tests/test_multidevice.py:46-48, :54-70, :101-135: relative error
    under 1e-4."""
    assert _err(runs, case) < 1e-4


def test_masked_completion(runs):
    """tests/test_multidevice.py:92-96: 70% observed, observed error under
    1e-2, unobserved under 5e-2."""
    inputs, _, port, _ = runs
    err = metrics.completion_errors(_t(port["masked/l"]),
                                    _t(inputs["p5/l0"]), _t(inputs["p5/mask"]))
    assert float(err.observed) < 1e-2
    assert float(err.unobserved) < 5e-2


def test_elastic_participation(runs):
    """tests/test_multidevice.py:129-132: a rate-0.5 schedule, the
    low-rank error at most 1e-2."""
    inputs, _, port, _ = runs
    assert float(metrics.low_rank_relative_error(
        _t(port["elastic/l"]), _t(inputs["p42/l0"]))) <= 1e-2


@pytest.mark.parametrize("case,bar", [("topk", 2.0), ("stale", 2.0)])
def test_wire_within_twice_dense(runs, case, bar):
    """tests/test_multidevice.py:256-278: top-k 0.1 and one round stale
    within 2x the dense error; full k within 1e-5 of it."""
    dense = _err(runs, "dense")
    assert dense < 1e-4
    assert _err(runs, case) <= bar * dense
    assert abs(_err(runs, "fullk") - dense) < 1e-5


def test_robust_consensus_quarantines(runs):
    """tests/test_multidevice.py:282-308 at E = 4: client 1 ships NaN and
    client 3 a 64x payload every round; the coordinate median stays finite
    and within 3x the fault-free error."""
    _, _, port, _ = runs
    e0, e1 = _err(runs, "robust_base"), _err(runs, "robust")
    assert np.isfinite(port["robust/l"]).all()
    assert e1 <= 3.0 * max(e0, 1e-6)


@pytest.mark.parametrize("case", ["dense", "topk"])
def test_sharded_matches_simulated(runs, case):
    """tests/test_multidevice.py:46-48: the sharded error within 1e-6 of
    the port's simulated engine at E = 4 from the same factors; on the
    60-round top-k solve the two take the same top-k choices (U within
    1e-6 relative)."""
    inputs, _, port, _ = runs
    pname, _, kw, _, _ = CASES[case]
    cfg = DCFConfig.tuned(kw["rank"], outer_iters=kw["outer_iters"],
                          consensus_compress=None if "topk" not in kw else
                          gcomp.CompressConfig(topk_frac=kw["topk"]))
    problem = dcf_pca.make_problem(_t(inputs[pname + "/m_obs"]), cfg, E,
                                   device="cpu")
    problem = problem._replace(
        u_init=_t(inputs[case + "/u0"]),
        v_init=_t(inputs[case + "/v0"]).reshape(E, -1, cfg.rank))
    sim = dcf_pca.solve_problem(problem, cfg)
    e_sim = float(metrics.relative_error(
        sim.l, sim.s, _t(inputs[pname + "/l0"]), _t(inputs[pname + "/s0"])))
    assert abs(_err(runs, case) - e_sim) < 1e-6
    assert _rel(sim.u.numpy(), port[case + "/u"]) < 1e-6


# ---------------------------------------------------------------------------
# The port's own invariants
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("a,b", [("mask_none", "mask_ones"),
                                 ("dense", "sched_ones"),
                                 ("ckpt", "ckpt_full"),
                                 ("ckpt_full", "ckpt_resumed"),
                                 ("dense", "dense_again")])
def test_bit_exact_pairs(runs, a, b):
    """All-ones mask == none, all-ones schedule == none, the snapshotting
    solve == the plain one, the resumed solve == the uninterrupted one
    (residual trace included), and a second solve in the same processes ==
    the first: L, S, U and V byte for byte."""
    _, _, port, _ = runs
    for f in ("l", "s", "u", "v"):
        assert port[f"{a}/{f}"].tobytes() == port[f"{b}/{f}"].tobytes(), f
    if b == "ckpt_resumed":
        assert int(port["snapshots"]) >= 2
        np.testing.assert_array_equal(port[a + "/residual"],
                                      port[b + "/residual"])


@pytest.mark.parametrize("case", sorted(CASES) + ["ckpt_full",
                                                  "ckpt_resumed"])
def test_every_rank_holds_the_same_u(runs, case):
    """Every rank's U has the same bytes (the consensus is the same
    collective result on every rank)."""
    outs = runs[3]
    hashes = set()
    for out in outs:
        mine = [ln.split()[2] for ln in out.splitlines()
                if ln.startswith(f"HASH {case} ")]
        assert len(mine) == 1, out[-2000:]
        hashes.add(mine[0])
    assert len(hashes) == 1
    want = hashlib.sha256(runs[2][case + "/u"].tobytes()).hexdigest()
    assert hashes == {want}


def test_snapshot_refused_on_another_mesh(runs):
    """tests/test_multidevice.py:361-367: a (4,) snapshot does not restore
    on (2, 2)."""
    msgs = json.loads(str(runs[2]["messages"]))
    assert "mesh" in msgs["mesh"]


@pytest.mark.parametrize("which", ["pack_mask", "segmented_model"])
def test_refusals_read_as_the_reference(runs, which):
    """The sharded engine's two refusals, word for word: a packed mask
    (before any group is made: a stand-in mesh does) and a segmented solve
    with a model axis (on the (2, 2) mesh)."""
    want = json.loads(str(runs[1]["messages"]))[which]
    if which == "pack_mask":
        m = torch.zeros(16, 16)
        with pytest.raises(ValueError) as got:
            rpca.solve(rpca.RPCASpec(m, mask=torch.ones(16, 16),
                                     mesh=types.SimpleNamespace()),
                       method="dcf_sharded",
                       cfg=DCFConfig.masked(5, pack_mask=True), device="cpu")
        assert str(got.value) == want
    else:
        assert json.loads(str(runs[2]["messages"]))[which] == want


@pytest.mark.parametrize("case", ["dense", "topk"])
def test_round_bytes_match_the_wire_model(runs, case):
    """The collectives' byte counter (the counterpart of the reference's
    HLO count, tests/test_multidevice.py:220-241): one dense round moves
    m r 4 bytes of all-reduce payload a client (half the model's up and
    down), one top-k round E k 8 bytes of all-gather (the model's shipped
    bytes), and nothing else."""
    cfg_kw = CASES[case][2]
    got = json.loads(str(runs[2][case + "/round_bytes"]))
    compress = None
    if "topk" in cfg_kw:
        compress = types.SimpleNamespace(topk_frac=cfg_kw["topk"])
    model = mh.consensus_wire_model(128, cfg_kw["rank"], E, compress)
    if compress is None:
        assert got == {"all_reduce_bytes": model["dense_bytes"] / 2,
                       "all_gather_bytes": 0}
    else:
        assert got == {"all_reduce_bytes": 0,
                       "all_gather_bytes": model["shipped_bytes"]}


def test_groups_on_a_two_by_two_mesh(runs):
    """On the (data 2, model 2) mesh (rank = 2 data + model) each rank's
    client is its data coordinate and its row block its model coordinate;
    ``all_gather`` stacks the data group in client order, ``all_reduce``
    sums over the named group, ``median_aggregate`` takes the coordinate
    median of the data group (the mean of two); the byte counter counts a
    payload a call (an all-gather what it receives)."""
    for rank, out in enumerate(runs[3]):
        (line,) = [ln.split()[1:] for ln in out.splitlines()
                   if ln.startswith("COMM ")]
        data, model = divmod(rank, 2)
        assert [int(x) for x in line[:4]] == [data, model, 2, 2]
        assert json.loads(line[4]) == [float(model), float(2 + model)]
        assert float(line[5]) == (1.0 if data == 0 else 5.0)
        assert float(line[6]) == 6.0
        mid = (model + 2 + model) / 2
        assert json.loads(line[7]) == [mid, 3 * mid]
        assert [float(x) for x in line[8:]] == [2 * 8 + 2 * 8, 8.0]


@pytest.mark.parametrize("seed", [0, 7])
def test_own_initial_factors(seed):
    """The port's own initial factors (statistical checks only: the
    reference draws with ``jax.random``): every client's rank draws the
    same U from the seed and its own V_i from ``client_generator(seed,
    i)``, both ~ N(0, 1/r), and a seed gives the same draws again.  A
    stand-in comm places the problem (no process group is needed to
    build one)."""
    m, n, r = 128, 160, 6
    mat = torch.randn(m, n, generator=torch.Generator().manual_seed(1))
    cfg = DCFConfig.tuned(r)

    def draw(client):
        comm = types.SimpleNamespace(clients=E, client=client, model_size=1,
                                     model_index=0, model_axis=None)
        p, layout = dcf_pca.make_sharded_problem(mat, cfg, comm, seed,
                                                 device="cpu")
        assert layout.n_i == n // E and p.blocks.shape == (1, m, n // E)
        return p.u_init, p.v_init[0]

    us, vs = zip(*(draw(i) for i in range(E)))
    assert all(torch.equal(u, us[0]) for u in us)
    assert all(not torch.equal(vs[i], vs[j])
               for i in range(E) for j in range(i))
    for x in (us[0], torch.cat(vs)):
        assert abs(float(x.mean())) < 0.05
        assert abs(float(x.std()) * r ** 0.5 - 1.0) < 0.1
    again = draw(2)
    assert torch.equal(again[0], us[0]) and torch.equal(again[1], vs[2])


# ---------------------------------------------------------------------------
# Robust gradient aggregation and the robust train step
# ---------------------------------------------------------------------------
def test_consensus_compress_tracks_the_reference(runs):
    """Every rank's aggregate from the reference's sketch within 1e-4
    (relative) of the reference's 4-device ``shard_map`` result."""
    _, ref, port, _ = runs
    assert port["byz/robust"].shape == (BYZ["m"], BYZ["k"])
    assert _rel(port["byz/robust"], ref["byz/robust"]) < TRACK_TOL


def test_byzantine_worker_is_rejected(runs):
    """tests/test_multidevice.py:138-179 at E = 4: the consensus aggregate
    within 0.2 of the clean mean (relative) and under a fifth of the plain
    mean's error."""
    inputs, _, port, _ = runs
    clean = inputs["byz/clean"]
    err_robust = _rel(port["byz/robust"], clean)
    err_plain = _rel(inputs["byz/grads"].mean(0), clean)
    assert err_robust < 0.2, err_robust
    assert err_robust < 0.2 * err_plain, (err_robust, err_plain)


@pytest.mark.parametrize("tag", ("byz",) + LM_STEPS)
def test_every_rank_aggregates_the_same(runs, tag):
    """The aggregate's bytes, and the parameters after each LM step, the
    same on every rank (lock-step)."""
    hashes = {ln.split()[2] for out in runs[3] for ln in out.splitlines()
              if ln.startswith(f"HASH {tag} ")}
    assert len(hashes) == 1


def _lm(inputs):
    """The port's smoke LM (fp32), the reference's parameters as the
    port's, and the reference's batch, from the written inputs."""
    from repro_torch import configs, convert
    from repro_torch.models import get_model

    cfg = configs.get_smoke_config(LM_ARCH).replace(
        param_dtype="float32", compute_dtype="float32")
    return (get_model(cfg), cfg,
            convert.lm_params_from_reference(nest(inputs, "lm"), cfg, "cpu"),
            {k: _t(x) for k, x in nest(inputs, "lm_batch").items()})


def _held(port, tag, want):
    """Every parameter of ``port``'s ``tag`` step within 1e-5 of its max
    |p| of ``want`` (the port's ``Params``)."""
    for name, p in want.named_parameters():
        w = p.detach().numpy()
        got = port[f"{tag}/{name}"]
        assert np.max(np.abs(got - w)) <= 1e-5 * np.max(np.abs(w)), name


def test_robust_train_step_runs(runs):
    """tests/test_multidevice.py:182-213 on 4 ranks, from the reference's
    parameters and batch: the loss finite and (the mean of the ranks'
    shard losses before the update) within 1e-5 of the plain full-batch
    loss at the same parameters and batch; at weight decay 0 the
    parameters moved, so the aggregated gradients were not all zero."""
    inputs, _, port, _ = runs
    model, _, params, batch = _lm(inputs)
    loss = float(port["robust_step/loss"])
    with torch.no_grad():
        want, _ = model.loss(params, batch)
    assert np.isfinite(loss)
    assert abs(loss - float(want)) <= 1e-5 * abs(float(want))
    assert float(port["robust_step/moved"]) > 0


def test_robust_train_step_matches_the_reference(runs):
    """The robust step with every leaf on the coordinate-wise median
    (``CompressConfig(min_dim=10**6)``: no sketch drawn) against the
    reference's ``make_robust_train_step`` on its 4-device mesh, from the
    same parameters and batch: the parameters after the update within
    1e-5 of max |p|, the loss within 1e-5 relative."""
    from repro_torch import convert

    inputs, ref, port, _ = runs
    _, cfg, _, _ = _lm(inputs)
    want = convert.lm_params_from_reference(nest(ref, "robust_median"),
                                            cfg, "cpu")
    _held(port, "robust_median", want)
    assert _rel(port["robust_median/loss"], ref["robust_median/loss"]) \
        <= 1e-5
    assert float(port["robust_median/moved"]) > 0


def test_data_parallel_step_matches_one_process(runs):
    """``make_train_step(comm=...)`` over the 4 ranks (each its shard of
    the batch, the gradients averaged by all-reduce) against the same step
    in one process on the whole batch: parameters within 1e-5 of max |p|,
    the loss within 1e-5 relative."""
    from repro_torch.training import optimizer as opt
    from repro_torch.training.train_step import make_train_step

    inputs, _, port, _ = runs
    model, _, params, batch = _lm(inputs)
    params, _, mets = make_train_step(model, opt.AdamWConfig(**LM_OCFG))(
        params, opt.init(params), batch)
    _held(port, "dp_step", params)
    assert _rel(port["dp_step/loss"], mets["loss"].numpy()) <= 1e-5


def test_launcher_over_ranks_matches_one_process(runs):
    """``launch/train.py`` without ``--robust-agg`` under the 4-rank
    harness (one ``data`` axis, each rank its shard of the global batch)
    logs the losses of the same run in one process within 1e-5
    relative."""
    from repro_torch.launch import train as launch_train

    want = [e["loss"] for e in launch_train.main(LAUNCH_ARGV)["log"]]
    got = runs[2]["launcher/losses"]
    assert len(got) == len(want) == 2
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("shape,kw", [
    ((256, 512), {"rank": 8, "rounds": 4}),
    ((256, 512), {"rank": 8, "rounds": 4, "topk_frac": 0.05}),
    ((8, 8), {"rank": 8, "rounds": 4, "topk_frac": 0.05}),
    ((3, 256, 512), {}),
    ((512,), {}),
])
def test_compression_ratio_matches_the_reference(shape, kw):
    """tests/test_multihost.py:64-83's shapes (and a stacked and a 1-D
    leaf): the static bytes ratio equals the reference's."""
    from repro.distributed import grad_compress as jgc

    assert gcomp.compression_ratio(shape, gcomp.CompressConfig(**kw)) == \
        jgc.compression_ratio(shape, jgc.CompressConfig(**kw))
