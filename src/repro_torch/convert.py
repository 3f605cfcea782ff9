"""Carry a problem, a config or LM parameters across from the JAX reference.

``jax.random`` and ``torch.Generator`` give different numbers from the same
seed, so a comparison of the two packages starts both from the same
factors: build the problem with the reference (``repro.core.dcf_pca.
make_problem``, ``cf_pca.make_problem``, or the convex solvers'
``_problem``), then hand it here.  Fields are
read by name and converted through numpy; nothing of the reference is
imported.  A bf16 data plane stays bf16 and a bit-packed mask stays uint8.
LM weights likewise: the reference materialises them, the port takes them
(:func:`lm_params_from_reference`; a rank's slices of them over a model
axis), and so with training state: a gradient
tree and an ``AdamWState`` (:func:`lm_grads_from_reference`,
:func:`adamw_state_from_reference`).  A rank of the sharded engine takes its
share of the reference's initial factors
(:func:`sharded_problem_from_reference`).
"""
from __future__ import annotations

from dataclasses import fields
from typing import Any

import numpy as np
import torch

from repro_torch.core.apgm import APGMProblem
from repro_torch.core.cf_pca import CFProblem
from repro_torch.core.dcf_pca import DCFProblem, ShardLayout, ShardProblem
from repro_torch.core.factorized import DCFConfig
from repro_torch.core.ialm import IALMProblem
from repro_torch.device import resolve_device
from repro_torch.distributed.grad_compress import CompressConfig
from repro_torch.models import get_model, lm
from repro_torch.models.params import Params, module_specs, shard_tensor
from repro_torch.training.optimizer import AdamWState


def config_from_reference(ref_cfg: Any) -> DCFConfig:
    """The port's :class:`DCFConfig` with every field read from
    ``ref_cfg`` by name (the reference's ``impl="pallas"`` becomes
    ``"cuda"``, its ``CompressConfig`` the port's)."""
    kw = {f.name: getattr(ref_cfg, f.name) for f in fields(DCFConfig)}
    if kw["impl"] == "pallas":
        kw["impl"] = "cuda"
    if kw["consensus_compress"] is not None:
        kw["consensus_compress"] = CompressConfig(**{
            f.name: getattr(kw["consensus_compress"], f.name)
            for f in fields(CompressConfig)})
    return DCFConfig(**kw)


def _tensor(x: Any, device: torch.device | str,
            dtype: torch.dtype | None = torch.float32) -> torch.Tensor | None:
    """``x`` through numpy onto ``device``, cast to ``dtype``; with
    ``dtype=None`` a bf16 array stays bf16 (numpy has no bf16: JAX gives
    ``ml_dtypes.bfloat16``, carried as its uint16 bits), a uint8 one
    (a bit-packed mask) stays uint8, and anything else becomes fp32."""
    if x is None:
        return None
    arr = np.array(x)  # a writable, contiguous copy
    if dtype is None and arr.dtype.name == "bfloat16":
        bits = torch.from_numpy(arr.view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    if dtype is None and arr.dtype == np.uint8:
        return torch.from_numpy(arr).to(device)
    return torch.from_numpy(arr).to(device=device,
                                    dtype=dtype or torch.float32)


_CONVEX = {"APGMProblem": APGMProblem, "IALMProblem": IALMProblem}


def problem_from_reference(ref_problem: Any, device: torch.device | str
                           ) -> DCFProblem | CFProblem | APGMProblem | IALMProblem:
    """The port's problem from a reference ``DCFProblem`` (it has
    ``blocks``), ``CFProblem`` (it has ``m_obs``), ``APGMProblem`` or
    ``IALMProblem`` (they have ``l_init``; the class of the same name), on
    ``device``.  A ``DCFProblem``'s participation schedule crosses as fp32
    and its fault table as int32.  A batch of reference problems (made by
    ``jax.vmap`` of their ``make_problem``: a leading problem axis on every
    field) crosses as the port's batch of the same shapes, which the
    solvers' ``solve_problem`` and ``runtime.solve_batch`` take."""
    if hasattr(ref_problem, "l_init"):
        return _CONVEX[type(ref_problem).__name__](
            m_obs=_tensor(ref_problem.m_obs, device),
            l_init=_tensor(ref_problem.l_init, device),
            s_init=_tensor(ref_problem.s_init, device),
            mask=_tensor(ref_problem.mask, device),
            lam0=_tensor(ref_problem.lam0, device),
        )
    common = dict(
        u_init=_tensor(ref_problem.u_init, device),
        v_init=_tensor(ref_problem.v_init, device),
        lam0=_tensor(ref_problem.lam0, device),
        t0=_tensor(ref_problem.t0, device, torch.int32),
        mask=_tensor(ref_problem.mask, device, None),
    )
    if not hasattr(ref_problem, "blocks"):
        return CFProblem(m_obs=_tensor(ref_problem.m_obs, device, None),
                         **common)
    return DCFProblem(
        blocks=_tensor(ref_problem.blocks, device, None),
        n_cols=_tensor(ref_problem.n_cols, device),
        participation=_tensor(getattr(ref_problem, "participation", None),
                              device),
        faults=_tensor(getattr(ref_problem, "faults", None), device,
                       torch.int32),
        **common)


def sharded_problem_from_reference(problem: ShardProblem,
                                   layout: ShardLayout, u_init: Any,
                                   v_init: Any, participation: Any = None
                                   ) -> ShardProblem:
    """This rank's sharded problem (``core.dcf_pca.make_sharded_problem``)
    with the reference's initial factors and, optionally, its drawn
    participation schedule: ``u_init`` the (m, r) server broadcast,
    ``v_init`` every client's V_i, client-major as (E n_i, r) or
    (E, n_i, r) over the padded split, and ``participation`` the (T, E)
    schedule.  The rank keeps its row block of U and its client's V_i."""
    comm, dev = layout.comm, problem.lam0.device
    rows = slice(comm.model_index * layout.m_loc,
                 (comm.model_index + 1) * layout.m_loc)
    u = _tensor(u_init, dev)[rows].contiguous()
    v = _tensor(v_init, dev).reshape(comm.clients, layout.n_i, -1)
    out = problem._replace(u_init=u, v_init=v[comm.client][None].contiguous())
    if participation is not None:
        out = out._replace(participation=_tensor(participation, dev))
    return out


def _layer_node(tree_np: Any, cfg: Any, layer: int
                ) -> tuple[Any, int | tuple[int, int]]:
    """The reference's subtree that stacks layer ``layer``'s leaves, and the
    layer's index on their leading axes: segment ``i`` of ``stack_plan``
    for the uniform stacks, ``groups["layer{L % period}"]`` at group
    ``L // period`` for the hybrid, the VLM's ``groups["self"]`` at
    (group, position) (two leading axes) or ``groups["cross"]`` at the
    group, the encoder-decoder's ``decoder`` at ``L``."""
    if cfg.family == "hybrid":
        period = cfg.attn_period
        return tree_np["groups"][f"layer{layer % period}"], layer // period
    if cfg.family == "vlm":
        group, at = divmod(layer, cfg.cross.every_k_layers)
        if at == cfg.cross.every_k_layers - 1:
            return tree_np["groups"]["cross"], group
        return tree_np["groups"]["self"], (group, at)
    if cfg.family == "encdec":
        return tree_np["decoder"], layer
    for i, seg in enumerate(lm.stack_plan(cfg)):
        if layer < seg.count:
            return tree_np["segments"][i], layer
        layer -= seg.count
    raise IndexError(f"{cfg.name} has no layer {layer}")


def _lm_leaf(tree_np: Any, name: str, cfg: Any) -> np.ndarray:
    """The leaf of the reference's LM tree (``embed``, the stacked layers,
    ``ln_f``; ``encoder`` and ``ln_enc`` of the encoder-decoder) that the
    port's parameter ``name`` (``layers.<L>.<...>``, ``encoder.<L>.<...>``
    or a top-level path) stands for."""
    parts = name.split(".")
    if parts[0] in ("layers", "encoder"):
        layer = int(parts[1])
        node, index = (_layer_node(tree_np, cfg, layer)
                       if parts[0] == "layers"
                       else (tree_np["encoder"], layer))
        for part in parts[2:]:
            node = node[part]
        return np.asarray(node)[index]
    node = tree_np
    for part in parts:
        node = node[part]
    return node


def _lm_named(tree_np: Any, cfg: Any, device: torch.device,
              dtype: torch.dtype | None) -> dict[str, torch.Tensor]:
    """Every parameter name of the LM ``cfg`` with its leaf of ``tree_np``
    on ``device`` (``dtype`` None: bf16 stays bf16), each checked against
    the port's shape."""
    out = {}
    for name, p in get_model(cfg).empty_params("meta").named_parameters():
        t = _tensor(_lm_leaf(tree_np, name, cfg), device, dtype)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {tuple(t.shape)}, "
                             f"port {tuple(p.shape)}")
        out[name] = t
    return out


@torch.no_grad()
def lm_params_from_reference(params_np: Any, cfg: Any,
                             device: torch.device | str | None = None,
                             rules: Any = None) -> Params:
    """The port's parameters of the LM ``cfg`` (a port ``ModelConfig`` of
    any family :func:`~repro_torch.models.get_model` builds) from the
    reference's params tree, as numpy arrays: ``embed`` (``table``,
    ``unembed``), the layers (every ``segments[i]``, each leaf stacked
    (count, ...) over the segment's layers; the hybrid's
    ``groups["layer{i}"]`` stacked over the groups; the VLM's
    ``groups["self"]`` stacked (groups, self layers, ...) and
    ``groups["cross"]`` (groups, ...); the encoder-decoder's ``encoder``
    and ``decoder``, with ``ln_enc``) and ``ln_f``.  Layers are unstacked
    into the port's flat lists;
    the port keeps the reference's (in, out) weight layout, so nothing is
    transposed.  bf16 leaves cross as their bits.  The parameters land on
    the card unless ``device`` says otherwise.  With ``rules`` over a model
    axis larger than 1 (``sharding.rules_for_mesh``), the per-rank form:
    each leaf sliced by its spec's axes to this rank's part
    (``Model.empty_params(device, rules)``)."""
    device = resolve_device(device)
    params = get_model(cfg).empty_params(device, rules)
    named = _lm_named(params_np, cfg, device, None)
    specs = module_specs(params)
    for name, p in params.named_parameters():
        p.copy_(shard_tensor(named[name], specs[name]).to(p.dtype))
    return params


def lm_grads_from_reference(grads_np: Any, cfg: Any,
                            device: torch.device | str | None = None
                            ) -> dict[str, torch.Tensor]:
    """A gradient tree of the reference's LM (the params tree's layout, as
    numpy) as the port's gradient dict, by parameter name, unstacked like
    :func:`lm_params_from_reference` (bf16 stays bf16)."""
    return _lm_named(grads_np, cfg, resolve_device(device), None)


def adamw_state_from_reference(state_np: Any, cfg: Any,
                               device: torch.device | str | None = None
                               ) -> AdamWState:
    """The reference's ``AdamWState`` (``step``, ``m``, ``v``, as numpy) as
    the port's: ``step`` int32, ``m`` and ``v`` fp32 dicts by parameter
    name, unstacked like :func:`lm_params_from_reference`."""
    device = resolve_device(device)
    return AdamWState(
        step=_tensor(state_np.step, device, torch.int32),
        m=_lm_named(state_np.m, cfg, device, torch.float32),
        v=_lm_named(state_np.v, cfg, device, torch.float32))
