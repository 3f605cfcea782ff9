"""Train-step builders, as ``repro/training/train_step.py``.

``make_train_step``          loss and gradients (with optional microbatch
                             accumulation in fp32), then AdamW.  Under
                             several ranks (a ``multihost.MeshComm`` whose
                             data group has more than one rank) each rank
                             takes its shard of the global batch and the
                             gradients and metrics are averaged over the
                             group by all-reduce: what XLA inserts for the
                             reference on a data-parallel mesh.

``make_robust_train_step``   DCF-PCA aggregation: each rank computes the
                             gradients of its batch shard, and every large
                             2-D gradient is aggregated by consensus
                             factorization instead of a plain mean
                             (``distributed.grad_compress.aggregate_tree``);
                             each rank holds whole parameters.

A step turns ``requires_grad`` on for the parameters it trains, takes the
gradients with ``torch.autograd.grad`` (no ``.grad`` buffers) and reads
nothing on the host: the loss and metrics come back as 0-d device tensors.
The step runs eagerly (capturing it in a CUDA graph is later work,
ROADMAP.md).
"""
from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from repro_torch.distributed import grad_compress as gc
from repro_torch.distributed.sharding import SINGLE_DEVICE, ShardingRules
from repro_torch.models import Model
from repro_torch.training import optimizer as opt

Tensor = torch.Tensor


def _trainable(params: nn.Module) -> tuple[list[str], list[Tensor]]:
    names, leaves = [], []
    for name, p in params.named_parameters():
        p.requires_grad_(True)
        names.append(name)
        leaves.append(p)
    return names, leaves


def _shard(batch: dict[str, Tensor], comm) -> dict[str, Tensor]:
    """This rank's rows of the global batch (its data coordinate's block)."""
    if comm is None or comm.clients == 1:
        return batch
    out = {}
    for key, x in batch.items():
        rows = x.shape[0] // comm.clients
        if rows * comm.clients != x.shape[0]:
            raise ValueError(
                f"global batch {x.shape[0]} does not split over "
                f"{comm.clients} data-parallel ranks")
        out[key] = x[comm.client * rows:(comm.client + 1) * rows]
    return out


def _mean_over(comm, x: Tensor) -> Tensor:
    return comm.all_reduce(x) / comm.clients


def _loss_and_grads(model: Model, params: nn.Module,
                    batch: dict[str, Tensor]):
    names, leaves = _trainable(params)
    loss, mets = model.loss(params, batch)
    grads = torch.autograd.grad(loss, leaves)
    return (loss.detach(), {k: v.detach() for k, v in mets.items()},
            dict(zip(names, grads)))


def make_train_step(model: Model, opt_cfg: opt.AdamWConfig,
                    rules: ShardingRules = SINGLE_DEVICE, *,
                    microbatches: int = 1, comm=None) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, state,
    {"loss", "ce", "aux", "grad_norm", "lr"})``; ``batch`` is the global
    batch.  ``microbatches`` > 1 splits it along dim 0 and accumulates the
    gradients in fp32, each divided by the count (the loss likewise; the
    other metrics are the last microbatch's).  ``comm`` (a
    ``multihost.MeshComm``) makes the step data-parallel over its data
    group.  ``rules`` may bind only data axes
    (``ShardingRules.check``)."""
    rules.check("tp", "sp", "ep")

    def fwd_bwd(params, batch):
        if microbatches == 1:
            return _loss_and_grads(model, params, batch)
        size = next(iter(batch.values())).shape[0] // microbatches
        acc, loss_sum, mets = None, None, None
        for i in range(microbatches):
            mb = {k: x[i * size:(i + 1) * size] for k, x in batch.items()}
            loss, mets, grads = _loss_and_grads(model, params, mb)
            grads = {n: g.to(torch.float32) / microbatches
                     for n, g in grads.items()}
            if acc is None:
                acc, loss_sum = grads, loss / microbatches
            else:
                acc = {n: acc[n] + g for n, g in grads.items()}
                loss_sum = loss_sum + loss / microbatches
        return loss_sum, mets, acc

    def train_step(params, opt_state, batch):
        loss, mets, grads = fwd_bwd(params, _shard(batch, comm))
        if comm is not None and comm.clients > 1:
            grads = {n: _mean_over(comm, g) for n, g in grads.items()}
            loss = _mean_over(comm, loss)
            mets = {k: _mean_over(comm, v) for k, v in mets.items()}
        params, opt_state, om = opt.update(opt_cfg, grads, opt_state, params)
        return params, opt_state, {"loss": loss, **mets, **om}

    return train_step


def make_robust_train_step(model: Model, opt_cfg: opt.AdamWConfig, mesh,
                           rules: ShardingRules,
                           ccfg: gc.CompressConfig) -> Callable:
    """DCF-PCA consensus gradient aggregation across the data axes of
    ``mesh`` (a ``DeviceMesh``, one rank a process).  Returns
    ``train_step(params, opt_state, batch, key) -> (params, state,
    metrics)``: ``batch`` is the global batch, ``key`` a seed (the
    launcher's ``fold_in(KEY, i)``: a generator on the device seeded with
    it) or a ``torch.Generator`` for the sketches, the same on every rank.
    The loss and metrics are averaged over the data group."""
    dp_axes = rules.dp
    if dp_axes is None:
        raise ValueError("robust aggregation needs a DP mesh axis")
    dp_axes = tuple(dp_axes) if isinstance(dp_axes, (tuple, list)) \
        else (dp_axes,)
    rules.check("tp", "sp", "ep")
    from repro_torch.distributed.multihost import MeshComm

    comm = MeshComm(mesh, dp_axes)

    def train_step(params, opt_state, batch, key):
        loss, mets, grads = _loss_and_grads(model, params,
                                            _shard(batch, comm))
        gen = key if isinstance(key, torch.Generator) else \
            torch.Generator(device=loss.device).manual_seed(key)
        grads = gc.aggregate_tree(grads, comm, ccfg, gen)
        loss = _mean_over(comm, loss)
        mets = {k: _mean_over(comm, v) for k, v in mets.items()}
        params, opt_state, om = opt.update(opt_cfg, grads, opt_state, params)
        return params, opt_state, {"loss": loss, **mets, **om}

    return train_step
