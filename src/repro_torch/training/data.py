"""Deterministic synthetic token pipeline, as ``repro/training/data.py``.

Batch ``i`` is a pure function of ``(seed, i)``: drawn from the port's own
explicit generator on the data's device (a CUDA generator on the card),
seeded with :func:`fold_in` of the two, so any rank can regenerate any
batch after a restart and a checkpoint holds the cursor as one integer.
The bits differ from ``jax.random``'s: the port's data gets statistical
checks, and parity tests feed the reference's batches.

The sequence is the reference's Markov chain: a fixed random permutation
``perm`` of the vocabulary; each next token is ``perm[previous]`` with
probability ``signal``, else uniform noise.  The chain is evaluated without
a loop over positions: a position's token is ``perm`` applied ``d`` times
to the last noise token at or before it (or to the first token), and
``perm^d`` comes from the tables ``perm^(2^j)`` (binary lifting).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.device import resolve_device
from repro_torch.models import CONTEXT_FAMILIES
from repro_torch.models.lm import ctx_len

Tensor = torch.Tensor


def fold_in(seed: int, index: int) -> int:
    """A generator seed for item ``index`` of stream ``seed`` (the
    reference's ``jax.random.fold_in``): distinct for distinct pairs."""
    return (int(seed) << 32) | (int(index) & 0xFFFFFFFF)


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    # Markov-chain synthetic text: the next token follows the previous one
    # through a fixed random permutation, with noise: a learnable signal.
    signal: float = 0.7


class SyntheticData:
    """Global batches of ``shape.global_batch`` x ``shape.seq_len`` int32
    ``tokens`` and ``labels`` (the next tokens) on ``device`` (the card
    unless ``"cpu"``).  The ``encdec`` and ``vlm`` families' batches also
    carry a ``ctx``: (B, n_context_tokens, d_model) standard normal in the
    compute type (the stub frame or patch embeddings), drawn after the
    tokens from the batch's generator."""

    def __init__(self, cfg: ModelConfig, shape: ShapeSpec,
                 data_cfg: DataConfig = DataConfig(),
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.shape = shape
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        gen = torch.Generator(device=self.device).manual_seed(data_cfg.seed)
        self.perm = torch.randperm(cfg.vocab, generator=gen,
                                   device=self.device)
        # perm^(2^j) for the chain's longest run (seq_len + 1 applications).
        self._powers = [self.perm]
        while 1 << len(self._powers) <= shape.seq_len + 1:
            last = self._powers[-1]
            self._powers.append(last[last])

    def _apply_perm(self, x: Tensor, times: Tensor) -> Tensor:
        """``perm`` applied ``times`` times to each entry of ``x``."""
        for j, table in enumerate(self._powers):
            x = torch.where((times >> j) & 1 == 1, table[x], x)
        return x

    def batch_at(self, index: int) -> dict[str, Tensor]:
        """Global batch for step ``index`` (a pure function of it)."""
        b, s, vocab = self.shape.global_batch, self.shape.seq_len, \
            self.cfg.vocab
        gen = torch.Generator(device=self.device).manual_seed(
            fold_in(self.data_cfg.seed, index))
        kw = dict(generator=gen, device=self.device)
        first = torch.randint(0, vocab, (b, 1), **kw)
        noise = torch.randint(0, vocab, (b, s), **kw)
        use_sig = torch.rand((b, s), **kw) < self.data_cfg.signal
        # x_t = perm[x_{t-1}] where use_sig[t], else noise[t]; x_{-1} = first.
        pos = torch.arange(s, device=self.device).expand(b, s)
        reset = torch.where(use_sig, -1, pos).cummax(dim=1).values
        start = torch.where(reset >= 0,
                            noise.gather(1, reset.clamp_min(0)), first)
        labels = self._apply_perm(start, pos - reset)
        tokens = torch.cat([first, labels[:, :-1]], dim=1)
        batch = {"tokens": tokens.to(torch.int32),
                 "labels": labels.to(torch.int32)}
        if self.cfg.family in CONTEXT_FAMILIES:
            batch["ctx"] = torch.randn(
                (b, ctx_len(self.cfg), self.cfg.d_model), **kw).to(
                    self.cfg.cdtype)
        return batch
