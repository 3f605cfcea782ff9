"""Batched generation: prefill once, then one decode step a token, as
``repro/serving/engine.py``.

A fixed batch of request slots decodes in lock-step.  Caches are allocated
at ``s_max``, one a layer of its kind (``Model.init_cache``): the prefill
writes an attention layer's prompt K/V (or MLA's latent) into ``[:, :S]``
of its sequence buffers and copies an SSD layer's state (conv tail and SSM
state, which have no sequence axis) and a cross layer's context K/V (at
the context's length) into their own.  The ``vlm`` and ``encdec``
families take their context ``ctx`` here; only the prefill sees it (the
reference's ``generate`` passes none, so it cannot serve them).  The
reference prefills at the prompt's length and pads the sequence caches
out (``_pad_caches``; SSM states and context K/V pass through); the values
are the same.  Sampling is greedy (argmax) or by temperature from an
explicit ``torch.Generator`` (other bits than ``jax.random``).

The reference runs the whole decode as one jitted ``lax.scan``.  Here, on
the card, the decode step is captured once in a CUDA graph over static
buffers (the token, the position as a 0-d device tensor that the graph
advances, the caches, the logits and the output tokens) and replayed: the
first decode step runs eagerly, as the warm-up, and the graph then
replays every later one; every cache, SSM states included, is updated in
place, so the graph's buffers carry them.  Greedy argmax sits inside the
graph; a
temperature sample runs after each replay from the static logits, with the
caller's generator, so the tokens are the eager ones.  The prefill stays
eager.  Generation runs under ``torch.no_grad()``: parameters that a train
step made require gradients bring no autograd state into the captured
step.  On the CPU (or with ``eager=True``, which only the tests and
``chip_smoke.py`` use) every step runs eagerly through the same step
function.  Tokens stay on the device until the caller reads them.

With the reference's ``rules`` over a mesh whose model axis has t > 1
ranks (``sharding.rules_for_mesh``), every rank of the mesh calls
``generate`` with the same prompt and its own slices of the parameters
(``Model.init_params(seed, device, rules)``), and the ``ctx`` of a
context family: every family's prefill and decode run tensor-parallel
(``models.parallel``), every rank samples
from the whole logits, and every rank returns the same tokens (a
temperature sample needs the same generator state on every rank).  The
decode step is captured only where its collectives can be
(``MeshComm.capturable``: NCCL); over gloo, whose collectives run on the
host, every step runs eagerly.  ``return_info=True`` returns, beside the
tokens, how the decode ran (``{"decode": "captured" | "eager", "why":
...}``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import runtime as rt
from repro_torch.models import Model


@dataclass(frozen=True)
class ServeConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0  # 0 => greedy
    eos_id: int = -1  # -1 => never stop early


def _sample(logits: torch.Tensor, generator: torch.Generator | None,
            temperature: float) -> torch.Tensor:
    """The next tokens, int32 on both branches (as the reference's)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


@torch.no_grad()
def generate(model: Model, params, prompt: torch.Tensor,
             scfg: ServeConfig = ServeConfig(),
             generator: torch.Generator | None = None,
             s_max: int | None = None, *, eager: bool = False,
             ctx: torch.Tensor | None = None, rules=None,
             return_info: bool = False):
    """Greedy or temperature decoding of ``prompt`` (B, S_prompt) on its
    device, with the context ``ctx`` (B, T, d_model) for the ``vlm`` and
    ``encdec`` families.  Returns (B, max_new_tokens) int32 token ids (the
    next token goes back in as int32; the embedding gathers at int32
    indices).

    On a CUDA device the decode steps after the first replay one captured
    step, from ``runtime.MIN_GRAPH_ROUNDS`` decode steps on
    (``eager=True`` runs them all eagerly), unless the ``rules``' model
    axis runs collectives that cannot be captured (gloo)."""
    b, s_prompt = prompt.shape
    steps = scfg.max_new_tokens - 1
    s_max = s_max or (s_prompt + scfg.max_new_tokens)
    device = prompt.device
    tp = model.tensor_parallel(rules)
    caches = model.init_cache(b, s_max, device, rules=rules)
    logits, caches = model.prefill(params, prompt, caches, ctx=ctx,
                                   rules=rules)
    tok = _sample(logits, generator, scfg.temperature)
    out = torch.empty(b, scfg.max_new_tokens, dtype=torch.int32,
                      device=device)
    out[:, 0] = tok
    greedy = scfg.temperature <= 0.0
    # The decode step's static buffers: the graph reads the token and the
    # position and writes the logits, the caches and (greedy) the next
    # token and its column of ``out``.
    state = {"tok": tok[:, None].contiguous(),
             "pos": torch.full((), s_prompt, dtype=torch.int32,
                               device=device),
             "col": torch.ones((), dtype=torch.int64, device=device),
             "logits": torch.empty_like(logits)}

    def decode() -> None:
        step_logits, _ = model.decode_step(params, state["tok"], caches,
                                           state["pos"], rules=rules)
        state["logits"].copy_(step_logits)
        if greedy:
            nxt = _sample(step_logits, None, 0.0)
            out.index_copy_(1, state["col"].reshape(1), nxt[:, None])
            state["tok"].copy_(nxt[:, None])
        state["pos"].add_(1)
        state["col"].add_(1)

    def sample(col: int) -> None:
        """A temperature step's token, after the step ran."""
        if not greedy:
            nxt = _sample(state["logits"], generator, scfg.temperature)
            out[:, col] = nxt
            state["tok"].copy_(nxt[:, None])

    why = ("not a CUDA device" if device.type != "cuda"
           else "eager=True" if eager
           else f"{steps} decode steps" if steps < rt.MIN_GRAPH_ROUNDS
           else "the model axis's collectives run on the host (gloo)"
           if tp is not None and not tp.comm.capturable else None)
    if why is None:
        graph = rt.CapturedRound(decode, device)  # runs the first step
        sample(1)
        for col in range(2, steps + 1):
            graph.replay()
            sample(col)
    else:
        for col in range(1, steps + 1):
            decode()
            sample(col)
    if return_info:
        return out, {"decode": "eager" if why else "captured", "why": why}
    return out
