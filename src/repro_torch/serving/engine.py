"""Batched generation: prefill once, then one decode step a token, as
``repro/serving/engine.py``.

A fixed batch of request slots decodes in lock-step.  Caches are allocated
at ``s_max`` and the prefill writes the prompt's K/V into them (the
reference prefills at the prompt's length and pads out; the values are the
same).  Sampling is greedy (argmax) or by temperature from an explicit
``torch.Generator`` (other bits than ``jax.random``).

The reference runs the whole decode as one jitted ``lax.scan``.  Here, on
the card, the decode step is captured once in a CUDA graph over static
buffers (the token, the position as a 0-d device tensor that the graph
advances, the caches, the logits and the output tokens) and replayed: the
first decode step runs eagerly, as the warm-up, and the graph then
replays every later one.  Greedy argmax sits inside the graph; a
temperature sample runs after each replay from the static logits, with the
caller's generator, so the tokens are the eager ones.  The prefill stays
eager.  On the CPU (or with ``eager=True``, which only the tests and
``chip_smoke.py`` use) every step runs eagerly through the same step
function.  Tokens stay on the device until the caller reads them.
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
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def generate(model: Model, params, prompt: torch.Tensor,
             scfg: ServeConfig = ServeConfig(),
             generator: torch.Generator | None = None,
             s_max: int | None = None, *, eager: bool = False
             ) -> torch.Tensor:
    """Greedy or temperature decoding of ``prompt`` (B, S_prompt) on its
    device.  Returns (B, max_new_tokens) token ids.

    On a CUDA device the decode steps after the first replay one captured
    step, from ``runtime.MIN_GRAPH_ROUNDS`` decode steps on
    (``eager=True`` runs them all eagerly)."""
    b, s_prompt = prompt.shape
    steps = scfg.max_new_tokens - 1
    s_max = s_max or (s_prompt + scfg.max_new_tokens)
    device = prompt.device
    caches = model.init_cache(b, s_max, device)
    logits, caches = model.prefill(params, prompt, caches)
    tok = _sample(logits, generator, scfg.temperature)
    out = torch.empty(b, scfg.max_new_tokens, dtype=tok.dtype, device=device)
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
                                           state["pos"])
        state["logits"].copy_(step_logits)
        if greedy:
            nxt = torch.argmax(step_logits, dim=-1)
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

    use_graph = (device.type == "cuda" and not eager
                 and steps >= rt.MIN_GRAPH_ROUNDS)
    if use_graph:
        graph = rt.CapturedRound(decode, device)  # runs the first step
        sample(1)
        for col in range(2, steps + 1):
            graph.replay()
            sample(col)
    else:
        for col in range(1, steps + 1):
            decode()
            sample(col)
    return out
