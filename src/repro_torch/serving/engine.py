"""Batched generation: prefill once, then one decode step a token, as
``repro/serving/engine.py``.

A fixed batch of request slots decodes in lock-step.  Caches are allocated
at ``s_max`` and the prefill writes the prompt's K/V into them (the
reference prefills at the prompt's length and pads out; the values are the
same).  Sampling is greedy (argmax) or by temperature from an explicit
``torch.Generator`` (other bits than ``jax.random``).  The decode loop is a
Python loop over steps; tokens stay on the device until the caller reads
them.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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
             s_max: int | None = None) -> torch.Tensor:
    """Greedy or temperature decoding of ``prompt`` (B, S_prompt) on its
    device.  Returns (B, max_new_tokens) token ids."""
    b, s_prompt = prompt.shape
    s_max = s_max or (s_prompt + scfg.max_new_tokens)
    caches = model.init_cache(b, s_max, prompt.device)
    logits, caches = model.prefill(params, prompt, caches)
    tok = _sample(logits, generator, scfg.temperature)
    out = [tok]
    for step in range(scfg.max_new_tokens - 1):
        logits, caches = model.decode_step(params, tok[:, None], caches,
                                           s_prompt + step)
        tok = _sample(logits, generator, scfg.temperature)
        out.append(tok)
    return torch.stack(out, dim=1)
