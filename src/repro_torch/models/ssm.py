"""Mamba-2 SSD mixer (state-space duality, arXiv:2405.21060), as
``repro/models/ssm.py``.

Prefill and training run the chunked SSD algorithm: within a chunk the
quadratic ("dual") form over a (B, G, cl, cl) score block, across chunks a
linear recurrence that carries the fp32 (B, H, N, P) state.  The reference
scans the chunks with ``lax.scan``; here a Python loop over chunks carries
the state.  Decode carries a constant-size state: the (B, H, N, P) SSM
state and the last ``d_conv - 1`` pre-conv channel values.

Casts are the reference's: scores, the decay matrix and the states are
fp32, each chunk's output is cast to the compute type, the skip term
``d_skip`` is taken in the compute type in :func:`ssd` and in fp32 in
:func:`ssd_decode`.  The padding too: the raw ``dt`` is padded with zeros
and ``softplus`` applied after, so each padded step of an unaligned prompt
still decays the final state by ``exp(-softplus(dt_bias) * exp(a_log))``
(ROADMAP.md, Queue 3); the per-token outputs are unaffected.

Everything here is plain PyTorch: the reference computes SSD outside any
Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import axis_if, rmsnorm, tp_ok
from repro_torch.models.params import ParamSpec

Tensor = torch.Tensor


class SSMState(NamedTuple):
    conv: Tensor  # (B, d_conv - 1, conv_dim), compute type
    ssm: Tensor  # (B, H, N, P), fp32


def _dims(cfg: ModelConfig) -> tuple[int, int, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, heads, conv_dim


def ssm_specs(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in, heads, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    f32 = torch.float32
    # The reference's axes (declarations: the port refuses SSD over a
    # model axis larger than 1 at build).
    in_tp = axis_if(tp_ok(d_in), "tp")
    rep = (None,)
    return {
        "w_z": ParamSpec((d, d_in), cfg.pdtype, axes=("fsdp", in_tp)),
        "w_x": ParamSpec((d, d_in), cfg.pdtype, axes=("fsdp", in_tp)),
        "w_b": ParamSpec((d, gn), cfg.pdtype, axes=("fsdp", None)),
        "w_c": ParamSpec((d, gn), cfg.pdtype, axes=("fsdp", None)),
        "w_dt": ParamSpec((d, heads), cfg.pdtype, axes=("fsdp", None)),
        "conv_x": ParamSpec((s.d_conv, d_in), cfg.pdtype, scale=0.5,
                            axes=(None, in_tp)),
        "conv_b": ParamSpec((s.d_conv, gn), cfg.pdtype, scale=0.5,
                            axes=(None, None)),
        "conv_c": ParamSpec((s.d_conv, gn), cfg.pdtype, scale=0.5,
                            axes=(None, None)),
        "a_log": ParamSpec((heads,), f32, init="zeros", axes=rep),
        "dt_bias": ParamSpec((heads,), f32, init="zeros", axes=rep),
        "d_skip": ParamSpec((heads,), f32, init="ones", axes=rep),
        "gate_norm": ParamSpec((d_in,), f32, init="ones", axes=rep),
        "out_proj": ParamSpec((d_in, d), cfg.pdtype, axes=(in_tp, "fsdp")),
    }


def _causal_conv(x: Tensor, kernel: Tensor) -> Tensor:
    """Depthwise causal 1-D conv.  x: (B, S, C), kernel: (K, C); the taps
    added in the reference's order."""
    k = kernel.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]] * kernel[i]
    return out


def _proj_inputs(params, h: Tensor, cfg: ModelConfig):
    cd = cfg.cdtype
    z = h @ params.w_z.to(cd)
    x = h @ params.w_x.to(cd)
    bb = h @ params.w_b.to(cd)
    cc = h @ params.w_c.to(cd)
    dt = (h @ params.w_dt.to(cd)).to(torch.float32)
    return z, x, bb, cc, dt


def _chunk_step(state: Tensor, xc: Tensor, bc: Tensor, cc: Tensor,
                dac: Tensor, dtc: Tensor, cfg: ModelConfig
                ) -> tuple[Tensor, Tensor]:
    """One chunk: (B, cl, H, P) inputs, (B, cl, G, N) B and C, (B, cl, H)
    log-decays and steps; returns the next state and the chunk's output
    (B, cl, H, P) in the compute type.  Works head-major, (B, G, hg, cl,
    .), so every contraction is one batched matmul."""
    s = cfg.ssm
    b, cl, heads, p = xc.shape
    g, n = s.n_groups, s.d_state
    hg = heads // g
    f32 = torch.float32
    cum = torch.cumsum(dac.transpose(1, 2), dim=-1)  # (B, H, cl)
    total = cum[..., -1:]  # (B, H, 1)
    xdt = (xc * dtc[..., None]).to(f32).transpose(1, 2).reshape(
        b, g, hg, cl, p)  # the discretized input
    bt = bc.to(f32).transpose(1, 2)[:, :, None]  # (B, G, 1, cl, N)
    ct = cc.to(f32).transpose(1, 2)[:, :, None]

    # Intra-chunk (the dual quadratic form).  The reference's three-operand
    # einsum "bgij,bijgh,bjghp->bighp" in two steps: scores x decays, then
    # x inputs, so no (B, cl, cl, H, P) intermediate is built.  Decays above
    # the diagonal are masked before exp (exp(-inf) = 0: the reference's
    # values, and no inf times 0 in backward).
    scores = ct @ bt.transpose(-1, -2)  # (B, G, 1, i, j)
    decay = cum[..., :, None] - cum[..., None, :]  # (B, H, i, j)
    causal = torch.ones(cl, cl, dtype=torch.bool, device=xc.device).tril()
    l_mat = torch.exp(decay.masked_fill(~causal, float("-inf")))
    y = (scores * l_mat.reshape(b, g, hg, cl, cl)) @ xdt  # (B, G, hg, i, P)

    # Inter-chunk: the carried state's contribution.
    state = state.reshape(b, g, hg, n, p)
    y = y + (ct * torch.exp(cum).reshape(b, g, hg, cl, 1)) @ state

    # The state for the next chunk: inputs decayed to the chunk's end.
    b_dec = bt * torch.exp(total - cum).reshape(b, g, hg, cl, 1)
    new_state = b_dec.transpose(-1, -2) @ xdt + torch.exp(total).reshape(
        b, g, hg, 1, 1) * state
    y = y.permute(0, 3, 1, 2, 4).reshape(b, cl, heads, p)
    return new_state.reshape(b, heads, n, p), y.to(cfg.cdtype)


def _ssd(params, h: Tensor, cfg: ModelConfig,
         initial_state: Tensor | None = None
         ) -> tuple[Tensor, Tensor, Tensor]:
    """:func:`ssd`'s output, its final state and the pre-conv channel
    values ``[x, B, C]`` (B, S, conv_dim) that a decode continues from."""
    s = cfg.ssm
    cd = cfg.cdtype
    b, sl, _ = h.shape
    d_in, heads, _ = _dims(cfg)
    g, n, p = s.n_groups, s.d_state, s.head_dim

    z, x, bb, cc, dt = _proj_inputs(params, h, cfg)
    pre = torch.cat([x, bb, cc], dim=-1)
    x = F.silu(_causal_conv(x, params.conv_x.to(cd)))
    bb = F.silu(_causal_conv(bb, params.conv_b.to(cd)))
    cc = F.silu(_causal_conv(cc, params.conv_c.to(cd)))

    cl = min(s.chunk, sl)
    pad = (-sl) % cl
    if pad:  # the raw dt padded: softplus makes its padded steps decay
        x, bb, cc, dt = (F.pad(t, (0, 0, 0, pad)) for t in (x, bb, cc, dt))
    nc = x.shape[1] // cl

    xh = x.reshape(b, nc, cl, heads, p)
    bh = bb.reshape(b, nc, cl, g, n)
    ch = cc.reshape(b, nc, cl, g, n)
    dt = F.softplus(dt + params.dt_bias).reshape(b, nc, cl, heads)
    a = -torch.exp(params.a_log)  # (H,) negative
    da = dt * a  # (B, nc, cl, H) log-decay per step

    state = (initial_state if initial_state is not None else
             torch.zeros(b, heads, n, p, dtype=torch.float32,
                         device=h.device))
    ys = []
    for c in range(nc):
        state, y = _chunk_step(state, xh[:, c], bh[:, c], ch[:, c],
                               da[:, c], dt[:, c], cfg)
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :sl]
    y = y + (params.d_skip.to(cd)[:, None]
             * x[:, :sl].reshape(b, sl, heads, p))
    y = y.reshape(b, sl, d_in)
    y = rmsnorm(params.gate_norm, y * F.silu(z), cfg.norm_eps,
                cfg.bf16_norm_grad)
    return y @ params.out_proj.to(cd), state, pre


def ssd(params, h: Tensor, cfg: ModelConfig, *,
        initial_state: Tensor | None = None, return_state: bool = False):
    """Chunked SSD forward of (B, S, d).  Returns (B, S, d), and with
    ``return_state`` also the final (B, H, N, P) fp32 state."""
    out, state, _ = _ssd(params, h, cfg, initial_state)
    return (out, state) if return_state else out


def ssd_prefill(params, h: Tensor, cfg: ModelConfig
                ) -> tuple[Tensor, SSMState]:
    """:func:`ssd` over a prompt and the decode-ready state: the final SSM
    state and the prompt's last ``d_conv - 1`` pre-conv channel values
    (the reference's ``blocks._ssm_prefill_state``, from the same
    projections)."""
    out, final, pre = _ssd(params, h, cfg)
    tail = pre[:, -(cfg.ssm.d_conv - 1):]
    return out, SSMState(conv=tail.to(cfg.cdtype), ssm=final)


def ssd_init_state(cfg: ModelConfig, batch: int,
                   device: torch.device | str) -> SSMState:
    s = cfg.ssm
    _, heads, conv_dim = _dims(cfg)
    return SSMState(
        conv=torch.zeros(batch, s.d_conv - 1, conv_dim, dtype=cfg.cdtype,
                         device=device),
        ssm=torch.zeros(batch, heads, s.d_state, s.head_dim,
                        dtype=torch.float32, device=device))


def ssd_decode(params, h: Tensor, state: SSMState, cfg: ModelConfig
               ) -> tuple[Tensor, SSMState]:
    """One token (B, 1, d) against ``state``, which it updates in place
    (a captured decode replays on the same buffers); returns the output
    (B, 1, d) and ``state``."""
    s = cfg.ssm
    cd = cfg.cdtype
    f32 = torch.float32
    b = h.shape[0]
    d_in, heads, _ = _dims(cfg)
    g, n, p = s.n_groups, s.d_state, s.head_dim
    hg = heads // g

    z, x, bb, cc, dt = _proj_inputs(params, h, cfg)
    xbc = torch.cat([x, bb, cc], dim=-1)  # (B, 1, conv_dim)
    window = torch.cat([state.conv, xbc], dim=1)  # (B, d_conv, conv_dim)
    kernel = torch.cat([params.conv_x, params.conv_b, params.conv_c],
                       dim=1).to(cd)
    conv_out = F.silu((window * kernel[None]).sum(dim=1))  # (B, conv_dim)
    x_t, b_t, c_t = torch.split(conv_out, [d_in, g * n, g * n], dim=-1)

    dt_t = F.softplus(dt[:, 0] + params.dt_bias)  # (B, H)
    da = torch.exp(dt_t * -torch.exp(params.a_log))
    x_t = x_t.reshape(b, heads, p).to(f32)
    b_t = b_t.reshape(b, g, 1, n, 1).to(f32)
    c_t = c_t.reshape(b, g, n).to(f32)
    inc = (b_t * (dt_t.reshape(b, g, hg, 1, 1)
                  * x_t.reshape(b, g, hg, 1, p))).reshape(b, heads, n, p)
    new_ssm = da[..., None, None] * state.ssm + inc
    y = torch.einsum("bgn,bghnp->bghp", c_t,
                     new_ssm.reshape(b, g, hg, n, p)).reshape(b, heads, p)
    y = y + params.d_skip[:, None] * x_t
    y = y.reshape(b, 1, d_in).to(cd)
    y = rmsnorm(params.gate_norm, y * F.silu(z), cfg.norm_eps,
                cfg.bf16_norm_grad)
    state.conv.copy_(window[:, 1:])
    state.ssm.copy_(new_ssm)
    return y @ params.out_proj.to(cd), state
