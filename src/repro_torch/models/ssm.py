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

Over a model axis (``tp``, a ``models.parallel.TensorParallel``) a rank
holds the heads of its slice of the inner width d_in, which is head-major
(:func:`head_split`): its ``w_z``/``w_x``/``conv_x`` columns and
``out_proj`` rows are its slices by the reference's axes, and it takes
its heads' entries of the replicated ``w_dt``, ``a_log``, ``dt_bias``,
``d_skip`` and ``gate_norm``.  ``w_b``/``w_c`` and their convs stay
whole: every rank computes all of B and C (its conv state keeps them
whole) and each of its heads reads its own group, global head // (H / G).
The gated RMSNorm runs over the whole d_in: the rank's fp32 sum of
squares, (B, S, 1), is added over the ranks by one all-reduce.
``out_proj`` is row-parallel, its fp32 partial sums added by a second.
A rank's state is its part, conv (B, d_conv - 1, d_in / t + 2 G N) and
ssm (B, H / t, N, P).

One device serves as 2 ranks would compute (:func:`_head_parts`): the
chunked scan and the decode's read of the state run on each half of the
heads apart, and the norm's and ``out_proj``'s sums over d_in are the
sums of the halves' fp32 partials.  So 2 ranks give one device's bits,
which bf16 needs: a bit that differs in an early layer of a 48-layer
mamba2 reaches its logits as the whole bf16 noise, past the greedy
tokens' margins (``tools/tp_bits.py``).

Everything here is plain PyTorch: the reference computes SSD outside any
Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (
    axis_if, by_columns, by_halves, rmsnorm, tp_ok,
)
from repro_torch.models.parallel import fp32_product
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


class HeadSplit(NamedTuple):
    """The SSD heads one rank of ``t`` holds: heads ``h0`` to ``h0 +
    heads`` of the inner width, which read B/C groups ``g0`` to ``g0 +
    groups``; ``split`` where its ``w_z``/``w_x``/``conv_x``/``out_proj``
    are its slices (else it holds and computes the whole mixer)."""
    heads: int
    h0: int
    groups: int
    g0: int
    split: bool

    def channels(self, width: int) -> slice:
        """This rank's entries of a head-major axis of ``width`` a head."""
        return slice(self.h0 * width, (self.h0 + self.heads) * width)


def head_split(cfg: ModelConfig, ranks: int = 1, index: int = 0
               ) -> HeadSplit:
    """Rank ``index`` of ``ranks`` on the model axis.  d_in splits where
    the reference's rule splits it (``tp``-tagged, divisible by
    ``ranks``).  Raises ``NotImplementedError`` naming ROADMAP.md where
    that split cuts a head, or puts a rank's heads across part of a B/C
    group (a rank holds whole groups, or lies inside one)."""
    s = cfg.ssm
    d_in, heads, _ = _dims(cfg)
    if not (ranks > 1 and tp_ok(d_in) and d_in % ranks == 0):
        return HeadSplit(heads, 0, s.n_groups, 0, False)
    if heads % ranks:
        raise NotImplementedError(
            f"{cfg.name}: its SSD inner width {d_in} splits over {ranks} "
            f"model ranks but its {heads} heads do not: a rank's slice "
            f"would cut a head (ROADMAP.md, unported features)")
    mine, per_group = heads // ranks, heads // s.n_groups
    if mine % per_group and per_group % mine:
        raise NotImplementedError(
            f"{cfg.name}: {mine} SSD heads a rank over {ranks} model ranks "
            f"would straddle its B/C groups of {per_group} heads "
            f"(ROADMAP.md, unported features)")
    h0 = index * mine
    return HeadSplit(mine, h0, max(1, mine // per_group), h0 // per_group,
                     True)


def rank_split(cfg: ModelConfig, tp) -> HeadSplit:
    """The heads of this rank of the model axis ``tp`` (all of them where
    ``tp`` is None)."""
    return head_split(cfg) if tp is None else head_split(cfg, tp.size,
                                                         tp.index)


def local_dims(cfg: ModelConfig, lay: HeadSplit) -> tuple[int, int, int]:
    """(d_in, heads, conv_dim) of the rank of ``lay``: its heads' width,
    and B and C whole."""
    s = cfg.ssm
    d_in = lay.heads * s.head_dim
    return d_in, lay.heads, d_in + 2 * s.n_groups * s.d_state


def _mine(v: Tensor, lay: HeadSplit, width: int = 1) -> Tensor:
    """The rank's heads' entries of a replicated head-major ``v`` (the
    last axis), ``width`` entries a head."""
    return v[..., lay.channels(width)] if lay.split else v


def _groups(x: Tensor, lay: HeadSplit, n: int) -> Tensor:
    """The rank's groups' channels of a whole B or C (..., G * N)."""
    if not lay.split:
        return x
    return x[..., lay.g0 * n:(lay.g0 + lay.groups) * n]


def ssm_specs(cfg: ModelConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in, heads, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    f32 = torch.float32
    # The reference's axes: d_in (head-major) splits over the model axis.
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


def _proj_inputs(params, h: Tensor, cfg: ModelConfig,
                 parts: list[HeadSplit]):
    """z and x of the rank's heads (by the columns of each of its
    :func:`_head_parts`); B, C and dt whole (every head's dt: ``w_dt`` is
    whole on every rank, and its product is then one device's, bit for
    bit)."""
    cd = cfg.cdtype
    cols = None if len(parts) == 1 else [
        part.channels(cfg.ssm.head_dim) for part in parts]
    z = by_columns(h, params.w_z.to(cd), cols)
    x = by_columns(h, params.w_x.to(cd), cols)
    bb = h @ params.w_b.to(cd)
    cc = h @ params.w_c.to(cd)
    dt = (h @ params.w_dt.to(cd)).to(torch.float32)
    return z, x, bb, cc, dt


def _head_parts(cfg: ModelConfig, lay: HeadSplit) -> list[HeadSplit]:
    """The parts of the heads that the mixer computes apart: the rank's
    heads where a model axis splits them; serving on every head (one
    device, or a rank the split skips), the halves that 2 ranks hold,
    where d_in splits in two without cutting a head or a B/C group.  The per-head work (the chunked scan, the decode's read of
    the state) runs one call a part, so that its products have a rank's
    shapes and so its bits; :func:`_gated_out` sums over the parts.
    Autograd keeps one part (training keeps the reference's norm and its
    ``bf16_norm_grad`` backward)."""
    if lay.split or not by_halves():
        return [lay]
    try:
        halves = [head_split(cfg, 2, i) for i in range(2)]
    except NotImplementedError:  # a head or a B/C group cut in two
        return [lay]
    return halves if halves[0].split else [lay]


def _gated_out(params, y: Tensor, z: Tensor, cfg: ModelConfig,
               lay: HeadSplit, tp) -> Tensor:
    """``rmsnorm(gate_norm, y * silu(z)) @ out_proj``, its two sums over
    d_in (the norm's sum of squares, ``out_proj``'s contraction) in fp32
    over parts of d_in, the compute type taken once at the end.

    Over a model axis a part is the rank's slice and the parts are added
    by an all-reduce (a norm over the rank's slice alone would be another
    function).  On one device, serving, the parts are the halves of d_in
    that 2 ranks hold, added in the same fp32: the sum of two terms does
    not depend on their order, so 2 ranks give one device's bits.  Any
    other order would do as well at fp32's precision, but not in bf16
    serving: a bit that differs in an early layer of a 48-layer mamba2
    grows to the logits' whole bf16 noise (tools/tp_bits.py)."""
    cd = cfg.cdtype
    n = len(_head_parts(cfg, lay))
    if n == 1 and not lay.split:
        y = rmsnorm(params.gate_norm, y * F.silu(z), cfg.norm_eps,
                    cfg.bf16_norm_grad)
        return y @ params.out_proj.to(cd)
    y = (y * F.silu(z)).to(torch.float32)
    ys = [p.contiguous() for p in y.chunk(n, dim=-1)]
    ws = _mine(params.gate_norm, lay, cfg.ssm.head_dim).chunk(n)
    outs = params.out_proj.to(cd).chunk(n)
    squares = [(p * p).sum(dim=-1, keepdim=True) for p in ys]
    ss = squares[0] if n == 1 else squares[0] + squares[1]
    if lay.split:
        ss = tp.all_reduce(ss)
    scale = torch.rsqrt(ss / _dims(cfg)[0] + cfg.norm_eps)
    part = [fp32_product((p * scale * w).to(cd), o)
            for p, w, o in zip(ys, ws, outs, strict=True)]
    out = part[0] if n == 1 else part[0] + part[1]
    if lay.split:
        out = tp.all_reduce(out)
    return out.to(cd)


def _chunk_step(state: Tensor, xc: Tensor, bc: Tensor, cc: Tensor,
                dac: Tensor, dtc: Tensor, cfg: ModelConfig
                ) -> tuple[Tensor, Tensor]:
    """One chunk: (B, cl, H, P) inputs, (B, cl, G, N) B and C (a rank's
    heads and the groups they read), (B, cl, H) log-decays and steps;
    returns the next state and the chunk's output
    (B, cl, H, P) in the compute type.  Works head-major, (B, G, hg, cl,
    .), so every contraction is one batched matmul."""
    b, cl, heads, p = xc.shape
    g, n = bc.shape[2:]
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


def _part(v: Tensor, part: HeadSplit, lay: HeadSplit, width: int,
          dim: int = -1) -> Tensor:
    """The heads of ``part`` of the rank's ``v`` (``width`` entries a head
    along ``dim``), as a tensor of its own."""
    if part is lay:
        return v
    heads = part.channels(width)
    return v.narrow(dim, heads.start, heads.stop - heads.start).contiguous()


def _scan(params, x: Tensor, bb: Tensor, cc: Tensor, dt: Tensor,
          state: Tensor | None, cl: int, part: HeadSplit,
          cfg: ModelConfig) -> tuple[Tensor, Tensor]:
    """The chunked scan of the heads of ``part``: x (B, S, H P) and the raw
    dt (B, S, H) of its heads, B and C (B, S, G N) whole, S a multiple of
    ``cl``, from ``state`` (B, H, N, P) or zeros.  Returns the output
    (B, S, H, P) in the compute type and the final state."""
    s = cfg.ssm
    b, sl = x.shape[:2]
    n, p, nc = s.d_state, s.head_dim, sl // cl
    xh = x.reshape(b, nc, cl, part.heads, p)
    bh = _groups(bb, part, n).reshape(b, nc, cl, part.groups, n)
    ch = _groups(cc, part, n).reshape(b, nc, cl, part.groups, n)
    dt = F.softplus(dt + _mine(params.dt_bias, part)).reshape(
        b, nc, cl, part.heads)
    a = -torch.exp(_mine(params.a_log, part))  # (H,) negative
    da = dt * a  # (B, nc, cl, H) log-decay per step
    if state is None:
        state = torch.zeros(b, part.heads, n, p, dtype=torch.float32,
                            device=x.device)
    ys = []
    for c in range(nc):
        state, y = _chunk_step(state, xh[:, c], bh[:, c], ch[:, c],
                               da[:, c], dt[:, c], cfg)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def _ssd(params, h: Tensor, cfg: ModelConfig,
         initial_state: Tensor | None = None, tp=None
         ) -> tuple[Tensor, Tensor, Tensor]:
    """:func:`ssd`'s output, its final state and the pre-conv channel
    values ``[x, B, C]`` (B, S, conv_dim) that a decode continues from
    (the rank's heads over a model axis ``tp``)."""
    s = cfg.ssm
    cd = cfg.cdtype
    b, sl, _ = h.shape
    lay = rank_split(cfg, tp)
    d_in, heads, _ = local_dims(cfg, lay)
    p = s.head_dim

    parts = _head_parts(cfg, lay)
    z, x, bb, cc, dt = _proj_inputs(params, h, cfg, parts)
    pre = torch.cat([x, bb, cc], dim=-1)
    x = F.silu(_causal_conv(x, params.conv_x.to(cd)))
    bb = F.silu(_causal_conv(bb, params.conv_b.to(cd)))
    cc = F.silu(_causal_conv(cc, params.conv_c.to(cd)))

    cl = min(s.chunk, sl)
    pad = (-sl) % cl
    if pad:  # the raw dt padded: softplus makes its padded steps decay
        x, bb, cc, dt = (F.pad(t, (0, 0, 0, pad)) for t in (x, bb, cc, dt))
    scans = [_scan(params, _part(x, part, lay, p), bb, cc,
                   _mine(dt, part), None if initial_state is None
                   else _part(initial_state, part, lay, 1, dim=1), cl,
                   part, cfg)
             for part in parts]
    y = torch.cat([y for y, _ in scans], dim=2)[:, :sl]
    state = torch.cat([st for _, st in scans], dim=1)
    y = y + (_mine(params.d_skip, lay).to(cd)[:, None]
             * x[:, :sl].reshape(b, sl, heads, p))
    y = y.reshape(b, sl, d_in)
    return _gated_out(params, y, z, cfg, lay, tp), state, pre


def ssd(params, h: Tensor, cfg: ModelConfig, *,
        initial_state: Tensor | None = None, return_state: bool = False,
        tp=None):
    """Chunked SSD forward of (B, S, d).  Returns (B, S, d), and with
    ``return_state`` also the final (B, H, N, P) fp32 state (the rank's
    H / t heads over a model axis ``tp``)."""
    out, state, _ = _ssd(params, h, cfg, initial_state, tp)
    return (out, state) if return_state else out


def ssd_prefill(params, h: Tensor, cfg: ModelConfig, tp=None
                ) -> tuple[Tensor, SSMState]:
    """:func:`ssd` over a prompt and the decode-ready state: the final SSM
    state and the prompt's last ``d_conv - 1`` pre-conv channel values
    (the reference's ``blocks._ssm_prefill_state``, from the same
    projections)."""
    out, final, pre = _ssd(params, h, cfg, tp=tp)
    tail = pre[:, -(cfg.ssm.d_conv - 1):]
    return out, SSMState(conv=tail.to(cfg.cdtype), ssm=final)


def ssd_init_state(cfg: ModelConfig, batch: int,
                   device: torch.device | str, tp=None) -> SSMState:
    s = cfg.ssm
    _, heads, conv_dim = local_dims(cfg, rank_split(cfg, tp))
    return SSMState(
        conv=torch.zeros(batch, s.d_conv - 1, conv_dim, dtype=cfg.cdtype,
                         device=device),
        ssm=torch.zeros(batch, heads, s.d_state, s.head_dim,
                        dtype=torch.float32, device=device))


def _read_state(c: Tensor, state: Tensor, part: HeadSplit,
                cfg: ModelConfig) -> Tensor:
    """C (B, G N) of the groups of ``part`` read against its heads' state
    (B, H, N, P): (B, H, P)."""
    b, n, p = c.shape[0], cfg.ssm.d_state, cfg.ssm.head_dim
    return torch.einsum(
        "bgn,bghnp->bghp", c.reshape(b, part.groups, n),
        state.reshape(b, part.groups, part.heads // part.groups, n, p)
    ).reshape(b, part.heads, p)


def ssd_decode(params, h: Tensor, state: SSMState, cfg: ModelConfig,
               tp=None) -> tuple[Tensor, SSMState]:
    """One token (B, 1, d) against ``state``, which it updates in place
    (a captured decode replays on the same buffers); returns the output
    (B, 1, d) and ``state`` (the rank's part over a model axis ``tp``)."""
    s = cfg.ssm
    cd = cfg.cdtype
    f32 = torch.float32
    b = h.shape[0]
    lay = rank_split(cfg, tp)
    d_in, heads, _ = local_dims(cfg, lay)
    g, n, p = s.n_groups, s.d_state, s.head_dim
    hg = heads // lay.groups

    parts = _head_parts(cfg, lay)
    z, x, bb, cc, dt = _proj_inputs(params, h, cfg, parts)
    xbc = torch.cat([x, bb, cc], dim=-1)  # (B, 1, conv_dim)
    window = torch.cat([state.conv, xbc], dim=1)  # (B, d_conv, conv_dim)
    kernel = torch.cat([params.conv_x, params.conv_b, params.conv_c],
                       dim=1).to(cd)
    conv_out = F.silu((window * kernel[None]).sum(dim=1))  # (B, conv_dim)
    x_t, b_t, c_t = torch.split(conv_out, [d_in, g * n, g * n], dim=-1)

    dt_t = F.softplus(dt[:, 0] + params.dt_bias)  # (B, H), every head
    da = _mine(torch.exp(dt_t * -torch.exp(params.a_log)), lay)
    dt_t = _mine(dt_t, lay)
    x_t = x_t.reshape(b, heads, p).to(f32)
    b_t = _groups(b_t, lay, n).reshape(b, lay.groups, 1, n, 1).to(f32)
    inc = (b_t * (dt_t.reshape(b, lay.groups, hg, 1, 1)
                  * x_t.reshape(b, lay.groups, hg, 1, p))).reshape(
        b, heads, n, p)
    new_ssm = da[..., None, None] * state.ssm + inc
    y = torch.cat([_read_state(_groups(c_t, part, n).to(f32),
                               _part(new_ssm, part, lay, 1, dim=1), part,
                               cfg)
                   for part in parts], dim=1)
    y = y + _mine(params.d_skip, lay)[:, None] * x_t
    y = y.reshape(b, 1, d_in).to(cd)
    state.conv.copy_(window[:, 1:])
    state.ssm.copy_(new_ssm)
    return _gated_out(params, y, z, cfg, lay, tp), state
