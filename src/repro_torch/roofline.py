"""The port's bound model on one NVIDIA H100, the counterpart of
``repro/roofline/analysis.py``.

Three parts:

* the card's published peaks (H100 SXM: fp32 on the CUDA cores, dense
  bf16 and TF32 on the tensor cores, HBM3) and the least time of one
  kernel call at them: :func:`bound` for the RPCA kernels, :func:`flash_bound`
  for attention (``chip_smoke.py`` and the kernel table of ``PERF.md``
  read them from here);
* :func:`model_flops_global`, a model's useful FLOP for a shape (6ND to
  train, 2ND to prefill, 2N a decoded token), as ``repro/launch/dryrun.py``
  counts it;
* :class:`Roofline`, the reference's record of compute, memory and
  collective terms, at this card's peaks.  The collective term takes its
  link rate as an argument: one card runs one rank, so no NVLink figure
  is assumed.

Not ported: ``roofline/hlo_costs.py`` and ``analysis.analyze`` /
``collective_bytes``, which price XLA's optimised HLO text; the port
compiles no HLO.  Its counts are per kernel (:func:`bound`) and per model
(:func:`model_flops_global`).
"""
from __future__ import annotations

import dataclasses

# Published H100 SXM peaks (fp32 on the CUDA cores, bf16 dense on the
# tensor cores, HBM3).
PEAK_FP32_FLOPS, PEAK_BF16_FLOPS, PEAK_BYTES = 67e12, 989e12, 3.35e12
# Dense TF32 on the tensor cores (H100 SXM): the bound of a 3xTF32 kernel
# is three TF32 products at this rate.
PEAK_TF32_FLOPS = 494.7e12


def bound(fn: str, mode: str, m_bytes: int, e: int, m: int, n: int,
          r: int) -> tuple[float, str]:
    """Least time (ms) the card needs for one call: the larger of the FLOP
    of the rank-r products at the fp32 peak (elementwise work not counted)
    and the bytes that must move (each input read once: M at ``m_bytes``
    per entry, a dense mask at 4 and a packed one at 1 bit per entry; each
    output written once) at the HBM rate."""
    w_bytes = {"none": 0, "dense": 4 * e * m * n,
               "packed": e * m * -(-n // 8)}[mode]
    factors = 4 * (e * m * r + e * n * r + e)
    flops, out = {
        "huber_contract_v": (4 * e * m * n * r, e * n * r),
        "huber_contract_u": (4 * e * m * n * r, e * m * r),
        "huber_contract_u_diag": (4 * e * m * n * r, e * m * r + 2 * e),
        "huber_dual_contract": (6 * e * m * n * r,
                                e * n * r + e * m * r + 2 * e),
        "residual_shrink": (2 * e * m * n * r, e * m * n),
        "residual_shrink_psi": (2 * e * m * n * r, 2 * e * m * n),
    }[fn]
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = (m_bytes * e * m * n + w_bytes + factors + 4 * out) \
        / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def flash_bound(b: int, sq: int, skv: int, h: int, d: int, causal: bool,
                dtype: str, peak: float | None = None,
                products: int = 1) -> tuple[float, str]:
    """Least time (ms) for one attention call: 4 d FLOP per (query, key)
    pair this call's mask keeps (row i sees keys j <= i when causal), times
    ``products``, at ``peak`` (default: the input type's, bf16 tensor cores
    or fp32 CUDA cores), against Q, K, V read once and O written once at
    the HBM rate."""
    pairs = sum(min(i + 1, skv) for i in range(sq)) if causal else sq * skv
    elem = 2 if dtype == "bf16" else 4
    if peak is None:
        peak = PEAK_BF16_FLOPS if dtype == "bf16" else PEAK_FP32_FLOPS
    t_ops = products * 4 * b * h * d * pairs / peak * 1e3
    t_bytes = elem * b * h * d * 2 * (sq + skv) / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def active_params(cfg, named_shapes) -> float:
    """N of :func:`model_flops_global`: the parameters of ``named_shapes``
    (``(name, shape)`` pairs of a model's ``Params``), without the input
    embedding table (``embed.table``; the unembedding ``embed.unembed``
    counts), the router and expert tensors of a MoE layer's ``ffn`` (those
    whose shape holds ``num_experts``; not its shared expert) scaled by
    ``top_k / num_experts``.  The reference's rule, on the reference's
    names: skip a path holding "embed" but not "unembed", scale a stacked
    tensor of three or more axes holding ``num_experts``
    (``repro/launch/dryrun.py:49-70``); on the port's unstacked layers that
    is each MoE layer's router (d, E) and expert weights (E, ., .)."""
    n = 0.0
    for name, shape in named_shapes:
        size = 1.0
        for s in shape:
            size *= s
        if name == "embed.table":
            continue
        parent = name.split(".")[-2] if "." in name else ""
        if (cfg.moe is not None and parent == "ffn"
                and cfg.moe.num_experts in shape):
            size *= cfg.moe.top_k / cfg.moe.num_experts
        n += size
    return n


def model_flops_global(cfg, model, shape) -> float:
    """6ND (train) / 2ND (prefill) / 2N a row (decode: one token each),
    N = :func:`active_params` of ``model``'s parameters (``model.specs()``,
    nothing allocated), D the shape's tokens."""
    from repro_torch.models.params import named_specs

    n = active_params(cfg, ((name, spec.shape) for name, spec
                            in named_specs(model.specs())))
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


@dataclasses.dataclass
class Roofline:
    """The reference's roofline record (``analysis.py:76-137``) at this
    card's peaks: ``t_compute`` at the dense bf16 tensor-core rate,
    ``t_memory`` at the HBM rate and ``t_collective`` at ``link_bytes_per_s``
    (the caller's: one card assumes no link)."""

    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: dict
    model_flops_global: float
    peak_memory_per_device: float
    link_bytes_per_s: float
    peak_flops: float = PEAK_BF16_FLOPS
    peak_bytes: float = PEAK_BYTES

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / self.peak_bytes

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / self.link_bytes_per_s

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """Model FLOP over the FLOP run (per device x devices): what the
        run computes beyond the model's (recompute, masked work, padding)
        lowers it."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops_global / total if total else 0.0

    @property
    def roofline_time(self) -> float:
        """Lower-bound step time: the largest of the three terms (perfect
        overlap)."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """The time the devices must spend on the model's FLOP over the
        bound step time."""
        ideal = self.model_flops_global / (self.n_devices * self.peak_flops)
        return ideal / self.roofline_time if self.roofline_time else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            t_compute=self.t_compute, t_memory=self.t_memory,
            t_collective=self.t_collective, bottleneck=self.bottleneck,
            useful_flops_ratio=self.useful_flops_ratio,
            roofline_time=self.roofline_time,
            roofline_fraction=self.roofline_fraction,
        )
        return d
