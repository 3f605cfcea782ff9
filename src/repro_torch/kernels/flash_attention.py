"""Flash attention (forward): CUDA kernel and its plain version.

``flash_attention(q, k, v, causal=, scale=)``  softmax(scale Q K^T) V on
(B, S, H, d) tensors with the GQA heads already expanded, causal or full,
in ``q``'s type.  Replaces ``repro/kernels/flash_attention.py::
flash_attention`` (:85, kernel ``_flash_kernel`` :37): the S_q x S_kv
scores stay on chip, key tiles past the causal diagonal are skipped, and
ragged edges are masked in the kernel (no padding copies).

The kernel (``csrc/flash_attention.cu``) reads the (B, S, H, d) layout in
place: no (B*H, S, d) copy.  bf16 runs on the tensor cores in Hopper's own
form (TMA loads through tensor maps into a ring of K/V stages, wgmma with
fp32 accumulation, one producer and two consumer warpgroups, P rounded to
bf16 for P V); fp32 on the tensor cores in 3xTF32 (mma.sync, each operand
split into two TF32 parts: fp32-level products), the key tiles of a query
tile split over a thread-block cluster where the query tiles alone leave
the card idle (:func:`f32_split`).  It is bound by operations (see the
source note).

On CPU tensors the wrapper returns the plain version; on CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches.  The
kernel has no backward (nor has the reference's): a call that autograd
would record (grad mode on, an input that requires grad) raises rather
than return a result cut off from the graph, on either device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels._launch import (
    DTYPE_CODES, I, P, call, on_cpu, sm_count,
)

#: Kernel launches (CUDA tensors only).
launches = {"flash_attention": 0}

#: Head dims the kernel is built for.
HEAD_DIMS = (16, 32, 64, 128)

_ENTRY = "repro_flash_attention"
_SIGNATURE = (P,) * 4 + (I,) * 7 + (ctypes.c_float, I, P)

#: Query rows and keys of one tile of the fp32 kernel (``kF32BQ``,
#: ``kF32BK`` in ``csrc/flash_attention.cu``).
F32_TILE = 64
#: Cluster sizes the fp32 kernel's key split takes (portable on Hopper).
F32_SPLITS = (1, 2, 4, 8)


@functools.lru_cache(maxsize=1024)
def f32_split(b: int, sq: int, skv: int, h: int, d: int, sms: int) -> int:
    """Blocks that share one query tile's key tiles in the fp32 kernel (a
    thread-block cluster): the largest of :data:`F32_SPLITS` whose blocks
    still fit the card's resident slots (two a SM, one at d = 128) and
    get a key tile each.  1 wherever the query tiles fill the card.  A pure
    function of the shape and the SM count."""
    blocks = b * h * -(-sq // F32_TILE)
    slots = sms * (1 if d == 128 else 2)
    kv_tiles = -(-skv // F32_TILE)
    split = 1
    for more in F32_SPLITS[1:]:
        if blocks * more <= slots and more <= kv_tiles:
            split = more
    return split


def flash_attention_plain(q, k, v, *, causal: bool = True,
                          scale: float | None = None) -> torch.Tensor:
    return ref.flash_attention(q, k, v, causal=causal, scale=scale)


def _check(q, k, v) -> None:
    dev, dt = q.device, q.dtype
    if not (k.device == dev and v.device == dev and k.dtype == dt
            and v.dtype == dt and q.ndim == k.ndim == v.ndim == 4):
        for name, t in (("k", k), ("v", v), ("q", q)):
            if t.device != dev:
                raise ValueError(f"{name} is on {t.device}, q on {dev}")
            if t.dtype != dt:
                raise TypeError(f"{name} has dtype {t.dtype}, q {dt}")
            if t.ndim != 4:
                raise ValueError(f"{name} must be (B, S, H, d), got "
                                 f"{tuple(t.shape)}")
    if dt not in DTYPE_CODES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, got "
                        f"{dt}")
    b, sq, h, d = q.shape
    kshape = k.shape
    if (kshape != v.shape or kshape[0] != b or kshape[2] != h
            or kshape[3] != d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if sq < 1 or kshape[1] < 1 or b * h > 65535:
        raise ValueError(f"unsupported sizes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """(B, S_q, H, d) in ``q``'s type; ``k``, ``v`` are (B, S_kv, H, d)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention has no backward: training takes the chunked "
            "attention (models/attention.py); call it under torch.no_grad() "
            "or on tensors that do not require grad")
    if on_cpu(q):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    _check(q, k, v)
    # The path's tensors are contiguous already; anything else is copied
    # once here (and the copy counts in this call's time).
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / d ** 0.5
    out = torch.empty_like(q)
    if (q.data_ptr() | k.data_ptr() | v.data_ptr() | out.data_ptr()) % 16:
        raise ValueError("the flash kernel needs 16-byte aligned tensors")
    lib = _build.library("flash_attention", {_ENTRY: _SIGNATURE})
    split = 1 if q.dtype == torch.bfloat16 else f32_split(
        b, sq, k.shape[1], h, d, sm_count(q.device))
    call(lib, _ENTRY, "flash_attention", launches, q.device,
         q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
         b, h, sq, k.shape[1], d, DTYPE_CODES[q.dtype], int(causal),
         float(scale), split)
    return out
