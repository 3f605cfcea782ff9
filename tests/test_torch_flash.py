"""The port's flash attention (plain version on the CPU) against the JAX
reference's Pallas kernel in interpret mode, on the cases of
tests/test_flash_attention.py, from the same numpy inputs.

The CUDA kernel itself is held against the plain version on the card in
tests/test_torch_gpu.py.  Tolerances: rtol = atol = 2e-4 in fp32 (as
tests/test_flash_attention.py: fp32 sums in another order, exp of scaled
scores) and 3e-2 for bf16 inputs and output (one bf16 rounding of O).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import attention as attn

CASES = [
    # (b, sq, skv, h, d, causal, bq, bk): the reference test's CASES
    (2, 128, 128, 4, 64, True, 64, 64),
    (1, 100, 100, 2, 32, True, 64, 64),
    (2, 64, 200, 2, 64, False, 32, 64),
    (1, 256, 256, 3, 128, True, 128, 64),
    (1, 32, 96, 1, 16, False, 32, 32),
]
TOL, BF16_TOL = 2e-4, 3e-2


def _qkv(b, sq, skv, h, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, h, d)).astype(np.float32),
            rng.standard_normal((b, skv, h, d)).astype(np.float32))


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_reference_kernel(case):
    b, sq, skv, h, d, causal, bq, bk = case
    q, k, v = _qkv(b, sq, skv, h, d, seed=sq * skv)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, bq=bq, bk=bk, interpret=True))
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                             causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_plain_matches_reference_kernel_bf16():
    q, k, v = _qkv(2, 128, 128, 2, 64, seed=3)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = jflash(jq, jk, jv, causal=True, bq=64, bk=64, interpret=True)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)


def test_scale_and_default_scale():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 20, 20, 2, 32, seed=5))
    default = fa.flash_attention(q, k, v, causal=True)
    explicit = fa.flash_attention(q, k, v, causal=True, scale=32 ** -0.5)
    assert torch.equal(default, explicit)
    other = fa.flash_attention(q, k, v, causal=True, scale=0.5)
    assert not torch.allclose(default, other)


@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_chunked_attention(causal):
    """The two plain attentions of the port (the flash oracle and the
    chunked path the model takes without the kernel) agree."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 45, 45, 3, 16, seed=7))
    a = ref.flash_attention(q, k, v, causal=causal)
    b = attn._sdpa_chunked(q, k, v, causal=causal, q_chunk=16,
                           scale=16 ** -0.5)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bad,match", [
    ("dtype", "float32 or bfloat16"),
    ("head_dim", "head dim"),
    ("shape", "shape mismatch"),
    ("mixed", "dtype"),
])
def test_kernel_operand_checks(bad, match):
    """What the kernel refuses (checked before any launch, so on CPU
    tensors here)."""
    q, k, v = (torch.zeros(1, 8, 2, 32) for _ in range(3))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = (torch.zeros(1, 8, 2, 48) for _ in range(3))
    elif bad == "shape":
        k = torch.zeros(1, 8, 3, 32)
    else:
        k = k.to(torch.bfloat16)
    with pytest.raises((TypeError, ValueError), match=match):
        fa._check(q, k, v)
