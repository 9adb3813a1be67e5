"""The port's attention forward against the JAX package's.

crct_tpu_torch/ops/attention.py is held against
crct_tpu.ops.attention.fused_attention with the Pallas kernel in interpret
mode and against reference_attention, on the same numpy inputs. On the CPU
the port's wrapper runs the kernel's plain version; the CUDA kernel itself
is held against that plain version on the card (tests/test_torch_on_card.py,
and chip_smoke.py at the flagship shapes).

Tolerances: fp32 at 1e-5 (both sides compute fp32 scores and probabilities;
only the summation order differs); bf16 at 2e-2 (one bf16 rounding of the
output, plus bf16 inputs to the plain-XLA path's P.V).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crct_tpu.ops import attention as jax_attention
from crct_tpu_torch.ops import attention as port


def make_qkv(seed, B=3, H=4, Lq=10, Lk=7, D=8, full_mask=False):
    g = np.random.default_rng(seed)
    q = g.normal(size=(B, H, Lq, D)).astype(np.float32)
    k = g.normal(size=(B, H, Lk, D)).astype(np.float32)
    v = g.normal(size=(B, H, Lk, D)).astype(np.float32)
    if full_mask:
        mask = np.where(g.random((B, 1, Lq, Lk)) < 0.2, -10000.0,
                        0.0).astype(np.float32)
    else:
        mask = np.zeros((B, 1, 1, Lk), np.float32)
        mask[:, :, :, -2:] = -10000.0
    return q, k, v, mask


def _port(q, k, v, mask, dtype=torch.float32, **kw):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    return port.fused_attention(*t, torch.from_numpy(mask), **kw)


@pytest.mark.parametrize("full_mask", [False, True], ids=["key_only", "full"])
def test_fp32_matches_pallas_interpret_and_reference(full_mask):
    q, k, v, mask = make_qkv(0, full_mask=full_mask)
    got = _port(q, k, v, mask).numpy()
    jq, jk, jv, jm = map(jnp.asarray, (q, k, v, mask))
    pallas = jax_attention.fused_attention(jq, jk, jv, jm, interpret=True)
    plain = jax_attention.reference_attention(jq, jk, jv, jm)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, np.asarray(plain), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("full_mask", [False, True], ids=["key_only", "full"])
def test_bf16_matches_pallas_interpret(full_mask):
    """bf16 keeps the probabilities fp32 through P.V, as the Pallas kernel
    does (the plain-XLA path casts them to bf16 first)."""
    q, k, v, mask = make_qkv(2, full_mask=full_mask)
    got = _port(q, k, v, mask, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = jax_attention.fused_attention(jq, jk, jv, jnp.asarray(mask),
                                         interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("H", [4, 6, 32])
def test_dropout_matches_pallas_kernel_seed_for_seed(H):
    """The same int seed gives the JAX kernel's keep mask: H=4 (one head
    block), 6 (head blocks of 2) and 32 (four blocks of 8) cover the
    program -> head mapping of the hash."""
    q, k, v, mask = make_qkv(5, B=2, H=H, Lq=9, Lk=11, D=8)
    rate, seed = 0.3, 123457
    got = _port(q, k, v, mask, dropout_rate=rate, seed=seed).numpy()
    want = jax_attention._attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        jnp.full((1, 1), seed, jnp.int32), rate, True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    base = _port(q, k, v, mask).numpy()
    assert not np.allclose(got, base)


def test_dropout_negative_and_wrapping_seeds():
    """Seeds near the int32 edges wrap in the hash as in the JAX kernel."""
    q, k, v, mask = make_qkv(7, B=3, H=16, Lq=5, Lk=6, D=4)
    for seed in (-1, -2 ** 31, 2 ** 31 - 1):
        got = _port(q, k, v, mask, dropout_rate=0.5, seed=seed).numpy()
        want = jax_attention._attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(mask), jnp.full((1, 1), seed, jnp.int32), 0.5, True)
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


def test_cpu_wrapper_leaves_launch_counter_alone():
    port.reset_launch_count()
    q, k, v, mask = make_qkv(3)
    _port(q, k, v, mask)
    _port(q, k, v, mask, dropout_rate=0.1, seed=1)
    assert port.launch_count() == 0


def test_no_mask_means_zeros():
    q, k, v, mask = make_qkv(4)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    got = port.fused_attention(*t, None)
    want = port.fused_attention(*t, torch.zeros(3, 1, 1, 7))
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("case", ["dtype", "noncontig", "head_dim", "mask",
                                  "rate", "seed"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    q, k, v, mask = (torch.from_numpy(x) for x in make_qkv(6))
    kw = {}
    if case == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "noncontig":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "head_dim":
        q, k, v = (torch.zeros(1, 1, 4, 129) for _ in range(3))
        mask = None
    elif case == "mask":
        mask = torch.zeros(3, 1, 4, 7)
    elif case == "rate":
        kw = dict(dropout_rate=1.0)
    else:
        kw = dict(dropout_rate=0.1, seed=2 ** 31)
    with pytest.raises((ValueError, TypeError)):
        port.fused_attention(q, k, v, mask, **kw)


@pytest.mark.parametrize("full_mask", [False, True], ids=["key_only", "full"])
def test_plain_lse_matches_numpy_logsumexp(full_mask):
    """The log-sum-exp the plain forward returns for the backward (what K1
    writes): fp32 [B, H, Lq], a numpy logsumexp of the fp32 scores in
    float64; the output is the one without it."""
    q, k, v, mask = make_qkv(8, full_mask=full_mask)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out, lse = port.attention_reference(*t, torch.from_numpy(mask), 0.2, 3,
                                        return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (3, 4, 10)
    s = (np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k)
         / np.sqrt(q.shape[-1]) + mask)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, atol=1e-5, rtol=1e-6)
    torch.testing.assert_close(
        out, port.attention_reference(*t, torch.from_numpy(mask), 0.2, 3),
        atol=0, rtol=0)
    got, got_lse = port.attention_forward(*t, torch.from_numpy(mask), 0.2, 3)
    torch.testing.assert_close(got, out, atol=0, rtol=0)
    torch.testing.assert_close(got_lse, lse, atol=0, rtol=0)
