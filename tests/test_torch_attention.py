"""The port's attention forward against the JAX package's.

crct_tpu_torch/ops/attention.py is held against
crct_tpu.ops.attention.fused_attention with the Pallas kernel in interpret
mode (the port's PALLAS mode), against reference_attention, and against
the default XLA path ``crct_tpu.models.layers.dot_product_attention`` (the
port's ROUND_PROBS mode), on the same numpy inputs. On the CPU the port's
wrapper runs the kernel's plain version; the CUDA kernel itself is held
against that plain version on the card (tests/test_torch_on_card.py, and
chip_smoke.py at the flagship shapes).

Tolerances: fp32 at 1e-5 (both sides compute fp32 scores and probabilities;
only the summation order differs); bf16 against the Pallas path at 2e-2
(one bf16 rounding of the output). bf16 against the XLA path, which rounds
P to bf16 at the same place as the port: at most 0.1 % of the elements
differ from JAX's at all, and none by more than one bf16 ulp of the
largest magnitude (fp32 sums in another order, or an exp a few fp32 ulps
apart, can move a rounding to its neighbour); the Pallas mode misses that
in about 41 % of the elements.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crct_tpu.models import layers as jax_layers
from crct_tpu.ops import attention as jax_attention
from crct_tpu_torch.ops import attention as port

# the flagship model's attention shapes (H, Lq, Lk, D): text, vision, and
# the bi-attention's two directions
FLAGSHIP = [(16, 124, 124, 48), (16, 44, 44, 64), (32, 124, 44, 32),
            (32, 44, 124, 32)]
# the most elements that may differ from JAX's XLA path in bf16 at all
DIFFERING = 1e-3


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
    """PALLAS mode keeps the bf16 probabilities fp32 through P.V, as the
    Pallas kernel does (the plain-XLA path casts them to bf16 first)."""
    q, k, v, mask = make_qkv(2, full_mask=full_mask)
    got = _port(q, k, v, mask, dtype=torch.bfloat16, mode=port.PALLAS)
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


def bf16_agreement(got, want):
    """(share of the elements that differ, the largest difference over one
    bf16 ulp of want's largest magnitude) of two bf16-valued arrays."""
    got, want = (np.asarray(x, np.float32) for x in (got, want))
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float((got != want).mean()), float(np.abs(got - want).max() / ulp)


def flagship_inputs(seed, shape, B=2):
    """bf16-valued q, k, v at a flagship shape and a key-only mask with 20 %
    of the keys masked, as fp32 numpy arrays."""
    H, Lq, Lk, D = shape
    g = np.random.default_rng(seed)
    q, k, v = (np.asarray(jnp.asarray(g.normal(size=(B, H, L, D)),
                                      jnp.bfloat16), np.float32)
               for L in (Lq, Lk, Lk))
    mask = np.where(g.random((B, 1, 1, Lk)) < 0.2, -10000.0,
                    0.0).astype(np.float32)
    return q, k, v, mask


@pytest.mark.parametrize("shape", FLAGSHIP,
                         ids=["text", "vision", "bi_text", "bi_vision"])
def test_bf16_default_mode_matches_the_jax_xla_path(shape):
    """ROUND_PROBS (the default) in bf16 against JAX's default attention
    path, which rounds the normalized probabilities to bf16 before P.V
    (crct_tpu/models/layers.py:61): within DIFFERING of the elements and one
    ulp; PALLAS mode, P kept fp32, misses that limit."""
    q, k, v, mask = flagship_inputs(30, shape)
    want = jax_layers.dot_product_attention(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(mask), dropout_rate=0.1, deterministic=True)
    got = _port(q, k, v, mask, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    share, ulps = bf16_agreement(got.float().numpy(), want)
    assert share <= DIFFERING and ulps <= 1.0, (share, ulps)
    pallas = _port(q, k, v, mask, dtype=torch.bfloat16, mode=port.PALLAS)
    assert bf16_agreement(pallas.float().numpy(), want)[0] > 0.3


def test_modes_are_one_function_in_fp32():
    """In fp32 the two modes are the same function, bit for bit, with and
    without dropout; an unknown mode is refused."""
    q, k, v, mask = make_qkv(12)
    for rate in (0.0, 0.3):
        a = _port(q, k, v, mask, dropout_rate=rate, seed=4)
        b = _port(q, k, v, mask, dropout_rate=rate, seed=4,
                  mode=port.PALLAS)
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    with pytest.raises(ValueError, match="mode"):
        _port(q, k, v, mask, mode="xla")


def test_default_mode_dropout_divides_in_bf16():
    """With dropout, ROUND_PROBS divides the kept bf16 probabilities by
    bf16(1 - rate) in bf16, as JAX's weak-typed ``/ (1.0 - rate)`` does
    (0.8984375 at rate 0.1): the port's plain forward against JAX's XLA
    path fed the port's keep mask (its bernoulli draw replaced)."""
    assert port.keep_divisor(0.1) == 0.8984375
    q, k, v, mask = flagship_inputs(31, FLAGSHIP[0])
    kept = port._kept((2, 16, 124, 124), 77, 0.1, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers.jax.random, "bernoulli",
                   lambda rng, p, shape: jnp.asarray(kept.numpy()))
        want = jax_layers.dot_product_attention(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
            jnp.asarray(mask), dropout_rate=0.1, deterministic=False,
            dropout_rng=jax.random.key(0))
    got = _port(q, k, v, mask, dtype=torch.bfloat16, dropout_rate=0.1,
                seed=77)
    share, ulps = bf16_agreement(got.float().numpy(), want)
    assert share <= DIFFERING and ulps <= 1.0, (share, ulps)


@pytest.mark.parametrize("rate", [0.1, 0.2, 0.3, 0.5, 0.05, 0.37])
def test_kernels_reciprocal_rounds_as_the_division(rate):
    """The kernels multiply by the fp32 reciprocal of bf16(1 - rate) (from
    _scalars) where JAX divides by bf16(1 - rate) in bf16: for every finite
    bf16 value, of either sign, the two give the same bf16 bits
    (csrc/attention_common.cuh says why)."""
    x = (torch.arange(1, 0x7F80, dtype=torch.int32).to(torch.int16)
         .view(torch.bfloat16).float())
    x = torch.cat([x, -x])
    q = torch.zeros(1, 1, 1, 1, dtype=torch.bfloat16)
    rcp = port._scalars(q, rate, 0, port.ROUND_PROBS)[3]
    want = (x / port.keep_divisor(rate)).to(torch.bfloat16)
    got = (x * rcp).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_tf32_split_keeps_the_forward_fp32_accurate():
    """The 3xTF32 split of K1's fp32 design (the TF32 wgmma design of
    csrc/attention_fwd.cu), its two products (q k^T, then the normalized P
    times the keep multipliers, v) emulated here with TF32 rounding by bit
    operations, against the plain version (held against JAX above) at the
    flagship's text shape at two rows, with a full mask and dropout: within
    1e-5, as chip_smoke.py holds K1 in fp32. One TF32 product alone (the
    control) misses that by far."""
    # the backward's file imports this one's helpers
    from tests.test_torch_attention_bwd import tf32_matmul
    q, k, v, mask = (torch.from_numpy(x) for x in make_qkv(
        13, B=2, H=16, Lq=124, Lk=124, D=48, full_mask=True))
    want = port.attention_reference(q, k, v, mask, 0.1, 5)
    keep = port.keep_mask((2, 16, 124, 124), 5, 0.1, "cpu")
    for terms, within in ((3, True), (1, False)):
        s = tf32_matmul(q, k.transpose(-1, -2), terms) * port._scale(48)
        got = tf32_matmul(port._softmax(s + mask)[0] * keep, v, terms)
        err = (got - want).abs().max().item()
        assert (err <= 1e-5) == within, (terms, err)
