"""The port's attention backward against the JAX package's.

crct_tpu_torch/ops/attention.py's backward (the autograd Function around
the kernels, which runs attention_bwd_reference, the plain version of the
CUDA kernel csrc/attention_bwd.cu, on CPU tensors) is held against jax.vjp
of crct_tpu.ops.attention._attention with the Pallas kernels in interpret
mode, on the same numpy inputs and the same int seed; and against
torch.autograd through attention_reference. The CUDA kernel itself is held
against the plain version on the card (tests/test_torch_on_card.py and
chip_smoke.py).

Tolerances: fp32 at 1e-5 absolute and relative (both sides compute fp32
scores, probabilities and sums; only the summation order differs); bf16
against the Pallas path (the port's PALLAS mode) at 2e-2 of the largest
gradient magnitude (one bf16 rounding of each gradient, and bf16 inputs).
The default mode (ROUND_PROBS) against jax.vjp of JAX's default XLA path
(crct_tpu/models/layers.py:dot_product_attention), fed the same keep mask:
at most 0.1 % of each of out, dq, dk and dv differ at all, none by more
than one bf16 ulp of the largest magnitude
(tests/test_torch_attention.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crct_tpu.models import layers as jax_layers
from crct_tpu.ops import attention as jax_attention
from crct_tpu_torch.ops import attention as port
from tests.test_torch_attention import (DIFFERING, FLAGSHIP, bf16_agreement,
                                        flagship_inputs)

FP32 = dict(atol=1e-5, rtol=1e-5)


def make_case(seed, B=2, H=4, Lq=6, Lk=5, D=8, full_mask=False):
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
    cot = g.normal(size=(B, H, Lq, D)).astype(np.float32)
    return q, k, v, mask, cot


def jax_vjp(q, k, v, mask, cot, rate, seed, dtype=jnp.float32):
    """(out, dq, dk, dv) of the Pallas kernels in interpret mode."""
    jm = jnp.asarray(mask)
    s = jnp.full((1, 1), seed, jnp.int32)
    out, vjp = jax.vjp(
        lambda a, b, c: jax_attention._attention(a, b, c, jm, s, rate, True),
        *(jnp.asarray(x, dtype) for x in (q, k, v)))
    grads = vjp(jnp.asarray(cot, dtype))
    return [np.asarray(x, np.float32) for x in (out, *grads)]


def port_vjp(q, k, v, mask, cot, rate, seed, dtype=torch.float32,
             mode=port.ROUND_PROBS):
    """(out, dq, dk, dv) through the port's autograd Function."""
    t = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = port.fused_attention(*t, torch.from_numpy(mask), rate, seed,
                               mode=mode)
    grads = torch.autograd.grad(out, t, torch.from_numpy(cot).to(dtype))
    return [x.detach().float().numpy() for x in (out, *grads)]


@pytest.mark.parametrize("rate", [0.0, 0.3], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("full_mask", [False, True], ids=["key_only", "full"])
@pytest.mark.parametrize("H", [4, 6, 16, 32])
def test_backward_matches_pallas_interpret(H, full_mask, rate):
    """H = 4 (one head block), 6 (blocks of 2), 16 and 32 (blocks of 8)
    cover the grid program -> head mapping of the dropout hash."""
    q, k, v, mask, cot = make_case(H, H=H, full_mask=full_mask)
    want = jax_vjp(q, k, v, mask, cot, rate, 424242)
    got = port_vjp(q, k, v, mask, cot, rate, 424242)
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, w, err_msg=name, **FP32)


def test_backward_plain_version_matches_pallas_interpret():
    """attention_bwd_reference alone, called as the kernel's wrapper calls
    the kernel: the JAX kernel's formulas, the same keep mask."""
    q, k, v, mask, cot = make_case(3, H=6, full_mask=True)
    want = jax_vjp(q, k, v, mask, cot, 0.3, 99)[1:]
    got = port.attention_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v, mask, cot)), 0.3, 99)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), w, **FP32)


@pytest.mark.parametrize("seed", [-1, -2 ** 31, 2 ** 31 - 1])
def test_backward_seeds_at_the_int32_edges(seed):
    q, k, v, mask, cot = make_case(11, H=16)
    want = jax_vjp(q, k, v, mask, cot, 0.5, seed)
    got = port_vjp(q, k, v, mask, cot, 0.5, seed)
    for a, w in zip(got, want):
        np.testing.assert_allclose(a, w, **FP32)


@pytest.mark.parametrize("full_mask", [False, True], ids=["key_only", "full"])
def test_backward_bf16_matches_pallas_interpret(full_mask):
    q, k, v, mask, cot = make_case(5, H=6, full_mask=full_mask)
    want = jax_vjp(q, k, v, mask, cot, 0.3, 7, jnp.bfloat16)
    got = port_vjp(q, k, v, mask, cot, 0.3, 7, torch.bfloat16, port.PALLAS)
    for a, w in zip(got, want):
        tol = 2e-2 * max(1.0, np.abs(w).max())
        np.testing.assert_allclose(a, w, atol=tol, rtol=0)


def test_dropout_forward_backward_mask_consistency():
    """out is linear in v, so <out, C> = <v, dv> holds only if the
    backward regenerated the forward's keep mask."""
    q, k, v, mask, cot = make_case(9, H=6, full_mask=True)
    out, _, _, dv = port_vjp(q, k, v, mask, cot, 0.3, 31337)
    np.testing.assert_allclose(np.vdot(out, cot), np.vdot(v, dv), rtol=1e-5)


@pytest.mark.parametrize("rate", [0.0, 0.3], ids=["no_dropout", "dropout"])
def test_backward_matches_torch_autograd_of_the_plain_forward(rate):
    q, k, v, mask, cot = make_case(13, H=4, full_mask=True)
    got = port_vjp(q, k, v, mask, cot, rate, 5)
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = port.attention_reference(*t, torch.from_numpy(mask), rate, 5)
    want = torch.autograd.grad(out, t, torch.from_numpy(cot))
    for a, w in zip(got[1:], want):
        np.testing.assert_allclose(a, w.numpy(), **FP32)


def test_mask_gets_no_gradient_and_plain_path_agrees():
    """The mask and the seed are not differentiated; plain_attention (what
    the kernels are held against on the card) gives the same gradients as
    the CPU wrapper; no kernel is counted on the CPU."""
    q, k, v, mask, cot = make_case(17, H=4)
    port.reset_launch_count()
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    m = torch.from_numpy(mask).requires_grad_()
    out = port.fused_attention(*t, m, 0.3, 1)
    out.backward(torch.from_numpy(cot))
    assert m.grad is None
    assert all(x.grad is not None for x in t)
    p = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    port.plain_attention(*p, torch.from_numpy(mask), 0.3, 1).backward(
        torch.from_numpy(cot))
    for a, b in zip(t, p):
        torch.testing.assert_close(a.grad, b.grad, atol=0, rtol=0)
    assert port.launch_count() == 0 and port.bwd_launch_count() == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("Lk", [5, port.ONE_PASS_KEYS + 3],
                         ids=["one_tile", "several_tiles"])
def test_plain_backward_with_and_without_lse_and_out(Lk, dtype):
    """attention_bwd_reference from the forward's (lse, out), as the
    Function runs it, against recomputing the softmax and delta, under
    dropout: P = exp(s - lse) equals the softmax, and delta from g . out
    (above ONE_PASS_KEYS keys, where the kernel takes it so) equals
    sum_j dP * P because out = (P * keep) v. fp32 within 1e-5, bf16
    within 2e-2 of the largest gradient (out is rounded to bf16)."""
    q, k, v, mask, cot = make_case(21, H=6, Lk=Lk, full_mask=True)
    q, k, v, cot = (torch.from_numpy(x).to(dtype) for x in (q, k, v, cot))
    mask = torch.from_numpy(mask)
    out, lse = port.attention_reference(q, k, v, mask, 0.3, 77,
                                        return_lse=True)
    want = port.attention_bwd_reference(q, k, v, mask, cot, 0.3, 77)
    got = port.attention_bwd_reference(q, k, v, mask, cot, 0.3, 77, lse, out)
    for a, w in zip(got, want):
        assert a.dtype == dtype
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, **FP32)
        else:
            tol = 2e-2 * max(1.0, w.float().abs().max().item())
            torch.testing.assert_close(a.float(), w.float(), atol=tol, rtol=0)


@pytest.mark.parametrize("rate", [0.0, 0.1], ids=["no_dropout", "dropout"])
@pytest.mark.parametrize("shape", FLAGSHIP,
                         ids=["text", "vision", "bi_text", "bi_vision"])
def test_bf16_default_mode_vjp_matches_the_jax_xla_path(shape, rate):
    """The default mode's out, dq, dk and dv in bf16 against jax.vjp of
    JAX's default attention path with the port's keep mask (its bernoulli
    draw replaced): dv from the bf16 P, dP rounded to bf16 and divided in
    bf16 by bf16(1 - rate) before the fp32 softmax backward, as JAX's VJP
    takes them. Within DIFFERING of the elements and one ulp each."""
    q, k, v, mask = flagship_inputs(40, shape)
    B, (H, Lq, Lk, D) = 2, shape
    cot = np.asarray(jnp.asarray(np.random.default_rng(41).normal(
        size=(B, H, Lq, D)), jnp.bfloat16), np.float32)
    kept = port._kept((B, H, Lq, Lk), 9, rate, "cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers.jax.random, "bernoulli",
                   lambda rng, p, shape: jnp.asarray(kept.numpy()))
        out, vjp = jax.vjp(
            lambda a, b, c: jax_layers.dot_product_attention(
                a, b, c, jnp.asarray(mask), dropout_rate=rate,
                deterministic=rate == 0.0, dropout_rng=jax.random.key(0)),
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
        want = (out, *vjp(jnp.asarray(cot, jnp.bfloat16)))
    got = port_vjp(q, k, v, mask, cot, rate, 9, torch.bfloat16)
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        share, ulps = bf16_agreement(a, w)
        assert share <= DIFFERING and ulps <= 1.0, (name, share, ulps)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 as cvt.rna.tf32.f32 rounds it: to the
    nearest value with 10 mantissa bits, ties away from zero (half of the 13
    dropped bits added to the magnitude, then the 13 bits cleared)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(
        torch.int32).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 product reads of an fp32 ``x`` as it lies in shared
    memory: its top 19 bits, the 13 low mantissa bits cleared."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFE000
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(
        torch.int32).view(torch.float32)


def tf32_split(x: torch.Tensor, raw: bool = False):
    """(hi, lo) of ``x`` as K2's TF32 designs split an operand: hi the TF32
    rounding of x, or with ``raw`` its truncation (the fp32 tile read as it
    is, which the TF32 TMA design does for the raw Q and G that TMA copies),
    and lo the TF32 rounding of what hi left over."""
    hi = tf32_truncate(x) if raw else tf32_round(x)
    return hi, tf32_round(x - hi)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, terms: int = 3,
                raw: str = ""):
    """a @ b in fp32 from TF32 operands, as K2's TF32 designs take their
    products: with 3 terms hi_a hi_b + hi_a lo_b + lo_a hi_b (3xTF32, lo_a
    lo_b left out); with 1 the product of the high parts alone. ``raw``
    names the operands ("a", "b") whose high part is their truncation
    (tf32_split)."""
    ah, al = tf32_split(a, "a" in raw)
    bh, bl = tf32_split(b, "b" in raw)
    out = ah @ bh
    if terms == 3:
        out = out + ah @ bl + al @ bh
    return out


def tf32_backward(q, k, v, mask, g, rate, seed, terms=3, raw=False):
    """attention_bwd_reference's fp32 formulas with each of K2's five
    products (q k^T, g v^T, dv, dq, dk) through tf32_matmul; with ``raw`` q
    and g enter every product as raw tiles (the TF32 TMA design: the B
    operands of S^T = K Q^T and dP^T = V G^T as TMA copies them, and of dK
    and dV, Q^T and G^T, the raw values transposed)."""
    scale = port._scale(q.shape[-1])
    a, b = ("a", "b") if raw else ("", "")
    s = tf32_matmul(q, k.transpose(-1, -2), terms, a) * scale + mask
    probs = port._softmax(s)[0]
    dpd = tf32_matmul(g, v.transpose(-1, -2), terms, a)
    keep = port.keep_mask(tuple(probs.shape), seed, rate, probs.device)
    pd, dp = probs * keep, dpd * keep
    ds = probs * (dp - (dp * probs).sum(-1, keepdim=True))
    return (tf32_matmul(ds, k, terms) * scale,
            tf32_matmul(ds.transpose(-1, -2), q, terms, b) * scale,
            tf32_matmul(pd.transpose(-1, -2), g, terms, b))


# (Lq, Lk, D, raw): a shape of the TF32 design's widths with its operands
# all rounded, and the vision self-attention (D 64) as the TF32 TMA design
# takes it, q and g read as raw tiles
TF32_SPLITS = {"tf32": (37, 41, 48, False), "tf32_tma_vision": (44, 44, 64, True)}


@pytest.mark.parametrize("case", TF32_SPLITS)
def test_tf32_split_keeps_the_backward_fp32_accurate(case):
    """The 3xTF32 split of K2's fp32 designs (csrc/attention_bwd.cu), its
    five products emulated here with TF32 rounding and truncation by bit
    operations, against attention_bwd_reference (held against JAX above)
    with dropout: within 1e-5 of max(1, |grad|), as chip_smoke.py holds the
    kernel on the card. One TF32 product alone (the control) misses that by
    far."""
    Lq, Lk, D, raw = TF32_SPLITS[case]
    q, k, v, mask, cot = (torch.from_numpy(x) for x in make_case(
        7, B=2, H=4, Lq=Lq, Lk=Lk, D=D, full_mask=True))
    want = port.attention_bwd_reference(q, k, v, mask, cot, 0.1, 5)
    top = max(1.0, max(w.abs().max().item() for w in want))
    for terms, within in ((3, True), (1, False)):
        got = tf32_backward(q, k, v, mask, cot, 0.1, 5, terms, raw)
        err = max((a - w).abs().max().item() for a, w in zip(got, want))
        assert (err <= 1e-5 * top) == within, (terms, err, top)
