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
scores, probabilities and sums; only the summation order differs); bf16 at
2e-2 of the largest gradient magnitude (one bf16 rounding of each
gradient, and bf16 inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crct_tpu.ops import attention as jax_attention
from crct_tpu_torch.ops import attention as port

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


def port_vjp(q, k, v, mask, cot, rate, seed, dtype=torch.float32):
    """(out, dq, dk, dv) through the port's autograd Function."""
    t = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out = port.fused_attention(*t, torch.from_numpy(mask), rate, seed)
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
    got = port_vjp(q, k, v, mask, cot, 0.3, 7, torch.bfloat16)
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
