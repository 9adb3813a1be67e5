"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA card and the CUDA toolkit (the kernel is built with
nvcc at first use); where no card is visible they skip. They import nothing
of JAX, so they also run on a machine that has only PyTorch; there, skip the
JAX-bound tests/conftest.py:

    python -m pytest --noconftest tests/test_torch_on_card.py -q

Tolerances: fp32 at 1e-5 (the kernels and the plain versions both compute
fp32 scores, probabilities and sums; only the summation order differs), of
the largest gradient magnitude for the backward; bf16 at 2e-2 (one bf16
rounding of each output). The RoIAlign backward (K3) at 2e-5 of
max(1, |grad|) in fp32 (it sums in another fixed order than the plain
version's index_add_) and, element by element, 2^-7 of |want| + 1e-3 in
bf16 (both round one fp32 sum once). chip_smoke.py holds the kernels
against the plain versions at the flagship shapes too.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from crct_tpu_torch.config import CRCTModelConfig
from crct_tpu_torch.models import layers
from crct_tpu_torch.models.crct import CRCTModel
from crct_tpu_torch.models.layers import init_weights
from crct_tpu_torch.ops import attention, roi_align
from crct_tpu_torch.ops import roi_align_kernel as rk

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# both attention modes: the JAX default path's rounding of P and the Pallas
# path's fp32 P (one kernel instance in fp32, two in bf16)
MODES = pytest.mark.parametrize("mode", attention.MODES)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest --noconftest "
                    "tests/test_torch_on_card.py on a machine with one")
    return torch.device("cuda")


def make_qkv(seed, B, H, Lq, Lk, D, Lm, dtype, device):
    g = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(g.normal(size=(B, H, L, D)).astype(np.float32))
               .to(device, dtype) for L in (Lq, Lk, Lk))
    mask = np.where(g.random((B, 1, Lm, Lk)) < 0.2, -10000.0, 0.0)
    return q, k, v, torch.from_numpy(mask.astype(np.float32)).to(device)


# (B, H, Lq, Lk, D): the flagship's bi-attention at a small batch, one query
# row, head counts of head blocks 2 and 1, many key tiles (the forward's
# online softmax, the backward's dq summed over key tiles in its scratch),
# many query tiles, and more (batch, head) items than the backward's
# persistent blocks, over several key and query tiles
SHAPES = [(5, 32, 44, 124, 32), (3, 6, 1, 9, 16), (2, 7, 33, 65, 128),
          (2, 2, 70, 1000, 128), (1, 2, 1100, 40, 128), (40, 16, 70, 300, 64)]


@MODES
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_matches_plain_on_card(card, shape, dtype, mode):
    B, H, Lq, Lk, D = shape
    for full in (False, True):
        for rate in (0.0, 0.1):
            q, k, v, mask = make_qkv(8, B, H, Lq, Lk, D, Lq if full else 1,
                                     dtype, card)
            before = attention.launch_count()
            got = attention.fused_attention(q, k, v, mask, rate, 99,
                                            mode=mode)
            assert attention.launch_count() == before + 1
            want = attention.attention_reference(q, k, v, mask, rate, 99,
                                                 mode=mode)
            assert got.dtype == dtype
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])


@MODES
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_lse_matches_plain_on_card(card, shape, dtype, mode):
    """The log-sum-exp K1 writes for the backward (fp32 [B, H, Lq]) against
    the plain one, within 1e-5 of max(1, |lse|) in both dtypes (the scores
    are fp32 sums of exact or 3xTF32 products), and the output of that
    launch as in test_kernel_matches_plain_on_card."""
    B, H, Lq, Lk, D = shape
    for full in (False, True):
        q, k, v, mask = make_qkv(10, B, H, Lq, Lk, D, Lq if full else 1,
                                 dtype, card)
        before = attention.launch_count()
        out, lse = attention.attention_forward(q, k, v, mask, 0.1, 5,
                                               mode=mode)
        assert attention.launch_count() == before + 1
        want, want_lse = attention.attention_reference(q, k, v, mask, 0.1, 5,
                                                       return_lse=True,
                                                       mode=mode)
        assert lse.dtype == torch.float32 and lse.shape == (B, H, Lq)
        top = max(1.0, want_lse.abs().max().item())
        torch.testing.assert_close(lse, want_lse, atol=1e-5 * top, rtol=0)
        torch.testing.assert_close(out.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@MODES
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_backward_kernel_matches_plain_on_card(card, shape, dtype, mode):
    """K2 through the autograd Function against attention_bwd_reference:
    one launch per backward, and dq, dk, dv within the tolerance."""
    B, H, Lq, Lk, D = shape
    for full in (False, True):
        for rate in (0.0, 0.1):
            q, k, v, mask = make_qkv(9, B, H, Lq, Lk, D, Lq if full else 1,
                                     dtype, card)
            g = torch.randn(q.shape, device=card,
                            generator=torch.Generator(card).manual_seed(3)
                            ).to(dtype)
            q, k, v = (x.requires_grad_() for x in (q, k, v))
            out = attention.fused_attention(q, k, v, mask, rate, -7,
                                            mode=mode)
            before = attention.bwd_launch_count()
            got = torch.autograd.grad(out, (q, k, v), g)
            assert attention.bwd_launch_count() == before + 1
            want = attention.attention_bwd_reference(q, k, v, mask, g, rate,
                                                     -7, mode=mode)
            for a, w in zip(got, want):
                assert a.dtype == dtype
                tol = TOL[dtype] * max(1.0, w.float().abs().max().item())
                torch.testing.assert_close(a.float(), w.float(), atol=tol,
                                           rtol=0)


def test_kernels_launch_on_every_card_on_card(card):
    """K1 and K2 on each visible card, the first card last (a scorer keeps a
    model replica on each): a kernel's shared-memory limit is raised per
    device, so a launch on a second card does not fail with
    cudaErrorInvalidValue."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    for d in list(range(1, n)) + [0]:
        dev = torch.device("cuda", d)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, mask = make_qkv(d, 4, 16, 124, 124, 48, 1, dtype, dev)
            q, k, v = (x.requires_grad_() for x in (q, k, v))
            out = attention.fused_attention(q, k, v, mask, 0.1, 5)
            got = torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
            want = attention.attention_bwd_reference(
                q, k, v, mask, torch.ones_like(out), 0.1, 5)
            torch.testing.assert_close(
                out.float(), attention.attention_reference(
                    q, k, v, mask, 0.1, 5).float(),
                atol=TOL[dtype], rtol=TOL[dtype])
            for a, w in zip(got, want):
                assert a.device == dev
                tol = TOL[dtype] * max(1.0, w.float().abs().max().item())
                torch.testing.assert_close(a.float(), w.float(), atol=tol,
                                           rtol=0)


def test_backward_regenerates_the_forward_mask_on_card(card):
    """<out, C> = <v, dv>: out is linear in v, so the two agree only if K2
    drew the keep mask K1 drew."""
    q, k, v, mask = make_qkv(4, 6, 16, 124, 124, 48, 1, torch.float32, card)
    v.requires_grad_()
    out = attention.fused_attention(q, k, v, mask, 0.1, 12345)
    c = torch.randn_like(out)
    (dv,) = torch.autograd.grad(out, (v,), c)
    torch.testing.assert_close((out * c).sum().double(),
                               (v * dv).sum().double(), rtol=1e-5, atol=1e-3)


# K1's wgmma design (bf16, the default mode, up to 128 keys) at its edges:
# query rows around its 64-row warpgroup tiles and 128-row blocks, keys
# around its 64- and 128-key instances (129 takes the two-pass instance),
# the head widths of each instance; key-only and full masks, dropout 0 and
# 0.1. Held as chip_smoke.py holds it at the flagship shapes: the output
# within 2e-2, the log-sum-exp within 1e-5 of max(1, |lse|), and at most
# 1 % of the output elements different from the plain version's at all
# (SHARE; about 3e-4 at the flagship shapes, PERF.md)
WG_SHARE = 0.01


@pytest.mark.parametrize("D", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("Lk", [1, 9, 124, 128, 129])
@pytest.mark.parametrize("Lq", [1, 63, 64, 65, 124, 129])
def test_wgmma_design_matches_plain_on_card(card, Lq, Lk, D):
    B, H = 4, 8
    mode = attention.ROUND_PROBS
    assert attention.fwd_design(torch.bfloat16, mode, Lk, D) == (
        "wgmma" if Lk <= 128 else "mma.sync two-pass")
    for full in (False, True):
        for rate in (0.0, 0.1):
            q, k, v, mask = make_qkv(Lq * Lk + D, B, H, Lq, Lk, D,
                                     Lq if full else 1, torch.bfloat16, card)
            before = attention.launch_count()
            out, lse = attention.attention_forward(q, k, v, mask, rate, 21,
                                                   mode=mode)
            assert attention.launch_count() == before + 1
            want, want_lse = attention.attention_reference(
                q, k, v, mask, rate, 21, return_lse=True, mode=mode)
            top = max(1.0, want_lse.abs().max().item())
            torch.testing.assert_close(lse, want_lse, atol=1e-5 * top, rtol=0)
            torch.testing.assert_close(out.float(), want.float(),
                                       atol=TOL[torch.bfloat16],
                                       rtol=TOL[torch.bfloat16])
            share = (out != want).float().mean().item()
            assert share <= WG_SHARE, (full, rate, share)


# K1's wgmma design in -pallas mode (P fp32, split into bf16 hi + lo for
# two register-A products a k-step) at its edges: query rows around its
# 64-row warpgroup tiles, keys around its 64- and 128-key instances (129
# takes the mma.sync instance), the head widths of each instance; key-only
# and full masks, dropout 0 and 0.1. The output within 2e-2, the
# log-sum-exp within 1e-5 of max(1, |lse|), as chip_smoke.py holds it.
@pytest.mark.parametrize("D", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("Lk", [1, 63, 64, 65, 128, 129])
@pytest.mark.parametrize("Lq", [1, 63, 64, 65, 124, 129])
def test_wgmma_pallas_design_matches_plain_on_card(card, Lq, Lk, D):
    B, H = 4, 8
    mode = attention.PALLAS
    assert attention.fwd_design(torch.bfloat16, mode, Lk, D) == (
        "wgmma" if Lk <= 128 else "mma.sync")
    for full in (False, True):
        for rate in (0.0, 0.1):
            q, k, v, mask = make_qkv(Lq * Lk + D + 1, B, H, Lq, Lk, D,
                                     Lq if full else 1, torch.bfloat16, card)
            before = attention.launch_count()
            out, lse = attention.attention_forward(q, k, v, mask, rate, 21,
                                                   mode=mode)
            assert attention.launch_count() == before + 1
            want, want_lse = attention.attention_reference(
                q, k, v, mask, rate, 21, return_lse=True, mode=mode)
            top = max(1.0, want_lse.abs().max().item())
            torch.testing.assert_close(lse, want_lse, atol=1e-5 * top, rtol=0)
            torch.testing.assert_close(out.float(), want.float(),
                                       atol=TOL[torch.bfloat16],
                                       rtol=TOL[torch.bfloat16])


def test_wgmma_design_takes_the_flagship_default_mode_on_card(card):
    """The bf16 launches at the flagship shapes take the wgmma design in
    both modes, the fp32 ones the TF32 wgmma design (one kernel for both
    modes); past 128 keys or at a D that is not a multiple of 8 the bf16
    default mode takes the two-pass instance and -pallas the one-pass
    mma.sync one, and fp32 past 128 keys or at a D past 64 or not a
    multiple of 4 the mma.sync one."""
    for Lk, D in ((124, 48), (44, 64), (44, 32), (124, 32)):
        for mode in attention.MODES:
            assert attention.fwd_design(torch.bfloat16, mode, Lk, D) \
                == "wgmma"
            assert attention.fwd_design(torch.float32, mode, Lk, D) \
                == "wgmma tf32"
    for Lk, D in ((300, 64), (44, 12)):
        assert attention.fwd_design(torch.bfloat16, attention.ROUND_PROBS,
                                    Lk, D) == "mma.sync two-pass"
        assert attention.fwd_design(torch.bfloat16, attention.PALLAS, Lk,
                                    D) == "mma.sync"
    assert attention.fwd_design(torch.float32, attention.ROUND_PROBS, 44,
                                12) == "wgmma tf32"
    for Lk, D in ((300, 64), (44, 128), (44, 6)):
        for mode in attention.MODES:
            assert attention.fwd_design(torch.float32, mode, Lk, D) \
                == "mma.sync"


@pytest.mark.parametrize("dtype, mode",
                         [(torch.bfloat16, m) for m in attention.MODES]
                         + [(torch.float32, attention.ROUND_PROBS)],
                         ids=[f"bfloat16-{m}" for m in attention.MODES]
                         + ["float32"])
def test_wgmma_design_refuses_a_misaligned_tensor_on_card(card, dtype, mode):
    """The wgmma designs read 16-byte aligned tensors (TMA, and the TF32
    design's 16-byte loads of K): a contiguous view one element (2 or 4
    bytes) into its storage raises at the launch, which is not counted,
    rather than taking another design, in either bf16 mode and in fp32."""
    q, k, v, mask = make_qkv(2, 2, 4, 124, 124, 48, 1, dtype, card)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=card)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    before = attention.launch_count()
    with pytest.raises(RuntimeError, match="CUDA error 716"):
        attention.fused_attention(shifted, k, v, mask, mode=mode)
    assert attention.launch_count() == before


# K1's TF32 wgmma design (fp32, up to 128 keys, D a multiple of 4 and at
# most 64) at its edges: query rows around its 64-row blocks, keys around
# its 64- and 128-key instances and the flagship 44 and 124, the head
# widths of its three instances (D 4 and 44 padded within them); key-only
# and full masks, dropout 0 and 0.1. The output within 1e-5 (atol and rtol)
# and the log-sum-exp within 1e-5 of max(1, |lse|) of the plain version's,
# as chip_smoke.py holds K1 in fp32. With dropout and no more keys than
# head columns, V's rows are the unit vectors, so that the output's zeros
# are the dropped probabilities: the same keep mask as the plain version's.
# With the full mask every fifth query row is masked at every key: its
# scores lie near -1e4, where fp32 keeps steps of 2^-10 (9.8e-4), and the
# kernel (in log2 units, one rounding more) and the plain version round
# them apart, which moves each probability by up to 2.6e-3 of itself; those
# rows are held at FULLY_MASKED (2.6e-3 of the output's up to ~4.5 at rate
# 0.1 is 1.2e-2), the rest at 1e-5.
FULLY_MASKED = 2e-2


@pytest.mark.parametrize("D", [4, 16, 32, 44, 48, 64])
@pytest.mark.parametrize("Lk", [1, 9, 44, 63, 64, 65, 124, 128])
@pytest.mark.parametrize("Lq", [1, 63, 64, 65, 124, 129])
def test_wgmma_tf32_forward_matches_plain_on_card(card, Lq, Lk, D):
    B, H = 4, 8
    for mode in attention.MODES:
        assert attention.fwd_design(torch.float32, mode, Lk, D) \
            == "wgmma tf32"
    tol = TOL[torch.float32]
    for full in (False, True):
        for rate in (0.0, 0.1):
            q, k, v, mask = make_qkv(Lq * Lk + D + 2, B, H, Lq, Lk, D,
                                     Lq if full else 1, torch.float32, card)
            masked = torch.zeros(Lq, dtype=torch.bool, device=card)
            if full:
                masked[3::5] = True
                mask[:, :, masked] = -10000.0
            before = attention.launch_count()
            out, lse = attention.attention_forward(q, k, v, mask, rate, 21)
            assert attention.launch_count() == before + 1
            want, want_lse = attention.attention_reference(
                q, k, v, mask, rate, 21, return_lse=True)
            top = max(1.0, want_lse.abs().max().item())
            torch.testing.assert_close(lse, want_lse, atol=1e-5 * top, rtol=0)
            torch.testing.assert_close(out[:, :, ~masked], want[:, :, ~masked],
                                       atol=tol, rtol=tol)
            torch.testing.assert_close(out[:, :, masked], want[:, :, masked],
                                       atol=FULLY_MASKED, rtol=0)
            if rate > 0 and Lk <= D:
                eye = torch.eye(Lk, D, device=card).expand(
                    B, H, Lk, D).contiguous()
                got = attention.fused_attention(q, k, eye, mask, rate, 21)
                drop = attention.attention_reference(q, k, eye, mask, rate,
                                                     21)
                assert torch.equal(got == 0, drop == 0)


# K2's wgmma design (bf16, up to 128 keys, D a multiple of 8) at its edges:
# query rows around its 64-query chunks (129 takes three, through both
# buffers), keys around its one- and two-warpgroup instances (129 takes the
# mma.sync design over key tiles), the head widths of each instance;
# key-only and full masks, dropout 0 and 0.1, each bf16 mode the design
# takes (WG_BWD_MODES). Held as chip_smoke.py holds K2 at the flagship
# shapes: each gradient within 2e-2 of max(1, |grad|) and, in the default
# mode, at most SHARE["K2"] (2 %) of the gradients' elements different from
# the plain version's at all (about 1.5e-3 at the flagship shapes,
# PERF.md). With one key dq and dk are zero in exact arithmetic (dS = P dP
# (1 - P) with P = 1) and rounding noise in both, so there the share is not
# held; nor past 128 keys, where the mma.sync design takes delta from
# g . out and the plain version, given no output, from dP * P.
WG_BWD_SHARE = 0.02
WG_BWD_MODES = attention.MODES


def wgmma_bwd_case(card, B, H, Lq, Lk, D, Lm, rate, mode, seed=0,
                   dtype=torch.bfloat16):
    """(K2's gradients, the plain version's, the share of elements that
    differ) for inputs in ``dtype`` made from ``seed``."""
    q, k, v, mask = make_qkv(seed, B, H, Lq, Lk, D, Lm, dtype, card)
    g = torch.randn(q.shape, device=card,
                    generator=torch.Generator(card).manual_seed(seed)
                    ).to(dtype)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = attention.fused_attention(q, k, v, mask, rate, 33, mode=mode)
    before = attention.bwd_launch_count()
    got = torch.autograd.grad(out, (q, k, v), g)
    assert attention.bwd_launch_count() == before + 1
    want = attention.attention_bwd_reference(q, k, v, mask, g, rate, 33,
                                             mode=mode)
    n = sum(w.numel() for w in want)
    share = sum((a != w).sum().item() for a, w in zip(got, want)) / n
    return got, want, share


@pytest.mark.parametrize("D", [16, 32, 48, 64, 128])
@pytest.mark.parametrize("Lk", [1, 9, 44, 64, 65, 124, 128, 129])
@pytest.mark.parametrize("Lq", [1, 63, 64, 65, 124, 129])
def test_wgmma_backward_matches_plain_on_card(card, Lq, Lk, D):
    B, H = 4, 8
    for mode in WG_BWD_MODES:
        assert attention.bwd_design(torch.bfloat16, mode, Lk, D) == (
            "wgmma" if Lk <= 128 else "mma.sync key tiles")
        for full in (False, True):
            for rate in (0.0, 0.1):
                got, want, share = wgmma_bwd_case(
                    card, B, H, Lq, Lk, D, Lq if full else 1, rate, mode,
                    Lq * Lk + D)
                for a, w in zip(got, want):
                    assert a.dtype == torch.bfloat16
                    tol = TOL[torch.bfloat16] * max(
                        1.0, w.float().abs().max().item())
                    torch.testing.assert_close(a.float(), w.float(),
                                               atol=tol, rtol=0)
                if mode == attention.ROUND_PROBS and 1 < Lk <= 128:
                    assert share <= WG_BWD_SHARE, (mode, full, rate, share)


def test_wgmma_backward_takes_the_flagship_bf16_launches_on_card(card):
    """The backward launches at the flagship shapes take the wgmma design
    in bf16, in each mode it takes, and the TF32 wgmma design in fp32 but
    at the vision shape (D 64), which takes the TF32 TMA design; more than
    128 keys the mma.sync design over key tiles, and the shapes the wgmma
    designs do not take (bf16 at a D that is not a multiple of 8, fp32 at
    one that is not a multiple of 4, above 64, or above 48 with more than
    64 keys) the mma.sync design."""
    for Lk, D in ((124, 48), (44, 64), (44, 32), (124, 32)):
        for mode in attention.MODES:
            assert attention.bwd_design(torch.bfloat16, mode, Lk, D) == (
                "wgmma" if mode in WG_BWD_MODES else "mma.sync")
            assert attention.bwd_design(torch.float32, mode, Lk, D) == (
                "wgmma tf32 tma" if D == 64 else "wgmma tf32")
    for dtype in (torch.float32, torch.bfloat16):
        assert attention.bwd_design(dtype, attention.ROUND_PROBS, 300, 64) \
            == "mma.sync key tiles"
    assert attention.bwd_design(torch.bfloat16, attention.ROUND_PROBS, 44,
                                12) == "mma.sync"
    assert attention.bwd_design(torch.float32, attention.ROUND_PROBS, 44,
                                12) == "wgmma tf32"
    for Lk, D in ((44, 30), (124, 64), (44, 128)):
        assert attention.bwd_design(torch.float32, attention.ROUND_PROBS,
                                    Lk, D) == "mma.sync"


# K2's TF32 wgmma design (fp32, up to 128 keys, D a multiple of 4 and at
# most 48: tf32_takes in csrc/attention_bwd.cu) at its edges: query rows
# around its 32-query chunks, keys around its one- and two-warpgroup
# instances (129 takes the mma.sync design over key tiles), the head widths
# of each instance and beyond it (D 64 takes the TF32 TMA design up to 64
# keys and the mma.sync design past them, D 128 the mma.sync design);
# key-only and full masks, dropout 0 and 0.1. Each gradient within 1e-5 of max(1, |grad|), as chip_smoke.py
# holds K2 in fp32. One key is held apart (the next test).
def tf32_design(Lk, D):
    if Lk > 128:
        return "mma.sync key tiles"
    if D % 4 == 0 and D <= 48:
        return "wgmma tf32"
    return "wgmma tf32 tma" if D % 4 == 0 and D <= 64 and Lk <= 64 \
        else "mma.sync"


@pytest.mark.parametrize("D", [16, 32, 44, 48, 64, 128])
@pytest.mark.parametrize("Lk", [9, 44, 63, 64, 65, 124, 128, 129])
@pytest.mark.parametrize("Lq", [1, 31, 33, 63, 64, 65, 124, 129])
def test_wgmma_tf32_backward_matches_plain_on_card(card, Lq, Lk, D):
    B, H = 4, 8
    for mode in attention.MODES:
        assert attention.bwd_design(torch.float32, mode, Lk, D) \
            == tf32_design(Lk, D)
    for full in (False, True):
        for rate in (0.0, 0.1):
            got, want, _ = wgmma_bwd_case(
                card, B, H, Lq, Lk, D, Lq if full else 1, rate,
                attention.ROUND_PROBS, Lq * Lk + D, torch.float32)
            for a, w in zip(got, want):
                assert a.dtype == torch.float32
                tol = TOL[torch.float32] * max(1.0, w.abs().max().item())
                torch.testing.assert_close(a, w, atol=tol, rtol=0)


# One key: the softmax over it is 1 whatever its score, so dq and dk are
# zero in exact arithmetic, and the plain version, which recomputes the
# softmax, gives exactly zero. K2 (every design) takes P = exp(s - lse)
# from the forward's log-sum-exp: where the key is masked, s and lse lie
# near -1e4, where fp32 keeps about 1e-3, and dq and dk are that rounding
# of P: dq and dk are P dP (1 - P), and dv = P^T g carries it too. Held:
# each gradient within 1e-2 of max(1, |grad|) (read: 1.6e-3 of it in dq
# and dk, 4.8e-3 absolute in dv of up to 24), at a width of the TF32 design
# (48), of the TF32 TMA design (64) and of the mma.sync one (128), every
# row's key masked.
@pytest.mark.parametrize("D", [48, 64, 128])
def test_fp32_backward_over_one_masked_key_on_card(card, D):
    B, H, Lq = 4, 8, 33
    assert attention.bwd_design(torch.float32, attention.ROUND_PROBS, 1,
                                D) == tf32_design(1, D)
    q, k, v, _ = make_qkv(D, B, H, Lq, 1, D, 1, torch.float32, card)
    mask = torch.full((B, 1, 1, 1), -10000.0, device=card)
    g = torch.randn(q.shape, device=card,
                    generator=torch.Generator(card).manual_seed(D))
    leaves = [x.requires_grad_() for x in (q, k, v)]
    out = attention.fused_attention(*leaves, mask, 0.1, 9)
    got = torch.autograd.grad(out, leaves, g)
    want = attention.attention_bwd_reference(q, k, v, mask, g, 0.1, 9)
    top = max(1.0, max(w.abs().max().item() for w in want))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, atol=1e-2 * top, rtol=0)


# K2's TF32 TMA design (fp32, at most 64 keys, 48 < D <= 64: tf32_tma_takes
# in csrc/attention_bwd.cu) at its edges: one query and one key, query rows
# around its 32-query chunks, keys around its one warpgroup, Lq != Lk, key-
# only and full masks that always mask the first key (a fully masked key)
# and never the last (no row masked whole: the test above holds that one),
# dropout 0 and 0.1. Each gradient within 1e-5 of max(1, |grad|), as
# chip_smoke.py holds K2 in fp32.
@pytest.mark.parametrize("D", [52, 64])
@pytest.mark.parametrize("Lk", [1, 17, 44, 64])
@pytest.mark.parametrize("Lq", [1, 17, 44, 64])
def test_wgmma_tf32_tma_backward_matches_plain_on_card(card, Lq, Lk, D):
    B, H = 4, 8
    for mode in attention.MODES:
        assert attention.bwd_design(torch.float32, mode, Lk, D) \
            == "wgmma tf32 tma"
    for full in (False, True):
        for rate in (0.0, 0.1):
            q, k, v, mask = make_qkv(Lq + Lk + D, B, H, Lq, Lk, D,
                                     Lq if full else 1, torch.float32, card)
            mask[..., -1] = 0.0
            if Lk > 1:
                mask[..., 0] = -10000.0
            g = torch.randn(q.shape, device=card,
                            generator=torch.Generator(card).manual_seed(D))
            leaves = [x.requires_grad_() for x in (q, k, v)]
            out = attention.fused_attention(*leaves, mask, rate, 21)
            before = attention.bwd_launch_count()
            got = torch.autograd.grad(out, leaves, g)
            assert attention.bwd_launch_count() == before + 1
            want = attention.attention_bwd_reference(q, k, v, mask, g, rate,
                                                     21)
            for a, w in zip(got, want):
                tol = TOL[torch.float32] * max(1.0, w.abs().max().item())
                torch.testing.assert_close(a, w, atol=tol, rtol=0)


@pytest.mark.parametrize("dtype, L, D",
                         [(torch.bfloat16, 124, 48), (torch.float32, 124, 48),
                          (torch.float32, 44, 64)],
                         ids=["bfloat16", "float32", "float32-d64"])
def test_wgmma_backward_refuses_a_misaligned_cotangent_on_card(card, dtype,
                                                               L, D):
    """The wgmma designs read 16-byte aligned tensors: a contiguous
    cotangent one element (2 or 4 bytes) into its storage raises at K2's
    launch, which is not counted, rather than taking another design (the
    TF32 TMA design at D 64)."""
    q, k, v, mask = make_qkv(2, 2, 4, L, L, D, 1, dtype, card)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = attention.fused_attention(q, k, v, mask)
    flat = torch.empty(out.numel() + 1, dtype=out.dtype, device=card)
    shifted = flat[1:].view(out.shape)
    shifted.copy_(torch.randn_like(out))
    before = attention.bwd_launch_count()
    with pytest.raises(RuntimeError, match="CUDA error 716"):
        torch.autograd.grad(out, (q, k, v), shifted)
    assert attention.bwd_launch_count() == before


@pytest.mark.parametrize("dtype, mode, L, D",
                         [(torch.bfloat16, m, 124, 48) for m in WG_BWD_MODES]
                         + [(torch.float32, attention.ROUND_PROBS, 124, 48),
                            (torch.float32, attention.ROUND_PROBS, 44, 64)],
                         ids=[f"bfloat16-{m}" for m in WG_BWD_MODES]
                         + ["float32", "float32-d64"])
def test_wgmma_backward_is_deterministic_on_card(card, dtype, mode, L, D):
    """Two launches on the same inputs give the same bits: one block owns a
    (batch, head), with no atomics and every sum in a fixed order (bf16 on
    the wgmma design, fp32 on the TF32 one and, at D 64, the TF32 TMA
    one)."""
    q, k, v, mask = make_qkv(6, 6, 16, L, L, D, 1, dtype, card)
    g = torch.randn(q.shape, device=card,
                    generator=torch.Generator(card).manual_seed(6)
                    ).to(dtype)
    out, lse = attention.attention_forward(q, k, v, mask, 0.1, 8, mode=mode)
    mask4 = mask.expand(6, 1, 1, L).contiguous()
    first, second = (attention._launch_bwd(q, k, v, mask4, g, out, lse, 0.1,
                                           8, mode) for _ in range(2))
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for a, b in zip(first, second):
        assert torch.equal(a.view(bits), b.view(bits))


def test_kernel_rejects_what_it_does_not_take_on_card(card):
    q, k, v, mask = make_qkv(1, 2, 4, 8, 8, 16, 1, torch.float32, card)
    before = attention.launch_count()
    for bad in ((q.half(), k.half(), v.half(), mask),
                (q.transpose(2, 3).contiguous().transpose(2, 3), k, v, mask),
                (q, k, v.cpu(), mask)):
        with pytest.raises((TypeError, ValueError)):
            attention.fused_attention(*bad)
    assert attention.launch_count() == before


def small_config(**kw):
    return CRCTModelConfig(
        vocab_size=600, hidden_size=64, num_hidden_layers=4,
        num_attention_heads=4, intermediate_size=128, v_feature_size=32,
        v_hidden_size=32, v_num_hidden_layers=2, v_num_attention_heads=2,
        v_intermediate_size=32, bi_hidden_size=32, bi_num_attention_heads=4,
        v_biattention_id=[0, 1], t_biattention_id=[2, 3],
        max_position_embeddings=128, **kw)


def small_batch(card):
    g = np.random.default_rng(0)
    B, L, R = 6, 16, 6
    sep = np.zeros((B, 50), np.int64)
    sep[:, 0] = g.integers(L // 2, L - 1, B)
    batch = {
        "tokens": g.integers(0, 600, (B, L)), "segments": g.integers(-1, 5, (B, L)),
        "loc": g.random((B, L, 4)).astype(np.float32), "sep_indices": sep,
        "hist_len": np.zeros((B, 1), np.int64),
        "image_feat": g.random((B, R, 32)).astype(np.float32),
        "image_loc": g.random((B, R, 4)).astype(np.float32),
        "image_target": g.integers(0, 10, (B, R)),
        "image_mask": (g.random((B, R)) < 0.8).astype(np.float32),
        "R": np.tile(np.float32([5.0, 1, 0.01, 10.0]), (B, 1)),
        "next_sentence_labels": g.integers(0, 2, (B,)),
    }
    return {k: torch.from_numpy(np.asarray(v)).to(card)
            for k, v in batch.items()}


def test_model_forward_goes_through_the_kernel_on_card(card):
    """A small CRCTModel on the card: one attention launch per attention
    block, and the same outputs as with the plain attention."""
    cfg = small_config()
    model = CRCTModel(cfg, categories=10)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(card).eval()
    batch = small_batch(card)
    per_forward = (cfg.num_hidden_layers + cfg.v_num_hidden_layers
                   + 2 * len(cfg.v_biattention_id))
    with torch.inference_mode():
        before = attention.launch_count()
        got = model(batch)
        assert attention.launch_count() == before + per_forward
        with mock.patch.object(layers, "fused_attention",
                               attention.attention_reference):
            want = model(batch)
        assert attention.launch_count() == before + per_forward
    for name in ("nsp_logits", "reg_output"):
        torch.testing.assert_close(getattr(got, name), getattr(want, name),
                                   atol=1e-5, rtol=1e-4)


def test_model_train_step_goes_through_both_kernels_on_card(card):
    """One training forward and backward of a small CRCTModel with dropout
    on: one K1 and one K2 launch per attention block, and the loss and
    every gradient as through the plain versions from the same generator
    state (fp32: loss within 1e-5 relative, each gradient within 1e-4 of
    its largest magnitude)."""
    cfg = small_config()
    model = CRCTModel(cfg, categories=10)
    init_weights(model, torch.Generator().manual_seed(0))
    model = model.to(card).train()
    batch = small_batch(card)
    per_forward = (cfg.num_hidden_layers + cfg.v_num_hidden_layers
                   + 2 * len(cfg.v_biattention_id))

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        out = model(batch, torch.Generator().manual_seed(5))
        out.loss.backward()
        return out.loss.item(), {n: p.grad.clone() for n, p in
                                 model.named_parameters()
                                 if p.grad is not None}

    attention.reset_launch_count()
    loss, grads = loss_and_grads()
    assert attention.launch_count() == per_forward
    assert attention.bwd_launch_count() == per_forward
    with mock.patch.object(layers, "fused_attention",
                           attention.plain_attention):
        want_loss, want = loss_and_grads()
    assert attention.launch_count() == per_forward
    assert attention.bwd_launch_count() == per_forward
    assert abs(loss - want_loss) <= 1e-5 * abs(want_loss)
    assert set(grads) == set(want)
    for name, g in grads.items():
        tol = 1e-4 * max(want[name].abs().max().item(), 1e-6)
        torch.testing.assert_close(g, want[name], atol=tol, rtol=0,
                                   msg=name)


ROI_CFG = ((4, 8, 16, 32), None, 2, 4, 224, 2, 5)
PYRAMID = [(336, 336), (168, 168), (84, 84), (42, 42)]     # 1344 canvas


def roi_cfg(P):
    return (ROI_CFG[0], P) + ROI_CFG[2:]


def roi_boxes(n, seed):
    """Boxes on the 1344 canvas, every FPN level taking some: wide labels,
    tall thin bars, tiny ticks, whole-figure boxes."""
    g = np.random.default_rng(seed)
    kind = np.arange(n) % 4
    lo = np.asarray([[300, 20], [12, 100], [6, 6], [500, 500]])[kind]
    hi = np.asarray([[900, 50], [120, 1100], [60, 24], [1344, 1344]])[kind]
    wh = g.uniform(lo, hi)
    xy = g.random((n, 2)) * (1344 - wh)
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


@pytest.mark.parametrize("P,N", [(7, 256), (14, 64)], ids=["box", "mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_roi_align_kernel_matches_plain_on_card(card, P, N, dtype):
    """K3 at the flagship shapes (C = 256, the 1344 pyramid): one launch,
    the maps' dtype, and the plain version's gradient: fp32 within 2e-5 of
    max(1, |grad|) (another fixed order of the sums); bf16 element by
    element within 2^-7 of |want| + 1e-3 (both sum in fp32 from the same
    bf16 g and round once, so they differ by at most about one bf16
    ulp)."""
    boxes = torch.from_numpy(roi_boxes(N, P)).to(card)
    g = torch.randn(N, P, P, 256, device=card,
                    generator=torch.Generator(card).manual_seed(P)).to(dtype)
    geo = roi_align.mlra_geometry(PYRAMID, boxes, *roi_cfg(P))
    assert set(geo["lvl"].tolist()) == {0, 1, 2, 3}
    before = rk.launch_count()
    got = rk.mlra_backward_kernel(g, geo, PYRAMID, dtype, 2)
    assert rk.launch_count() == before + 1
    want = rk.mlra_backward_reference(g, geo, PYRAMID, dtype, 2)
    assert_roi_close(got, want, dtype)


def assert_roi_close(got, want, dtype):
    """K3's tolerances against the plain version, level by level."""
    top = max(1.0, max(w.float().abs().max().item() for w in want))
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=2e-5 * top, rtol=0)
        else:
            torch.testing.assert_close(a.float(), w.float(), atol=1e-3,
                                       rtol=2 ** -7)


ODD_PYRAMID = [(200, 304), (100, 152), (50, 76), (25, 38)]  # 800 x 1216


def roi_case(name):
    """(pyramid, boxes) of one K3 edge case: an odd canvas whose levels
    end in partial 8 x 8 tiles, with every level hit; 320 rois crowded into
    one tile of level 0 (more than one 256-roi scan of a block); boxes on
    and past the canvas's border (clamped corners, lo == hi) and of zero
    area (every sample on one position); one roi."""
    g = np.random.default_rng(11)
    if name == "odd_canvas":
        return ODD_PYRAMID, roi_boxes(64, 5) * np.float32(800 / 1344)
    if name == "crowded":
        xy = g.uniform(34.5, 53, (320, 2))        # level-0 positions 8..15
        wh = g.uniform(0, 8, (320, 2))
        return PYRAMID, np.concatenate([xy, xy + wh], 1).astype(np.float32)
    if name == "border":
        b = [[-10, -10, 60, 30], [1300, 1310, 1350, 1360], [0, 0, 0, 0],
             [1344, 1344, 1344, 1344], [600, 600, 600, 600],
             [500, 700, 500, 900], [100, 800, 300, 800],
             [-40, 400, 1400, 460], [1200, -30, 1400, 1400],
             [0, 0, 1344, 1344], [1343.5, 5, 1344, 1344]]
        return PYRAMID, np.asarray(b, np.float32)
    if name == "one_roi":
        return PYRAMID, roi_boxes(1, 9)
    raise ValueError(name)


@pytest.mark.parametrize("case", ["odd_canvas", "crowded", "border",
                                  "one_roi"])
@pytest.mark.parametrize("P", [7, 14], ids=["box", "mask"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_roi_align_kernel_matches_plain_at_edge_cases_on_card(card, case, P,
                                                              dtype):
    """K3 against its plain version where a tile-owned kernel goes wrong
    while the flagship shapes pass: partial tiles, a crowded tile (more
    rois than one scan of a block), clamped corners, degenerate boxes and
    N = 1 (tolerances as at the flagship shapes)."""
    shapes, boxes = roi_case(case)
    boxes = torch.from_numpy(boxes).to(card)
    geo = roi_align.mlra_geometry(shapes, boxes, *roi_cfg(P))
    if case == "odd_canvas":
        assert set(geo["lvl"].tolist()) == {0, 1, 2, 3}
    if case == "crowded":
        assert set(geo["lvl"].tolist()) == {0}
        assert geo["y0"].min() >= 8 and geo["y1i"].max() <= 15
        assert geo["x0"].min() >= 8 and geo["x1i"].max() <= 15
    g = torch.randn(len(boxes), P, P, 256, device=card,
                    generator=torch.Generator(card).manual_seed(3)).to(dtype)
    got = rk.mlra_backward_kernel(g, geo, shapes, dtype, 2)
    want = rk.mlra_backward_reference(g, geo, shapes, dtype, 2)
    assert_roi_close(got, want, dtype)


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32),
                                    (torch.bfloat16, torch.bfloat16),
                                    (torch.bfloat16, torch.float32)],
                         ids=["fp32", "bf16", "bf16_g_fp32_maps"])
def test_roi_align_kernel_is_one_deterministic_launch_on_card(card, dtypes):
    """Two launches give the same bits; a call launches exactly one CUDA
    kernel (no memset, no cast, no copy: torch.profiler sees nothing else)
    and returns the maps' dtype, also from a cotangent of another dtype."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    g_dtype, dtype = dtypes
    boxes = torch.from_numpy(roi_boxes(256, 7)).to(card)
    geo = roi_align.mlra_geometry(PYRAMID, boxes, *roi_cfg(7))
    g = torch.randn(256, 7, 7, 256, device=card,
                    generator=torch.Generator(card).manual_seed(4)).to(g_dtype)
    first = rk.mlra_backward_kernel(g, geo, PYRAMID, dtype, 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = rk.mlra_backward_kernel(g, geo, PYRAMID, dtype, 2)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "roi_align_bwd" in names[0], names
    for a, b in zip(first, again):
        assert a.dtype == b.dtype == dtype
        assert torch.equal(a.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32),
                           b.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
    want = rk.mlra_backward_reference(g, geo, PYRAMID, dtype, 2)
    assert_roi_close(again, want, dtype)


def test_roi_align_kernel_rejects_what_it_does_not_take_on_card(card):
    """Wrong dtypes, devices, shapes, no roi, channels not a multiple of
    8 and geometry that is not as the forward saved it raise before any
    launch. P * S has no limit: P 33 (66 samples an axis, above the first
    kernel's 64) is taken and matches the plain version."""
    boxes = torch.from_numpy(roi_boxes(8, 0)).to(card)
    geo = roi_align.mlra_geometry(PYRAMID, boxes, *roi_cfg(7))
    cpu_geo = {k: v.cpu() for k, v in geo.items()}
    int32_geo = dict(geo, y0=geo["y0"].int())
    strided_geo = dict(geo, wx1=geo["wx1"].t().contiguous().t())
    none = roi_align.mlra_geometry(PYRAMID, boxes[:0], *roi_cfg(7))
    g = torch.randn(8, 7, 7, 16, device=card)
    f32 = torch.float32
    before = rk.launch_count()
    for bad in ((g.half(), geo, PYRAMID, f32),
                (g, geo, PYRAMID, torch.float16),
                (g, cpu_geo, PYRAMID, f32),
                (g, int32_geo, PYRAMID, f32),
                (g, strided_geo, PYRAMID, f32),
                (g[..., :12], geo, PYRAMID, f32),
                (g[:, :6], geo, PYRAMID, f32),
                (g[:0], none, PYRAMID, f32)):
        with pytest.raises((TypeError, ValueError)):
            rk.mlra_backward_kernel(*bad, 2)
    assert rk.launch_count() == before
    g33 = torch.randn(8, 33, 33, 16, device=card)
    geo33 = roi_align.mlra_geometry(PYRAMID, boxes, *roi_cfg(33))
    got = rk.mlra_backward_kernel(g33, geo33, PYRAMID, f32, 2)
    assert rk.launch_count() == before + 1
    assert_roi_close(got, rk.mlra_backward_reference(g33, geo33, PYRAMID,
                                                     f32, 2), f32)


def test_detector_train_step_goes_through_k3_on_card(card, monkeypatch):
    """One train step of a tiny detector (depth 14, 128 x 128, batch 2):
    one K3 launch per image and RoIAlign branch, and the
    losses and gradients of the same step through K3's plain version
    (fp32: losses within 1e-5 relative, gradients within 1e-4 of their
    largest magnitude)."""
    from crct_tpu_torch.detector.mask_rcnn import (MaskRCNN,
                                                   init_detector_weights)
    model = MaskRCNN(num_classes=4, depth=14, roi_batch=32,
                     post_nms_topk_train=64, fc_dim=64)
    init_detector_weights(model, torch.Generator().manual_seed(0))
    model.to(card)
    g = np.random.default_rng(1)
    gt = np.zeros((2, 8, 4), np.float32)
    gt[:, :6] = roi_boxes(12, 3).reshape(2, 6, 4) / 10.5
    batch = {"images": torch.from_numpy(g.normal(size=(2, 128, 128, 3))
                                        .astype(np.float32)).to(card),
             "gt_boxes": torch.from_numpy(gt).to(card),
             "gt_classes": torch.from_numpy(g.integers(0, 4, (2, 8))
                                            .astype(np.int32)).to(card),
             "gt_valid": torch.from_numpy(np.arange(8) < 6).expand(2, 8)
                              .to(card),
             "gt_masks28": torch.ones(2, 8, 28, 28, device=card)}
    # fp32 convolutions without TF32, as DetectorTrainer runs them: TF32
    # would turn the last-bit differences of another order of the sums into
    # ~1e-3 ones
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)

    def step():
        model.zero_grad(set_to_none=True)
        losses = model(batch["images"], train=True,
                       gt_boxes=batch["gt_boxes"],
                       gt_classes=batch["gt_classes"],
                       gt_valid=batch["gt_valid"],
                       gt_masks28=batch["gt_masks28"],
                       generator=torch.Generator(card).manual_seed(2))
        losses["total"].backward()
        return ({k: v.item() for k, v in losses.items()},
                {n: p.grad.clone() for n, p in model.named_parameters()})

    rk.reset_launch_count()
    losses, grads = step()
    assert rk.LAUNCHES == {("float32", 7, 256): 2, ("float32", 14, 256): 2}
    monkeypatch.setattr(rk, "mlra_backward_kernel",
                        rk.mlra_backward_reference)
    want_losses, want = step()
    assert rk.launch_count() == 4
    for k, w in want_losses.items():
        assert abs(losses[k] - w) <= 1e-5 * abs(w), k
    for name, gr in grads.items():
        tol = 1e-4 * max(want[name].abs().max().item(), 1e-6)
        torch.testing.assert_close(gr, want[name], atol=tol, rtol=0,
                                   msg=name)


def eval_setup(root, card):
    """A synthetic test split (4 figures x 3 questions, 32-wide region
    features) and a small model with a fast-scorer head on the card, its
    weights drawn at scale 0.3 from a seed: wide enough apart that the
    kernel's and the plain attention's last-bit differences move no
    answer."""
    import dataclasses
    from crct_tpu_torch.config import default_params
    from crct_tpu_torch.data.dataset import ChartQADataset
    from crct_tpu_torch.data.synthetic import generate_dataset
    data = generate_dataset(str(root / "data"), n_images=4, division=4,
                            n_questions=3, feat_dim=32, splits=("test",))
    params = default_params(
        figure_feat_path=data["figure_feat_path"],
        qa_parent_dir=data["qa_parent_dir"], dataset_config=data,
        eval_set="test", eval_batch_size=32, save_path=str(root / "out"))
    ds = ChartQADataset(params, "test", init_split="test")
    ds.get_all_answers = True
    model = CRCTModel(dataclasses.replace(small_config(), vocab_size=30522),
                      categories=params["categories"], fast_scorer=True)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3
                    + (1.0 if "LayerNorm" in name else 0.0))
    return params, ds, model.to(card).eval()


def test_fast_eval_step_goes_through_the_kernel_on_card(card, tmp_path):
    """make_fast_eval_step on the card: one K1 launch per attention block
    of the one backbone pass, and the candidate logits and regression
    outputs of the plain attention within 1e-4 of max(1, |plain|)."""
    from crct_tpu_torch.data.dataset import DataLoader
    from crct_tpu_torch.train import eval_loop
    params, ds, model = eval_setup(tmp_path, card)
    batch = next(iter(DataLoader(ds, 6, shuffle=False, num_workers=1)))
    rows = eval_loop.build_fast_rows(batch)
    step = eval_loop.make_fast_eval_step(model)
    cfg = model.config
    per_forward = (cfg.num_hidden_layers + cfg.v_num_hidden_layers
                   + 2 * len(cfg.v_biattention_id))
    attention.reset_launch_count()
    got = step(rows)
    assert attention.launch_count() == per_forward
    with mock.patch.object(layers, "fused_attention",
                           attention.attention_reference):
        want = step(rows)
    assert attention.launch_count() == per_forward
    valid = torch.from_numpy(rows["cand_valid"] > 0).to(card)
    for g, w in ((got[0][valid], want[0][valid]), (got[1], want[1])):
        tol = 1e-4 * max(1.0, w.abs().max().item())
        torch.testing.assert_close(g, w, atol=tol, rtol=0)


def test_evaluate_goes_through_the_kernel_on_card(card, tmp_path):
    """evaluate()'s full protocol on the card against the same call with
    the plain attention: K1 launched, per-row NSP probabilities within
    1e-4, and the same answers wherever the plain run's two best
    candidates lie more than 1e-4 apart."""
    from crct_tpu_torch.data.dataset import DataLoader
    from crct_tpu_torch.train import eval_loop
    params, ds, model = eval_setup(tmp_path, card)

    def run():
        seen, recs = [], []
        real = eval_loop.segmented_argmax

        def rec(values, offsets):
            seen.append((values.copy(), offsets.copy()))
            return real(values, offsets)
        with mock.patch.object(eval_loop, "segmented_argmax", rec):
            total, _, _ = eval_loop.evaluate(
                DataLoader(ds, 5, shuffle=False, drop_last=False,
                           num_workers=1), ds, params, model, csv=False,
                on_predictions=recs.extend, log_print=lambda m: None)
        return total, seen, recs

    attention.reset_launch_count()
    total, seen, recs = run()
    launches = attention.launch_count()
    assert launches > 0
    with mock.patch.object(layers, "fused_attention",
                           attention.attention_reference):
        _, want_seen, want_recs = run()
    assert attention.launch_count() == launches
    assert total[0, 1] == len(ds)
    for (v, off), (w, woff) in zip(seen, want_seen):
        np.testing.assert_array_equal(off, woff)
        assert np.abs(v - w).max() <= 1e-4
        for s, e in zip(woff[:-1], woff[1:]):
            top = np.sort(w[s:e])[::-1]
            if len(top) < 2 or top[0] - top[1] > 1e-4:
                assert np.argmax(v[s:e]) == np.argmax(w[s:e])
    assert len(recs) == len(want_recs) == len(ds)


def test_retrieval_recipe_through_the_kernels_as_through_the_plain_attention(
        card, tmp_path):
    """The shortlist tool's backbone (the retrieval recipe of
    tests/test_torch_recipe.py) from the tool's initial weights, 600 steps
    through K1 and K2 and 600 through the plain attention on the card: the
    first 40 steps' losses within 2e-3 of each other, the CPU test's limit
    of the port against the JAX Trainer. Each run's mean loss over its last
    50 steps is printed (ln 2 = 0.693: the plateau); the recipe amplifies
    rounding, so the two need not agree there."""
    from crct_tpu_torch.tools import shortlist_miss_rate as tool
    params, _, batches = tool.recipe(str(tmp_path))
    runs = {}
    for path, fn in (("kernels", attention.fused_attention),
                     ("plain", attention.plain_attention)):
        before = attention.launch_count() + attention.bwd_launch_count()
        with mock.patch.object(layers, "fused_attention", fn):
            _, losses = tool.train_backbone(params, batches, card, 600)
        runs[path] = (np.asarray(losses), attention.launch_count()
                      + attention.bwd_launch_count() - before)
    (got, launched), (want, plain_launched) = runs["kernels"], runs["plain"]
    gap = np.abs(got - want)
    print(f"retrieval recipe on {torch.cuda.get_device_name(card)}: first "
          f"40 steps' largest loss gap {gap[:40].max():.3g}; mean loss of "
          f"the last 50 steps: K1/K2 {got[-50:].mean():.5f}, plain "
          f"{want[-50:].mean():.5f}")
    assert launched > 0 and plain_launched == 0
    assert gap[:40].max() <= 2e-3, gap[:40]


def test_a_span_holds_its_launch_on_the_profilers_clock_on_card(card,
                                                                tmp_path):
    """The tracer's spans around launches of a sleep kernel hold each
    launch's ``cudaLaunchKernel`` record of the profiler's trace (CUDA
    activity only), on the trace's clock; by the tightest of ten, the two
    clocks lie within 20 us of each other (the larger of the room before
    and after the call). The bound read is printed."""
    import json
    from torch.profiler import ProfilerActivity, profile

    from crct_tpu_torch.utils import tracing
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    tracing.enable()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                with tracing.span("probe"):
                    torch.cuda._sleep(1000)
            torch.cuda.synchronize()
    finally:
        tracing.disable()
    spans = tracing.drain()["spans"]
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    launches = sorted((e for e in trace["traceEvents"]
                       if e.get("name") == "cudaLaunchKernel"),
                      key=lambda e: e["ts"])
    assert len(launches) == len(spans) == 10
    events = tracing.chrome_events(spans, int(trace["baseTimeNanoseconds"]))
    slack = []
    for ev, sp in zip(launches, events):
        before = ev["ts"] - sp["ts"]
        after = sp["ts"] + sp["dur"] - (ev["ts"] + ev["dur"])
        assert before >= 0 and after >= 0, (before, after)
        slack.append(max(before, after))
    print(f"clock alignment on {torch.cuda.get_device_name(card)}: within "
          f"{min(slack):.2f} us (each: {[round(s, 2) for s in slack]})")
    assert min(slack) < 20.0, slack
