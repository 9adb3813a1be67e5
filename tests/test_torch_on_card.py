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
max(1, |grad|) in fp32 (fp32 atomics reorder the sums) and 1e-2 of it in
bf16. chip_smoke.py holds the kernels against the plain versions at the
flagship shapes too.
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


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_matches_plain_on_card(card, shape, dtype):
    B, H, Lq, Lk, D = shape
    for full in (False, True):
        for rate in (0.0, 0.1):
            q, k, v, mask = make_qkv(8, B, H, Lq, Lk, D, Lq if full else 1,
                                     dtype, card)
            before = attention.launch_count()
            got = attention.fused_attention(q, k, v, mask, rate, 99)
            assert attention.launch_count() == before + 1
            want = attention.attention_reference(q, k, v, mask, rate, 99)
            assert got.dtype == dtype
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_lse_matches_plain_on_card(card, shape, dtype):
    """The log-sum-exp K1 writes for the backward (fp32 [B, H, Lq]) against
    the plain one, within 1e-5 of max(1, |lse|) in both dtypes (the scores
    are fp32 sums of exact or 3xTF32 products), and the output of that
    launch as in test_kernel_matches_plain_on_card."""
    B, H, Lq, Lk, D = shape
    for full in (False, True):
        q, k, v, mask = make_qkv(10, B, H, Lq, Lk, D, Lq if full else 1,
                                 dtype, card)
        before = attention.launch_count()
        out, lse = attention.attention_forward(q, k, v, mask, 0.1, 5)
        assert attention.launch_count() == before + 1
        want, want_lse = attention.attention_reference(q, k, v, mask, 0.1, 5,
                                                       return_lse=True)
        assert lse.dtype == torch.float32 and lse.shape == (B, H, Lq)
        top = max(1.0, want_lse.abs().max().item())
        torch.testing.assert_close(lse, want_lse, atol=1e-5 * top, rtol=0)
        torch.testing.assert_close(out.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_backward_kernel_matches_plain_on_card(card, shape, dtype):
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
            out = attention.fused_attention(q, k, v, mask, rate, -7)
            before = attention.bwd_launch_count()
            got = torch.autograd.grad(out, (q, k, v), g)
            assert attention.bwd_launch_count() == before + 1
            want = attention.attention_bwd_reference(q, k, v, mask, g, rate,
                                                     -7)
            for a, w in zip(got, want):
                assert a.dtype == dtype
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
    max(1, |grad|) (atomics reorder the sums); bf16 element by element
    within 2^-7 of |want| + 1e-3 (both sum in fp32 from the same bf16 g
    and round once, so they differ by at most about one bf16 ulp)."""
    boxes = torch.from_numpy(roi_boxes(N, P)).to(card)
    g = torch.randn(N, P, P, 256, device=card,
                    generator=torch.Generator(card).manual_seed(P)).to(dtype)
    geo = roi_align.mlra_geometry(PYRAMID, boxes, *roi_cfg(P))
    assert set(geo["lvl"].tolist()) == {0, 1, 2, 3}
    before = rk.launch_count()
    got = rk.mlra_backward_kernel(g, geo, PYRAMID, dtype, 2)
    assert rk.launch_count() == before + 1
    want = rk.mlra_backward_reference(g, geo, PYRAMID, dtype, 2)
    top = max(1.0, max(w.float().abs().max().item() for w in want))
    for a, w in zip(got, want):
        assert a.dtype == dtype and a.shape == w.shape
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, atol=2e-5 * top, rtol=0)
        else:
            torch.testing.assert_close(a.float(), w.float(), atol=1e-3,
                                       rtol=2 ** -7)


def test_roi_align_kernel_rejects_what_it_does_not_take_on_card(card):
    boxes = torch.from_numpy(roi_boxes(8, 0)).to(card)
    geo = roi_align.mlra_geometry(PYRAMID, boxes, *roi_cfg(7))
    cpu_geo = {k: v.cpu() for k, v in geo.items()}
    none = roi_align.mlra_geometry(PYRAMID, boxes[:0], *roi_cfg(7))
    g = torch.randn(8, 7, 7, 16, device=card)
    f32 = torch.float32
    before = rk.launch_count()
    for bad in ((g.half(), geo, PYRAMID, f32),
                (g, geo, PYRAMID, torch.float16),
                (g, cpu_geo, PYRAMID, f32),
                (g[:, :6], geo, PYRAMID, f32),
                (g[:0], none, PYRAMID, f32)):
        with pytest.raises((TypeError, ValueError)):
            rk.mlra_backward_kernel(*bad, 2)
    with pytest.raises(ValueError):          # P * S above the kernel's 64
        rk.mlra_backward_kernel(
            torch.randn(8, 33, 33, 16, device=card),
            roi_align.mlra_geometry(PYRAMID, boxes, *roi_cfg(33)), PYRAMID,
            f32, 2)
    assert rk.launch_count() == before


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
    # would turn the atomics' last-bit differences into ~1e-3 ones
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
    assert rk.LAUNCHES == {(7, 256): 2, (14, 256): 2}
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
