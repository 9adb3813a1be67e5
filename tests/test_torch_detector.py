"""The port's Mask R-CNN detector against the JAX package's, on the CPU.

One tiny detector (depth 14, a 64 x 64 image, fc_dim 64, 16 sampled rois,
as tests/test_mask_rcnn.py builds it) is initialized by the JAX package,
its frozen-norm statistics drawn at random, and carried into the port by
``detector_flax_to_state_dict`` (loaded with strict=True). The same numpy
image and boxes then go through both packages:

  * the trunk, FPN, RPN head and RoI heads: within 1e-5 of the largest
    magnitude (fp32 convolutions summed in other orders);
  * ResNet alone, stride_in_1x1 both ways, freeze_at 0 and 2: outputs and
    gradients (the frozen stages' gradients are zero in JAX, absent here);
  * the train losses within 1e-5 relative and every gradient within 1e-4
    of its largest magnitude, against jax.value_and_grad, with the JAX
    sampling noise handed to the port's one draw function, through K3's
    wrapper (its plain version on the CPU) and through the einsum backward
    put in its place;
  * inference: the same detections (boxes within 1e-3 px);
  * SGD steps against make_detector_optimizer (within 1e-6), the schedule,
    and the decay of the frozen convs (a quirk of the reference, matched);
  * CocoDataset items and evaluate_detections on charts rendered by the
    JAX package's synthetic_charts;
  * Detectron2- and torchvision-named files loaded by both packages'
    loaders;
  * the CLI: two iterations on the CPU, checkpoints, and --test.

Discrete choices (top-k, NMS, matching, sampling) are held equal: the
inputs were checked to keep them clear of ties, and the test asserts equal
proposals first, so a flip shows as such.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from crct_tpu.detector import coco as jax_coco
from crct_tpu.detector import rpn as jax_rpn
from crct_tpu.detector import trainer as jax_trainer
from crct_tpu.detector.convert import \
    restore_detector_params as jax_restore
from crct_tpu.detector.mask_rcnn import MaskRCNN as JaxMaskRCNN
from crct_tpu.detector.resnet import ResNet as JaxResNet
from crct_tpu.detector.synthetic_charts import generate_png_dataset
from crct_tpu_torch.detector import boxes, coco, trainer
from crct_tpu_torch.detector.convert import (detector_file_meta,
                                             detector_flax_to_state_dict,
                                             restore_detector_params)
from crct_tpu_torch.detector.mask_rcnn import MaskRCNN
from crct_tpu_torch.detector.resnet import ResNet
from crct_tpu_torch.ops import roi_align, roi_align_kernel

KW = dict(num_classes=5, depth=14, with_mask=True, post_nms_topk_train=32,
          post_nms_topk_test=16, roi_batch=16, fc_dim=64)
GT_BOXES = np.asarray([[4, 4, 30, 30], [32, 32, 60, 60], [0, 0, 0, 0]],
                      np.float32)
GT_CLASSES = np.asarray([1, 3, 0], np.int32)
GT_VALID = np.asarray([True, True, False])
GT_MASKS = np.ones((3, 28, 28), np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def random_norms(params, seed):
    """The frozen norms' statistics at random (JAX inits them to identity)."""
    r = np.random.default_rng(seed)

    def draw(path, x):
        names = [getattr(k, "key", "") for k in path]
        if not any("bn" in n for n in names):
            return np.asarray(x)
        if names[-1] in ("scale", "var"):
            return (r.random(x.shape) + 0.5).astype(np.float32)
        return (r.normal(size=x.shape) * 0.1).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def port_model(params, **kw):
    model = MaskRCNN(**dict(KW, **kw))
    model.load_state_dict(detector_flax_to_state_dict(params), strict=True)
    return model


def rel_err(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max()
                 / max(float(np.abs(np.asarray(want)).max()), 1e-6))


@pytest.fixture(scope="module")
def tiny():
    jm = JaxMaskRCNN(**KW)
    image = np.random.default_rng(0).random((64, 64, 3)).astype(np.float32)
    variables = jax.jit(functools.partial(jm.init, train=True))(
        jax.random.key(0), image, gt_boxes=GT_BOXES, gt_classes=GT_CLASSES,
        gt_valid=GT_VALID, gt_masks28=GT_MASKS, rng=jax.random.key(1))
    params = random_norms(variables["params"], 5)
    return jm, params, image


@pytest.fixture(scope="module")
def jax_train(tiny):
    """jax.value_and_grad of the tiny detector's train losses, and the
    sampling noise its two samplers drew."""
    jm, params, image = tiny
    key = jax.random.key(2)

    def loss_fn(p):
        losses = jm.apply({"params": p}, image, train=True,
                          gt_boxes=jnp.asarray(GT_BOXES),
                          gt_classes=jnp.asarray(GT_CLASSES),
                          gt_valid=jnp.asarray(GT_VALID),
                          gt_masks28=jnp.asarray(GT_MASKS), rng=key)
        return losses["total"], losses

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn,
                                                    has_aux=True))(params)
    shapes = [(64 // s, 64 // s) for s in jax_rpn.RPN_STRIDES]
    n_anchors = sum(a.shape[0] for a in jax_rpn.level_anchors(shapes))
    r1, r2 = jax.random.split(key)
    noise = [np.asarray(jax.random.uniform(r1, (n_anchors,))),
             np.asarray(jax.random.uniform(r2, (KW["post_nms_topk_train"]
                                                + len(GT_BOXES),)))]
    return ({k: float(v) for k, v in losses.items()},
            detector_flax_to_state_dict(jax.tree.map(np.asarray, grads)),
            noise)


def test_trunk_fpn_rpn_and_heads_match_jax(tiny):
    jm, params, image = tiny
    model = port_model(params)
    want = jax.jit(lambda p, im: jm.apply({"params": p}, im,
                                          method=JaxMaskRCNN.features))(
        params, image)
    with torch.no_grad():
        got = model.features(t(image)[None])
        logits, deltas = model.proposal_generator.rpn_head(got)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert rel_err(g[0].permute(1, 2, 0), w) <= 1e-5

    def heads(mod, feats, pooled7, pooled14):
        lg, dl = mod.rpn_head(feats)
        sc, bd = mod.box_predictor(mod.box_head(pooled7))
        return lg, dl, sc, bd, mod.mask_head(pooled14)

    r = np.random.default_rng(1)
    p7 = r.normal(size=(6, 7, 7, 256)).astype(np.float32)
    p14 = r.normal(size=(3, 14, 14, 256)).astype(np.float32)
    jlg, jdl, jsc, jbd, jmask = jm.apply({"params": params}, want, p7, p14,
                                         method=heads)
    with torch.no_grad():
        sc, bd = model.roi_heads.box_predictor(
            model.roi_heads.box_head(t(p7)))
        mask = model.roi_heads.mask_head(t(p14))
    for lvl in range(5):
        assert rel_err(logits[lvl][0], jlg[lvl]) <= 1e-5
        assert rel_err(deltas[lvl][0], jdl[lvl]) <= 1e-5
    assert rel_err(sc, jsc) <= 1e-5 and rel_err(bd, jbd) <= 1e-5
    assert rel_err(mask.permute(0, 2, 3, 1), jmask) <= 1e-5


@pytest.mark.parametrize("stride_in_1x1,freeze_at", [(False, 0), (True, 2)])
def test_resnet_matches_jax(stride_in_1x1, freeze_at):
    """C2..C5 and every gradient of <outputs, cotangents>; with freeze_at 2
    the stem's and res2's gradients are zero in JAX and absent here."""
    jr = JaxResNet(depth=14, stride_in_1x1=stride_in_1x1, freeze_at=freeze_at)
    x = np.random.default_rng(3).normal(size=(1, 32, 32, 3)).astype(np.float32)
    params = random_norms(jax.jit(jr.init)(jax.random.key(4), x)["params"], 6)
    cot = [np.random.default_rng(i).normal(size=(1, 32 // s, 32 // s, c))
           .astype(np.float32)
           for i, (s, c) in enumerate(zip((4, 8, 16, 32),
                                          (256, 512, 1024, 2048)))]

    def loss(p):
        outs = jr.apply({"params": p}, x)
        return sum(jnp.sum(o * c) for o, c in zip(outs, cot)), outs

    (_, outs), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)
    model = ResNet(14, stride_in_1x1, freeze_at)
    prefix = "backbone.bottom_up."
    sd = detector_flax_to_state_dict({"backbone": params})
    model.load_state_dict({k[len(prefix):]: v for k, v in sd.items()},
                          strict=True)
    got = model(t(x).permute(0, 3, 1, 2))
    sum((o * t(c).permute(0, 3, 1, 2)).sum()
        for o, c in zip(got, cot)).backward()
    for g, w in zip(got, outs):
        assert rel_err(g.detach().permute(0, 2, 3, 1), w) <= 1e-5
    want = detector_flax_to_state_dict(
        {"backbone": jax.tree.map(np.asarray, jgrads)})
    frozen = ("stem.", "res2.")[:freeze_at]
    for name, p in model.named_parameters():
        w = want[prefix + name]
        if name.startswith(frozen):
            assert p.grad is None and not w.any(), name
        else:
            assert rel_err(p.grad, w) <= 1e-4, name


@pytest.mark.parametrize("route", ["einsum", "kernel"])
def test_train_losses_and_gradients_match_jax(tiny, jax_train, route,
                                              monkeypatch):
    """The losses within 1e-5 relative and every gradient within 1e-4 of
    its largest magnitude, from the same weights, image and noise, through
    K3's wrapper and through the einsum backward put in its place."""
    jm, params, image = tiny
    want_losses, want_grads, noise = jax_train
    model = port_model(params)
    draws = list(noise)

    def draw(generator, n, device):
        x = draws.pop(0)
        assert x.shape == (n,)
        return t(x)

    monkeypatch.setattr(boxes, "_draw_uniform", draw)
    calls = []
    real = (roi_align_kernel.mlra_backward_kernel if route == "kernel"
            else roi_align._mlra_backward)
    monkeypatch.setattr(roi_align_kernel, "mlra_backward_kernel",
                        lambda g, *a: calls.append(g.shape) or real(g, *a))
    losses = model(t(image)[None], train=True, gt_boxes=t(GT_BOXES)[None],
                   gt_classes=t(GT_CLASSES)[None], gt_valid=t(GT_VALID)[None],
                   gt_masks28=t(GT_MASKS)[None])
    losses["total"].backward()
    assert not draws
    # the backward reaches the mask branch first
    assert calls == [(4, 14, 14, 256), (16, 7, 7, 256)]
    assert set(losses) == set(want_losses)
    for k, w in want_losses.items():
        assert abs(losses[k].item() - w) <= 1e-5 * abs(w), k
    for name, p in model.named_parameters():
        assert rel_err(p.grad, want_grads[name]) <= 1e-4, name


def test_inference_matches_jax(tiny):
    """Detections at a 0.05 score cut, so that NMS keeps some: the same
    classes and validity, boxes within 1e-3 px, scores and features within
    1e-5 of their largest magnitude."""
    jm, params, image = tiny
    jm = jm.clone(score_thresh_test=0.05)
    model = port_model(params, score_thresh_test=0.05)
    want = jax.jit(lambda p, im: jm.apply({"params": p}, im, train=False))(
        params, image)
    with torch.no_grad():
        got = model(t(image)[None], train=False)
    assert set(got) == set(want)
    valid = np.asarray(want["valid"])
    assert 0 < valid.sum() < len(valid)
    for k in ("valid", "classes", "proposal_valid"):
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(want[k]))
    np.testing.assert_allclose(got["proposals"][0].numpy(),
                               np.asarray(want["proposals"]), atol=1e-3)
    np.testing.assert_allclose(got["boxes"][0].numpy(),
                               np.asarray(want["boxes"]), atol=1e-3)
    for k in ("scores", "features", "mask_logits"):
        assert rel_err(got[k][0], want[k]) <= 1e-5, k


def test_sgd_steps_and_schedule_match_optax(tiny):
    """Three steps of DetectorSGD against make_detector_optimizer on the
    same gradients, within 1e-6. With freeze_at 2 the stem's and res2's
    convs get zero gradients in JAX (stop_gradient) and none here, yet both
    packages decay them: _param_labels freezes only the '*bn*' params, so
    add_decayed_weights still reaches the frozen convs (Detectron2 would
    leave them alone; ROADMAP.md records it). A large rate and decay make
    the decay visible in fp32."""
    jm, params, image = tiny
    base_lr, wd = 10.0, 0.1
    tx = jax_trainer.make_detector_optimizer(base_lr, weight_decay=wd)
    model = port_model(params)
    opt = trainer.DetectorSGD(list(model.parameters()), base_lr, wd)
    names = [n for n, _ in model.named_parameters()]
    frozen = ("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")
    jparams, state = params, tx.init(params)
    update = jax.jit(tx.update)
    r = np.random.default_rng(8)
    for _ in range(3):
        grads = jax.tree_util.tree_map_with_path(
            lambda path, x: np.zeros_like(x)
            if getattr(path[1], "key", "").startswith(("stem", "stage2"))
            and path[0].key == "backbone"
            else r.normal(size=x.shape).astype(np.float32), params)
        updates, state = update(grads, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tgrads = detector_flax_to_state_dict(grads)
        for n, p in model.named_parameters():
            p.grad = None if n.startswith(frozen) else tgrads[n].clone()
        opt.step()
    want = detector_flax_to_state_dict(jax.tree.map(np.asarray, jparams))
    start = detector_flax_to_state_dict(params)
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=1e-6, err_msg=n)
    stem = "backbone.bottom_up.stem.conv1.weight"
    assert stem in names
    assert (want[stem] - start[stem]).abs().max() > 1e-5
    # the frozen norms never move
    for n, b in model.named_buffers():
        assert torch.equal(b, want[n]), n

    jax_sched = jax_trainer.detector_lr_schedule(2.5e-4)
    sched = trainer.detector_lr_schedule(2.5e-4)
    for step in (0, 999, 1000, 9999, 10000, 70000):
        assert sched(step) == pytest.approx(float(jax_sched(step)),
                                            rel=1e-7), step


@pytest.fixture(scope="module")
def charts(tmp_path_factory):
    root = tmp_path_factory.mktemp("charts")
    return generate_png_dataset(str(root), n_images=3, seed=0, split="train")


def test_coco_dataset_and_evaluate_match_jax(charts):
    kw = dict(max_boxes=16, short_edge=64, max_size=96, with_masks=True)
    for aug in ({}, dict(augment=True, train_scales=(48, 64), aug_seed=3)):
        want = jax_coco.CocoDataset(charts["coco"], charts["png_dir"],
                                    **kw, **aug)
        got = coco.CocoDataset(charts["coco"], charts["png_dir"], **kw, **aug)
        assert len(got) == len(want) == 3
        assert got.categories == want.categories
        for i in (0, 1, 2, 0):
            a, b = got[i], want[i]
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(np.asarray(a[k]),
                                              np.asarray(b[k]), err_msg=k)
    ds = coco.CocoDataset(charts["coco"], charts["png_dir"], **kw)
    r = np.random.default_rng(2)
    dets, gts = [], []
    for i in range(3):
        ex = ds[i]
        gv = ex["gt_valid"]
        g = ex["gt_boxes"][gv]
        dets.append({"boxes": (g + r.normal(size=g.shape) * 1.5)
                     .astype(np.float32),
                     "scores": r.random(len(g)).astype(np.float32),
                     "classes": np.where(r.random(len(g)) < 0.8,
                                         ex["gt_classes"][gv], 0)})
        gts.append({"boxes": g, "classes": ex["gt_classes"][gv]})
    want = jax_coco.evaluate_detections(dets, gts, len(ds.categories))
    got = coco.evaluate_detections(dets, gts, len(ds.categories))
    assert 0 < got["bbox_mAP"] < 1
    assert got == pytest.approx(want, rel=1e-6)
    np.testing.assert_array_equal(
        coco.rasterize_mask28([[0, 0, 10, 0, 10, 10, 0, 10]],
                              np.float32([0, 0, 10, 10]), 1.0),
        jax_coco.rasterize_mask28([[0, 0, 10, 0, 10, 10, 0, 10]],
                                  np.float32([0, 0, 10, 10]), 1.0))


def torchvision_keys(sd):
    """The trunk of a port state dict under torchvision ResNet names."""
    out = {}
    for k, v in sd.items():
        if not k.startswith("backbone.bottom_up."):
            continue
        k = k[len("backbone.bottom_up."):]
        k = k.replace("stem.conv1.norm.", "bn1.").replace("stem.", "")
        for stage in range(2, 6):
            k = k.replace(f"res{stage}.", f"layer{stage - 1}.")
        k = k.replace("shortcut.norm.", "downsample.1.")
        k = k.replace("shortcut.", "downsample.0.")
        for i in (1, 2, 3):
            k = k.replace(f"conv{i}.norm.", f"bn{i}.")
        out[k] = v
    return out


@pytest.mark.parametrize("layout", ["detectron2", "torchvision"])
def test_weights_files_load_like_the_jax_converter(tiny, tmp_path, layout):
    """A Detectron2-named Mask R-CNN file, and a torchvision-named ResNet,
    built from the JAX params: both packages' loaders read them into the
    same weights and the same meta (Detectron2 weights get their stem
    flipped from BGR to RGB and stride-in-1x1; torchvision neither)."""
    jm, params, image = tiny
    sd = detector_flax_to_state_dict(params)
    path = str(tmp_path / f"{layout}.pth")
    torch.save({"model": sd if layout == "detectron2"
                else torchvision_keys(sd)}, path)
    jparams, jmeta = jax_restore(params, path, verbose=False)
    model = MaskRCNN(**KW)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    meta = restore_detector_params(model, path, verbose=False)
    assert meta == jmeta and detector_file_meta(path) == jmeta
    assert meta["stride_in_1x1"] == (layout == "detectron2")
    want = detector_flax_to_state_dict(jax.tree.map(np.asarray, jparams))
    got = model.state_dict()
    stem = "backbone.bottom_up.stem.conv1.weight"
    for k, v in want.items():
        if layout == "torchvision" and not k.startswith("backbone.bottom_up"):
            assert torch.equal(got[k], before[k]), k    # left as initialized
        else:
            assert torch.equal(got[k], v), k
    assert torch.equal(got[stem], sd[stem].flip(1) if layout == "detectron2"
                       else sd[stem])


def test_cli_trains_checkpoints_and_tests_on_cpu(charts, tmp_path,
                                                 monkeypatch):
    """Two iterations, checkpoints, --test; the trainer turns TF32 off (the
    fp32 the card's numbers are measured in)."""
    from crct_tpu_torch.cli.detector_train import main
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    out = str(tmp_path / "out")
    common = ["--annotations", charts["coco"], "--image-dir",
              charts["png_dir"], "--device", "cpu", "--depth", "14",
              "--image-size", "64", "--max-boxes", "16"]
    tr = main(common + ["--output-dir", out, "--max-iter", "2",
                        "--batch-size", "2", "--checkpoint-every", "1",
                        "--no-augment"])
    assert tr.step == 2 and tr.optimizer.count == 2
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert next(tr.model.parameters()).device.type == "cpu"
    ckpts = sorted(os.listdir(out))
    assert ckpts == ["detector_1.ckpt", "detector_2.ckpt"]
    path = os.path.join(out, "detector_2.ckpt")
    assert detector_file_meta(path) == {
        "stride_in_1x1": False, "pixel_mean": [123.675, 116.28, 103.53],
        "pixel_std": [58.395, 57.12, 57.375], "depth": 14}
    fresh = MaskRCNN(num_classes=16, depth=14)
    restore_detector_params(fresh, path, verbose=False)
    live = tr.model.state_dict()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, live[k]), k
    assert torch.load(path, weights_only=False)["iter_id"] == 2
    metrics = main(common + ["--test", "--load-weights", path,
                             "--eval-images", "2"])
    assert set(metrics) == {"bbox_mAP", "bbox_AP50"}


def test_bf16_train_step_and_inference_on_cpu(tiny):
    """--bf16: autocast over fp32 parameters; the losses come out fp32 and
    finite, the parameters stay fp32 and move, and inference boxes stay
    fp32 (bf16 coordinates would quantize on large canvases)."""
    jm, params, image = tiny
    model = port_model(params)
    opt = trainer.DetectorSGD(list(model.parameters()), base_lr=1.0)
    step = trainer.make_detector_train_step(model, opt, bf16=True)
    batch = {"image": t(image)[None], "gt_boxes": t(GT_BOXES)[None],
             "gt_classes": t(GT_CLASSES)[None], "gt_valid": t(GT_VALID)[None],
             "gt_masks28": t(GT_MASKS)[None]}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    losses = step(batch, torch.Generator().manual_seed(0))
    for k, v in losses.items():
        assert v.dtype == torch.float32 and torch.isfinite(v), k
    moved = [n for n, p in model.named_parameters()
             if p.dtype == torch.float32 and not torch.equal(p, before[n])]
    assert len(moved) == len(before)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        out = model(t(image)[None], train=False)
    assert out["boxes"].dtype == torch.float32
    assert torch.isfinite(out["boxes"]).all()
