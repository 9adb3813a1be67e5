"""The port's feature extraction against the JAX package's, on the CPU.

  * The host functions of detector/extract.py, ocr.py, ocr_lite.py, pie.py
    and synthetic_charts.py: the same numpy inputs through both packages,
    outputs exactly equal (the same numpy code on the same values).
  * MaskRCNN.detect_with_roi_features / extract_roi_features: a depth-14
    trunk on a 256 x 320 canvas (a synthetic chart padded into it), the
    JAX params carried over by detector_flax_to_state_dict. The same
    classes and validity, boxes within 1e-3 px, scores and features within
    1e-5 of their largest magnitude (fp32 convolutions summed in other
    orders, as tests/test_torch_detector.py holds the detector).
  * batched_detect running its last group at its own size gives the
    records of the group padded with its last image, as the JAX package
    pads it (the <IMG> feature within 1e-5 of its largest magnitude, the
    rest exactly).
  * cli.extract_features against the JAX CLI's shards on the same PNGs,
    --image-size 64 and 32,64 (tests/test_extract.py): the same weights
    (the JAX CLI's random init, saved as a port detector checkpoint),
    text_feat, classes, boxes, sizes exactly equal, vis_feat within 1e-5
    of its largest magnitude.
"""

import functools
import sys
import types
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from crct_tpu.detector import extract as jx
from crct_tpu.detector import ocr as jocr
from crct_tpu.detector import ocr_lite as jocr_lite
from crct_tpu.detector import pie as jpie
from crct_tpu.detector import synthetic_charts as jcharts
from crct_tpu.detector.mask_rcnn import MaskRCNN as JaxMaskRCNN
from crct_tpu_torch.detector import extract as px
from crct_tpu_torch.detector import ocr as pocr
from crct_tpu_torch.detector import ocr_lite as pocr_lite
from crct_tpu_torch.detector import pie as ppie
from crct_tpu_torch.detector import synthetic_charts as pcharts
from crct_tpu_torch.detector.convert import detector_flax_to_state_dict
from crct_tpu_torch.detector.mask_rcnn import MaskRCNN
from tests.test_extract import _synthetic_detections
from tests.test_torch_detector import random_norms

CANVAS = (256, 320)
FEAT_TOL = 1e-5



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch thread: the tier-1 run puts six pytest-xdist processes on
    the same cores, and torch's default of a thread per core makes every op
    wait on threads the other processes have descheduled
    (tests/test_torch_eval.py measured 696 s against 92 s). The comparisons
    hold on any count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def same(a, b, path="x"):
    """Exact structural equality of records: dicts, sequences, arrays
    (NaN equal to NaN), numbers, strings and pie Points."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (path, a, b)
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=path)
    elif hasattr(a, "x") and hasattr(a, "y"):
        assert (a.x, a.y) == (b.x, b.y), path
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()
                 / max(float(np.abs(want).max()), 1e-6))


def same_record(got, want, feat_tol=FEAT_TOL):
    """A feature record: everything exact but vis_feat, within feat_tol of
    its largest magnitude."""
    assert got.keys() == want.keys()
    for k in want:
        if k == "vis_feat" and want[k] is not None:
            assert got[k].shape == want[k].shape
            assert rel_err(got[k], want[k]) <= feat_tol
        else:
            same(got[k], want[k], k)


# ---------------------------------------------------------------------------
# host functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataset", ["plotqa", "plotqa_colorless",
                                     "figure_qa", "dvqa", "unknown"])
def test_get_nonvis_ids(dataset):
    if dataset == "unknown":
        for mod in (jx, px):
            with pytest.raises(ValueError):
                mod.get_nonvis_ids(dataset)
        return
    same(px.get_nonvis_ids(dataset), jx.get_nonvis_ids(dataset))


@pytest.mark.parametrize("h,w,short,max_size", [
    (480, 640, 800, 1344), (480, 1280, 800, 1344), (240, 320, 0, 1344),
    (2000, 1500, 0, 1344), (240, 320, 800, (832, 1344)),
    (640, 640, 800, (832, 1344)), (1000, 600, 800, (832, 1344)),
    (240, 320, 0, (256, 320)), (240, 320, 128, (256, 320)), (1, 5000, 800, 64)])
def test_resize_shortest_edge(h, w, short, max_size):
    assert px.resize_shortest_edge(h, w, short, max_size) == \
        jx.resize_shortest_edge(h, w, short, max_size)


@pytest.mark.parametrize("spec", ["64", "32,64", "832,1344", 1344, "250,320",
                                  "a,b", "32,64,96", "33"])
def test_parse_canvas(spec):
    try:
        want = jx.parse_canvas(spec)
    except ValueError as exc:
        with pytest.raises(ValueError, match=str(exc)[:20]):
            px.parse_canvas(spec)
    else:
        assert px.parse_canvas(spec) == want


def test_chunk_gen_and_path_helpers(tmp_path):
    lst = list(range(53))
    for rng in (None, "0:2", "3:5", "5:99"):
        same(list(px.chunk_gen(lst, 10, rng)), list(jx.chunk_gen(lst, 10, rng)))
    for name in ("10.png", "2.png", "1.png", "33.png", "x.txt"):
        (tmp_path / name).write_bytes(b"")
    assert px.sorted_image_files(str(tmp_path)) == \
        jx.sorted_image_files(str(tmp_path))
    assert px.path_to_img_id("a/b/17.png") == jx.path_to_img_id("a/b/17.png")


@pytest.mark.parametrize("present", ["both", "x", "y", "none"])
def test_validate_both_axes(present):
    boxes = np.array([[5, 5, 50, 40], [10, 10, 20, 20]], np.float32)
    ax = {"x_axis": np.array([[5.0, 40, 50, 42]]),
          "y_axis": np.array([[4.0, 5, 6, 45]])}

    def axes():
        return {k: (v if present in ("both", k[0]) else np.zeros((0, 4)))
                for k, v in ax.items()}

    a, b = axes(), axes()
    assert px.validate_both_axes(a, boxes, verbose=False) == \
        jx.validate_both_axes(b, boxes, verbose=False)
    same(a, b)


def _plotqa_inputs(seed=0):
    feats, classes, boxes, gt_texts, hw = _synthetic_detections()
    feats = np.random.default_rng(seed).random(feats.shape).astype(np.float32)
    img_feat = np.random.default_rng(seed + 1).random(1024).astype(np.float32)
    return feats, classes, boxes, gt_texts, hw, img_feat


@pytest.mark.parametrize("mode", ["gt", "oracle"])
def test_build_feature_record_plotqa(mode):
    feats, classes, boxes, gt_texts, hw, img_feat = _plotqa_inputs()
    # predictions jittered off the GT so the Hungarian oracle has work
    jitter = np.random.default_rng(3).normal(size=boxes.shape) * 2
    boxes = (boxes + jitter).astype(np.float32)
    recs = []
    for mod in (px, jx):
        f, c, b = mod.inject_img_token(feats, classes, boxes, img_feat, hw)
        recs.append(mod.build_feature_record(
            7, f, c, b, hw, dataset="plotqa", gt_texts=gt_texts,
            ocr_mode=mode))
    assert recs[1]["vis_feat"] is not None
    same(recs[0], recs[1])


def test_build_feature_record_figure_qa_pie():
    """No axis detected in a figure_qa chart: the pie-chart branch."""
    _, cls = jx.get_nonvis_ids("figure_qa")
    boxes = np.array([[100, 100, 200, 200], [200, 100, 300, 200],
                      [100, 200, 200, 300], [200, 200, 300, 300],
                      [98, 98, 302, 302], [320, 40, 380, 55],
                      [320, 60, 380, 75]], np.float32)
    classes = np.array([9, 10, 11, 12, 7, cls["legend_label"],
                        cls["legend_label"]])
    gt = {"bboxes": boxes[5:] + 1, "text": np.array(["Red", "Dark Blue"]),
          "class": classes[5:]}
    feats = np.random.default_rng(0).random((7, 16)).astype(np.float32)
    recs = []
    for mod in (px, jx):
        f, c, b = mod.inject_img_token(feats, classes, boxes,
                                       np.ones(16, np.float32), (400, 400))
        recs.append(mod.build_feature_record(
            3, f, c, b, (400, 400), dataset="figure_qa", gt_texts=gt,
            ocr_mode="oracle", verbose=False))
    assert "pie" in recs[1]["text_feat"]
    same(recs[0], recs[1])


def test_dvqa_axes_and_record():
    _, cls = jx.get_nonvis_ids("dvqa")
    oracle = {
        'class': np.array([3, 3, 3, 0, 0]),
        'text': np.array(["0", "50", "100", "cat_a", "cat_b"]),
        'bboxes': np.array([[30, 392, 54, 408], [30, 212, 54, 228],
                            [30, 32, 54, 48], [100, 420, 150, 440],
                            [300, 420, 350, 440]], np.float32),
    }
    vis = np.array([[0, 0, 640, 480], [100, 200, 160, 400],
                    [300, 100, 360, 400]], np.float32)
    same(px.dvqa_axes(cls, oracle, vis), jx.dvqa_axes(cls, oracle, vis))
    horiz = dict(oracle, bboxes=oracle["bboxes"][:, [1, 0, 3, 2]])
    same(px.dvqa_axes(cls, horiz, vis), jx.dvqa_axes(cls, horiz, vis))
    words = dict(oracle, text=np.array(["a", "b", "c", "d", "e"]))
    assert px.dvqa_axes(cls, words, vis) is jx.dvqa_axes(cls, words, vis) \
        is None
    boxes = np.concatenate([vis[1:], oracle["bboxes"] + 1])
    classes = np.concatenate([[70, 71], oracle["class"]])
    feats = np.random.default_rng(1).random((len(boxes), 8)).astype(
        np.float32)
    recs = [mod.build_feature_record(
        5, feats, classes, boxes, (480, 640), dataset="dvqa",
        gt_texts={"bboxes": oracle["bboxes"], "text": oracle["text"]},
        ocr_mode="oracle") for mod in (px, jx)]
    same(recs[0], recs[1])
    for mod in (px, jx):
        with pytest.raises(ValueError, match="ocr-gt"):
            mod.build_feature_record(1, feats, classes, boxes, (480, 640),
                                     dataset="dvqa", ocr_mode="gt",
                                     gt_texts=oracle)


def test_empty_record_without_text_elements():
    boxes = np.array([[0, 0, 10, 10], [3, 3, 9, 9]], np.float32)
    recs = [mod.build_feature_record(
        1, np.ones((2, 4), np.float32), np.array([1000, 12]), boxes,
        (10, 10), dataset="plotqa", gt_texts={}, ocr_mode="oracle")
        for mod in (px, jx)]
    same(recs[0], recs[1])
    assert recs[0]["vis_feat"] is None


@pytest.fixture(scope="module")
def charts(tmp_path_factory):
    """Synthetic PNG charts written by both packages from the same seed."""
    root = tmp_path_factory.mktemp("extract_charts")
    got = pcharts.generate_png_dataset(str(root / "port"), n_images=3,
                                       seed=0, split="test")
    want = jcharts.generate_png_dataset(str(root / "jax"), n_images=3,
                                        seed=0, split="test")
    return got, want


def test_synthetic_charts_match_jax(charts):
    import json
    got, want = charts
    for name in ("annotations", "coco"):
        with open(got[name]) as f, open(want[name]) as g:
            assert json.load(f) == json.load(g)
    for i in range(3):
        with open(f"{got['png_dir']}/{i}.png", "rb") as f, \
                open(f"{want['png_dir']}/{i}.png", "rb") as g:
            assert f.read() == g.read()
    same(list(np.load(got["qa_file"], allow_pickle=True)),
         list(np.load(want["qa_file"], allow_pickle=True)))


@pytest.mark.parametrize("dataset", ["plotqa", "figure_qa"])
def test_get_gt_texts(charts, dataset):
    import json
    _, want = charts
    with open(want["annotations"]) as f:
        anns = json.load(f)
    for ann in anns:
        _, cls = jx.get_nonvis_ids(dataset)
        same(px.get_gt_texts(ann, cls, dataset),
             jx.get_gt_texts(ann, cls, dataset))
    dv = {"texts": [{"text_function": f, "text": t, "bbox": b}
                    for f, t, b in [("title", "T", [5, 5, 40, 12]),
                                    ("legend", "a", [100, 9, 30, 10]),
                                    ("legend_heading", "h", [1, 1, 1, 1])]]}
    _, cls = jx.get_nonvis_ids("dvqa")
    same(px.get_gt_texts(dv, cls, "dvqa"), jx.get_gt_texts(dv, cls, "dvqa"))


def test_axes_info_title_legends_normalize():
    feats, classes, boxes, gt, hw, _ = _plotqa_inputs()
    _, cls = jx.get_nonvis_ids("plotqa")
    axes = {"x_axis": boxes[classes == cls["x_axis"]][0],
            "y_axis": boxes[classes == cls["y_axis"]][0],
            "values_are_x": False}
    info_p = px.get_axes_info(dict(axes), gt, cls)
    info_j = jx.get_axes_info(dict(axes), gt, cls)
    same(info_p, info_j)
    same(px.get_title_legends(info_p, gt, cls),
         jx.get_title_legends(info_j, gt, cls))
    same(px.normalize_bbox(boxes, info_p), jx.normalize_bbox(boxes, info_j))
    same(px._mathdefault_to_sci("$\\mathdefault{10^{-3}}$"),
         jx._mathdefault_to_sci("$\\mathdefault{10^{-3}}$"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_match_bboxes_and_ocr_oracle(seed):
    r = np.random.default_rng(seed)
    gt = r.uniform(0, 200, (7, 2))
    gt = np.concatenate([gt, gt + r.uniform(5, 40, (7, 2))], 1)
    pred = np.concatenate([gt[:5] + r.normal(size=(5, 4)) * 3,
                           r.uniform(0, 250, (3, 4))]).astype(np.float32)
    pred[5:, 2:] = pred[5:, :2] + 10
    same(pocr.pairwise_iou_plus_one(gt, pred),
         jocr.pairwise_iou_plus_one(gt, pred))
    same(pocr.match_bboxes(gt, pred, 0.2), jocr.match_bboxes(gt, pred, 0.2))
    gtd = {"bboxes": gt, "text": np.array([f"t{i}" for i in range(7)])}
    pd = {"bboxes": pred, "class": r.integers(0, 6, len(pred))}
    same(pocr.ocr_oracle(pd, gtd), jocr.ocr_oracle(pd, gtd))


def test_apply_ocr_with_stubbed_pytesseract(monkeypatch):
    """The crop dilation, vertical-tick rotation and numeric / colour
    clean-up, through a stub engine: both packages read the same crops and
    return the same texts."""
    replies = ["12.5\nnoise", "\x0c", "Dark Turqoise", "(37.5)", "qqqq zzzz"]
    image = np.random.default_rng(0).integers(0, 255, (100, 200, 3),
                                              dtype=np.uint8)
    boxes = np.asarray([[10, 10, 20, 55], [30, 30, 60, 40], [50, 10, 90, 25],
                        [0, 0, 30, 12], [100, 50, 150, 70]], np.float32)
    classes = np.asarray([3, 9, 9, 9, 9])
    out = []
    for mod in (pocr, jocr):
        crops = []
        fake = types.ModuleType("pytesseract")
        fake.image_to_string = lambda c: (crops.append(np.array(c))
                                          or replies[len(crops) - 1])
        monkeypatch.setitem(sys.modules, "pytesseract", fake)
        out.append((mod.apply_ocr(image, boxes, classes, {"xticklabel": 3}),
                    crops))
    same(out[0], out[1])
    assert out[0][0] == ["12.5", "0", "Dark Turquoise", "37.5", "qqqq zzzz"]


def test_ocr_lite_reads_like_jax(charts):
    from PIL import Image
    _, want = charts
    im = np.asarray(Image.open(f"{want['png_dir']}/0.png").convert("RGB"))
    crops = [im[0:30, 80:260], im[200:240, 0:320], im[100:160, 0:70]]
    for crop in crops:
        assert pocr_lite.image_to_string(crop) == \
            jocr_lite.image_to_string(crop)


def test_pie_areas():
    boxes = np.array([[100, 100, 200, 200], [200, 100, 300, 200],
                      [100, 200, 200, 300], [200, 200, 300, 300],
                      [0, 0, 10, 10]], np.float32)
    same(ppie.get_pie_areas(boxes), jpie.get_pie_areas(boxes))
    same(ppie.get_pie_areas(boxes[-1:]), jpie.get_pie_areas(boxes[-1:]))


# ---------------------------------------------------------------------------
# detect_with_roi_features
# ---------------------------------------------------------------------------

KW = dict(num_classes=5, depth=14, with_mask=True, post_nms_topk_test=16,
          fc_dim=64, score_thresh_test=0.05)


@pytest.fixture(scope="module")
def det(charts):
    """The JAX detector and its params (random frozen norms), the port's
    MaskRCNN with the same weights, and one chart padded into the canvas."""
    from PIL import Image
    _, want = charts
    jm = JaxMaskRCNN(**KW)
    dummy = np.zeros((*CANVAS, 3), np.float32)
    params = random_norms(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.key(0), dummy)["params"], 5)
    model = MaskRCNN(**KW)
    model.load_state_dict(detector_flax_to_state_dict(params), strict=True)
    model.eval()
    images = []
    for i in range(3):
        raw = np.asarray(Image.open(f"{want['png_dir']}/{i}.png")
                         .convert("RGB"), np.float32)
        padded = np.zeros((*CANVAS, 3), np.float32)
        padded[:raw.shape[0], :raw.shape[1]] = (raw - 128.0) / 64.0
        images.append(padded)
    return jm, params, model, images


def test_detect_with_roi_features_matches_jax(det):
    jm, params, model, images = det
    extra = np.array([[0, 0, 320, 240], [10, 20, 200, 120],
                      [150, 30, 300, 230]], np.float32)
    want = jax.jit(lambda p, im, b: jm.apply(
        {"params": p}, im, b, method=JaxMaskRCNN.detect_with_roi_features))(
        params, images[0], extra)
    with torch.no_grad():
        got = model.detect_with_roi_features(
            torch.from_numpy(images[0])[None], torch.from_numpy(extra)[None])
        feats = model.extract_roi_features(
            torch.from_numpy(images[0])[None], torch.from_numpy(extra)[None])
    assert set(got) == set(want) and "mask_logits" not in got
    valid = np.asarray(want["valid"])
    assert 0 < valid.sum() < len(valid)
    for k in ("valid", "classes", "proposal_valid"):
        np.testing.assert_array_equal(got[k][0].numpy(), np.asarray(want[k]))
    for k in ("boxes", "proposals"):
        np.testing.assert_allclose(got[k][0].numpy(), np.asarray(want[k]),
                                   atol=1e-3)
    for k in ("scores", "features", "roi_features"):
        assert rel_err(got[k][0], want[k]) <= FEAT_TOL, k
    jfeats = jax.jit(lambda p, im, b: jm.apply(
        {"params": p}, im, b, method=JaxMaskRCNN.extract_roi_features))(
        params, images[0], extra)
    assert rel_err(feats[0], jfeats) <= FEAT_TOL
    # the same trunk pass: the detections equal the plain forward's
    with torch.no_grad():
        plain = model(torch.from_numpy(images[0])[None], train=False,
                      compute_masks=False)
    for k in plain:
        assert torch.equal(plain[k], got[k]), k


def test_batched_detect_tail_matches_padded_group(det):
    """Three images at infer_batch 2: the tail group runs at its own size
    here, padded with its last image in the JAX package."""
    _, _, model, images = det
    hws = [[240, 320], [240, 320], [200, 300]]
    got = px.batched_detect(model, images, 2, hws)
    padded = (px.detect(model, np.stack(images[:2]), hws[:2])
              + px.detect(model, np.stack([images[2], images[2]]),
                          [hws[2], hws[2]])[:1])
    assert len(got) == len(padded) == 3
    for (go, gf), (po, pf) in zip(got, padded):
        assert go.keys() == po.keys()
        for k in ("valid", "classes", "proposal_valid"):
            np.testing.assert_array_equal(go[k], po[k])
        for k in ("boxes", "scores", "features", "proposals"):
            assert rel_err(go[k], po[k]) <= FEAT_TOL, k
        assert rel_err(gf, pf) <= FEAT_TOL
    # ... and the records built from them agree
    _, cls = px.get_nonvis_ids("plotqa")
    for (go, gf), (po, pf) in zip(got, padded):
        recs = []
        for out, img_feat in ((go, gf), (po, pf)):
            v = out["valid"]
            f, c, b = px.inject_img_token(out["features"][v],
                                          out["classes"][v],
                                          out["boxes"][v], img_feat,
                                          (240, 320))
            recs.append(px.build_feature_record(
                0, f, c, b, (240, 320), dataset="plotqa", ocr_mode="gt",
                gt_texts=_synthetic_detections()[3], verbose=False))
        same_record(*recs)


def test_detector_from_weights(tmp_path):
    from crct_tpu_torch.utils.checkpoint import save_detector_checkpoint
    model, mean, std = px.detector_from_weights(
        "none", dataset="plotqa", num_classes=4, canvas=(32, 64), depth=14,
        score_thresh=0.05, seed=3, device="cpu")
    assert model.score_thresh_test == 0.05 and model.with_mask
    assert not model.training
    same((mean, std), (np.asarray([123.675, 116.28, 103.53], np.float32),
                       np.asarray([58.395, 57.12, 57.375], np.float32)))
    again, _, _ = px.detector_from_weights(
        "none", dataset="figure_qa", num_classes=4, canvas=(32, 64),
        depth=14, seed=3, device="cpu")
    assert again.score_thresh_test == 0.5 and not again.with_mask
    for k, v in again.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    path = str(tmp_path / "det.ckpt")
    save_detector_checkpoint(path, model.state_dict(), 1, {
        "stride_in_1x1": True, "pixel_mean": [1.0, 2.0, 3.0],
        "pixel_std": [4.0, 5.0, 6.0], "depth": 14})
    loaded, mean, std = px.detector_from_weights(
        path, dataset="plotqa", num_classes=4, canvas=(32, 64),
        device="cpu")
    same((mean, std), (np.float32([1, 2, 3]), np.float32([4, 5, 6])))
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, model.state_dict()[k]), k
    with pytest.raises(ValueError, match="does not match"):
        px.detector_from_weights(path, dataset="plotqa", num_classes=4,
                                 canvas=(32, 64), depth=50, device="cpu")
    with pytest.raises(ValueError, match="multiples of 32"):
        px.detector_from_weights("none", dataset="plotqa", num_classes=4,
                                 canvas=(30, 64), depth=14, device="cpu")


# ---------------------------------------------------------------------------
# the extract CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("canvas", ["64", "32,64"])
def test_extract_cli_matches_jax_shards(tmp_path, charts, canvas):
    from crct_tpu.cli import extract_features as jcli
    from crct_tpu_torch.cli import extract_features as pcli
    from crct_tpu_torch.utils.checkpoint import save_detector_checkpoint

    _, want = charts
    data = want["root"]

    def tiny_jax(**kw):
        kw.update(depth=14, post_nms_topk_test=32)
        return JaxMaskRCNN(**kw)

    def tiny_port(**kw):
        kw.update(post_nms_topk_test=32)
        return MaskRCNN(**kw)

    common = ["--dir-path", data, "--split", "test", "--batch-size", "3",
              "--infer-batch", "2", "--ocr-gt", "--dataset", "plotqa",
              "--image-size", canvas]
    with mock.patch("crct_tpu.detector.mask_rcnn.MaskRCNN", tiny_jax):
        jcli.main(["--load-weights", "none", "--output",
                   str(tmp_path / "jax"), *common])
        # the JAX CLI's random init, as a port detector checkpoint
        _, params, mean, std = jx.detector_from_weights(
            "none", dataset="plotqa", num_classes=228,
            canvas=px.parse_canvas(canvas), depth=14)
    ckpt = str(tmp_path / "det.ckpt")
    save_detector_checkpoint(
        ckpt, detector_flax_to_state_dict(jax.tree.map(np.asarray, params)),
        0, {"stride_in_1x1": False, "pixel_mean": mean.tolist(),
            "pixel_std": std.tolist(), "depth": 14})
    with mock.patch("crct_tpu_torch.detector.mask_rcnn.MaskRCNN", tiny_port):
        pcli.main(["--load-weights", ckpt, "--output", str(tmp_path / "port"),
                   "--device", "cpu", *common])
    want_recs = np.load(tmp_path / "jax" / "0.npy", allow_pickle=True)
    got_recs = np.load(tmp_path / "port" / "0.npy", allow_pickle=True)
    assert len(got_recs) == len(want_recs) == 3
    for g, w in zip(got_recs, want_recs):
        assert g["class"][0] == 1000
        assert (g["width"], g["height"]) == (320, 240)
        same_record(g, w)


def test_extract_cli_rejects_bad_flags():
    from crct_tpu_torch.cli import extract_features as pcli
    with pytest.raises(SystemExit):
        pcli.parse_args(["--load-weights", "none", "--output", "o",
                         "--batch-size", "2", "--image-size", "50"])
    with pytest.raises(SystemExit):
        pcli.parse_args(["--load-weights", "none", "--output", "o",
                         "--batch-size", "2", "--dataset", "dvqa",
                         "--ocr-gt"])
    args = pcli.parse_args(["--load-weights", "none", "--output", "o",
                            "--batch-size", "2", "--image-size", "32,64"])
    assert args.canvas == (32, 64) and args.device == "cuda"
