"""The port's online chart ingestion and demo against the JAX package's.

  * FigureIngestor: the JAX ingestor (a depth-14 detector, fc_dim 64, on a
    256 x 320 canvas, frozen norms drawn at random) and the port's (the same
    weights through detector_flax_to_state_dict, on the CPU) ingest the
    same PNG charts, on the no-resize path (short edge 0) and the resize
    path (short edge 128, PIL bilinear). In 'gt' mode with no detection
    surviving the score cut, the records' text_feat, classes and
    normalized boxes are exactly equal and the <IMG> feature within 1e-5
    of its largest magnitude; with detections (the reference's 0.5 cut)
    the classes and texts are equal and the geometry within 1e-5. In
    'oracle' mode at a 0.05 cut the detections reach the Hungarian oracle:
    the same classes and texts, boxes and tick positions within 1e-4 of
    their magnitude.
  * The /v1/figures routes and their 400 / 404 / 422 codes on a port
    server with -serve_no_dataset on the CPU (tests/test_ingest.py), a
    PNG answered over HTTP as the scorer answers the ingested record, and
    make_server wired by -serve_detector_weights.
  * The demo's PlotQAModel.forward against the JAX demo's (the same
    weights, scale 0.3 so that no two candidates tie within fp32 noise)
    and its scripted REPL (tests/test_e2e_pipeline.py).
"""

import base64
import contextlib
import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crct_tpu.config import default_params as jax_default_params
from crct_tpu.detector import extract as jx
from crct_tpu.detector.mask_rcnn import MaskRCNN as JaxMaskRCNN
from crct_tpu.detector.synthetic_charts import generate_png_dataset
from crct_tpu.ingest import FigureIngestor as JaxIngestor
from crct_tpu_torch.config import CRCTModelConfig, default_params
from crct_tpu_torch.detector import extract as px
from crct_tpu_torch.detector.convert import detector_flax_to_state_dict
from crct_tpu_torch.detector.mask_rcnn import MaskRCNN
from crct_tpu_torch.ingest import FigureIngestor, IngestError
from crct_tpu_torch.models.crct import CRCTModel
from crct_tpu_torch.serve import InMemoryFigures, QAScorer, QAServer
from tests.helpers import tiny_model_config
from tests.test_torch_detector import random_norms
from tests.test_torch_extract import FEAT_TOL, rel_err, same, same_record
from tests.test_torch_model import fill_params

FEAT_DIM = 64
CANVAS = (256, 320)
KW = dict(num_classes=16, with_mask=False, fc_dim=FEAT_DIM,
          post_nms_topk_test=32, depth=14)



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

@pytest.fixture(scope="module")
def png_env(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_ingest_pngs"))
    env = generate_png_dataset(root, n_images=2, seed=3, split="test")
    with open(env["annotations"]) as f:
        env["anns"] = json.load(f)
    return env


@pytest.fixture(scope="module")
def ingestors():
    """The JAX ingestor and the port's holding the same weights, built
    once for the module."""
    jm = JaxMaskRCNN(**KW)
    dummy = jnp.zeros((*CANVAS, 3), jnp.float32)
    params = random_norms(jax.jit(lambda r: jm.init(r, dummy, train=False))(
        jax.random.key(0))["params"], 7)
    model = MaskRCNN(**KW)
    model.load_state_dict(detector_flax_to_state_dict(params), strict=True)
    return (JaxIngestor(jm, params, dataset="plotqa", canvas=CANVAS,
                        short_edge=0),
            FigureIngestor(model, dataset="plotqa", canvas=CANVAS,
                           short_edge=0))


def _load_png(png_env, img_id):
    from PIL import Image
    return Image.open(f"{png_env['png_dir']}/{img_id}.png").convert("RGB")


def close(a, b, tol, path="x"):
    """Structural equality with numbers within ``tol`` of the largest
    magnitude of their array (strings and integers exact)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (path, a.keys(), b.keys())
        for k in a:
            close(a[k], b[k], tol, f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            close(x, y, tol, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) and a.dtype.kind == "f":
        assert a.shape == np.shape(b), path
        assert rel_err(a, b) <= tol, path
    elif isinstance(a, (float, np.floating)):
        assert abs(a - b) <= tol * max(abs(b), 1.0), (path, a, b)
    else:
        same(a, b, path)


@contextlib.contextmanager
def score_cut(ingestors, cut):
    """Both ingestors' detectors at another score cut."""
    jing, ing = ingestors
    jdet = jing.detector
    jing.detector = jdet.clone(score_thresh_test=cut)
    jing._detect = jax.jit(jx.make_detect_one(jing.detector))
    ing.detector.score_thresh_test = cut
    try:
        yield
    finally:
        jing.detector = jdet
        jing._detect = jax.jit(jx.make_detect_one(jdet))
        ing.detector.score_thresh_test = 0.5


@pytest.mark.parametrize("short_edge", [0, 128])
@pytest.mark.parametrize("cut", [1.01, 0.5])
def test_gt_records_match_jax(png_env, ingestors, short_edge, cut):
    """The no-resize (240 x 320 fits the canvas) and resize paths. Above a
    score cut of 1 no detection survives (as with the random full-width
    detector, whose 229-way softmax never reaches 0.5): the <IMG> token
    alone, text_feat, classes and boxes exactly equal. At the reference's
    0.5 this detector keeps a few: the same classes and texts, the boxes
    and the geometry derived from them within 1e-5 (fp32 convolutions
    summed in other orders)."""
    jing, ing = ingestors
    jing.short_edge = ing.short_edge = short_edge
    try:
        with score_cut(ingestors, cut):
            for i in range(2):
                img = _load_png(png_env, i)
                want = jing.ingest(img, i, annotation=png_env["anns"][i],
                                   ocr_mode="gt")
                got = ing.ingest(img, i, annotation=png_env["anns"][i],
                                 ocr_mode="gt")
                assert (got["width"], got["height"]) == (320, 240)
                same(got["class"], want["class"])
                if cut > 1:
                    assert list(got["class"]) == [1000]
                    same_record(got, want)
                else:
                    close(got, want, FEAT_TOL)
                # the same image as an array: the same record
                again = ing.ingest(np.asarray(img), i,
                                   annotation=png_env["anns"][i],
                                   ocr_mode="gt")
                same_record(again, got, feat_tol=0.0)
    finally:
        jing.short_edge = ing.short_edge = 0


def test_oracle_records_match_jax(png_env, ingestors, monkeypatch):
    """Detections through to the Hungarian oracle: a 0.05 score cut, and
    the classifier's bias raised by 2 on the eight text and axis classes
    (a random classifier puts every box in one or two visual classes). The
    same classes and attached texts, geometry within 1e-4."""
    jing, ing = ingestors
    params = jax.tree.map(np.array, jing.det_params)
    params["box_predictor"]["cls_score"]["bias"][:8] += 2.0
    jm = jing.detector.clone(score_thresh_test=0.05)
    jax_oracle = JaxIngestor(jm, params, dataset="plotqa", canvas=CANVAS,
                             short_edge=0)
    model = MaskRCNN(**dict(KW, score_thresh_test=0.05))
    model.load_state_dict(detector_flax_to_state_dict(params), strict=True)
    oracle = FigureIngestor(model, dataset="plotqa", canvas=CANVAS,
                            short_edge=0)
    calls = {"port": [], "jax": []}
    for name, mod in (("port", px), ("jax", jx)):
        def spy(pred, gt, _real=mod.ocr_oracle, _sink=calls[name]):
            out = _real(pred, gt)
            _sink.append((pred["class"], out["text"]))
            return out
        monkeypatch.setattr(mod, "ocr_oracle", spy)
    for i in range(2):
        img = _load_png(png_env, i)
        args = dict(annotation=png_env["anns"][i], ocr_mode="oracle")
        want = jax_oracle.ingest(img, i, **args)
        got = oracle.ingest(img, i, **args)
        same(got["class"], want["class"])
        close(got, want, 1e-4)
    same(calls["port"], calls["jax"])
    # the oracle matched predicted text boxes of both charts
    assert len(calls["port"]) == 2 and all(len(c) for c, _ in calls["port"])


def test_ingest_rejects_bad_inputs(png_env, ingestors):
    _, ing = ingestors
    img = _load_png(png_env, 0)
    with pytest.raises(IngestError, match="annotation"):
        ing.ingest(img, 0, ocr_mode="oracle")
    with pytest.raises(IngestError, match="ocr_mode"):
        ing.ingest(img, 0, annotation=png_env["anns"][0], ocr_mode="bogus")
    with pytest.raises(IngestError, match="RGB"):
        ing.ingest(np.zeros((8, 8), np.float32), 0,
                   annotation=png_env["anns"][0])
    try:
        import pytesseract  # noqa: F401
    except ImportError:
        with pytest.raises(IngestError, match="pytesseract"):
            ing.ingest(img, 0)
    with pytest.raises(ValueError, match="multiples of 32"):
        FigureIngestor(ing.detector, canvas=(250, 320))
    ing.warmup()
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


# ---------------------------------------------------------------------------
# the dataset-free HTTP server: PNG in, answers out
# ---------------------------------------------------------------------------

def _post(url, payload, timeout=120):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def _png64(png_env, i):
    with open(f"{png_env['png_dir']}/{i}.png", "rb") as f:
        return base64.b64encode(f.read()).decode()


def _qa_model(params, feat_dim, seed=0):
    cfg = dataclasses.asdict(tiny_model_config(vocab_size=30522,
                                               v_feature_size=feat_dim))
    torch.manual_seed(seed)
    return CRCTModel(CRCTModelConfig.from_dict(cfg),
                     categories=params["categories"])


@pytest.fixture(scope="module")
def live_server(ingestors, tmp_path_factory):
    params = default_params(
        serve_no_dataset=True, eval_set="test", eval_batch_size=64,
        save_path=str(tmp_path_factory.mktemp("torch_serve_results")))
    scorer = QAScorer(params, InMemoryFigures(params),
                      model=_qa_model(params, FEAT_DIM), device="cpu")
    server = QAServer(("127.0.0.1", 0), scorer, max_batch=8,
                      max_delay_ms=2.0, ingestor=ingestors[1])
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", server
    server.shutdown()
    server.server_close()
    t.join(timeout=30)
    assert not t.is_alive()


def test_png_to_answer_over_http(live_server, png_env):
    base, server = live_server
    with urllib.request.urlopen(base + "/v1/figures", timeout=30) as resp:
        body = json.loads(resp.read())
    assert body["ingest_enabled"] and body["ingested"] == []

    status, body = _post(base + "/v1/figures",
                         {"png_base64": _png64(png_env, 0), "image_id": 777,
                          "annotation": png_env["anns"][0],
                          "ocr_mode": "gt"})
    assert status == 200 and body["image_index"] == 777
    assert body["n_elements"] >= 1 and body["n_possible_answers"] > 0
    assert body["title"] == png_env["anns"][0]["general_figure_info"][
        "title"]["text"]

    question = {"image_index": 777, "question": "how many bars are there ?",
                "top": 2}
    status, rec = _post(base + "/v1/answer", question)
    assert status == 200 and rec["answer"] is not None
    assert len(rec["top"]) == 2
    # the answer over HTTP is the scorer's on the ingested record
    [direct] = server.scorer.score([{
        "question_string": question["question"], "image_index": 777,
        "answer": None, "qid": None, "type": "dot"}], top=2)
    assert rec["cls_output"] == direct["cls_output"]
    assert rec["confidence"] == pytest.approx(direct["confidence"],
                                              abs=1e-6)

    status, body2 = _post(base + "/v1/figures",
                          {"png_base64": _png64(png_env, 1),
                           "annotation": png_env["anns"][1],
                           "ocr_mode": "gt"})
    assert status == 200 and body2["image_index"] >= 10 ** 9
    with urllib.request.urlopen(base + "/v1/figures", timeout=30) as resp:
        assert json.loads(resp.read())["ingested"] == \
            [777, body2["image_index"]]
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(base + "/v1/figures/777/questions",
                               timeout=30)
    assert err.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(base + "/v1/figures/abc/questions",
                               timeout=30)
    assert err.value.code == 400


@pytest.mark.parametrize("case,code,needle", [
    ("no_png", 400, "png_base64"), ("bad_base64", 400, "base64"),
    ("not_an_image", 400, "decode"), ("unknown_figure", 404, "unknown"),
    ("no_ocr", 422, "pytesseract"), ("bad_annotation", 422,
                                     "ingestion failed"),
    ("truncated", 422, ""), ("bad_json", 400, "JSON")])
def test_ingest_http_error_paths(live_server, png_env, case, code, needle):
    base, _ = live_server
    png64 = _png64(png_env, 0)
    url, payload = base + "/v1/figures", {
        "no_png": {},
        "bad_base64": {"png_base64": "!!!not-base64!!!"},
        "not_an_image": {"png_base64": base64.b64encode(b"abc").decode()},
        "no_ocr": {"png_base64": png64, "ocr_mode": "ocr"},
        "bad_annotation": {"png_base64": png64, "annotation": "not-a-dict",
                           "ocr_mode": "gt"},
        "truncated": {"png_base64": base64.b64encode(
            base64.b64decode(png64)[:200]).decode(),
            "annotation": png_env["anns"][0], "ocr_mode": "gt"},
    }.get(case, {})
    if case == "no_ocr":
        try:
            import pytesseract  # noqa: F401
            pytest.skip("pytesseract is installed: real OCR would run")
        except ImportError:
            pass
    if case == "unknown_figure":
        url, payload = base + "/v1/answer", {"image_index": 12345,
                                             "question": "what ?"}
    if case == "bad_json":
        req = urllib.request.Request(url, data=b"{not json",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
    else:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(url, payload)
    assert err.value.code == code
    assert needle in json.loads(err.value.read())["error"]


def test_batch_resilience_and_id_hygiene(live_server, png_env):
    """An unknown figure in a coalesced batch does not fail its
    batchmates; auto ids never overwrite claimed ids; ingested records are
    FIFO-capped."""
    base, server = live_server
    png64 = _png64(png_env, 1)
    _post(base + "/v1/figures", {"png_base64": png64, "image_id": 778,
                                 "annotation": png_env["anns"][1],
                                 "ocr_mode": "gt"})
    status, body = _post(base + "/v1/answers", {"questions": [
        {"image_index": 778, "question": "how many bars are there ?"},
        {"image_index": 55555, "question": "what ?"}]})
    assert status == 200
    ok, bad = body["answers"]
    assert ok["answer"] is not None and "error" not in ok
    assert "unknown figure" in bad["error"] and bad["answer"] is None

    claimed = server._next_fig_id
    _post(base + "/v1/figures", {"png_base64": png64, "image_id": claimed,
                                 "annotation": png_env["anns"][1],
                                 "ocr_mode": "gt"})
    status, body = _post(base + "/v1/figures",
                         {"png_base64": png64,
                          "annotation": png_env["anns"][1], "ocr_mode": "gt"})
    assert status == 200 and body["image_index"] > claimed
    assert claimed in server.scorer.figs

    server.scorer.params["serve_max_figures"] = 2
    try:
        oldest = next(iter(server.scorer.figs))
        rec = dict(server.scorer.figs[claimed])
        rec["image_id"] = claimed + 1000
        server.scorer.add_figure(rec)
        assert len(server.scorer.figs) == 2
        assert oldest not in server.scorer.figs
    finally:
        server.scorer.params["serve_max_figures"] = 512


def test_disabled_ingestion_answers_400(png_env):
    params = default_params(serve_no_dataset=True, eval_set="test",
                            eval_batch_size=64)
    scorer = QAScorer(params, InMemoryFigures(params),
                      model=_qa_model(params, FEAT_DIM), device="cpu")
    server = QAServer(("127.0.0.1", 0), scorer)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(base + "/v1/figures", timeout=30) as r:
            assert json.loads(r.read()) == {"ingested": [],
                                            "ingest_enabled": False}
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + "/v1/figures", {"png_base64": _png64(png_env, 0)})
        assert err.value.code == 400
        assert "disabled" in json.loads(err.value.read())["error"]
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)


def test_make_server_wires_serve_detector_weights(png_env, ingestors,
                                                  tmp_path):
    """-serve_no_dataset with -serve_detector_weights: make_server builds
    the ingestor from the weights file on the CPU and warms it up; a PNG
    posted to it is answered."""
    from crct_tpu_torch.serve import make_server
    from crct_tpu_torch.utils.checkpoint import save_detector_checkpoint
    model = ingestors[1].detector
    ckpt = str(tmp_path / "det.ckpt")
    save_detector_checkpoint(ckpt, model.state_dict(), 1, {
        "stride_in_1x1": False, "pixel_mean": [123.675, 116.28, 103.53],
        "pixel_std": [58.395, 57.12, 57.375], "depth": 14})
    params = default_params(
        serve_no_dataset=True, serve_detector_weights=ckpt,
        serve_detector_canvas="256,320", serve_short_edge=0,
        eval_set="test", eval_batch_size=64, port=0)
    # the weights file's heads are fc_dim 64 with 16 classes: the
    # ingestor's detector is built at 1024 and 228 classes and takes the
    # trunk and the RPN only
    server = make_server(params, model=_qa_model(params, 1024),
                         device="cpu")
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert isinstance(server.scorer.dataset, InMemoryFigures)
        assert server.ingestor.canvas == CANVAS
        det = server.ingestor.detector
        for k in ("backbone.bottom_up.stem.conv1.weight",
                  "proposal_generator.rpn_head.conv.weight"):
            assert torch.equal(det.state_dict()[k], model.state_dict()[k])
        status, body = _post(base + "/v1/figures", {
            "png_base64": _png64(png_env, 0), "image_id": 5,
            "annotation": png_env["anns"][0], "ocr_mode": "gt"})
        assert status == 200 and body["image_index"] == 5
        status, rec = _post(base + "/v1/answer", {
            "image_index": 5, "question": "what is the title ?"})
        assert status == 200 and rec["answer"] is not None
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=30)


# ---------------------------------------------------------------------------
# the demo
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def demo_env(png_env, tmp_path_factory):
    """A one-figure split built by the extraction's record builder from GT
    text and seeded features (tests/test_e2e_pipeline.py), for both
    packages."""
    from crct_tpu.data.dataset import ChartQADataset as JaxDataset
    from crct_tpu_torch.data.dataset import ChartQADataset
    tmp = tmp_path_factory.mktemp("torch_demo")
    _, cls_dict = jx.get_nonvis_ids("plotqa")
    gt_texts = jx.get_gt_texts(png_env["anns"][0], cls_dict, "plotqa")
    rng = np.random.default_rng(0)
    n = 6
    feats = rng.random((n, 64)).astype(np.float32)
    classes = np.concatenate([[1000], rng.integers(8, 30, n - 1)])
    boxes = np.concatenate([[[0, 0, 320, 240]],
                            rng.random((n - 1, 4)) * 200]).astype(np.float32)
    boxes[1:, 2:] = boxes[1:, :2] + 30
    rec = jx.build_feature_record(0, feats, classes, boxes, (240, 320),
                                  dataset="plotqa", gt_texts=gt_texts,
                                  ocr_mode="gt")
    (tmp / "ff" / "test").mkdir(parents=True)
    (tmp / "qa" / "test").mkdir(parents=True)
    np.save(tmp / "ff" / "test" / "0.npy", np.asarray([rec], dtype=object),
            allow_pickle=True)
    qa_pairs = [{"image_index": 0, "qid": "S1", "type": "vbar",
                 "question_string": "how many bars ?", "answer": 3},
                {"image_index": 0, "qid": "D7", "type": "vbar",
                 "question_string": "what is the value of north ?",
                 "answer": 42.5}]
    np.save(tmp / "qa" / "test" / "qa_pairs.npy",
            np.asarray(qa_pairs, dtype=object), allow_pickle=True)
    kw = dict(figure_feat_path=str(tmp / "ff") + "/",
              qa_parent_dir=str(tmp / "qa") + "/",
              dataset_config={"dataset_files_divisions": {"test": 4}},
              eval_set="test", eval_batch_size=64, BOT_MODE=True,
              save_path=str(tmp / "results"))
    jparams, params = jax_default_params(**kw), default_params(**kw)
    jds = JaxDataset(jparams, "test", init_split="test")
    ds = ChartQADataset(params, "test", init_split="test")
    jds.get_all_answers = ds.get_all_answers = True
    return jparams, params, jds, ds, qa_pairs


@pytest.fixture(scope="module")
def demo_models(demo_env):
    """The JAX demo model and the port's holding the same weights."""
    from crct_tpu.cli.demo import PlotQAModel as JaxPlotQAModel
    from crct_tpu.models.crct import CRCTModel as JaxCRCTModel
    from crct_tpu.train.eval_loop import make_eval_step as jax_eval_step
    from crct_tpu_torch.cli.demo import PlotQAModel
    from crct_tpu_torch.utils.convert import flax_to_state_dict
    jparams, params, jds, ds, qa_pairs = demo_env
    jcfg = tiny_model_config(v_feature_size=64)
    jdemo = JaxPlotQAModel(jparams, jds)
    jdemo.model = JaxCRCTModel(config=jcfg, categories=jparams["categories"])
    jdemo.eval_step = jax_eval_step(jdemo.model)
    jdemo.forward(qa_pairs[0])                 # builds the parameter tree
    jdemo.model_params = fill_params(jax.device_get(jdemo.model_params),
                                     seed=0, scale=0.3)
    model = CRCTModel(CRCTModelConfig.from_dict(dataclasses.asdict(jcfg)),
                      categories=params["categories"])
    model.load_state_dict(flax_to_state_dict(jdemo.model_params),
                          strict=True)
    return jdemo, PlotQAModel(params, ds, model=model, device="cpu")


@pytest.mark.parametrize("which", ["structural", "regression", "free_form"])
def test_demo_forward_matches_jax(demo_env, demo_models, which):
    *_, qa_pairs = demo_env
    jdemo, demo = demo_models
    qa = {"structural": qa_pairs[0], "regression": qa_pairs[1],
          "free_form": {"question_string": "is this rising ?",
                        "image_index": 0, "answer": None, "qid": None,
                        "type": "dot"}}[which]
    want, got = jdemo.forward(qa), demo.forward(qa)
    assert set(got) == set(want)
    for k in ("nsp_right", "is_correct", "is_reg", "cls_output"):
        assert got[k] == want[k], k
    assert [a for _, a in got["all_answers"]] == \
        [a for _, a in want["all_answers"]]
    np.testing.assert_allclose([c for c, _ in got["all_answers"]],
                               [c for c, _ in want["all_answers"]],
                               atol=1e-5)
    assert len(got["all_answers"]) > 10        # chart texts + fixed vocab
    assert got["reg_output"] == pytest.approx(want["reg_output"], rel=1e-4,
                                              abs=1e-5)
    assert got["reg_loss"] == pytest.approx(want["reg_loss"], rel=1e-4,
                                            abs=1e-5)


def test_demo_bot_repl_loop_scripted(demo_env, demo_models, monkeypatch,
                                     capsys):
    """PlotQABot.loop with scripted input: a bad image id, image 0, a
    listed question, a free-form one; the input running out ends it."""
    from crct_tpu_torch.cli.demo import PlotQABot
    _, params, *_ = demo_env
    _, demo = demo_models
    bot = PlotQABot(params, "test", model=demo.model, device="cpu")
    feed = iter(["99", "0", "1", "is this rising ?"])

    def scripted(*_):
        try:
            return next(feed)
        except StopIteration:
            raise EOFError from None

    monkeypatch.setattr("builtins.input", scripted)
    with pytest.raises(EOFError):
        bot.loop()
    out = capsys.readouterr().out
    assert "Nothing to ask about this image" in out
    assert "<1>: how many bars ?" in out
    assert "<GT>:  3" in out
    assert "<CRCT>" in out
    assert "[Answers probabilities]" in out
