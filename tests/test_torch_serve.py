"""The port's serving path against the JAX package's.

The port's example builder and collate give the JAX arrays exactly; its
QAScorer (on the CPU, weights carried across from the JAX scorer by
flax_to_state_dict) answers as the JAX QAScorer does; the live HTTP
endpoints and the dynamic batcher behave as tests/test_serve.py pins them
for the JAX server.

Tolerances: confidence (an NSP probability) within 1e-5 absolute and
reg_output within 1e-4 relative, from fp32 forwards whose LayerNorms take
the variance in two different ways (see tests/test_torch_model.py).
"""

import dataclasses
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from crct_tpu.config import default_params as jax_default_params
from crct_tpu.data.dataset import ChartQADataset as JaxDataset
from crct_tpu.data.dataset import collate as jax_collate
from crct_tpu.data.synthetic import generate_dataset
from crct_tpu.models.crct import CRCTModel as JaxCRCTModel
from crct_tpu.serve import QAScorer as JaxQAScorer
from crct_tpu_torch.config import CRCTModelConfig, default_params
from crct_tpu_torch.data.dataset import ChartQADataset, collate
from crct_tpu_torch.models.crct import CRCTModel
from crct_tpu_torch.serve import DynamicBatcher, QAScorer, make_server
from crct_tpu_torch.utils.convert import flax_to_state_dict
from tests.helpers import tiny_model_config
from tests.test_torch_model import fill_params


def _params(cfg, root, make):
    return make(figure_feat_path=cfg["figure_feat_path"],
                qa_parent_dir=cfg["qa_parent_dir"],
                dataset_config={"dataset_files_divisions":
                                cfg["dataset_files_divisions"]},
                eval_set="test", eval_batch_size=64,
                save_path=str(root / "results"))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve")
    cfg = generate_dataset(str(root / "data"), n_images=8, division=4,
                           n_questions=3, feat_dim=64)
    jparams = _params(cfg, root, jax_default_params)
    params = _params(cfg, root, default_params)
    jds = JaxDataset(jparams, "test", init_split="test")
    ds = ChartQADataset(params, "test", init_split="test")
    jds.get_all_answers = ds.get_all_answers = True
    return jparams, params, jds, ds


@pytest.fixture(scope="module")
def scorers(env):
    """The JAX scorer and the port's scorer on the CPU holding the same
    weights. The weights are drawn from a numpy seed at a scale (0.3) that
    spreads the candidates' NSP probabilities well beyond fp32 noise: at the
    init's 0.02 they all sit within ~1e-7 of each other and the ranking is
    a coin toss in both frameworks."""
    jparams, params, jds, ds = env
    jcfg = tiny_model_config(vocab_size=30522, v_feature_size=64)
    jscorer = JaxQAScorer(jparams, jds, model=JaxCRCTModel(
        config=jcfg, categories=jparams["categories"]))
    jscorer.score(list(jds.qa["test"][:1]))        # builds the param tree
    weights = fill_params(jax.device_get(jscorer.model_params), seed=0,
                          scale=0.3)
    jscorer.model_params = weights
    jrecs = jscorer.score(list(jds.qa["test"][:6]), top=3)
    model = CRCTModel(CRCTModelConfig.from_dict(dataclasses.asdict(jcfg)),
                      categories=params["categories"])
    model.load_state_dict(flax_to_state_dict(weights), strict=True)
    return jrecs, QAScorer(params, ds, model=model, device="cpu")


def test_builder_and_collate_match_exactly(env):
    jparams, params, jds, ds = env
    qas = list(ds.qa["test"][:5])
    batches = []
    for d in (jds, ds):
        items = [d.builder.build(d.get_fig_feat(int(qa["image_index"])), qa,
                                 split="test", get_all_answers=True,
                                 qa_ind=-1, rng=np.random.default_rng(0))
                 for qa in qas]
        batches.append((jax_collate if d is jds else collate)(items))
    jb, b = batches
    assert set(jb) == set(b)
    for k in jb:
        if isinstance(jb[k], list):
            assert jb[k] == b[k], k
        else:
            assert jb[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(jb[k], b[k], err_msg=k)
    for qa in qas:
        idx = int(qa["image_index"])
        assert (jds.get_possible_answers(idx)
                == ds.get_possible_answers(idx))


def test_train_split_examples_match_exactly(env):
    """The train path (GT and random-negative halves, seeded per index)."""
    jparams, params, _, _ = env
    jds = JaxDataset(jparams, "train", init_split="train")
    ds = ChartQADataset(params, "train", init_split="train")
    n = ds.orig_len()
    for i in (0, 1, n, n + 1):
        a, b = jds[i], ds[i]
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k


def test_scorer_matches_jax_scorer(env, scorers):
    _, _, _, ds = env
    jrecs, scorer = scorers
    recs = scorer.score(list(ds.qa["test"][:6]), top=3)
    for jr, r in zip(jrecs, recs):
        assert r["cls_output"] == jr["cls_output"]
        assert r["is_reg"] == jr["is_reg"]
        assert [x["answer"] for x in r["top"]] == \
            [x["answer"] for x in jr["top"]]
        assert r["confidence"] == pytest.approx(jr["confidence"], abs=1e-5)
        if jr["is_reg"]:
            assert r["reg_output"] == pytest.approx(jr["reg_output"],
                                                    rel=1e-4)
            assert r["answer"] == r["reg_output"]
        else:
            assert r["answer"] == r["cls_output"]


def test_scorer_without_dedup_gives_the_same_answers(env, scorers):
    _, params, _, ds = env
    _, scorer = scorers
    qas = list(ds.qa["test"][:4])
    plain = QAScorer(dict(params, eval_dedup=False), ds, model=scorer.model,
                     device="cpu")
    for a, b in zip(scorer.score(qas, top=2), plain.score(qas, top=2)):
        assert a["cls_output"] == b["cls_output"]
        assert a["confidence"] == pytest.approx(b["confidence"], abs=1e-6)


def test_scorer_loads_start_checkpoint(env, scorers, tmp_path):
    """-start_checkpoint: the scorer builds the model from -model_config and
    loads a checkpoint in the reference layout strict."""
    import torch
    _, params, _, ds = env
    _, scorer = scorers
    cfg = dataclasses.asdict(tiny_model_config(vocab_size=30522,
                                               v_feature_size=64))
    (tmp_path / "tiny.json").write_text(json.dumps(cfg))
    torch.save({"model_state_dict": {
        f"bert_pretrained.{k}": v
        for k, v in scorer.model.state_dict().items()}},
        tmp_path / "crct.ckpt")
    loaded = QAScorer(dict(params, model_config=str(tmp_path / "tiny.json"),
                           start_checkpoint=str(tmp_path / "crct.ckpt")),
                      ds, device="cpu")
    qas = list(ds.qa["test"][:3])
    for a, b in zip(scorer.score(qas, top=2), loaded.score(qas, top=2)):
        assert a == b


@pytest.fixture(scope="module")
def live_server(env, scorers):
    _, params, _, ds = env
    _, scorer = scorers
    server = make_server(dict(params, serve_max_batch=8,
                              serve_max_delay_ms=2.0),
                         dataset=ds, model=scorer.model, port=0,
                         device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", server
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as resp:
        return json.loads(resp.read())


def test_http_endpoints(live_server, env):
    base, server = live_server
    _, _, _, ds = env
    assert _get(base + "/healthz")["status"] == "ok"
    assert _get(base + "/v1/figures") == {"ingested": [],
                                          "ingest_enabled": False}
    img = int(ds.qa["test"][0]["image_index"])
    assert _get(base + f"/v1/figures/{img}/questions")["questions"]

    status, rec = _post(base + "/v1/answer",
                        {"image_index": img, "question_id": 0})
    assert status == 200
    direct = server.scorer.score([server.img_to_qas[img][0]])[0]
    assert rec["cls_output"] == direct["cls_output"]
    assert rec["answer"] == direct["answer"]
    assert "top" not in rec

    status, rec = _post(base + "/v1/answer",
                        {"image_index": img,
                         "question": "is the trend rising ?", "top": 2})
    assert status == 200 and rec["answer"] is not None
    assert len(rec["top"]) == 2

    questions = [{"image_index": int(qa["image_index"]), "question_id": 0}
                 for qa in ds.qa["test"][:3]]
    status, body = _post(base + "/v1/answers", {"questions": questions})
    assert status == 200 and len(body["answers"]) == 3

    health = _get(base + "/healthz")
    assert health["served"] >= 5
    assert health["latency_ms_p95"] >= health["latency_ms_p50"] > 0
    assert health["mean_coalesced_batch"] >= 1


def test_http_error_paths(live_server):
    base, _ = live_server
    for path, payload, code, needle in [
            ("/v1/answer", {}, 400, "image_index"),
            ("/v1/answer", {"image_index": 0}, 400, "question"),
            ("/v1/answer", {"image_index": 0, "question_id": 99}, 400,
             "out of range"),
            ("/v1/answer", {"image_index": 10 ** 6, "question": "x ?"}, 404,
             "unknown figure"),
            ("/v1/figures", {"png_base64": "AAAA"}, 400,
             "figure ingestion is disabled"),
            ("/nope", {}, 404, "unknown path")]:
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base + path, payload)
        assert err.value.code == code
        assert needle in json.loads(err.value.read())["error"]
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(base + "/v1/figures/999999/questions",
                               timeout=30)
    assert err.value.code == 404


def test_dynamic_batcher_coalesces_and_preserves_order():
    """Requests arriving while a dispatch is in flight share the next one;
    results land on the right futures even across coalesced batches."""
    gate = threading.Event()
    calls = []

    def fake_score(pairs, top=0):
        calls.append(len(pairs))
        if len(calls) == 1:
            gate.wait(timeout=10)   # hold the first dispatch open
        return [{"answer": p["question_string"]} for p in pairs]

    b = DynamicBatcher(fake_score, max_batch=8, max_delay_ms=2.0)
    try:
        first = b.submit({"question_string": "q0"})
        while not calls:          # first dispatch is now blocked in-flight
            pass
        rest = [b.submit({"question_string": f"q{i}"}) for i in range(1, 6)]
        gate.set()
        assert first.result(timeout=10) == {"answer": "q0"}
        for i, fut in enumerate(rest, start=1):
            assert fut.result(timeout=10) == {"answer": f"q{i}"}
        # the 5 queued requests were coalesced, not dispatched one-by-one
        assert calls[0] == 1 and len(calls) < 6 and sum(calls) == 6
    finally:
        b.close()


def test_cli_rejects_flags_not_yet_ported():
    from crct_tpu_torch.cli.serve import main
    for flag in (["-fast_scorer"], ["-serve_no_dataset"], ["-pallas"],
                 ["-mesh_shape", "4"]):
        with pytest.raises(SystemExit, match="not yet ported"):
            main(["-qa_file", "qa_pairs.npy", "-save_name", "x",
                  "-device", "cpu", *flag])
