"""The port's evaluation path against the JAX package's.

The same synthetic data and the same weights (a JAX parameter tree drawn
from a numpy seed, carried across by flax_to_state_dict with strict=True)
go through crct_tpu's evaluate() and crct_tpu_torch's (on the CPU), for the
full protocol with the dedup transfer on and off, a run resumed halfway,
and binary FigureQA. The accuracy, breakdown and histogram tables must be
exactly equal; so must the host pieces (reducers, printed tables, the
result CSV and snapshots) on the same inputs. Per-question records: the
same answers; confidence (an NSP probability) within 1e-5 absolute and
reg_output within 1e-4 relative (fp32 forwards whose LayerNorms take the
variance in two different ways, see tests/test_torch_model.py).

Exact tables need answers that a last-bit difference cannot flip: each
fixture first asserts that no question's two best JAX NSP probabilities lie
within 1e-5 (weights drawn at scale 0.3 spread them; seed 0 has no such
tie).
"""

import dataclasses
import io
import json
import os
from contextlib import redirect_stdout
from unittest import mock

import jax
import numpy as np
import pytest

import crct_tpu.train.eval_loop as jel
from crct_tpu.config import default_params as jax_default_params
from crct_tpu.data.dataset import ChartQADataset as JaxDataset
from crct_tpu.data.dataset import DataLoader as JaxLoader
from crct_tpu.data.synthetic import generate_dataset
from crct_tpu.models.crct import CRCTModel as JaxCRCTModel
from crct_tpu_torch.config import CRCTModelConfig, default_params
from crct_tpu_torch.data.dataset import ChartQADataset, DataLoader
from crct_tpu_torch.models.crct import CRCTModel
from crct_tpu_torch.train import eval_loop as el
from crct_tpu_torch.utils.convert import flax_to_state_dict
from tests.helpers import tiny_model_config
from tests.test_binary_eval import _write_figqa_dataset
from tests.test_torch_model import fill_params

QUIET = {"log_print": lambda m: None}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Evaluation runs thousands of tiny forwards. With torch's default of
    one OpenMP thread per core, every op's barrier waits on threads that
    other test processes on the same cores have descheduled: these files
    took 696 s under two pytest-xdist workers, and 92 s on one thread
    each. The comparisons hold on any thread count."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(cfg, root, make, **kw):
    return make(figure_feat_path=cfg["figure_feat_path"],
                qa_parent_dir=cfg["qa_parent_dir"],
                dataset_config={"dataset_files_divisions":
                                cfg["dataset_files_divisions"]},
                eval_set="test", eval_batch_size=16, seed=3,
                save_path=str(root / "results"), **kw)


def port_model(jcfg, weights, **kw):
    model = CRCTModel(CRCTModelConfig.from_dict(dataclasses.asdict(jcfg)),
                      **kw)
    model.load_state_dict(flax_to_state_dict(weights), strict=True)
    return model.eval()


def spread_params(jmodel, batch, seed):
    """A JAX parameter tree for ``batch`` drawn from a numpy seed at scale
    0.3, which spreads the candidates' NSP probabilities (and the fast
    head's logits) well beyond fp32 noise: at the init's 0.02 they sit
    within ~1e-7 of each other and the ranking is a coin toss in both
    frameworks."""
    batch = {k: np.asarray(v) for k, v in batch.items()}
    return fill_params(jax.eval_shape(
        lambda r, b: jmodel.init(r, b, train=False),
        {"params": jax.random.key(0)}, batch)["params"], seed, scale=0.3)


def record_gaps(fn):
    """Run fn with the JAX segmented_argmax recorded; the smallest gap
    between a question's two best NSP probabilities."""
    gaps = []
    real = jel.segmented_argmax

    def rec(values, offsets):
        for s, e in zip(offsets[:-1], offsets[1:]):
            top = np.sort(values[s:e])[::-1]
            if len(top) > 1:
                gaps.append(top[0] - top[1])
        return real(values, offsets)

    with mock.patch.object(jel, "segmented_argmax", rec):
        out = fn()
    return out, min(gaps)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Datasets of both packages, the JAX model with a fast-scorer head and
    the port's model holding the same weights."""
    root = tmp_path_factory.mktemp("torch_eval")
    cfg = generate_dataset(str(root / "data"), n_images=8, division=4,
                           n_questions=3, feat_dim=32)
    jparams = _params(cfg, root, jax_default_params)
    params = _params(cfg, root, default_params)
    jds = JaxDataset(jparams, "test", init_split="test")
    ds = ChartQADataset(params, "test", init_split="test")
    jds.get_all_answers = ds.get_all_answers = True
    jcfg = tiny_model_config(vocab_size=30522, v_feature_size=32)
    jmodel = JaxCRCTModel(config=jcfg, categories=jparams["categories"],
                          fast_scorer=True)
    sample = next(iter(JaxLoader(jds, batch_size=2, shuffle=False,
                                 num_workers=1, drop_last=False)))
    weights = spread_params(jmodel, jel.build_fast_rows(sample), seed=0)
    return dict(jparams=jparams, params=params, jds=jds, ds=ds, jcfg=jcfg,
                jmodel=jmodel, weights=weights, data=cfg,
                model=port_model(jcfg, weights, fast_scorer=True,
                                 categories=params["categories"]))


def jax_eval(env, extra=None, indices=None, **kw):
    p = dict(env["jparams"], **(extra or {}))
    loader = JaxLoader(env["jds"], batch_size=16, shuffle=False,
                       drop_last=False, num_workers=1, indices=indices)
    recs = []
    out = jel.evaluate(loader, env["jds"], p, env["jmodel"], env["weights"],
                       on_predictions=recs.extend, **QUIET, **kw)
    return out, recs


def port_eval(env, extra=None, indices=None, **kw):
    p = dict(env["params"], **(extra or {}))
    loader = DataLoader(env["ds"], batch_size=16, shuffle=False,
                        drop_last=False, num_workers=1, indices=indices)
    recs = []
    out = el.evaluate(loader, env["ds"], p, env["model"],
                      on_predictions=recs.extend, **QUIET, **kw)
    return out, recs


def assert_same_tables(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def assert_same_records(got, want):
    assert len(got) == len(want)
    for r, jr in zip(got, want):
        assert set(r) == set(jr)
        for k, v in jr.items():
            if k == "confidence":
                assert r[k] == pytest.approx(v, abs=1e-5), (k, r, jr)
            elif k in ("reg_output", "answer") and isinstance(v, float):
                assert r[k] == pytest.approx(v, rel=1e-4), (k, r, jr)
            else:
                assert r[k] == v, (k, r, jr)


@pytest.fixture(scope="module")
def jax_full(env):
    """The JAX full protocol (dedup on), its records and the smallest gap
    between a question's two best candidates."""
    (out, recs), gap = record_gaps(lambda: jax_eval(env, csv=False))
    assert gap > 1e-5, gap
    return out, recs


# ---------------------------------------------------------------------------
# host pieces
# ---------------------------------------------------------------------------

def test_qcat_and_fig_tables_match():
    for qid in (jel.STRUCTURAL_QID + jel.DATA_RETRIEVAL_QID
                + ["A1", "M4", "C2", "", "S99"]):
        assert el.get_qcat_by_qid(qid) == jel.get_qcat_by_qid(qid)
    assert el.FIG_TABLE_IDS == jel.FIG_TABLE_IDS
    assert el.ROW_KEYS == jel.ROW_KEYS
    assert el.EVAL_VIS_KEYS == jel.EVAL_VIS_KEYS
    assert el.FAST_CAND_TOKENS == jel.FAST_CAND_TOKENS


class _AnsTypes:
    def __init__(self, types):
        self.types = types

    def get_ans_type(self, i):
        return int(self.types[i])


@pytest.mark.parametrize("seed", range(3))
def test_reducers_match_exactly(seed):
    g = np.random.default_rng(seed)
    n = 40
    needs_reg = g.random(n) < 0.4
    nsp, reg, reg_t = (g.random(n) < 0.5 for _ in range(3))
    a = el.reduce_total_acc(np.zeros((6, 2)), needs_reg, nsp, reg & needs_reg,
                            reg_t & needs_reg)
    b = jel.reduce_total_acc(np.zeros((6, 2)), needs_reg, nsp,
                             reg & needs_reg, reg_t & needs_reg)
    np.testing.assert_array_equal(a, b)
    dist = np.concatenate([g.random(n) * 1.5, [0.0, 0.05, 0.1, 1.0, 2.0]])
    np.testing.assert_array_equal(
        el.reduce_histogram(np.zeros(13, np.int64), dist),
        jel.reduce_histogram(np.zeros(13, np.int64), dist))
    batch = {"id": np.arange(n),
             "qa_type": list(g.choice(list(jel.FIG_TABLE_IDS)[1:], n)),
             "qid": list(g.choice(jel.STRUCTURAL_QID + ["A1", "D7"], n))}
    ds = _AnsTypes(g.integers(0, 3, n))
    np.testing.assert_array_equal(
        el.reduce_breakdown(np.zeros((5, 4, 3, 3)), ds, batch, nsp & reg,
                            nsp & reg_t, needs_reg),
        jel.reduce_breakdown(np.zeros((5, 4, 3, 3)), ds, batch, nsp & reg,
                             nsp & reg_t, needs_reg))


@pytest.mark.parametrize("dataset", ["plotqa", "dvqa"])
@pytest.mark.parametrize("seed", range(4))
def test_printed_tables_match_pandas(dataset, seed):
    """The printers' text equals the JAX package's pandas text, character
    for character: empty cells, regression-tolerance pairs, a Total row of
    floats with NaN, and an accumulator of zeros."""
    g = np.random.default_rng(seed)
    total = g.integers(0, 9, (6, 2)).astype(np.float64)
    total[:, 1] += total[:, 0]
    if seed == 0:
        total[:] = 0
    br = g.integers(0, 5, (5, 4, 3, 3)).astype(np.float64)
    br[..., 1] = np.maximum(br[..., 0], br[..., 1] * (g.random() < 0.5))
    br[..., 2] += br[..., 1]
    br[g.random((5, 4, 3)) < 0.3] = 0
    if seed == 1:
        br[:, :3, 1] = 0         # a whole question category empty: NaN
    params = {"dataset": dataset}
    for lp_fn, jfn, args in (
            (el.print_acc_table, jel.print_acc_table, (total,)),
            (el.print_breakdown_table, jel.print_breakdown_table,
             (params, br))):
        got, want = [], []
        if len(args) == 1:
            lp_fn(got.append, *args)
            jfn(want.append, *args)
        else:
            lp_fn(args[0], got.append, args[1])
            jfn(args[0], want.append, args[1])
        assert got == want


def test_evaluation_log_and_snapshots_match(tmp_path):
    """The result CSV, the snapshots and the resume ids: byte for byte the
    JAX package's on the same rows."""
    g = np.random.default_rng(0)
    data = np.stack([np.arange(6), g.integers(0, 5, 6), g.integers(0, 5, 6),
                     g.random(6), g.random(6).astype(np.float32),
                     g.random(6), g.random(6), g.random(6)],
                    axis=1).astype(object)
    data[[1, 4], 3:] = np.nan
    acc = (g.random((5, 4, 3, 3)), g.random((6, 2)),
           g.integers(0, 9, 13))
    files = {}
    for name, mod, kw in (("port", el, {}), ("jax", jel, {"rank": 0})):
        params = {"save_path": str(tmp_path / name), "eval_set": "test",
                  "start_checkpoint": "/x/run.ckpt"}
        log = mod.EvaluationLog(params, False, **kw)
        log.append(data[:3])
        log.append(data[3:])
        log.save_tensors(*acc)
        files[name] = {os.path.basename(p): open(p, "rb").read()
                       for p in [log.fp, *log.snapshot_paths.values()]}
        assert list(mod.get_prev_done_ids(params)) == list(range(6))
        again = mod.EvaluationLog(params, True, **kw)
        for a, b in zip(again.load_tensors(), acc):
            np.testing.assert_array_equal(a, b)
    assert files["port"] == files["jax"]


# ---------------------------------------------------------------------------
# evaluate(): the full protocol, resume, binary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dedup", [True, False], ids=["dedup", "no_dedup"])
def test_full_protocol_matches_jax(env, jax_full, dedup):
    want, jrecs = jax_full
    got, recs = port_eval(env, {"eval_dedup": dedup}, csv=False)
    assert_same_tables(got, want)
    assert_same_records(recs, jrecs)
    assert want[0][0, 1] == len(env["ds"])
    assert want[0][0, 0] > 0 and want[0][2, 1] > 0     # a non-trivial run


def test_resumed_run_matches_jax(env, jax_full, tmp_path):
    """Half the questions, then the rest with cont_eval: the CSV's ids
    feed the resume, the snapshots carry the accumulators, and the final
    tables equal the JAX package's one-pass tables."""
    want, _ = jax_full
    extra = {"save_path": str(tmp_path), "start_checkpoint": "run.ckpt"}
    n = len(env["ds"])
    port_eval(env, extra, indices=np.arange(n // 2), csv=True)
    done = el.get_prev_done_ids(dict(env["params"], **extra))
    assert sorted(done.tolist()) == list(range(n // 2))
    rest = np.array(sorted(set(range(n)) - set(done.tolist())))
    got, _ = port_eval(env, extra, indices=rest, csv=True, cont_eval=True)
    assert_same_tables(got, want)
    done = el.get_prev_done_ids(dict(env["params"], **extra))
    assert sorted(done.tolist()) == list(range(n))     # one CSV, appended


def test_progress_prints_the_tables(env, jax_full):
    """progress: the tables after each batch and the inference-time line,
    the same text as the JAX package's apart from that timing."""
    want, _ = jax_full
    lines = []
    el.evaluate(DataLoader(env["ds"], 16, shuffle=False, drop_last=False,
                           num_workers=1), env["ds"], env["params"],
                env["model"], progress="vocab_table", csv=False,
                log_print=lines.append)
    jlines = []
    jel.print_acc_table(jlines.append, want[0])
    jel.print_breakdown_table(env["jparams"], jlines.append, want[1])
    assert lines[-len(jlines) - 1:-1] == jlines
    assert lines[-1].startswith("Avg inference time:")


@pytest.fixture(scope="module")
def figqa(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("figqa")
    jparams = _write_figqa_dataset(tmp, n_images=4, n_questions=4)
    # the test split's questions name legend colours (ColorMapping)
    templates = {"1": "Is $_c1_$ greater than $_c2_$ ?",
                 "2": "Does $_c1_$ have the lowest value ?"}
    qas = [{"image_index": i, "question_id": q, "answer": (i + q) % 2,
            "color1_name": "old_name_a",
            "color2_name": "old_name_b" if q == 0 else "--None--",
            "question_string": ""} for i in range(4) for q in range(2)]
    np.save(tmp / "qa" / "validation2" / "qa_pairs.npy",
            np.asarray(qas, dtype=object), allow_pickle=True)
    jparams["question_templates"] = templates
    params = default_params(**{k: v for k, v in jparams.items()
                               if k != "dvqa_floats"})
    return jparams, params


def test_figureqa_test_split_matches_jax(figqa):
    """FigureQA test items: the colour names rewritten by ColorMapping, the
    arrays equal to the JAX dataset's."""
    jparams, params = figqa
    jds = JaxDataset(jparams, ["test"], init_split="test")
    ds = ChartQADataset(params, ["test"], init_split="test")
    jds.get_all_answers = ds.get_all_answers = True
    assert len(ds) == len(jds) == 8
    rewritten = 0
    for i in range(len(ds)):
        a, b = jds[i], ds[i]
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            else:
                assert a[k] == b[k], k
        raw = ds.get_raw(i)
        assert raw["question_string"] == ""     # the record is not touched
        rewritten += int("old_name" not in str(b["tokens"]))
    assert rewritten == len(ds)


def test_binary_figureqa_matches_jax(figqa):
    jparams, params = figqa
    jds = JaxDataset(jparams, ["val"], init_split="val")
    ds = ChartQADataset(params, ["val"], init_split="val")
    jds.get_all_answers = ds.get_all_answers = True
    jcfg = tiny_model_config(v_feature_size=32)
    jmodel = JaxCRCTModel(config=jcfg, categories=jparams["categories"],
                          dataset="figure_qa", binary_answers=True)
    sample = next(iter(JaxLoader(jds, 4, shuffle=False, num_workers=1)))
    rows = {k: np.asarray(sample[k]) for k in jel.ROW_KEYS if k in sample}
    weights = spread_params(jmodel, rows, seed=1)
    model = port_model(jcfg, weights, categories=params["categories"],
                       dataset="figure_qa", binary_answers=True)
    jrecs, recs = [], []
    want = jel.evaluate(JaxLoader(jds, 4, shuffle=False, drop_last=False,
                                  num_workers=1), jds, jparams, jmodel,
                        weights, csv=False, on_predictions=jrecs.extend,
                        **QUIET)
    got = el.evaluate(DataLoader(ds, 4, shuffle=False, drop_last=False,
                                 num_workers=1), ds, params, model,
                      csv=False, on_predictions=recs.extend, **QUIET)
    # no answer may sit on the rounding edge of its probability
    assert all(abs(r["confidence"] - 0.5) > 1e-5 for r in jrecs)
    assert_same_tables(got, want)
    assert_same_records(recs, jrecs)
    assert want[0][0, 1] == len(ds) == 16


def test_histogram_png_is_optional(tmp_path):
    """make_histogram_png writes the PNG where matplotlib is installed and
    returns None where it is not, as the JAX package's does."""
    hist = np.arange(13)
    params = {"save_path": str(tmp_path), "eval_set": "test"}
    got = el.make_histogram_png(params, hist)
    want = jel.make_histogram_png(dict(params, save_path=str(tmp_path / "j")),
                                  hist)
    assert (got is None) == (want is None)
    if got is not None:
        assert os.path.getsize(got) > 0
    with mock.patch.dict("sys.modules", {"matplotlib": None}):
        assert el.make_histogram_png(params, hist) is None


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------

def _cli_files(env, tmp_path):
    cfg = dict(env["data"], main_folder="", save_path=str(tmp_path),
               max_seq_len=124,
               max_vis_features=44, categories=228)
    (tmp_path / "ds.json").write_text(json.dumps(cfg))
    (tmp_path / "tiny.json").write_text(json.dumps(
        dataclasses.asdict(env["jcfg"])))
    return ["-qa_file", "qa_pairs.npy", "-dataset_config",
            str(tmp_path / "ds.json"), "-model_config",
            str(tmp_path / "tiny.json"), "-num_workers", "1",
            "-device", "cpu"]


def test_cli_evaluate_on_the_cpu_and_resume(env, jax_full, tmp_path):
    """cli.evaluate with a port checkpoint: the JAX tables, the prediction
    records, and a second run that finds every question done."""
    import torch
    from crct_tpu_torch.cli.evaluate import main
    from crct_tpu_torch.utils.checkpoint import save_checkpoint
    want, jrecs = jax_full
    save_checkpoint(str(tmp_path / "run.ckpt"), env["model"].state_dict())
    argv = _cli_files(env, tmp_path) + [
        "-eval_set", "test", "-eval_batch_size", "16", "-save_name", "ev",
        "-start_checkpoint", str(tmp_path / "run.ckpt"),
        "-predictions_out", str(tmp_path / "answers.jsonl")]
    out = io.StringIO()
    with redirect_stdout(out):
        total, breakdown = main(argv)
    np.testing.assert_array_equal(total, want[0])
    np.testing.assert_array_equal(breakdown, want[1])
    text = out.getvalue()
    assert "Done evaluation" in text and "Model's parameters" in text
    recs = [json.loads(ln) for ln in
            (tmp_path / "answers.jsonl").read_text().splitlines()]
    assert [r["cls_output"] for r in recs] == \
        [r["cls_output"] for r in jrecs]
    assert list((tmp_path / "ev").glob("eval_results_test_run.ckpt_0.csv"))
    with redirect_stdout(io.StringIO()) as again:
        total2, _ = main(argv)
    assert f"Done Ids: {len(env['ds'])}" in again.getvalue()
    np.testing.assert_array_equal(total2, want[0])
    assert torch.get_default_dtype() == torch.float32


def test_cli_train_evaluates_each_epoch(tmp_path):
    """cli.train without -no_eval: after the epoch the training model is
    scored on the eval split (the in-train tables in the log) and put back
    in training mode."""
    from crct_tpu_torch.cli.train import main
    cfg = generate_dataset(str(tmp_path / "data"), n_images=4, division=4,
                           n_questions=2, feat_dim=32,
                           splits=("train", "val"))
    ds_cfg = dict(cfg, main_folder="", save_path=str(tmp_path),
                  max_seq_len=124, max_vis_features=44, categories=228)
    (tmp_path / "ds.json").write_text(json.dumps(ds_cfg))
    tiny = tiny_model_config(vocab_size=30522, v_feature_size=32)
    (tmp_path / "tiny.json").write_text(json.dumps(dataclasses.asdict(tiny)))
    with redirect_stdout(io.StringIO()) as out:
        trainer = main(["-qa_file", "qa_pairs.npy", "-dataset_config",
                        str(tmp_path / "ds.json"), "-model_config",
                        str(tmp_path / "tiny.json"), "-batch_size", "8",
                        "-num_epochs", "1", "-num_workers", "1",
                        "-eval_batch_size", "8", "-fast_scorer",
                        "-save_name", "run", "-device", "cpu"])
    assert trainer.model.training
    assert not trainer.model.has_fast_scorer
    log = (tmp_path / "run" / "log.txt")
    text = log.read_text() if log.exists() else out.getvalue()
    assert "Eval time" in text and "Total Accuracy" in text
    assert "==================== Total: 8 " in text
