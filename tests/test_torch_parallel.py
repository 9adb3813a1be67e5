"""The port's data parallelism (crct_tpu_torch.parallel) against the JAX
package's mesh, on the CPU.

Two port ranks run as two processes joined by a gloo process group (as
tests/test_multihost.py runs two JAX processes: a child environment without
JAX_/XLA_ variables, a free port, a timeout on each), each on its half of
the global batch; the JAX side runs in this process over a 2-device mesh of
the 8 virtual CPU devices that tests/conftest.py gives JAX:

  * DataLoader(num_shards, shard_index): exactly the JAX loader's indices
    and batches, odd counts (padded by repeating the head) included;
  * one QA train step at local batch 4 against make_train_step over a
    2-device mesh at batch 8 (dropout off, as in tests/test_torch_train.py):
    the metrics within rtol 2e-4 and the parameters after AdamW within rtol
    1e-3, test_two_process_real_train_step's limits;
  * cli.evaluate over 2 ranks: the accuracy, breakdown and histogram tables
    exactly equal to the JAX single-process evaluate(), one result CSV a
    rank, and -predictions_out written to <path>.rank{r};
  * one detector step over 2 ranks (one image each, depth-14 trunk, 64 x 64)
    against the JAX DetectorTrainer on a 2-device mesh, with the JAX
    sampling noise of each image handed to its rank: the losses within 1e-5
    relative and each parameter's SGD update within 1e-4 of its largest
    magnitude (test_torch_detector.py's gradient limit) plus two fp32
    spacings of the parameter's values, through which the update is read,
    at images with no ReLU input within fp32 reordering of zero; at such a
    kink the gradient jumps, and one image's gradients at 1 and at 4 CPU
    threads differ beyond 1e-4 only where such an input flips, and agree
    within 1e-4 with the ReLU signs replayed (seeds 0-6); batch_multiply 2
    against optax.MultiSteps on the same gradients, within 1e-6;
  * QAScorer over ["cpu", "cpu"] (one replica each, every dispatch split in
    two) against one device: the same answers, NSP probabilities within
    1e-6;
  * a 2-rank run_training that only rank 1 preempts: both ranks stop at the
    same step, rank 0 alone saves, and -continue resumes both to the end;
    the in-train eval's totals count each sampled question once.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from tests.torch_ranks import start_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import glob, json, os, signal, sys
mode, rank, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
sys.path.insert(0, {repo!r})
import numpy as np, torch
torch.set_num_threads(1)
from crct_tpu_torch import parallel
url = f"tcp://127.0.0.1:{{port}}"
parallel.init_distributed(2, rank, init_method=url, device="cpu")
assert parallel.world_size() == 2 and parallel.rank() == rank
case = torch.load(os.path.join(out, mode + "_case.pt"), weights_only=False)

if mode == "qa":
    from crct_tpu_torch.cli.evaluate import main as evaluate_main
    from crct_tpu_torch.config import CRCTModelConfig
    from crct_tpu_torch.models import layers
    from crct_tpu_torch.models.crct import CRCTModel
    from crct_tpu_torch.train.optimizer import AdamW
    from crct_tpu_torch.train.train_loop import make_train_step
    layers.DropoutRNG.dropout = lambda self, x, p: x
    model = CRCTModel(CRCTModelConfig.from_dict(case["cfg"]), categories=10)
    model.load_state_dict(case["state"], strict=True)
    model.train()
    opt = AdamW(list(model.named_parameters()), case["opt"], 5)
    local = {{k: torch.from_numpy(v[rank * 4:(rank + 1) * 4])
              for k, v in case["batch"].items()}}
    metrics = make_train_step(model, opt)(local, torch.Generator())
    torch.save({{"metrics": metrics.numpy(), "state": model.state_dict()}},
               os.path.join(out, f"qa_{{rank}}.pt"))
    # the eval CLI over the same process group (it finds it formed)
    total, breakdown = evaluate_main(case["eval_argv"] + [
        "-dist_url", url, "-world_size", "2", "-rank", str(rank)])
    np.save(os.path.join(out, f"eval_{{rank}}.npy"),
            np.concatenate([total.ravel(), breakdown.ravel()]))

elif mode == "det":
    from crct_tpu_torch.detector import boxes
    from crct_tpu_torch.detector.trainer import DetectorTrainer
    draws = [torch.from_numpy(x) for x in case["noise"][rank]]
    boxes._draw_uniform = lambda gen, n, device: draws.pop(0)
    trainer = DetectorTrainer(device="cpu", **case["kw"])
    trainer.model.load_state_dict(case["state"], strict=True)
    losses = trainer.run_step(case["batch"])
    assert not draws
    torch.save({{"losses": losses, "state": trainer.model.state_dict()}},
               os.path.join(out, f"det_{{rank}}.pt"))

else:                                    # run_training: preempt / resume
    from crct_tpu_torch.cli.train import in_train_eval
    from crct_tpu_torch.data.dataset import ChartQADataset
    from crct_tpu_torch.train.train_loop import run_training
    params = dict(case["params"])
    ds = ChartQADataset(params, ["train", "val"])
    if mode == "preempt":
        def eval_fn(trainer, dataset, epoch_id):
            total = in_train_eval(trainer, dataset, epoch_id)
            print(f"EVAL_COUNT_{{rank}}={{int(total[4, 1])}}", flush=True)
            if epoch_id == 0 and rank == 1:    # rank 1 alone is preempted
                os.kill(os.getpid(), signal.SIGTERM)
            return total
        trainer = run_training(params, ds, eval_fn=eval_fn, device="cpu")
    else:
        cks = sorted(glob.glob(os.path.join(params["save_path"],
                                            "plotqa_encoder_0_*.ckpt")))
        params.update(start_checkpoint=cks[-1], **{{"continue": True}})
        trainer = run_training(params, ds, eval_fn=in_train_eval,
                               device="cpu")
    print(f"STEPS_{{rank}}={{trainer.step}}", flush=True)
print(f"CHILD_OK_{{rank}}", flush=True)
"""


def run_ranks(mode, out, case, timeout=300):
    """The two ranks of ``mode`` over ``case`` (saved for them under
    ``out``); their outputs."""
    torch.save(case, os.path.join(out, f"{mode}_case.pt"))
    script = os.path.join(out, "child.py")
    with open(script, "w") as f:
        f.write(CHILD.format(repo=REPO))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    def start(port):
        return [subprocess.Popen(
            [sys.executable, script, mode, str(r), str(port), str(out)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=str(out)) for r in (0, 1)]

    outs = []
    for r, (code, text, _) in enumerate(start_ranks(start, timeout)):
        assert code == 0, f"rank {r} failed:\n{text}"
        assert f"CHILD_OK_{r}" in text, text
        outs.append(text)
    return outs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the loader's shards
# ---------------------------------------------------------------------------

class _Items:
    def __init__(self, n):
        self.n, self.epoch = n, 0

    def __len__(self):
        return self.n


@pytest.mark.parametrize("n,shards,shuffle,drop_last",
                         [(10, 2, True, True), (11, 2, True, False),
                          (7, 3, False, False), (12, 4, True, True)])
def test_loader_shards_equal_jax(n, shards, shuffle, drop_last):
    """Each shard's epoch indices, length and batches equal the JAX
    loader's, over two epochs; the shards cover the (padded) index list
    once. An odd count repeats the head of the list: a sharded eval counts
    those questions twice (ROADMAP.md §3)."""
    from crct_tpu.data.dataset import DataLoader as JaxLoader
    from crct_tpu_torch.data.dataset import DataLoader
    seen = []
    for s in range(shards):
        kw = dict(shuffle=shuffle, seed=5, num_workers=1,
                  drop_last=drop_last, num_shards=shards, shard_index=s)
        port, ref = DataLoader(_Items(n), 2, **kw), JaxLoader(_Items(n), 2,
                                                              **kw)
        for epoch in (0, 1):
            port.epoch = ref.epoch = epoch
            np.testing.assert_array_equal(port._epoch_indices(),
                                          ref._epoch_indices())
            assert len(port) == len(ref)
            for a, b in zip(port._batches(), ref._batches()):
                np.testing.assert_array_equal(a, b)
        port.epoch = 0
        seen.extend(port._epoch_indices().tolist())
    padded = -(-n // shards) * shards
    assert len(seen) == padded and set(seen) == set(range(n))


# ---------------------------------------------------------------------------
# a QA train step and the eval CLI over 2 ranks
# ---------------------------------------------------------------------------

def _qa_batch():
    from tests.test_torch_model import make_batch
    b = make_batch(51, B=8)
    b["next_sentence_labels"] = np.asarray([0, 1, 1, 0, 1, 0, 0, 1],
                                           np.int32)
    # regression rows on both ranks, targets inside and outside [-1, 1]
    b["R"] = np.asarray([[5.0, 1, 0.01, 10.0], [-2.5, 1, 0.01, 10.0],
                         [0, 0, 0, 0], [0, 0, 0, 0],
                         [30.0, 1, 0.01, 10.0], [0, 0, 0, 0],
                         [0, 0, 0, 0], [0, 0, 0, 0]], np.float32)
    return b


@pytest.fixture(scope="module")
def qa_ranks(tmp_path_factory):
    """The JAX mesh step, the JAX evaluate() tables and records, and the
    two port ranks' step and eval CLI outputs."""
    from crct_tpu.data.dataset import ChartQADataset as JaxDataset
    from crct_tpu.data.dataset import DataLoader as JaxLoader
    from crct_tpu.models.crct import CRCTModel as JaxCRCTModel
    from crct_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from crct_tpu.train import eval_loop as jel
    from crct_tpu.train import optimizer as jax_opt
    from crct_tpu.train.train_loop import make_train_step
    from crct_tpu_torch.utils.checkpoint import save_checkpoint
    from crct_tpu_torch.utils.convert import flax_to_state_dict
    from tests.helpers import tiny_model_config
    from tests.test_torch_eval import _cli_files, _params, spread_params
    from tests.test_torch_model import random_params
    from tests.test_torch_train import NO_DROPOUT, OPT, _Deterministic
    from crct_tpu.config import default_params as jax_default_params
    from crct_tpu.data.synthetic import generate_dataset

    out = tmp_path_factory.mktemp("qa_ranks")
    # the train step over a 2-device mesh at batch 8
    jcfg = tiny_model_config(**NO_DROPOUT)
    jmodel = JaxCRCTModel(config=jcfg, categories=10)
    batch = _qa_batch()
    params = random_params(jmodel, batch, 51)
    tx = jax_opt.make_optimizer(OPT, params, iters_per_epoch=5)
    mesh = make_mesh(2)
    step = jax.jit(make_train_step(_Deterministic(jmodel), tx))
    new, _, metrics = step(replicate(params, mesh),
                           replicate(tx.init(params), mesh),
                           shard_batch(batch, mesh), jax.random.key(0))

    # the eval split, the JAX tables over all of it
    data = generate_dataset(str(out / "data"), n_images=8, division=4,
                            n_questions=3, feat_dim=32)
    jparams = _params(data, out, jax_default_params)
    jds = JaxDataset(jparams, "test", init_split="test")
    jds.get_all_answers = True
    assert len(jds) % 2 == 0, len(jds)    # no padded repeat: exact tables
    ecfg = tiny_model_config(vocab_size=30522, v_feature_size=32)
    emodel = JaxCRCTModel(config=ecfg, categories=jparams["categories"])
    sample = next(iter(JaxLoader(jds, batch_size=2, shuffle=False,
                                 num_workers=1, drop_last=False)))
    rows, _ = jel._flatten_valid_rows(sample)
    weights = spread_params(emodel, rows, seed=0)
    recs = []
    tables = jel.evaluate(
        JaxLoader(jds, batch_size=16, shuffle=False, drop_last=False,
                  num_workers=1), jds, jparams, emodel, weights, csv=False,
        log_print=lambda m: None, on_predictions=recs.extend)
    save_checkpoint(str(out / "run.ckpt"), flax_to_state_dict(weights))
    env = {"data": data, "jcfg": ecfg}
    argv = _cli_files(env, out) + [
        "-eval_set", "test", "-eval_batch_size", "16", "-save_name", "ev",
        "-start_checkpoint", str(out / "run.ckpt"),
        "-predictions_out", str(out / "answers.jsonl")]

    outs = run_ranks("qa", str(out), {
        "cfg": dataclasses.asdict(jcfg), "state": flax_to_state_dict(params),
        "opt": OPT, "batch": batch, "eval_argv": argv})
    return dict(out=out, metrics=np.asarray(metrics),
                new=flax_to_state_dict(jax.device_get(new)), tables=tables,
                recs=recs, n=len(jds), outs=outs)


def test_two_rank_qa_step_matches_the_jax_mesh_step(qa_ranks):
    out = qa_ranks["out"]
    for r in (0, 1):
        got = torch.load(out / f"qa_{r}.pt", weights_only=False)
        np.testing.assert_allclose(got["metrics"], qa_ranks["metrics"],
                                   rtol=2e-4, atol=1e-5)
        for k, want in qa_ranks["new"].items():
            np.testing.assert_allclose(got["state"][k].numpy(),
                                       want.numpy(), rtol=1e-3, atol=2e-5,
                                       err_msg=k)


def test_two_rank_eval_equals_the_jax_tables(qa_ranks):
    out = qa_ranks["out"]
    total, breakdown, _ = qa_ranks["tables"]
    want = np.concatenate([total.ravel(), breakdown.ravel()])
    for r in (0, 1):
        np.testing.assert_array_equal(np.load(out / f"eval_{r}.npy"), want)
    assert total[4, 1] == qa_ranks["n"]
    # one result CSV a rank, covering the split once between them
    from crct_tpu_torch.train.eval_loop import get_prev_done_ids
    csvs = sorted(glob.glob(str(out / "ev" / "eval_results_test_*.csv")))
    assert [c.rsplit("_", 1)[1] for c in csvs] == ["0.csv", "1.csv"]
    done = get_prev_done_ids({"save_path": str(out / "ev"),
                              "eval_set": "test",
                              "start_checkpoint": str(out / "run.ckpt")})
    assert sorted(done.tolist()) == list(range(qa_ranks["n"]))
    # -predictions_out: a file a rank, the JAX records between them
    recs = []
    for r in (0, 1):
        lines = (out / f"answers.jsonl.rank{r}").read_text().splitlines()
        assert lines
        recs += [json.loads(ln) for ln in lines]
    assert not (out / "answers.jsonl").exists()
    key = lambda rec: (str(rec["cls_output"]), str(rec["gt_answer"]))
    assert sorted(map(key, recs)) == sorted(map(key, qa_ranks["recs"]))


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------

DET_KW = dict(num_classes=5, depth=14, batch_size=2, base_lr=10.0,
              roi_batch=16, post_nms_topk=32)
GT_BOXES = np.asarray([[4, 4, 30, 30], [32, 32, 60, 60], [0, 0, 0, 0]],
                      np.float32)


# the images (seed, box shift) of the two-rank check against JAX
DET_IMAGES = ((0, 0.0), (5, 0.5))


def _det_sample(seed, shift):
    r = np.random.default_rng(seed)
    return {"image": r.random((64, 64, 3)).astype(np.float32),
            "gt_boxes": np.where(GT_BOXES > 0, GT_BOXES + shift,
                                 0).astype(np.float32),
            "gt_classes": np.asarray([1, 3, 0], np.int32),
            "gt_valid": np.asarray([True, True, False]),
            "gt_masks28": np.ones((3, 28, 28), np.float32)}


def test_two_rank_detector_step_matches_the_jax_mesh_step(tmp_path):
    """One image a rank against the JAX trainer's step over the global
    batch of 2 on a 2-device mesh: the losses (means over the world) and
    each parameter's update."""
    from crct_tpu.detector import rpn as jax_rpn
    from crct_tpu.detector.trainer import DetectorTrainer as JaxTrainer
    from crct_tpu_torch.detector.convert import detector_flax_to_state_dict

    # images with no ReLU input within fp32 reordering of zero (checked in
    # test_detector_gradients_move_with_fp32_order_only_at_relu_kinks):
    # at such a kink the gradient jumps, and any two orders of the sums
    # (the port's and XLA's convolutions) may take either side
    samples = [_det_sample(*a) for a in DET_IMAGES]
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    jt = JaxTrainer(samples, **DET_KW)
    assert jt.mesh.devices.size == 2
    start = detector_flax_to_state_dict(
        jax.tree.map(np.asarray, jax.device_get(jt.params)))
    # the noise each image's two samplers draw in the JAX step
    _, sub = jax.random.split(jt._rng)
    shapes = [(64 // s, 64 // s) for s in jax_rpn.RPN_STRIDES]
    n_anchors = sum(a.shape[0] for a in jax_rpn.level_anchors(shapes))
    noise = []
    for key in jax.random.split(sub, 2):
        r1, r2 = jax.random.split(key)
        noise.append([np.asarray(jax.random.uniform(r1, (n_anchors,))),
                      np.asarray(jax.random.uniform(
                          r2, (DET_KW["post_nms_topk"] + 3,)))])
    want_losses = jt.run_step(batch)
    want = detector_flax_to_state_dict(
        jax.tree.map(np.asarray, jax.device_get(jt.params)))

    run_ranks("det", str(tmp_path), {"kw": DET_KW, "state": start,
                                      "noise": noise, "batch": batch})
    for r in (0, 1):
        got = torch.load(tmp_path / f"det_{r}.pt", weights_only=False)
        assert set(got["losses"]) == set(want_losses)
        for k, w in want_losses.items():
            assert abs(float(got["losses"][k]) - w) <= 1e-5 * abs(w), k
        for k, p in got["state"].items():
            delta = (p - start[k]).numpy()
            wdelta = (want[k] - start[k]).numpy()
            # the update seen through fp32 parameters: to within the
            # spacing of their values
            ulp = np.finfo(np.float32).eps * float(start[k].abs().max())
            scale = float(np.abs(wdelta).max())
            assert np.abs(delta - wdelta).max() <= 1e-4 * scale + 2 * ulp, k


@pytest.fixture(scope="module")
def one_image_detector():
    from crct_tpu_torch.detector.trainer import DetectorTrainer
    model = DetectorTrainer(device="cpu", **dict(DET_KW, batch_size=1)).model
    return model, {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("seed", range(7))
def test_detector_gradients_move_with_fp32_order_only_at_relu_kinks(
        one_image_detector, monkeypatch, seed):
    """The cause of the detector's sensitivity to the order of fp32 sums:
    one image's gradients at 1 and at 4 CPU threads (the convolutions' sums
    split differently) differ by more than 1e-4 of a parameter's largest
    magnitude only where a ReLU input within 1e-6 of zero changes sign (a
    mask-head ReLU flips at some seeds and moves a small mask-head gradient
    by up to ~3e-3 of its magnitude). With the 1-thread run's ReLU masks
    replayed, the 4-thread gradients agree within 1e-4 at every seed; the
    proposals and the RoI sample are the same. The two-rank check against
    JAX takes images with no such flip."""
    import torch.nn.functional as F
    from crct_tpu_torch.detector import boxes, mask_rcnn
    model, start = one_image_detector
    s = _det_sample(seed, 0.5 if seed else 0.0)
    batch = {k: torch.from_numpy(v[None]) for k, v in s.items()}
    relu, propose = F.relu, mask_rcnn.propose

    def step(threads, replay=None):
        noise = np.random.default_rng(100)
        monkeypatch.setattr(boxes, "_draw_uniform", lambda g, n, d: (
            torch.from_numpy(noise.random(n).astype(np.float32))))
        inputs, props, masks = [], [], iter(replay or ())

        def rec_relu(x, inplace=False):
            inputs.append(x.detach().clone())
            if replay is not None:
                return torch.where(next(masks), x, torch.zeros_like(x))
            return relu(x)

        def rec_propose(*a, **kw):
            props.append(propose(*a, **kw))
            return props[-1]
        monkeypatch.setattr(F, "relu", rec_relu)
        monkeypatch.setattr(mask_rcnn, "propose", rec_propose)
        torch.set_num_threads(threads)
        try:
            model.load_state_dict(start)
            model.zero_grad(set_to_none=True)
            model(batch["image"], train=True, gt_boxes=batch["gt_boxes"],
                  gt_classes=batch["gt_classes"], gt_valid=batch["gt_valid"],
                  gt_masks28=batch["gt_masks28"])["total"].backward()
        finally:
            torch.set_num_threads(1)
            monkeypatch.setattr(F, "relu", relu)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        return grads, inputs, props[0]

    def worst(a, b):
        return max(((a[n] - g).abs().max() / g.abs().max()).item()
                   for n, g in b.items())

    g1, x1, p1 = step(1)
    g4, x4, p4 = step(4)
    # the discrete choices stand still: the same proposals (to fp32
    # reordering of their coordinates)
    assert torch.equal(p1[2], p4[2])
    assert torch.allclose(p1[0], p4[0], rtol=0, atol=1e-4)
    flips = [(a > 0) != (b > 0) for a, b in zip(x1, x4)]
    n_flips = sum(int(f.sum()) for f in flips)
    for a, b, f in zip(x1, x4, flips):
        if f.any():
            assert a[f].abs().max() < 1e-6 and b[f].abs().max() < 1e-6
    if n_flips == 0:
        assert worst(g4, g1) <= 1e-4
    if seed in [i for i, _ in DET_IMAGES]:
        assert n_flips == 0
    g4r, _, _ = step(4, replay=[a > 0 for a in x1])
    assert worst(g4r, g1) <= 1e-4


def test_detector_batch_multiply_matches_optax_multisteps():
    """DetectorSGD(every_k=2) against optax.MultiSteps around
    make_detector_optimizer on the same gradients: an update every second
    call, from the mean of the two, the schedule counting updates."""
    from crct_tpu.detector.trainer import make_detector_optimizer
    from crct_tpu_torch.detector.trainer import DetectorSGD
    r = np.random.default_rng(3)
    tree = {"conv": {"kernel": r.normal(size=(3, 3, 4, 8)).astype(np.float32),
                     "bias": r.normal(size=(8,)).astype(np.float32)}}
    tx = optax.MultiSteps(make_detector_optimizer(10.0, weight_decay=0.1), 2)
    state, jparams = tx.init(tree), tree
    leaves = [torch.nn.Parameter(torch.from_numpy(tree["conv"][k].copy()))
              for k in ("kernel", "bias")]
    opt = DetectorSGD(leaves, 10.0, weight_decay=0.1, every_k=2)
    update = jax.jit(tx.update)
    for i in range(5):
        g = {"conv": {k: r.normal(size=v.shape).astype(np.float32)
                      for k, v in tree["conv"].items()}}
        updates, state = update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(leaves, ("kernel", "bias")):
            p.grad = torch.from_numpy(g["conv"][k])
        opt.step()
        assert opt.count == (i + 1) // 2
        for p, k in zip(leaves, ("kernel", "bias")):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams["conv"][k]),
                                       atol=1e-6, rtol=0, err_msg=f"{i} {k}")


# ---------------------------------------------------------------------------
# serving over two replicas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dedup", [True, False], ids=["dedup", "rows"])
def test_scorer_over_two_devices_answers_as_over_one(tmp_path, dedup):
    from crct_tpu_torch.config import CRCTModelConfig, default_params
    from crct_tpu_torch.data.dataset import ChartQADataset
    from crct_tpu_torch.data.synthetic import generate_dataset
    from crct_tpu_torch.models.crct import CRCTModel
    from crct_tpu_torch.models.layers import init_weights
    from crct_tpu_torch.serve import QAScorer
    from tests.helpers import tiny_model_config

    data = generate_dataset(str(tmp_path / "data"), n_images=4, division=4,
                            n_questions=3, feat_dim=32, splits=("test",))
    params = default_params(
        figure_feat_path=data["figure_feat_path"],
        qa_parent_dir=data["qa_parent_dir"],
        dataset_config={"dataset_files_divisions":
                        data["dataset_files_divisions"]},
        eval_set="test", eval_batch_size=None, eval_dedup=dedup,
        serve_max_batch=5)
    ds = ChartQADataset(params, "test", init_split="test")
    cfg = CRCTModelConfig.from_dict(dataclasses.asdict(
        tiny_model_config(vocab_size=30522, v_feature_size=32)))
    model = CRCTModel(cfg, categories=params["categories"])
    init_weights(model, torch.Generator().manual_seed(0))
    for p in model.parameters():        # spread the candidates' scores
        p.data.mul_(15.0)
    qas = ds.qa["test"][:7]
    one = QAScorer(params, ds, model=model.eval(), device="cpu")
    two = QAScorer(params, ds, model=model, device=["cpu", "cpu"])
    assert len(two.replicas) == 2 and two.replicas[1] is not model
    assert two.chunk % 2 == 0
    calls = []
    real = two._eval_steps[0]
    two._eval_steps[0] = lambda *a: calls.append(1) or real(*a)
    want, got = one.score(qas, top=3), two.score(qas, top=3)
    assert calls and two.dispatches == one.dispatches
    for w, g in zip(want, got):
        assert g["answer"] == w["answer"], (g, w)
        assert [t["answer"] for t in g["top"]] == \
            [t["answer"] for t in w["top"]]
        assert g["confidence"] == pytest.approx(w["confidence"], abs=1e-6)


# ---------------------------------------------------------------------------
# run_training: preemption and resume over 2 ranks
# ---------------------------------------------------------------------------

def test_two_rank_run_training_preempts_together_and_resumes(tmp_path):
    from crct_tpu_torch.config import default_params
    from crct_tpu_torch.data.dataset import ChartQADataset
    from crct_tpu_torch.data.synthetic import generate_dataset
    from tests.helpers import tiny_model_config

    data = generate_dataset(str(tmp_path / "data"), n_images=8, division=4,
                            n_questions=2, feat_dim=32,
                            splits=("train", "val"))
    (tmp_path / "tiny.json").write_text(json.dumps(dataclasses.asdict(
        tiny_model_config(v_feature_size=32))))
    params = default_params(
        figure_feat_path=data["figure_feat_path"],
        qa_parent_dir=data["qa_parent_dir"], dataset_config=data,
        model_config=str(tmp_path / "tiny.json"), ddp=True, batch_size=2,
        num_epochs=3, num_workers=1, eval_batch_size=64, eval_set="val",
        save_path=str(tmp_path / "results"), device="cpu")
    n_val = len(ChartQADataset(params, ["val"], init_split="val"))
    assert n_val % 2 == 0 and n_val <= 500
    n_train = len(ChartQADataset(params, ["train"]))
    per_epoch = n_train // 4                  # global batch 2 x 2 ranks

    outs = run_ranks("preempt", str(tmp_path), {"params": params})
    # rank 1's SIGTERM stopped both ranks at the first step of epoch 1
    for r in (0, 1):
        assert f"STEPS_{r}={per_epoch}" in outs[r], outs[r]
        # the in-train eval sums the ranks' shards: each question once
        assert f"EVAL_COUNT_{r}={n_val}" in outs[r]
    assert "saved preemption checkpoint" in outs[0]
    assert "saved preemption checkpoint" not in outs[1]
    assert "De facto batch_size: 2*2*1 = 4" in outs[0]
    cks = glob.glob(str(tmp_path / "results" / "plotqa_encoder_*.ckpt"))
    assert cks and all("encoder_0_" in c for c in cks), cks
    # the saved keys are the reference torch keys, no wrapper prefix
    saved = torch.load(sorted(cks)[-1], weights_only=False)
    assert not any(k.startswith("module.")
                   for k in saved["model_state_dict"])

    outs = run_ranks("resume", str(tmp_path), {"params": params})
    assert "[Ep: 1." in outs[0] and "[Ep: 0." not in outs[0]
    for r in (0, 1):
        assert f"STEPS_{r}={3 * per_epoch}" in outs[r]
    epochs = sorted({int(os.path.basename(c).split("_")[2]) for c in
                     glob.glob(str(tmp_path / "results" /
                                   "plotqa_encoder_*.ckpt"))})
    assert epochs == [0, 1, 2], epochs
