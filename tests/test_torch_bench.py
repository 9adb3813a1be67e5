"""The port's bench (crct_tpu_torch/bench.py) against bench.py, on the CPU.

The analytic FLOP count and the synthetic step batch are bench.py's and
__graft_entry__.py's; FlopCounterMode's count of the port's flagship grad
step (plain attention on the CPU) agrees with the analytic count, as XLA's
cost model does in tests/test_bench.py; every section runs at the tiny
config on the CPU (``--device cpu --tiny``) and returns its keys, finite and
positive; without a card the bench raises, prints no line and leaves
BENCH_LAST_GOOD.json as it was.
"""

import io
import json
import math
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jax_bench
from __graft_entry__ import _synthetic_step_batch as jax_step_batch
from crct_tpu_torch import bench
from tests.torch_ranks import start_ranks

REPO = Path(__file__).resolve().parents[1]

# the keys each section writes on the CPU (its MFU keys need the card's
# peak: they are the card's alone)
SECTION_KEYS = {
    "train": ("train_step_ms", "train_step_tflop",
              "train_step_tflop_analytic"),
    "eval": ("eval_candidate_rows_per_sec_per_chip",
             "eval_questions_per_sec_per_chip_at_120_fanout"),
    "fast_scorer": ("fast_scorer_questions_per_sec_per_chip",
                    "fast_topk8_questions_per_sec_per_chip_derived"),
    "fast_topk8": ("fast_topk8_questions_per_sec_per_chip",
                   "eval_protocol_questions_per_sec_per_chip_measured",
                   "eval_measured_mean_candidates"),
    "input_pipeline": ("input_pipeline_samples_per_sec_per_host",),
    "roofline": ("roofline_fwd_ms", "roofline_grad_ms",
                 "roofline_grad_no_dropout_ms", "roofline_step_ms",
                 "roofline_optimizer_ms", "roofline_dropout_ms"),
    "e2e": ("e2e_charts_per_sec_per_chip", "e2e_extract_s", "e2e_qa_s",
            "qa_build_s", "qa_eval_s", "qa_questions"),
    "detector_800px": ("detector_train_imgs_per_sec_per_chip_800px",
                       "detector_train_step_tflop_800px"),
    "detector": ("detector_train_imgs_per_sec_per_chip",),
    "detector_800px_bf16": (
        "detector_train_imgs_per_sec_per_chip_800px_bf16",),
    "detector_800px_fastnms": (
        "detector_train_imgs_per_sec_per_chip_800px_fastnms",),
}
DIFFERENCES = ("roofline_dropout_ms",)


@pytest.fixture(scope="module")
def line():
    """One tiny run of every section on the CPU, and its printed line."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            result = bench.main(["--device", "cpu", "--tiny", "--all",
                                 "--roofline"])
    finally:
        torch.set_num_threads(n)
    printed = [json.loads(s) for s in buf.getvalue().splitlines()
               if s.startswith("{")]
    assert printed == [json.loads(json.dumps(result))]
    return result


@pytest.mark.parametrize("B,L,R", [(80, 124, 44), (1, 124, 44),
                                   (240, 124, 44), (8, 64, 16),
                                   (33, 200, 100)])
def test_analytic_train_flops_is_the_jax_benchs(B, L, R):
    assert bench.analytic_train_flops(B, L, R) == \
        jax_bench.analytic_train_flops(B, L, R)


@pytest.mark.parametrize("B,seed", [(1, 0), (8, 3), (80, 0)])
def test_synthetic_step_batch_is_the_graft_entrys(B, seed):
    kw = dict(B=B, L=124, R=44, vdim=1024, vocab=30522, cats=228)
    want = jax_step_batch(np.random.default_rng(seed), **kw)
    got = bench._synthetic_step_batch(np.random.default_rng(seed), **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert isinstance(got[k], np.ndarray), k
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_analytic_flops_match_the_flop_counter():
    """FlopCounterMode over the port's flagship forward and backward (fp32,
    plain attention, two rows) scaled to batch 80 agrees with the analytic
    matmul count within 5 %, as XLA's cost model does for the JAX step
    (tests/test_bench.py::test_analytic_flops_matches_cost_model): a layer
    added or resized in either breaks it."""
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        counted = bench.train_step_flops()
    finally:
        torch.set_num_threads(n)
    analytic = bench.analytic_train_flops(B=80)
    assert abs(counted - analytic) / analytic < 0.05, (counted, analytic)


@pytest.mark.parametrize("section", sorted(SECTION_KEYS))
def test_each_section_returns_its_keys(line, section):
    aux = line["aux"]
    for key in SECTION_KEYS[section]:
        assert key in aux, key
        assert math.isfinite(aux[key]), (key, aux[key])
        # the dropout's share is a difference of two windows, which
        # one-step windows on a shared CPU may swap; the rest are measured
        assert aux[key] > 0 or key in DIFFERENCES, (key, aux[key])
        if key in aux["spread"]:
            s = aux["spread"][key]
            assert s["n"] >= 1 and s["q1"] <= aux[key] <= s["q3"], s
            assert s["q1"] > 0 or key in DIFFERENCES, s
    # on the CPU the wrappers run the kernels' plain versions: no launch
    assert aux["launches"][section] == {"k1": 0, "k2": 0, "k3": 0,
                                        "shapes": {}}


def test_the_line_has_bench_pys_shape(line):
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "aux"}
    assert line["unit"] == "qa_pairs/s/chip"
    assert line["value"] > 0 and math.isfinite(line["value"])
    assert line["vs_baseline"] == pytest.approx(line["value"] / 115.0)
    aux = line["aux"]
    assert aux["attention_path"] == "cuda_k1_k2_round_probs"
    assert aux["device_name"] == "cpu" and aux["n_chips"] == 1
    assert set(aux["launches"]) == set(SECTION_KEYS)
    # no number of a device metric from the CPU: no MFU, no peak
    assert not [k for k in aux if "mfu" in k or "peak" in k]
    # the QA step at the tiny config, counted like the flagship's
    assert aux["train_step_tflop"] > 0
    assert aux["roofline_step_ms"] == aux["train_step_ms"]
    # the windows of the three roofline runs take turns: as many of each
    spread = aux["spread"]
    assert spread["roofline_fwd_ms"]["n"] == spread["roofline_grad_ms"]["n"] \
        == spread["roofline_grad_no_dropout_ms"]["n"] \
        == spread["roofline_dropout_ms"]["n"]


def test_peaks_are_the_cards_own():
    assert bench.peak_tflops("NVIDIA H100 80GB HBM3") == {
        "bfloat16": 989.4, "float32": 67.0}
    with pytest.raises(RuntimeError, match="no peak FLOP/s known"):
        bench.peak_tflops("Some Other Card")


@pytest.mark.parametrize("flags", [[], ["--pallas"]],
                         ids=["default", "pallas"])
def test_pallas_flag_picks_the_attention_mode(flags, monkeypatch):
    """--pallas, as bench.py's, runs the model with the Pallas path's
    attention numerics; without it, the default path's. The run stops at
    the first section."""
    seen = []

    class Stop(Exception):
        pass

    def bench_train(cfg, *args, **kwargs):
        seen.append((cfg.dtype, cfg.use_pallas_attention))
        raise Stop

    monkeypatch.setattr(bench, "bench_train", bench_train)
    with pytest.raises(Stop):
        bench.main([*flags, "--device", "cpu", "--tiny"])
    assert seen == [("bfloat16", bool(flags))]


RANK = ("from crct_tpu_torch import parallel\n"
        "formed = parallel.maybe_initialize_distributed({'device': 'cpu'})\n"
        "print(formed, parallel.world_size(), parallel.rank())\n"
        "parallel.destroy()\n")


def test_two_ranks_form_a_group_from_params_without_seed_or_save_path():
    """The bench joins torchrun's group with params that hold only the
    device: neither a seed nor a save path to agree on. Two gloo ranks form
    the group (``maybe_initialize_distributed`` broadcast an empty object
    list, which raised, before)."""
    def start(port):
        return [subprocess.Popen(
            [sys.executable, "-c", RANK], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), WORLD_SIZE="2", RANK=str(r),
                     LOCAL_RANK=str(r)))
            for r in range(2)]

    for r, (code, out, err) in enumerate(start_ranks(start, timeout=120)):
        assert code == 0, err[-2000:]
        assert out.split() == ["True", "2", str(r)]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CUDA default is valid here")


def test_no_card_no_line_and_bench_last_good_untouched(no_card):
    """With no card and no --device cpu the bench raises before any work:
    exit non-zero, no JSON line, and BENCH_LAST_GOOD.json (the JAX bench's
    snapshot) byte for byte as it was."""
    snapshot = REPO / "BENCH_LAST_GOOD.json"
    before = snapshot.read_bytes()
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "crct_tpu_torch.bench"],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=env)
    assert proc.returncode != 0
    assert not [s for s in proc.stdout.splitlines() if s.startswith("{")]
    assert "no card" in proc.stderr
    assert snapshot.read_bytes() == before
