"""The port's measurement tools (crct_tpu_torch/tools/) on the CPU.

Each of the eight runs at ``--device cpu`` and its tiny or smallest flags
and prints its JSON line: the serve bench answers every request with no
client error and coalesces under concurrency (the port of
tests/test_bench.py::test_serve_bench_smoke); the chunk sweep's tables are
equal across chunks; the detector knockouts leave ``mask_rcnn``'s and
``box_ops``' namespaces as they found them. Without a card every tool
raises before it does any work.
"""

import importlib
import io
import json
from contextlib import redirect_stdout

import pytest
import torch

TOOLS = ("serve_bench", "eval_overhead_profile", "eval_chunk_sweep",
         "attention_shape_bench", "detector_step_decomp",
         "roi_backward_compare", "opt_variant_bench", "shortlist_miss_rate")


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """Tiny models: torch's thread pool only waits on the other test
    processes' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(name, *argv):
    """The tool's main() on the CPU; its result, which must be the last
    line it printed."""
    tool = importlib.import_module(f"crct_tpu_torch.tools.{name}")
    buf = io.StringIO()
    with redirect_stdout(buf):
        res = tool.main(["--device", "cpu", *argv])
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == \
        json.loads(json.dumps(res))
    assert res["device_name"] == "cpu"
    return res


def test_serve_bench_answers_every_request_and_coalesces():
    res = run("serve_bench", "--tiny", "--requests", "16", "--threads", "4",
              "--sequential", "2", "--chunk", "64")
    assert res["requests"] == 16
    assert res["errors"] == []
    assert res["dispatches"] >= 1
    assert res["serve_questions_per_sec_per_chip"] > 0
    assert res["latency_ms_p50"] <= res["latency_ms_p95"]
    # 4 concurrent clients share dispatches
    assert res["mean_coalesced_batch"] > 1


def test_eval_chunk_sweep_tables_equal_across_chunks():
    """24- and 120-row chunks (loader batches of 8 and 10 questions) give
    the same accuracy tables."""
    res = run("eval_chunk_sweep", "--tiny", "--questions", "16", "--chunks",
              "24,120", "--repeats", "1")
    assert [r["chunk"] for r in res["table"]] == [24, 120]
    assert [r["loader_batch"] for r in res["table"]] == [8, 10]
    assert res["tables_equal"] is True
    assert all(r["questions"] == 16 and r["questions_per_sec_per_chip"] > 0
               for r in res["table"])
    from crct_tpu_torch.train import eval_loop
    assert eval_loop.EVAL_AUTO_ROWS_PER_CARD == 240      # put back


def test_eval_overhead_profile_times_every_phase():
    res = run("eval_overhead_profile", "--tiny", "--questions", "16",
              "--passes", "1")
    assert res["questions"] == 16 and res["chunks"] >= 1
    assert res["chunk_rows"] == 24
    assert set(res["phases_s"]) == {"flatten", "put_vis", "pack", "put",
                                    "dispatch", "fetch", "account"}
    assert all(v > 0 for v in res["phases_s"].values())
    assert res["e2e_s"] > 0 and res["e2e_q_per_s"] > 0


def test_attention_shape_bench_puts_the_attention_back():
    from crct_tpu_torch.models import layers
    from crct_tpu_torch.ops import attention
    res = run("attention_shape_bench", "--tiny", "--steps", "1",
              "--repeats", "1", "--shapes", "serve_b8,train_b80")
    assert set(res["shapes"]) == {"serve_b8", "train_b80"}
    for r in res["shapes"].values():
        for path in ("kernels", "pallas", "plain", "sdpa"):
            assert r[path] > 0
        assert r["pallas_over_kernels"] > 0
    assert layers.fused_attention is attention.fused_attention


def test_detector_knockouts_leave_the_namespaces_as_found():
    from crct_tpu_torch.detector import boxes, mask_rcnn
    before = (dict(vars(mask_rcnn)), dict(vars(boxes)))
    res = run("detector_step_decomp", "--tiny", "--steps", "1", "--repeats",
              "1", "--warmup", "1")
    assert (dict(vars(mask_rcnn)), dict(vars(boxes))) == before
    for v in ("full", "no_mask", "stub_roialign", "stub_nms",
              "stub_rpn_loss", "stub_roi_match", "backbone_only",
              "optimizer_only"):
        assert res[f"{v}_ms"] > 0, v
    assert set(res["deltas_ms"]) == {"mask_branch", "roialign",
                                     "proposal_nms", "rpn_loss_matching",
                                     "roi_matching_sampling", "optimizer"}


def test_roi_backward_compare_three_gradients_agree():
    from crct_tpu_torch.ops import roi_align_kernel
    want = roi_align_kernel.mlra_backward_kernel
    res = run("roi_backward_compare", "--tiny", "--rois", "16", "--iters",
              "2")
    assert roi_align_kernel.mlra_backward_kernel is want
    tol = 2e-5 * max(1.0, res["max_abs_grad"])
    assert res["max_abs_diff"]["k3_vs_scatter"] <= tol
    assert res["max_abs_diff"]["einsum_vs_scatter"] <= tol
    assert min(res["k3_ms"], res["einsum_ms"], res["scatter_ms"]) > 0


def test_opt_variant_bench_runs_both_variants():
    res = run("opt_variant_bench", "--tiny", "--opt-bf16-m", "--dropout0",
              "--repeats", "2")
    assert res["variant"] == {"opt_bf16_m": True, "dropout0": True}
    assert res["qa_pairs_per_sec_per_chip"] > 0 and res["train_step_ms"] > 0
    assert res["spread"]["train_step_ms"]["n"] == 2


def test_shortlist_miss_rate_on_the_learned_task():
    res = run("shortlist_miss_rate", "--backbone-steps", "10",
              "--head-steps", "5", "--ks", "4")
    assert res["n_questions"] > 0 and res["backbone_tail_loss"] > 0
    assert 0.0 <= res["k4"]["miss_rate"] <= 1.0
    assert 0.0 <= res["k4"]["topk_accuracy"] <= 1.0
    assert 0.0 <= res["full_protocol_accuracy"] <= 1.0


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CUDA default is valid here")


@pytest.mark.parametrize("name", TOOLS)
def test_every_tool_defaults_to_the_card(no_card, name):
    tool = importlib.import_module(f"crct_tpu_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="no card"):
        tool.main([])
