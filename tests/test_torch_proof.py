"""The port's pixels-to-accuracy proof.

``crct_tpu_torch.tools.full_pipeline_proof`` chains the port's CLIs (chart
PNGs -> detector training -> feature extraction -> QA training ->
evaluation). Here it runs at its smallest sizes on the CPU: one detector
iteration, one QA epoch. Each stage's artifacts must exist and the JSON
line must carry the JAX tool's fields. The JAX tool itself is not run (it
takes minutes).
"""

import glob
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

# the fields of tools/full_pipeline_proof.py's JSON line
JAX_FIELDS = {"e2e_learned_heldout_accuracy", "cls_only_accuracy",
              "tolerance_accuracy", "chance", "questions", "det_iters",
              "qa_epochs", "charts_train", "charts_test", "fast", "fast_nms",
              "ocr"}
STAGES = ("charts", "detector_train", "extract_features", "train",
          "evaluate")


def test_proof_runs_on_the_cpu(tmp_path):
    root = tmp_path / "proof"
    code = textwrap.dedent(f"""
        import torch
        torch.set_num_threads(1)
        from crct_tpu_torch.tools.full_pipeline_proof import main
        main(["--fast", "--det-iters", "1", "--device", "cpu",
              "--root", {str(root)!r}])
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert JAX_FIELDS <= set(result)
    assert (result["det_iters"], result["qa_epochs"], result["charts_train"],
            result["charts_test"], result["questions"]) == (1, 1, 8, 4, 8)
    assert 0.0 <= result["e2e_learned_heldout_accuracy"] <= 1.0
    assert 0.0 < result["chance"] < 1.0
    assert tuple(result["stages"]) == STAGES
    for stage in result["stages"].values():
        assert stage["seconds"] > 0
        # the CPU runs the kernels' plain versions: no launch
        assert stage["k1"] == stage["k2"] == stage["k3"] == 0
    for split, n in (("train", 8), ("test", 4)):
        assert len(glob.glob(str(root / "charts" / split / "png" /
                                 "*.png"))) == n
        assert glob.glob(str(root / "fig_features" / split / "*.npy"))
    assert (root / "detector" / "detector_1.ckpt").is_file()
    assert glob.glob(str(root / "results" / "qa" / "plotqa_encoder_0_*.ckpt"))
    assert glob.glob(str(root / "results" / "qa_eval" / "*.csv"))


def test_proof_stage_counts_each_kernels_launches(capsys):
    """A stage's entry in the JSON line holds the launches of K1, K2 and
    K3 made inside it, each kernel's apart, and no launch made before."""
    from crct_tpu_torch.ops import attention, roi_align_kernel
    from crct_tpu_torch.tools.full_pipeline_proof import _Stage
    key = ("float32", attention.ROUND_PROBS, 4, 8, 8, 16)
    attention.LAUNCHES[key] += 5
    stages = {}
    try:
        with _Stage(stages, "train"):
            attention.LAUNCHES[key] += 2
            attention.BWD_LAUNCHES[key] += 3
            roi_align_kernel.LAUNCHES[("float32", 7, 256)] += 1
    finally:
        attention.reset_launch_count()
        roi_align_kernel.reset_launch_count()
    assert set(stages) == {"train"}
    assert (stages["train"]["k1"], stages["train"]["k2"],
            stages["train"]["k3"]) == (2, 3, 1)
    assert stages["train"]["seconds"] >= 0
    assert "[proof] train:" in capsys.readouterr().out


def test_proof_refuses_ocr_with_fast_nms(tmp_path, capsys):
    """--ocr and --fast-nms change different stages: the proof refuses to
    run both at once, as the JAX tool does, before any work."""
    from crct_tpu_torch.tools.full_pipeline_proof import main
    with pytest.raises(SystemExit):
        main(["--ocr", "--fast-nms", "--device", "cpu", "--root",
              str(tmp_path)])
    assert "--ocr and --fast-nms" in capsys.readouterr().err
    assert not any(tmp_path.iterdir())
