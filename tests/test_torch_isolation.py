"""The port stands alone, and runs on the CPU only when asked.

crct_tpu_torch imports torch and numpy and nothing of JAX or of the JAX
package, and PIL only inside the functions that decode or draw (the machine
with the card has none); its entry points run on the card unless the caller
passes device="cpu", and with no card they raise instead of carrying on on
the CPU.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]


def test_every_module_imports_without_jax_or_the_jax_package():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import crct_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            crct_tpu_torch.__path__, "crct_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules
                     if k.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                            "orbax", "crct_tpu", "PIL"))
        assert not bad, bad
        assert "crct_tpu_torch.serve" in names, names
        print(len(names))
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20


def test_no_source_file_names_the_jax_package():
    pkg = REPO / "crct_tpu_torch"
    for path in pkg.rglob("*.py"):
        for line in path.read_text().splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")):
                root = stripped.split()[1].split(".")[0]
                assert root not in ("jax", "flax", "crct_tpu"), (path, line)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the CUDA default is valid here")


def test_entry_points_raise_without_a_card(no_card, tmp_path):
    from crct_tpu_torch.config import default_params
    from crct_tpu_torch.models.crct import build_model
    from crct_tpu_torch.serve import QAScorer, make_server
    from crct_tpu_torch.utils.device import resolve_device

    params = default_params()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no card"):
        build_model(params)
    with pytest.raises(RuntimeError, match="no card"):
        QAScorer(params, dataset=None)
    with pytest.raises(RuntimeError, match="no card"):
        make_server(params, port=0)
    assert resolve_device("cpu") == torch.device("cpu")


def test_cli_defaults_to_the_card(no_card):
    from crct_tpu_torch.cli.serve import main
    with pytest.raises(RuntimeError, match="no card"):
        main(["-qa_file", "qa_pairs.npy", "-save_name", "x"])



def test_train_entry_points_default_to_the_card(no_card, tmp_path):
    from crct_tpu_torch.cli.train import main
    from crct_tpu_torch.config import default_params
    from crct_tpu_torch.train.train_loop import Trainer
    with pytest.raises(RuntimeError, match="no card"):
        main(["-qa_file", "qa_pairs.npy", "-save_name", "x", "-no_eval"])
    with pytest.raises(RuntimeError, match="no card"):
        Trainer(default_params(save_path=str(tmp_path)), None, 1)


def test_detector_entry_points_default_to_the_card(no_card):
    from crct_tpu_torch.cli.detector_train import main
    from crct_tpu_torch.detector.trainer import DetectorTrainer
    with pytest.raises(RuntimeError, match="no card"):
        main(["--annotations", "train.json", "--image-dir", "png"])
    with pytest.raises(RuntimeError, match="no card"):
        DetectorTrainer(num_classes=3, depth=14)
