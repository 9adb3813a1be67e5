"""The port stands alone, and runs on the CPU only when asked.

crct_tpu_torch imports torch and numpy and nothing of JAX or of the JAX
package, and PIL, pandas, matplotlib, tensorboard, scipy, tensorstore,
tensorflow and transformers only inside the functions that need them (the
machine with the card has no tensorstore); its entry points run on the
card unless the caller passes device="cpu", and with no card they raise
instead of carrying on on the CPU.
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
                                            "orbax", "crct_tpu", "PIL",
                                            "pandas", "matplotlib",
                                            "tensorboard", "scipy",
                                            "tensorstore", "tensorflow",
                                            "transformers"))
        assert not bad, bad
        assert "crct_tpu_torch.serve" in names, names
        assert "crct_tpu_torch.parallel.mesh" in names, names
        for name in ("cli.convert_checkpoint", "cli.import_bert",
                     "tools.full_pipeline_proof", "bench",
                     "tools.serve_bench", "tools.eval_overhead_profile",
                     "tools.eval_chunk_sweep", "tools.attention_shape_bench",
                     "tools.detector_step_decomp",
                     "tools.roi_backward_compare",
                     "tools.opt_variant_bench",
                     "tools.shortlist_miss_rate", "utils.profiling"):
            assert "crct_tpu_torch." + name in names, names
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


def test_data_parallelism_defaults_to_the_card(no_card, monkeypatch):
    """-ddp on the default device raises without a card, before any process
    group forms, rather than training on the CPU over gloo."""
    from crct_tpu_torch.cli.train import main
    from crct_tpu_torch.parallel import maybe_initialize_distributed
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="no card"):
        maybe_initialize_distributed({"ddp": True})
    with pytest.raises(RuntimeError, match="no card"):
        main(["-qa_file", "qa_pairs.npy", "-save_name", "x", "-no_eval",
              "-ddp"])
    import torch.distributed as dist
    assert not dist.is_initialized()


def test_ddp_without_a_rendezvous_refuses_several_cards(monkeypatch):
    """-ddp in one process on a machine with several cards raises and names
    the torchrun launch, where the JAX -ddp would span every local chip;
    with one card it is the world of one."""
    from crct_tpu_torch.parallel import mesh
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
              "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(mesh, "resolve_device", lambda d: torch.device(d))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 4"):
        mesh.maybe_initialize_distributed({"ddp": True})
    assert not mesh.maybe_initialize_distributed({"ddp": False})
    assert not mesh.maybe_initialize_distributed({"ddp": True,
                                                  "device": "cpu"})
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert not mesh.maybe_initialize_distributed({"ddp": True})
    assert not mesh.is_initialized()


def test_detector_entry_points_default_to_the_card(no_card):
    from crct_tpu_torch.cli.detector_train import main
    from crct_tpu_torch.detector.trainer import DetectorTrainer
    with pytest.raises(RuntimeError, match="no card"):
        main(["--annotations", "train.json", "--image-dir", "png"])
    with pytest.raises(RuntimeError, match="no card"):
        DetectorTrainer(num_classes=3, depth=14)


def test_eval_entry_points_default_to_the_card(no_card):
    from crct_tpu_torch.cli.evaluate import main as evaluate
    from crct_tpu_torch.cli.train_fast_scorer import main as train_fast
    for main in (evaluate, train_fast):
        with pytest.raises(RuntimeError, match="no card"):
            main(["-qa_file", "qa_pairs.npy", "-save_name", "x"])


def test_ingest_entry_points_default_to_the_card(no_card):
    from crct_tpu_torch.cli.extract_features import main as extract
    from crct_tpu_torch.detector.extract import detector_from_weights
    from crct_tpu_torch.ingest import FigureIngestor
    with pytest.raises(RuntimeError, match="no card"):
        extract(["--load-weights", "none", "--output", "out",
                 "--batch-size", "2"])
    with pytest.raises(RuntimeError, match="no card"):
        detector_from_weights("none", dataset="plotqa", num_classes=4,
                              canvas=(32, 32), depth=14)
    with pytest.raises(RuntimeError, match="no card"):
        FigureIngestor.from_weights("none", num_classes=4, canvas=(32, 32))


def test_weight_tools_and_the_proof_default_to_the_card(no_card, tmp_path):
    """The proof raises before it draws a chart; the checkpoint readers and
    the weight tools run no model, and take no device."""
    from crct_tpu_torch.tools.full_pipeline_proof import main
    with pytest.raises(RuntimeError, match="no card"):
        main(["--fast", "--root", str(tmp_path)])
    assert not any(tmp_path.iterdir())
