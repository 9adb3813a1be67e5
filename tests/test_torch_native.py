"""The port's native C++ tokenizer against the JAX package's and the Python
tokenizer, on the CPU.

The same vocab file (written from the synthetic vocab) loads into the
port's NativeWordPieceTokenizer, the JAX package's and the port's
pure-Python WordPieceTokenizer; the ids must be equal on the corpus, the
fuzz and the unicode cases of tests/test_native.py. The port builds its
library under build/native/, never into native/, and load_tokenizer
returns it for a vocab file.
"""

import random

import numpy as np
import pytest

from crct_tpu.data import native as jax_native
from crct_tpu.data.native import NativeWordPieceTokenizer as JaxNative
from crct_tpu.data.native import write_vocab_file as jax_write_vocab_file
from crct_tpu_torch.data import native
from crct_tpu_torch.data.tokenizer import WordPieceTokenizer, load_tokenizer
from tests.test_native import CORPUS



@pytest.fixture(scope="module")
def toks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_vocab")
    py_tok = WordPieceTokenizer.synthetic()
    vocab_path = native.write_vocab_file(py_tok.vocab,
                                         str(tmp / "vocab.txt"))
    jax_path = jax_write_vocab_file(py_tok.vocab, str(tmp / "jax_vocab.txt"))
    with open(vocab_path, "rb") as a, open(jax_path, "rb") as b:
        assert a.read() == b.read()
    # the JAX library is built into this test's own directory: a build
    # into native/ could race tests/test_native.py's in another worker
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB", str(tmp / "libwordpiece.so"))
        jax_tok = JaxNative(vocab_path)
    return py_tok, load_tokenizer(vocab_path), jax_tok


def test_load_tokenizer_builds_under_build_not_native(toks, tmp_path):
    py_tok, nat, _ = toks
    assert isinstance(nat, native.NativeWordPieceTokenizer)
    lib = native.build_library()
    assert lib.parent == native.BUILD_DIR
    assert lib.parts[-3:-1] == ("build", "native")
    assert lib.name == f"libwordpiece-{native.source_digest(native.SRC)}.so"
    assert lib.exists()
    # the Python tokenizer serves a vocab file only when asked to
    path = native.write_vocab_file(py_tok.vocab, str(tmp_path / "v.txt"))
    assert isinstance(load_tokenizer(path, prefer_native=False),
                      WordPieceTokenizer)
    assert isinstance(load_tokenizer(""), WordPieceTokenizer)


def test_missing_vocab_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_tokenizer(str(tmp_path / "absent.txt"))


def test_failed_build_raises(monkeypatch, tmp_path):
    """No silent fallback: a source that does not compile raises."""
    bad = tmp_path / "wordpiece.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build_library()
    assert not list((tmp_path / "build").glob("*.so"))


@pytest.mark.parametrize("case", ["corpus", "charts", "fuzz", "unicode",
                                  "unicode_fuzz"])
def test_ids_equal_jax_native_and_python(toks, case, tmp_path):
    py_tok, nat, jax_nat = toks
    if case == "corpus":
        texts = CORPUS
    elif case == "charts":
        from crct_tpu_torch.detector.synthetic_charts import \
            generate_png_dataset
        env = generate_png_dataset(str(tmp_path), n_images=3, seed=1)
        texts = [q["question_string"] for q in
                 np.load(env["qa_file"], allow_pickle=True)]
        with open(env["annotations"]) as f:
            texts += [str(a) for a in f.read().split('"')]
    elif case == "fuzz":
        rng = np.random.default_rng(0)
        chars = list("abcdefghijklmnopqrstuvwxyz0123456789 .,!?-_%()")
        texts = ["".join(rng.choice(chars, size=int(rng.integers(0, 60))))
                 for _ in range(200)]
    elif case == "unicode":
        cps = (list(range(0x20, 0x180)) + list(range(0x2000, 0x2070))
               + [0x3000, 0xFF01, 0xFF1A])
        texts = [t for cp in cps for t in (f"a{chr(cp)}b", f"{chr(cp)}x",
                                           f"12{chr(cp)}34", chr(cp) * 2)]
    else:
        rng = random.Random(1)
        alphabet = ([chr(c) for c in range(0xA0, 0x180)]
                    + [chr(c) for c in range(0x2000, 0x2070)]
                    + list("abcdefghij0123456789 .,-%$"))
        texts = ["".join(rng.choice(alphabet)
                         for _ in range(rng.randint(1, 30)))
                 for _ in range(500)]
    for text in texts:
        want = py_tok.encode(text)
        assert nat.encode(text) == want, repr(text)
        assert jax_nat.encode(text) == want, repr(text)


def test_special_ids_and_crlf_vocab(toks, tmp_path):
    py_tok, nat, _ = toks
    assert (nat.cls_id, nat.sep_id, nat.mask_id, nat.pad_id, nat.unk_id) \
        == (py_tok.cls_id, py_tok.sep_id, py_tok.mask_id, py_tok.pad_id,
            py_tok.unk_id)
    lf = native.write_vocab_file(py_tok.vocab, str(tmp_path / "v.txt"))
    crlf = tmp_path / "v_crlf.txt"
    with open(lf, "rb") as f:
        crlf.write_bytes(f.read().replace(b"\n", b"\r\n"))
    nat2 = native.NativeWordPieceTokenizer(str(crlf))
    text = "hello world 42.5"
    assert nat2.encode(text) == JaxNative(str(crlf)).encode(text) \
        == py_tok.encode(text)
    assert nat2.cls_id == py_tok.cls_id
    nat2.close()
    nat2.close()                      # closing twice is harmless


def test_dataset_uses_the_native_tokenizer(toks, tmp_path):
    """ChartQADataset given -vocab_file tokenizes through the native
    library, and its examples equal those of the Python tokenizer."""
    from crct_tpu_torch.config import default_params
    from crct_tpu_torch.data.dataset import ChartQADataset
    from crct_tpu_torch.data.synthetic import generate_dataset

    py_tok, _, _ = toks
    vocab = native.write_vocab_file(py_tok.vocab, str(tmp_path / "v.txt"))
    cfg = generate_dataset(str(tmp_path / "data"), n_images=4, division=4,
                           n_questions=2, feat_dim=16, splits=("test",))
    params = default_params(
        figure_feat_path=cfg["figure_feat_path"],
        qa_parent_dir=cfg["qa_parent_dir"],
        dataset_config={"dataset_files_divisions":
                        cfg["dataset_files_divisions"]},
        eval_set="test", vocab_file=vocab)
    ds = ChartQADataset(params, "test", init_split="test")
    ref = ChartQADataset(params, "test", init_split="test",
                         tokenizer=py_tok)
    assert isinstance(ds.tokenizer, native.NativeWordPieceTokenizer)
    for i in range(len(ds)):
        a, b = ds[i], ref[i]
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)
