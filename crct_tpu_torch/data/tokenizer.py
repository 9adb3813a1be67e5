"""Self-contained WordPiece tokenizer (bert-base-uncased compatible).

The PyTorch port's copy of ``crct_tpu/data/tokenizer.py``. The reference
uses ``pytorch_transformers.BertTokenizer`` and its hub-hosted
vocab (CRCT/fig_dataloader.py:7,67). This rebuild has zero network egress, so
tokenization is implemented from scratch: a BERT basic tokenizer (lowercase,
accent stripping, punctuation splitting, CJK spacing) plus greedy
longest-match WordPiece. Given the official ``vocab.txt`` it produces
identical ids to the reference tokenizer; for tests a deterministic synthetic
vocab is generated on the fly.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class BasicTokenizer:
    """BERT basic tokenizer: cleanup, lowercase, accents, punctuation."""

    def __init__(self, do_lower_case: bool = True):
        self.do_lower_case = do_lower_case

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._pad_cjk(text)
        tokens: List[str] = []
        for tok in text.split():
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            tokens.extend(self._split_punct(tok))
        return " ".join(tokens).split()

    @staticmethod
    def _clean(text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _pad_cjk(text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.append(" " + ch + " ")
            else:
                out.append(ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text: str) -> str:
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_punct(tok: str) -> List[str]:
        out: List[List[str]] = []
        start_new = True
        for ch in tok:
            if _is_punctuation(ch):
                out.append([ch])
                start_new = True
            else:
                if start_new:
                    out.append([])
                    start_new = False
                out[-1].append(ch)
        return ["".join(x) for x in out]


# Word list baked into the synthetic test vocab so fixture sequences stay
# realistically short (the real vocab has whole-word entries for these).
DEFAULT_TEST_WORDS = [
    "revenue", "exports", "imports", "population", "growth", "cost",
    "energy", "income", "rainfall", "apples", "bananas", "cars", "ships",
    "dogs", "cats", "students", "teachers", "books", "north", "south",
    "east", "west", "alpha", "beta", "gamma", "delta", "years", "value",
    "country", "region", "annual", "total", "average", "difference", "sum",
    "what", "is", "the", "of", "in", "across", "all", "how", "many", "does",
    "exceed", "legend", "labels", "label", "title", "axis", "are", "there",
    "rising", "yes", "no", "vertical", "horizontal", "center", "right",
    "bottom", "left", "top",
]


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a vocab.

    ``encode(text)`` returns plain wordpiece ids without special tokens, the
    behavior the reference relies on via ``tokenizer.encode`` of the
    pytorch_transformers era.
    """

    UNK = "[UNK]"

    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.basic = BasicTokenizer(do_lower_case)
        self.max_chars_per_word = max_chars_per_word
        self.cls_id = vocab.get("[CLS]", 101)
        self.sep_id = vocab.get("[SEP]", 102)
        self.mask_id = vocab.get("[MASK]", 103)
        self.pad_id = vocab.get("[PAD]", 0)
        self.unk_id = vocab.get(self.UNK, 100)

    # ---- construction -------------------------------------------------
    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, "r", encoding="utf-8") as f:
            for i, line in enumerate(f):
                token = line.rstrip("\n").rstrip("\r")  # CRLF vocab files
                if token:
                    vocab[token] = i
        return cls(vocab, **kw)

    @classmethod
    def synthetic(cls, words: Optional[Iterable[str]] = None,
                  vocab_size: int = 30522) -> "WordPieceTokenizer":
        """A deterministic test vocab with the standard special-token layout.

        Ids follow bert-base-uncased conventions ([PAD]=0, [UNK]=100,
        [CLS]=101, [SEP]=102, [MASK]=103); single characters fill the low
        range so every string tokenizes without [UNK].
        """
        vocab: Dict[str, int] = {"[PAD]": 0}
        for i in range(1, 100):
            vocab[f"[unused{i}]"] = i
        vocab["[UNK]"] = 100
        vocab["[CLS]"] = 101
        vocab["[SEP]"] = 102
        vocab["[MASK]"] = 103
        nxt = 104
        chars = [chr(c) for c in range(ord("a"), ord("z") + 1)]
        chars += [str(d) for d in range(10)]
        chars += list(".,:;!?%()-_=+/<>$&'\"")
        for ch in chars:
            if ch not in vocab:
                vocab[ch] = nxt
                nxt += 1
        for ch in chars:
            piece = "##" + ch
            if piece not in vocab:
                vocab[piece] = nxt
                nxt += 1
        if words is None:
            words = DEFAULT_TEST_WORDS
        else:
            words = list(words) + DEFAULT_TEST_WORDS
        for w in words:
            for piece in (w, w.lower()):
                if piece not in vocab and nxt < vocab_size:
                    vocab[piece] = nxt
                    nxt += 1
        return cls(vocab)

    # ---- tokenization --------------------------------------------------
    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars_per_word:
            return [self.UNK]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.UNK]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in self.basic.tokenize(text):
            out.extend(self.wordpiece(word))
        return out

    def encode(self, text: str) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in self.tokenize(str(text))]


def load_tokenizer(vocab_file: str = ""):
    """Load the real vocab when provided, else the synthetic test vocab.

    The port keeps the pure-Python tokenizer only; the JAX package's ctypes
    C++ tokenizer (same ids) is not ported yet."""
    if vocab_file:
        return WordPieceTokenizer.from_vocab_file(vocab_file)
    return WordPieceTokenizer.synthetic()
