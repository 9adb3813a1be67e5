"""Inputs and weights of a run, made from ``--seed``.

The same seed gives the same weights, the same batches and the same
questions. Every seed gives the same multiset of sizes (caption, question
and answer lengths, regions, candidates a question), drawn in another
order, so that the work of a run does not depend on its seed.

Rows follow the layout of the reference's data loader
(``fig_dataloader.py``): ``[CLS]`` chart texts with their boxes and element
types ``[SEP]`` question (type -1) ``[SEP]`` answer (type 1) ``[SEP]``, the
attention mask from ``sep_indices[hist_len]``, 44 (PlotQA) or 70 (FigureQA)
regions, the first the image token, padded regions masked out.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from perfbench import reference

CLS, SEP = 101, 102
EVAL_PAD = 120          # candidates a question is padded to
FIG_TYPES = ["vbar", "hbar", "line", "dot"]
QIDS = ["S1", "S7", "D7", "D14", "A1", "C2"]


def substream(seed: int, *tags: int) -> np.random.SeedSequence:
    return np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *tags])


def torch_seed(seed: int, tag: int) -> int:
    return int(substream(seed, tag).generate_state(1, np.uint64)[0]
               & (2 ** 63 - 1))


# --------------------------------------------------------------------------
# weights
# --------------------------------------------------------------------------

def make_weights(cfg: Dict[str, Any], seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """Every parameter of the configuration, fp32, on ``device``: the
    weights one truncated-normal draw (std 0.02, cut at two std) from a
    generator on the device, biases 0, LayerNorm scales 1."""
    spec = reference.param_spec(cfg)
    n = sum(int(np.prod(s)) for _, s, init in spec if init == "normal")
    g = torch.Generator(device)
    g.manual_seed(torch_seed(seed, 1))
    flat = torch.empty(n, device=device)
    torch.nn.init.trunc_normal_(flat, std=reference.INIT_STD,
                                a=-2 * reference.INIT_STD,
                                b=2 * reference.INIT_STD, generator=g)
    out, at = {}, 0
    for name, shape, init in spec:
        if init == "normal":
            size = int(np.prod(shape))
            out[name] = flat[at:at + size].view(shape)
            at += size
        elif init == "ones":
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# --------------------------------------------------------------------------
# rows
# --------------------------------------------------------------------------

def _lengths(L: int, binary: bool) -> Tuple[List[int], List[int], List[int]]:
    """The fixed multisets of caption, question and answer lengths that
    every seed draws its rows from (three tokens go to [CLS] and the
    [SEP]s, one more [SEP] with an answer)."""
    room = L - (3 if binary else 4)
    q = [6, 8, 10, 12, 14, 16]
    a = [0] if binary else [1, 1, 2, 2, 3, 4]
    cap = [int(room * f) - 20 for f in (0.55, 0.65, 0.75, 0.85, 0.95, 1.0)]
    if min(cap) <= 0:
        raise ValueError(f"rows of {L} tokens are too short for the mix")
    return cap, q, a


def _text(rng, L: int, cap: int, q: int, a: int, vocab: int):
    """One text row: tokens, segments, loc, sep_indices, hist_len."""
    tokens = np.zeros(L, np.int32)
    seg = np.zeros(L, np.int32)
    loc = np.zeros((L, 4), np.float32)
    sep = np.zeros(50, np.int32)
    tokens[0] = CLS
    at = 1
    tokens[at:at + cap] = rng.integers(1000, vocab, cap)
    seg[at:at + cap] = rng.integers(2, 12, cap)
    xy = rng.random((cap, 2)).astype(np.float32) * 0.9
    loc[at:at + cap] = np.concatenate([xy, xy + 0.05], 1)
    at += cap
    parts = [(q, -1)] + ([(a, 1)] if a else [])
    tokens[at] = SEP
    sep[0] = at
    at += 1
    for i, (n, t) in enumerate(parts):
        tokens[at:at + n] = rng.integers(1000, vocab, n)
        seg[at:at + n] = t
        at += n
        tokens[at] = SEP
        sep[i + 1] = at
        at += 1
    return tokens, seg, loc, sep, np.asarray([len(parts)], np.int32)


def _visual(rng, R: int, feat: int, cats: int, figure_qa: bool,
            n_valid: int):
    mask = np.zeros(R, np.float32)
    mask[:n_valid] = 1
    out = {
        "image_feat": np.zeros((R, feat), np.float32),
        "image_loc": np.zeros((R, 4), np.float32),
        "image_mask": mask,
        "image_target": np.zeros(R, np.int32),
    }
    out["image_feat"][:n_valid] = rng.random((n_valid, feat), np.float32)
    xy = rng.random((n_valid, 2)).astype(np.float32) * 0.8
    out["image_loc"][:n_valid] = np.concatenate(
        [xy, xy + rng.random((n_valid, 2)).astype(np.float32) * 0.2], 1)
    out["image_loc"][0] = 0
    out["image_target"][:n_valid] = rng.integers(0, cats, n_valid)
    out["image_target"][0] = cats
    if figure_qa:
        area = np.zeros(R, np.float32)
        e = np.exp(rng.random(n_valid - 1))
        area[1:n_valid] = e / e.sum()
        out["area"] = area
    return out


def _regression(rng, needs: bool) -> np.ndarray:
    if not needs:
        return np.zeros(4, np.float32)
    y = float(rng.choice([1.0, 10.0, 100.0, 1000.0]))
    return np.asarray([float(rng.uniform(-0.2, 1.0)) * y, 1.0, 0.01, y],
                      np.float32)


def _shapes(cfg) -> Tuple[int, int, int, int, int, bool]:
    m, d = cfg["model"], cfg["dataset"]
    return (d["max_seq_len"], d["max_vis_features"], m["v_feature_size"],
            m["vocab_size"], d["categories"], d["binary_answers"])


def train_pool(cfg, seed: int, batches: int, batch: int
               ) -> List[Dict[str, np.ndarray]]:
    """``batches`` distinct training batches of ``batch`` rows: a third of
    the rows of a PlotQA batch are regression questions, each NSP label
    positive or negative with even odds, as the loader samples negatives."""
    L, R, F, vocab, cats, binary = _shapes(cfg)
    figure_qa = cfg["dataset"]["dataset"] == "figure_qa"
    rng = np.random.default_rng(substream(seed, 2))
    cap, q, a = _lengths(L, binary)
    n = batches * batch
    sizes = [(cap[i % len(cap)], q[(i // 6) % len(q)], a[(i // 36) % len(a)],
              R // 3 + (i * 7) % (R - R // 3 + 1)) for i in range(n)]
    order = rng.permutation(n)
    rows = []
    for j in order:
        c, qq, aa, nv = sizes[j]
        t, s, lo, sp, hl = _text(rng, L, c, qq, aa, vocab)
        row = dict(tokens=t, segments=s, loc=lo, sep_indices=sp,
                   hist_len=hl, **_visual(rng, R, F, cats, figure_qa, nv))
        row["R"] = _regression(rng, (not binary) and j % 3 == 0)
        row["next_sentence_labels"] = np.int32(rng.integers(2))
        rows.append(row)
    pool = []
    for b in range(batches):
        chunk = rows[b * batch:(b + 1) * batch]
        pool.append({k: np.stack([r[k] for r in chunk]) for k in chunk[0]})
    return pool


def fanout_distribution(candidates: Dict[str, Any]) -> Dict[int, float]:
    """The distribution of a question's candidate count: ``fixed`` plus a
    draw from each inclusive range of ``uniform``, every value of a range
    equally likely, the draws independent."""
    dist = {int(candidates["fixed"]): 1.0}
    for lo, hi in candidates.get("uniform", []):
        p = 1.0 / (hi - lo + 1)
        out: Dict[int, float] = {}
        for n, q in dist.items():
            for k in range(lo, hi + 1):
                out[n + k] = out.get(n + k, 0.0) + q * p
        dist = out
    return dict(sorted(dist.items()))


def fanouts(candidates: Dict[str, Any], n: int) -> List[int]:
    """The candidate counts of ``n`` questions: the distribution's
    quantiles at (i + 1/2) / n, so that ``n`` questions hold it as closely
    as ``n`` can."""
    dist = fanout_distribution(candidates)
    out = []
    for i in range(n):
        p, acc = (i + 0.5) / n, 0.0
        for k, q in dist.items():
            acc += q
            if acc >= p:
                break
        out.append(k)
    return out


class EvalQuestions:
    """The questions of an eval pool, as the loader batches that
    ``evaluate()`` reads and as the dataset object its prediction records
    and breakdown table ask (candidate strings, answer types)."""

    def __init__(self, cfg, seed: int, questions: int, per_batch: int,
                 candidates: Dict[str, Any]):
        L, R, F, vocab, cats, binary = _shapes(cfg)
        rng = np.random.default_rng(substream(seed, 3))
        # every loader batch holds the same candidate counts, so that every
        # batch and every seed carries the same rows
        per = fanouts(candidates, per_batch)
        if max(per) > EVAL_PAD:
            raise ValueError(f"{max(per)} candidates, padded to {EVAL_PAD}")
        num_ans = [per[i % per_batch] for i in range(questions)]
        cap, q, a = _lengths(L, binary)
        order = np.concatenate([
            b0 + rng.permutation(min(per_batch, questions - b0))
            for b0 in range(0, questions, per_batch)])
        self.batches: List[Dict[str, Any]] = []
        self.num_ans = np.zeros(questions, np.int64)
        self.ans_type = np.zeros(questions, np.int64)
        for b0 in range(0, questions, per_batch):
            items = []
            for i in range(b0, min(b0 + per_batch, questions)):
                j = int(order[i])
                n = num_ans[j]
                self.num_ans[i] = n
                cq = (cap[j % len(cap)], q[(j // 6) % len(q)])
                text = [_text(rng, L, *cq, a[(j + c) % len(a)] or 1, vocab)
                        for c in range(n)]
                # candidates share the chart and the question: only the
                # answer tokens differ
                for c in range(1, n):
                    tail = text[c][3][1]
                    text[c][0][:tail + 1] = text[0][0][:tail + 1]
                    text[c][1][:tail + 1] = text[0][1][:tail + 1]
                    text[c][2][:tail + 1] = text[0][2][:tail + 1]
                vis = _visual(rng, R, F, cats, False,
                              R // 3 + (j * 7) % (R - R // 3 + 1))
                needs = j % 3 == 0
                Rq = _regression(rng, needs)
                self.ans_type[i] = j % 3
                item = {"id": i, "gt_id": int(rng.integers(n)), "num_ans": n,
                        "needs_reg": needs, "R": Rq,
                        "tolerance_margin": Rq[2],
                        "gt": Rq[0], "reg_target": Rq[0] / (Rq[3] or 1.0),
                        "qa_type": FIG_TYPES[j % 4], "qid": QIDS[j % 6]}
                for k, col in zip(("tokens", "segments", "loc",
                                   "sep_indices", "hist_len"),
                                  zip(*text)):
                    arr = np.stack(col)
                    pad = np.zeros((EVAL_PAD - n,) + arr.shape[1:],
                                   arr.dtype)
                    item[k] = np.concatenate([arr, pad])
                item.update(vis)
                items.append(item)
            self.batches.append(self._collate(items))

    @staticmethod
    def _collate(items):
        out = {}
        for k in ("tokens", "segments", "loc", "sep_indices", "hist_len"):
            out[k] = np.stack([it[k] for it in items])
        for k in ("image_feat", "image_loc", "image_mask", "image_target",
                  "R"):
            # per-question arrays, the same over the candidates: a view
            v = np.stack([it[k] for it in items])[:, None]
            out[k] = np.broadcast_to(v, (v.shape[0], EVAL_PAD) + v.shape[2:])
        for k, dt in (("id", np.int64), ("gt_id", np.int64),
                      ("num_ans", np.int64)):
            out[k] = np.asarray([it[k] for it in items], dt)
        out["needs_reg"] = np.asarray([[it["needs_reg"]] for it in items])
        for k in ("tolerance_margin", "gt", "reg_target"):
            out[k] = np.asarray([[it[k]] for it in items], np.float32)
        out["qa_type"] = [it["qa_type"] for it in items]
        out["qid"] = [it["qid"] for it in items]
        return out

    # what evaluate() asks of its dataset
    def get_ans_type(self, qid: int) -> int:
        return int(self.ans_type[qid])

    def get_raw(self, qid: int) -> Dict[str, Any]:
        return {"image_index": int(qid), "question_string": "",
                "answer": None}

    def get_possible_answers(self, image_index: int) -> List[str]:
        return [f"c{c}" for c in range(int(self.num_ans[image_index]))]

    def rows(self, qid: int) -> Dict[str, np.ndarray]:
        """The candidate rows of question ``qid``, unpadded."""
        b, i = divmod(qid, len(self.batches[0]["id"]))
        batch, n = self.batches[b], int(self.num_ans[qid])
        out = {k: np.asarray(batch[k][i, :n])
               for k in ("tokens", "segments", "loc", "sep_indices",
                         "hist_len", "image_feat", "image_loc", "image_mask",
                         "image_target", "R")}
        out["hist_len"] = out["hist_len"].reshape(n, -1)[:, :1]
        return out
