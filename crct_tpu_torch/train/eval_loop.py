"""Full-candidate ranking evaluation (reference CRCT/evaluation.py).

The port of ``crct_tpu/train/eval_loop.py``, one card a process (under a
process group each rank scores its shard of the questions and the
accumulators are summed over the ranks at the end). Each question fans
out to all its candidate answers (padded to EVAL_PADDED_SIZE with a validity
mask); the valid candidate rows are packed host-side into fixed-size chunks,
scored by the model, and a per-question argmax over the candidates' NSP
probabilities picks the answer. A question is correct when the
classification is right AND (it needs no regression OR the regression is
within 5% / the tick tolerance) (evaluation.py:287-312).

``evaluate()`` has four branches, as in the JAX package: the full protocol
(pipelined one loader batch deep: batch k+1's rows go to the card before
batch k's outputs come back), binary FigureQA (one row per question), the
fast scorer (one answer-masked backbone pass per question and a light
candidate head) and top-k (the fast head shortlists K candidates and the
full model rescores them). Every branch runs the model's forward, so on the
card every attention goes through the kernel K1.

Accumulators mirror the reference reducers: the 6x2 total-accuracy tensor
(evaluation.py:494-525), the 5x4x3x3 fig-type x answer-type x
question-category breakdown (evaluation.py:465-491) and the 13-bin
regression-error histogram (evaluation.py:528-548). Evaluation is resumable
through a CSV of completed question ids and accumulator snapshots
(evaluation.py:69-126). The table printers format pandas' text with plain
Python: the card's machine has no pandas.
"""

from __future__ import annotations

import glob
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from crct_tpu_torch import parallel
from crct_tpu_torch.models.crct import CRCTModel
from crct_tpu_torch.utils import tracing

# question-category membership by qid prefix lists (evaluation.py:434-445)
STRUCTURAL_QID = ['S7', 'S17', 'S6', 'S1', 'S4', 'S3', 'S5', 'S2', 'S0', 'S8',
                  'S9', 'S15', 'S10', 'S13', 'S14', 'S16', 'S11', 'S12']
DATA_RETRIEVAL_QID = ['D15', 'D9', 'D12', 'D8', 'D7', 'D10', 'D11', 'D14',
                      'D5', 'D2', 'D13', 'D3', 'D0', 'D4', 'D1']
FIG_TABLE_IDS = {'Total': 0, 'line': 1, 'vbar': 2, 'hbar': 3, 'dot': 4}


def get_qcat_by_qid(qid: str) -> Tuple[str, int]:
    if qid in STRUCTURAL_QID:
        return 's', 0
    if qid in DATA_RETRIEVAL_QID:
        return 'd', 1
    return 'r', 2


ROW_KEYS = ["tokens", "segments", "loc", "sep_indices", "hist_len",
            "image_feat", "image_loc", "image_mask", "image_target", "R",
            "area"]

# Per-QUESTION constants across the candidate fan-out: the builder
# broadcasts these over the P candidate rows. The dedup path ships them to
# the card once per question and gathers them per row there; image_feat
# alone is [44, 1024] fp32 per question, ~98% of the bytes of a row.
EVAL_VIS_KEYS = ["image_feat", "image_loc", "image_mask", "image_target",
                 "R"]
EVAL_TEXT_KEYS = [k for k in ROW_KEYS if k not in EVAL_VIS_KEYS]

# Rows per card per eval dispatch: the JAX package's chunk (240 rows per
# chip), one card.
EVAL_AUTO_ROWS_PER_CARD = 240

FAST_CAND_TOKENS = 8        # max WordPiece tokens per candidate answer


def to_device(rows: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy arrays (or tensors) -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in rows.items()}


def _gather_vis(rows, vis, row_qidx, device):
    """The per-question visual arrays (on the card) gathered per row."""
    idx = torch.as_tensor(row_qidx).to(device, torch.long)
    for k, v in vis.items():
        rows[k] = v.index_select(0, idx)
    return rows


def _scores(model: CRCTModel, rows: Dict[str, torch.Tensor]):
    out = model(rows)
    nsp_probs = torch.softmax(out.nsp_logits, dim=-1)[:, 0]
    return nsp_probs, out.reg_output, out.reg_5_dist, out.reg_l1


def _fast_scores(model: CRCTModel, rows: Dict[str, torch.Tensor]):
    out = model(rows)
    return out.cand_logits, out.reg_output, out.reg_5_dist, out.reg_l1


def make_eval_step(model: CRCTModel):
    """Scorer over a chunk of candidate rows: (nsp_prob_pos, reg_output,
    reg_5_dist, reg_l1) per row on the model's device, the quantities the
    reference collects per sub-batch (evaluation.py:243-262)."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def eval_step(rows):
        return _scores(model, to_device(rows, device))

    return eval_step


def make_eval_step_dedup(model: CRCTModel):
    """`make_eval_step` over transfer-deduplicated inputs: per-row text
    arrays, per-QUESTION visual arrays already on the card, and a
    row->question index; the visual rows are gathered on the card. Outputs
    equal `make_eval_step` on the expanded rows."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def eval_step(text_rows, vis: Dict[str, torch.Tensor], row_qidx):
        return _scores(model, _gather_vis(to_device(text_rows, device), vis,
                                          row_qidx, device))

    return eval_step


def make_fast_eval_step(model: CRCTModel):
    """Fast-scorer step over per-QUESTION rows: one backbone pass per
    question (answer tokens masked from attention) + the light candidate
    head. Returns (cand_logits[B, C], reg_output, reg_5_dist, reg_l1) on the
    model's device."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def eval_step(rows):
        return _fast_scores(model, to_device(rows, device))

    return eval_step


def make_fast_eval_step_dedup(model: CRCTModel):
    """`make_fast_eval_step` over transfer-deduplicated inputs: per-question
    text rows plus the SAME per-question visual arrays the rescore stage
    uses, joined on the card with one gather, so top-k ships image_feat once
    per loader batch."""
    device = next(model.parameters()).device

    @torch.inference_mode()
    def eval_step(text_rows, vis: Dict[str, torch.Tensor], row_qidx):
        return _fast_scores(model, _gather_vis(to_device(text_rows, device),
                                               vis, row_qidx, device))

    return eval_step


def build_fast_rows(batch: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Eval batch [B, P, ...] -> per-question rows for the fast scorer.

    Row = candidate row 0 with answer tokens masked out of the attention
    (the caption+question prefix is identical across a question's candidate
    rows); cand_tokens[B, P, A] = each candidate's answer tokens (segment
    type 1), cand_valid from num_ans."""
    tokens = np.asarray(batch["tokens"])          # [B, P, L]
    segments = np.asarray(batch["segments"])
    B, P, L = tokens.shape
    num_ans = np.asarray(batch["num_ans"]).reshape(-1)

    rows: Dict[str, np.ndarray] = {}
    for k in ROW_KEYS:
        if k in batch:
            rows[k] = np.asarray(batch[k])[:, 0]
    if rows["hist_len"].ndim > 1:
        rows["hist_len"] = rows["hist_len"].reshape(B, -1)[:, :1]

    # attention cut at the first answer token of row 0
    seq_len = np.take_along_axis(
        rows["sep_indices"], rows["hist_len"].reshape(B, 1), axis=1)[:, 0] + 1
    is_ans0 = segments[:, 0] == 1
    ans_start = np.where(is_ans0.any(-1), is_ans0.argmax(-1), seq_len)
    rows["attention_mask"] = (
        np.arange(L)[None, :] < np.minimum(seq_len, ans_start)[:, None]
    ).astype(np.float32)

    # candidate answer tokens: stable-sort the answer positions first
    is_ans = segments == 1                          # [B, P, L]
    order = np.argsort(~is_ans, axis=-1, kind="stable")[..., :FAST_CAND_TOKENS]
    cand = np.take_along_axis(tokens, order, axis=-1)
    n_ans_tok = is_ans.sum(-1, keepdims=True)       # [B, P, 1]
    cand = np.where(np.arange(FAST_CAND_TOKENS)[None, None, :] < n_ans_tok,
                    cand, 0)
    rows["cand_tokens"] = cand.astype(np.int64)
    rows["cand_valid"] = (np.arange(P)[None, :]
                          < num_ans[:, None]).astype(np.float32)
    return rows


def _flatten_valid_rows(batch: Dict[str, Any], keys=ROW_KEYS
                        ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """[B, P, ...] -> [N_valid, ...] keeping per-question row offsets.
    ``keys`` restricts the flattened keys (the dedup path flattens text
    keys only)."""
    num_ans = np.asarray(batch["num_ans"]).reshape(-1)
    B = num_ans.shape[0]
    pad = np.asarray(batch["tokens"]).shape[1]
    # a num_ans above the candidate pad would index into the NEXT
    # question's rows (the builder clamps too)
    num_ans = np.minimum(num_ans, pad)
    flat_idx = np.concatenate([np.arange(n) + q * pad
                               for q, n in enumerate(num_ans)])
    rows = {}
    for k in keys:
        if k not in batch:
            continue
        v = np.asarray(batch[k])
        rows[k] = v.reshape((B * pad,) + v.shape[2:])[flat_idx]
    # hist_len arrives [B,120,1] after padding; the model wants [N] or [N,1]
    if rows["hist_len"].ndim > 1:
        hl = rows["hist_len"]
        rows["hist_len"] = (hl.reshape(len(flat_idx), -1)[:, :1]
                            if len(flat_idx) else hl.reshape(0, 1))
    offsets = np.concatenate([[0], np.cumsum(num_ans)])
    return rows, offsets


def resolve_eval_chunk(params: Dict[str, Any]) -> int:
    """Rows per eval dispatch: an explicit ``-eval_batch_size`` wins, else
    ``EVAL_AUTO_ROWS_PER_CARD`` on the one card."""
    ebs = params.get("eval_batch_size")
    if ebs:
        return max(1, int(ebs))
    return EVAL_AUTO_ROWS_PER_CARD


def resolve_eval_question_batch(params: Dict[str, Any]) -> int:
    """Questions per dataloader batch feeding the row chunker. An explicit
    ``-eval_batch_size`` keeps the reference's one-number semantics (it
    sized both the loader batch and the model chunk); in auto mode, pull
    enough questions that each loader batch fills several row chunks
    (typical questions carry ~20-40 valid candidate rows). Capped at 128: a
    padded eval question is ~22 MB on the host (image_feat [120, 44, 1024]
    fp32)."""
    ebs = params.get("eval_batch_size")
    if ebs:
        return max(1, int(ebs))
    return max(8, min(resolve_eval_chunk(params) // 12, 128))


def shortlist_rescore_rows(batch: Dict[str, Any], top_idx: np.ndarray,
                           keys=ROW_KEYS) -> Dict[str, np.ndarray]:
    """Gather the per-candidate padded batch [B, P, ...] down to the
    shortlisted [B*K, ...] rows for full-model rescoring
    (-fast_scorer_topk). ``top_idx`` [B, K] holds candidate indices.
    ``keys`` restricts the gathered keys (the dedup path gathers text
    keys only)."""
    B, K = top_idx.shape
    rows: Dict[str, np.ndarray] = {}
    for k in keys:
        if k not in batch:
            continue
        v = np.asarray(batch[k])
        idx = top_idx.reshape((B, K) + (1,) * (v.ndim - 2))
        g = np.take_along_axis(v, idx, axis=1)
        rows[k] = g.reshape((B * K,) + v.shape[2:])
    if rows["hist_len"].ndim > 1:
        rows["hist_len"] = rows["hist_len"].reshape(B * K, -1)[:, :1]
    return rows


def _chunk_rows(rows: Dict[str, np.ndarray], chunk: int):
    """Fixed-size pieces of ``rows`` (the last zero-padded) and the number of
    valid rows in each."""
    n = len(next(iter(rows.values())))
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        pad = chunk - (e - s)
        out = {}
        for k, v in rows.items():
            piece = v[s:e]
            if pad:
                piece = np.concatenate(
                    [piece, np.zeros((pad,) + piece.shape[1:], piece.dtype)])
            out[k] = piece
        yield out, e - s


def segmented_argmax(values: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """argmax within each [offsets[q], offsets[q+1]) segment, relative to the
    segment start; ties break to the first maximum like np.argmax. Empty
    segments return 0. reduceat runs over the non-empty segments' starts
    only, which are strictly increasing and tile the row range."""
    starts = np.asarray(offsets[:-1], np.int64)
    lens = np.diff(offsets).astype(np.int64)
    nseg = len(starts)
    out = np.zeros(nseg, np.int64)
    nonempty = lens > 0
    n = len(values)
    if n == 0 or not nonempty.any():
        return out
    ne_starts = starts[nonempty]
    seg_max = np.maximum.reduceat(values, ne_starts)
    # map each row to its (non-empty) segment's max, find the first match
    seg_of_row = np.repeat(np.arange(nseg), lens)
    ne_index_of_seg = np.cumsum(nonempty) - 1
    row_max = seg_max[ne_index_of_seg[seg_of_row]]
    row_ids = np.where(values == row_max, np.arange(n), n)
    first = np.minimum.reduceat(row_ids, ne_starts)
    out[nonempty] = first - ne_starts
    return out


# ---------------------------------------------------------------------------
# accumulator reducers (host-side numpy)
# ---------------------------------------------------------------------------

def reduce_total_acc(total: np.ndarray, needs_reg, nsp_right, reg_right,
                     reg_t_right) -> np.ndarray:
    t = np.zeros_like(total)
    t[0] = [np.sum(nsp_right), nsp_right.shape[0]]
    t[1] = [np.sum(nsp_right & needs_reg), np.sum(needs_reg)]
    t[2] = [np.sum(reg_right), np.sum(needs_reg)]
    t[3] = [np.sum(reg_t_right), np.sum(needs_reg)]
    correct = nsp_right & (~needs_reg | reg_right)
    t[4] = [np.sum(correct), nsp_right.shape[0]]
    correct_t = nsp_right & (~needs_reg | reg_t_right)
    t[5] = [np.sum(correct_t), nsp_right.shape[0]]
    total += t
    return total


def reduce_breakdown(breakdown: np.ndarray, dataset, batch, correct,
                     t_correct, needs_reg) -> np.ndarray:
    """Breakdown accumulation (reference reduce_breakdown_table,
    evaluation.py:465-491) as a scatter-add over (fig, ans_type, qcat)
    index triples; only the string->int lookups stay per question."""
    ids = np.asarray(batch["id"]).reshape(-1)
    n = len(ids)
    fig = np.fromiter((FIG_TABLE_IDS[batch["qa_type"][i]] for i in range(n)),
                      np.int64, n)
    qcat = np.fromiter((get_qcat_by_qid(batch["qid"][i])[1] for i in range(n)),
                       np.int64, n)
    ans = np.fromiter((dataset.get_ans_type(int(i)) for i in ids),
                      np.int64, n)
    c = np.asarray(correct, breakdown.dtype)
    t = np.asarray(t_correct, breakdown.dtype)
    one = np.ones(n, breakdown.dtype)
    nr = np.asarray(needs_reg, bool)

    def scatter(sel, fig_idx, ans_idx):
        np.add.at(breakdown, (fig_idx, ans_idx, qcat[sel], 0), c[sel])
        np.add.at(breakdown, (fig_idx, ans_idx, qcat[sel], 1), t[sel])
        np.add.at(breakdown, (fig_idx, ans_idx, qcat[sel], -1), one[sel])

    # every question counts toward the 'Total' table (fig row 0) and, when
    # different, its own fig-type row ({0, fig_id} set semantics)
    every = np.ones(n, bool)
    nz = fig != 0
    reg_row = breakdown.shape[1] - 1
    scatter(every, np.zeros(n, np.int64), ans)
    scatter(nz, fig[nz], ans[nz])
    # regression rows (ans_type -1)
    scatter(nr, np.zeros(int(nr.sum()), np.int64),
            np.full(int(nr.sum()), reg_row, np.int64))
    both = nz & nr
    scatter(both, fig[both], np.full(int(both.sum()), reg_row, np.int64))
    return breakdown


def reduce_histogram(histogram: np.ndarray, reg_5_dist: np.ndarray) -> np.ndarray:
    """13 bins: 0-5..15-20 (by 5%), 20-30..90-100 (by 10%), 100+."""
    add = np.zeros_like(histogram)
    bar = 0
    for i in range(4):
        add[bar] = np.sum((i / 20 < reg_5_dist) & (reg_5_dist <= (i + 1) / 20))
        bar += 1
    for i in range(2, 10):
        add[bar] = np.sum((i / 10 < reg_5_dist) & (reg_5_dist <= (i + 1) / 10))
        bar += 1
    add[bar] = np.sum(reg_5_dist > 1)
    histogram += add
    return histogram


# ---------------------------------------------------------------------------
# resumable CSV log (reference Evaluation_Log, utils.py:252-281)
# ---------------------------------------------------------------------------

class EvaluationLog:
    """One CSV of per-question results and one snapshot set of the
    accumulators per process; the file names carry the rank (of the process
    group, unless given) as the JAX package's do."""

    COLUMNS = ["qa_ind", "gt_cls", "pred_cls", "gt_reg", "pred_reg",
               "reg_target", "reg_%_error", "reg_t_error"]

    def __init__(self, params: Dict[str, Any], cont_eval: bool,
                 rank: Optional[int] = None):
        os.makedirs(params["save_path"], exist_ok=True)
        ckpt = os.path.basename(str(params.get("start_checkpoint", "ck")))
        base = f"{params['save_path']}/eval_results_{params['eval_set']}_{ckpt}"
        if rank is None:
            rank = parallel.rank()
        self.rank = rank
        self.fp = f"{base}_{rank}.csv"
        self.snapshot_paths = {k: f"{base}_{k}_{rank}.npy"
                               for k in ("breakdown", "total_correct", "histogram")}
        if not cont_eval or not os.path.exists(self.fp):
            with open(self.fp, "w") as f:
                f.write("," + ",".join(self.COLUMNS) + "\n")
        self._row = 0

    def append(self, data: np.ndarray) -> None:
        with open(self.fp, "a") as f:
            for row in data:
                f.write(f"{self._row}," + ",".join(str(x) for x in row) + "\n")
                self._row += 1

    def save_tensors(self, breakdown, total_correct, histogram) -> None:
        np.save(self.snapshot_paths["breakdown"], breakdown)
        np.save(self.snapshot_paths["total_correct"], total_correct)
        np.save(self.snapshot_paths["histogram"], histogram)

    def load_tensors(self):
        def _load(key):
            path = self.snapshot_paths[key]
            if not os.path.exists(path) and self.rank == 0:
                # pre-rank-suffix snapshot naming ("{base}_{key}.npy"), read
                # by rank 0 only
                legacy = path.rsplit("_", 1)[0] + ".npy"
                if os.path.exists(legacy):
                    return np.load(legacy)
            return np.load(path)
        return (_load("breakdown"), _load("total_correct"),
                _load("histogram"))


def get_prev_done_ids(params: Dict[str, Any]) -> Optional[np.ndarray]:
    ckpt = os.path.basename(str(params.get("start_checkpoint", "ck")))
    files = glob.glob(
        f"{params['save_path']}/eval_results_{params['eval_set']}_{ckpt}_*.csv")
    files = [f for f in files if f.rsplit("_", 1)[-1].split(".")[0].isdigit()]
    if not files:
        return None
    ids: List[int] = []
    for fn in files:
        with open(fn) as f:
            header = f.readline().strip().split(",")
            col = header.index("qa_ind")
            for line in f:
                parts = line.strip().split(",")
                if len(parts) > col and parts[col]:
                    ids.append(int(float(parts[col])))
    return np.asarray(ids) if ids else None


# ---------------------------------------------------------------------------
# main evaluation loop
# ---------------------------------------------------------------------------

def evaluate(dataloader, dataset, params: Dict[str, Any], model: CRCTModel,
             *, eval_batch_size: Optional[int] = None,
             progress: Any = False, csv: bool = True, cont_eval: bool = False,
             log_print: Optional[Callable[[str], None]] = None,
             allreduce: Optional[Callable[[np.ndarray], np.ndarray]] = None,
             on_predictions: Optional[Callable[[List[dict]], None]] = None):
    """Run full-candidate eval with ``model``'s weights on its device;
    returns (total_correct[6,2], breakdown[5,4,3,3], histogram[13]).

    A model in training mode (in-train eval: fp32 masters, autocast to its
    compute dtype) is scored in eval mode and put back in training mode
    afterwards. ``allreduce`` sums the accumulators over processes (default:
    over the process group, the identity without one); each rank scores
    the questions of its own loader on its own card."""
    was_training = model.training
    model.eval()
    try:
        return _evaluate(dataloader, dataset, params, model, eval_batch_size,
                         progress, csv, cont_eval, log_print,
                         allreduce or parallel.global_sum, on_predictions)
    finally:
        model.train(was_training)


def _evaluate(dataloader, dataset, params, model, eval_batch_size, progress,
              csv, cont_eval, log_print, allreduce, on_predictions):
    log_print = log_print or (lambda msg: print(msg, flush=True))
    device = next(model.parameters()).device
    chunk = max(eval_batch_size or resolve_eval_chunk(params), 1)
    # the fast paths dispatch per-QUESTION rows: in auto mode they get the
    # question-batch size, not the candidate-row chunk
    qchunk = max(eval_batch_size or resolve_eval_question_batch(params), 1)
    binary = params.get("binary_answers", False)
    fast = bool(params.get("fast_scorer")) and not binary
    # -fast_scorer_topk K: the fast head only SHORTLISTS K candidates and
    # the full model rescores those K rows (fig_dataloader.py:282-291)
    topk = int(params.get("fast_scorer_topk") or 0) if fast else 0
    if params.get("fast_scorer_topk") and not fast:
        log_print("WARNING: -fast_scorer_topk has no effect without "
                  "-fast_scorer (running the full reference protocol)")
    # dedup transfer: per-question visual arrays go to the card once per
    # loader batch and are gathered per row there (see EVAL_VIS_KEYS)
    dedup = bool(params.get("eval_dedup", True)) and not binary
    if fast:
        eval_step = (make_fast_eval_step_dedup(model) if dedup
                     else make_fast_eval_step(model))
    else:
        eval_step = (make_eval_step_dedup(model) if dedup
                     else make_eval_step(model))
    rank_step = ((make_eval_step_dedup(model) if dedup
                  else make_eval_step(model)) if topk else None)
    # bf16 models cast image_feat to bf16 at their first touch, so the
    # host casts it before the transfer (round to nearest even either way)
    # and moves half the bytes
    bf16_transfer = (bool(params.get("eval_bf16_transfer", True))
                     and model.compute_dtype == torch.bfloat16)

    def cast_feat(arrs):
        if bf16_transfer and "image_feat" in arrs:
            arrs = dict(arrs)
            arrs["image_feat"] = torch.from_numpy(np.ascontiguousarray(
                arrs["image_feat"])).to(torch.bfloat16)
        return arrs
    regs_mode = bool(params.get("qa_file")) and "_REGS" in str(params["qa_file"])

    breakdown = np.zeros((5, 4, 3, 3), np.float64)
    total_correct = np.zeros((6, 2), np.float64)
    histogram = np.zeros(13, np.int64)
    logger = EvaluationLog(params, cont_eval) if csv else None
    if csv and cont_eval:
        try:
            breakdown, total_correct, histogram = logger.load_tensors()
        except FileNotFoundError:
            pass

    inf_time = [0.0, 0]
    _qb_pad = [0]   # the question axis padded to the largest batch so far

    def put_vis(batch, trace):
        """Per-question visual arrays -> the card, padded to a stable B."""
        with tracing.span("eval.put_vis", trace=trace):
            nq = np.asarray(batch["tokens"]).shape[0]
            _qb_pad[0] = max(_qb_pad[0], nq)
            vis = {}
            for k in EVAL_VIS_KEYS:
                if k not in batch:
                    continue
                v = np.asarray(batch[k])[:, 0]
                if _qb_pad[0] > nq:
                    v = np.concatenate([v, np.zeros(
                        (_qb_pad[0] - nq,) + v.shape[1:], v.dtype)])
                t = torch.from_numpy(np.ascontiguousarray(v))
                if k == "image_feat" and bf16_transfer:
                    t = t.to(torch.bfloat16)
                vis[k] = t.to(device, non_blocking=True)
            return vis

    def dispatch_chunks(rows, trace, step=None, chunk_size=None, vis=None,
                        qidx=None):
        """Transfer + launch every chunk; the outputs stay on the card (see
        collect_chunks), so the host packs chunk k+1 while the card runs
        chunk k and, in the pipelines, a later stage's launches queue behind
        these before any output comes back."""
        step = step or eval_step
        size = chunk_size or chunk
        t0 = time.time()
        if qidx is not None:
            rows = dict(rows, _qidx=np.asarray(qidx, np.int64))
        # drawn inside the pack span, so that the slicing and padding of
        # _chunk_rows count there
        pieces = _chunk_rows(rows, size)
        pending = []
        for _ in range(-(-len(next(iter(rows.values()))) // size)):
            with tracing.span("eval.pack", trace=trace):
                piece, valid = next(pieces)
                q = piece.pop("_qidx", None)
                piece = cast_feat(piece)
            tracing.count("eval.rows_valid", valid)
            tracing.count("eval.rows_launched", size)
            with tracing.span("eval.put", trace=trace):
                piece = to_device(piece, device)
            with tracing.span("eval.dispatch", trace=trace):
                outs = (step(piece, vis, q) if q is not None else step(piece))
            pending.append((outs, valid))
        inf_time[0] += time.time() - t0
        return pending

    def collect_chunks(pending, trace):
        """The outputs of every chunk on the host."""
        t0 = time.time()
        collected = None
        with tracing.span("eval.fetch", trace=trace):
            for outs, valid in pending:
                outs = [o[:valid].float().cpu().numpy() for o in outs]
                if collected is None:
                    collected = [[] for _ in outs]
                for acc, o in zip(collected, outs):
                    acc.append(o)
        inf_time[0] += time.time() - t0
        return [np.concatenate(a) for a in collected]

    def run_chunks(rows, trace, step=None, chunk_size=None, vis=None,
                   qidx=None):
        return collect_chunks(dispatch_chunks(rows, trace, step, chunk_size,
                                              vis, qidx), trace)

    def _topk_stage2(bi, batch, ids, gt_id, frows):
        """Fast logits on the host -> shortlist -> launch the rescore
        (returns the in-flight state; outputs collected in _topk_finish)."""
        cand_valid = frows["cand_valid"] > 0                # [B, P]
        cand_logits = frows.pop("_cand_logits")
        B, P = cand_logits.shape
        K = min(topk, P)
        top_idx = np.argsort(-cand_logits, axis=1, kind="stable")[:, :K]
        if regs_mode:
            # regression-only eval scores the GT candidate's row;
            # pin it into the shortlist so its outputs exist
            has_gt = (top_idx == gt_id[:, None]).any(axis=1)
            top_idx[~has_gt, -1] = gt_id[~has_gt]
        if dedup:
            # vis is already on the card from the fast pass
            pend = dispatch_chunks(
                shortlist_rescore_rows(batch, top_idx,
                                       keys=EVAL_TEXT_KEYS),
                bi, rank_step, vis=frows["_vis"],
                qidx=np.repeat(np.arange(B, dtype=np.int64), K))
        else:
            pend = dispatch_chunks(
                shortlist_rescore_rows(batch, top_idx), bi, rank_step)
        return (bi, batch, ids, gt_id, cand_valid, top_idx, K, pend)

    def _topk_finish(st):
        bi, batch, ids, gt_id, cand_valid, top_idx, K, pend = st
        nsp_probs, reg_out, reg5, regl1 = collect_chunks(pend, bi)
        B = top_idx.shape[0]
        probs = np.where(
            np.take_along_axis(cand_valid, top_idx, axis=1),
            nsp_probs[:B * K].reshape(B, K), -np.inf)
        if regs_mode:
            best_k = np.argmax(top_idx == gt_id[:, None], axis=1)
            answers_idx = gt_id.astype(np.int64)
        else:
            # break prob ties by CANDIDATE index (the full protocol's
            # segmented_argmax picks the first max in candidate order)
            corder = np.argsort(top_idx, axis=1, kind="stable")
            probs_c = np.take_along_axis(probs, corder, axis=1)
            bk0 = np.argmax(probs_c, axis=1)
            best_k = np.take_along_axis(corder, bk0[:, None],
                                        axis=1)[:, 0]
            answers_idx = np.take_along_axis(
                top_idx, best_k[:, None], axis=1)[:, 0]
        sel = np.arange(B) * K + best_k
        nonempty = np.isfinite(probs).any(axis=1)
        return bi, batch, (answers_idx,
                           (answers_idx == gt_id) & nonempty,
                           np.where(nonempty, reg5[sel], np.inf),
                           np.where(nonempty, regl1[sel], np.inf),
                           np.where(nonempty, reg_out[sel], np.nan),
                           probs[np.arange(B), best_k])

    def _topk_batches():
        """Shortlist-then-rescore, pipelined one batch deep: while the card
        rescores batch k, the host builds and launches the fast pass of
        batch k+1 (its chunks queue behind the rescore), and batch k's
        outputs come back only after that."""
        inflight = None
        for bi, batch in enumerate(dataloader):
            ids = np.asarray(batch["id"]).reshape(-1)
            if ids.shape[0] == 0:
                continue
            gt_id = np.asarray(batch["gt_id"]).reshape(-1)
            with tracing.span("eval.flatten", trace=bi):
                frows = build_fast_rows(batch)
            if dedup:
                vis = put_vis(batch, bi)
                ftext = {k: v for k, v in frows.items()
                         if k not in EVAL_VIS_KEYS}
                fpend = dispatch_chunks(
                    ftext, bi, chunk_size=qchunk, vis=vis,
                    qidx=np.arange(len(ids), dtype=np.int64))
                frows["_vis"] = vis
            else:
                fpend = dispatch_chunks(frows, bi, chunk_size=qchunk)
            if inflight is not None:
                yield _topk_finish(inflight)
            frows["_cand_logits"] = collect_chunks(fpend, bi)[0]
            inflight = _topk_stage2(bi, batch, ids, gt_id, frows)
        if inflight is not None:
            yield _topk_finish(inflight)

    def _rank_finish(st):
        bi, batch, offsets, pend = st
        return bi, batch, (collect_chunks(pend, bi), offsets)

    def _rank_batches():
        """Full reference protocol, pipelined one batch deep (the structure
        of _topk_batches): batch k+1's rows go to the card before batch k's
        outputs come back, so the card keeps working through the host's
        flatten / transfer / accounting. Zero-candidate batches launch
        nothing and flush the pipeline to keep the batch order."""
        inflight = None
        for bi, batch in enumerate(dataloader):
            ids = np.asarray(batch["id"]).reshape(-1)
            if ids.shape[0] == 0:
                continue
            if not np.any(np.asarray(batch["num_ans"]).reshape(-1) > 0):
                if inflight is not None:
                    yield _rank_finish(inflight)
                    inflight = None
                yield bi, batch, None    # poisoned outputs, no dispatch
                continue
            with tracing.span("eval.flatten", trace=bi):
                if dedup:
                    rows, offsets = _flatten_valid_rows(
                        batch, keys=EVAL_TEXT_KEYS)
                    qidx = np.repeat(
                        np.arange(len(ids), dtype=np.int64),
                        np.diff(offsets).astype(np.int64))
                else:
                    rows, offsets = _flatten_valid_rows(batch)
            if dedup:
                pend = dispatch_chunks(rows, bi, vis=put_vis(batch, bi),
                                       qidx=qidx)
            else:
                pend = dispatch_chunks(rows, bi)
            if inflight is not None:
                yield _rank_finish(inflight)
            inflight = (bi, batch, offsets, pend)
        if inflight is not None:
            yield _rank_finish(inflight)

    if fast and topk:
        batch_iter = _topk_batches()
    elif not fast and not binary:
        batch_iter = _rank_batches()
    else:
        batch_iter = ((bi, b, None) for bi, b in enumerate(dataloader))

    for bi, batch, pre in batch_iter:
        ids = np.asarray(batch["id"]).reshape(-1)
        if ids.shape[0] == 0:
            continue
        if fast and not topk:
            # one backbone pass per question + light candidate head; the
            # regression outputs come from the same answer-masked pass
            with tracing.span("eval.flatten", trace=bi):
                frows = build_fast_rows(batch)
            if dedup:
                ftext = {k: v for k, v in frows.items()
                         if k not in EVAL_VIS_KEYS}
                pre = run_chunks(ftext, bi, chunk_size=qchunk,
                                 vis=put_vis(batch, bi),
                                 qidx=np.arange(len(ids), dtype=np.int64))
            else:
                pre = run_chunks(frows, bi, chunk_size=qchunk)
        elif binary:
            pre = run_chunks({k: np.asarray(batch[k]) for k in ROW_KEYS
                              if k in batch}, bi)
        with tracing.span("eval.account", trace=bi):
            needs_reg = np.asarray(batch["needs_reg"]).reshape(
                len(ids), -1)[:, 0]
            needs_reg = needs_reg.astype(bool)
            gt_id = np.asarray(batch["gt_id"]).reshape(-1)

            if fast and topk:
                (answers_idx, nsp_right, ans_reg5, ans_regl1, ans_reg_out,
                 ans_prob) = pre
            elif fast:
                cand_logits, ans_reg_out, ans_reg5, ans_regl1 = pre
                if regs_mode:
                    answers_idx = gt_id.astype(np.int64)
                else:
                    answers_idx = np.argmax(cand_logits, axis=-1)
                nsp_right = answers_idx == gt_id
                masked = np.where(frows["cand_valid"] > 0, cand_logits,
                                  -np.inf)
                masked = masked - masked.max(axis=1, keepdims=True)
                e = np.exp(masked)
                with np.errstate(invalid="ignore"):
                    smax = e / np.maximum(e.sum(axis=1, keepdims=True), 1e-30)
                ans_prob = smax[np.arange(len(ids)), answers_idx]
            elif binary:
                nsp_probs, reg_out, reg5, regl1 = pre
                answers = np.round(nsp_probs).astype(np.int64)
                labels = np.asarray(batch["next_sentence_labels"]).reshape(-1)
                nsp_right = answers == (1 - labels)
                ans_reg5 = np.zeros(len(ids))
                ans_regl1 = np.zeros(len(ids))
                ans_reg_out = np.zeros(len(ids))
                answers_idx = answers
                ans_prob = np.where(answers == 1, nsp_probs, 1.0 - nsp_probs)
            elif pre is None:
                # every question in this loader batch has zero valid candidates
                # (_rank_batches launched nothing): the poisoned outputs of the
                # `nonempty` masking below
                answers_idx = (gt_id.astype(np.int64) if regs_mode
                               else np.zeros(len(ids), np.int64))
                nsp_right = np.zeros(len(ids), bool)
                ans_reg5 = np.full(len(ids), np.inf)
                ans_regl1 = np.full(len(ids), np.inf)
                ans_reg_out = np.full(len(ids), np.nan)
                ans_prob = np.full(len(ids), np.nan)
            else:
                # the pipelined rank path: outputs already collected
                (nsp_probs, reg_out, reg5, regl1), offsets = pre
                # per-question (segmented) argmax over candidate NSP probs,
                # first-max tie-breaking (evaluation.py:287-296)
                starts = offsets[:-1].astype(np.int64)
                if regs_mode:
                    answers_idx = gt_id.astype(np.int64)
                else:
                    answers_idx = segmented_argmax(nsp_probs, offsets)
                sel = np.minimum(starts + answers_idx,
                                 max(len(nsp_probs) - 1, 0))
                # a question with zero valid candidates can never be right, and
                # its `sel` row belongs to another question: poison its
                # regression outputs so the reg-accuracy counters skip it too
                nonempty = np.diff(offsets) > 0
                ans_reg5 = np.where(nonempty, reg5[sel], np.inf)
                ans_regl1 = np.where(nonempty, regl1[sel], np.inf)
                ans_reg_out = np.where(nonempty, reg_out[sel], np.nan)
                nsp_right = (answers_idx == gt_id) & nonempty
                ans_prob = np.where(nonempty, nsp_probs[sel], np.nan)
            inf_time[1] += len(ids)

            tol = np.asarray(batch["tolerance_margin"]).reshape(
                len(ids), -1)[:, 0]
            reg_right = (ans_reg5 <= 0.05) & needs_reg
            reg_t_right = (ans_regl1 <= tol) & needs_reg
            correct = nsp_right & (~needs_reg | reg_right)
            t_correct = nsp_right & (~needs_reg | reg_t_right)

            if on_predictions is not None and dataset is not None:
                # batch answer serving: one record per question, the demo bot's
                # pred dict (reference Interactive_demo.py:161-247)
                recs = []
                for i in range(len(ids)):
                    raw = dataset.get_raw(int(ids[i]))
                    rec = {"question_id": int(ids[i]),
                           "image_index": int(raw["image_index"]),
                           "question": str(raw.get("question_string", "")),
                           "is_reg": bool(needs_reg[i]),
                           "confidence": (float(ans_prob[i])
                                          if np.isfinite(ans_prob[i])
                                          else None)}
                    if binary:
                        rec["answer"] = rec["cls_output"] = int(answers_idx[i])
                    else:
                        opts = dataset.get_possible_answers(raw["image_index"])
                        ci = int(answers_idx[i])
                        rec["cls_output"] = (str(opts[ci])
                                             if 0 <= ci < len(opts) else None)
                        if needs_reg[i]:
                            rec["reg_output"] = (float(ans_reg_out[i])
                                                 if np.isfinite(ans_reg_out[i])
                                                 else None)
                            rec["answer"] = rec["reg_output"]
                        else:
                            rec["answer"] = rec["cls_output"]
                    if raw.get("answer") is not None:
                        a = raw["answer"]
                        rec["gt_answer"] = (a.item() if hasattr(a, "item")
                                            else a)
                    recs.append(rec)
                on_predictions(recs)

            if logger is not None:
                gt = np.asarray(batch["gt"]).reshape(len(ids), -1)[:, 0]
                reg_target = np.asarray(batch["reg_target"]).reshape(
                    len(ids), -1)[:, 0]
                data = np.stack([ids, gt_id, answers_idx, gt, ans_reg_out,
                                 reg_target, ans_reg5, ans_regl1],
                                axis=1).astype(object)
                data[~needs_reg, 3:] = np.nan
                logger.append(data)

            total_correct = reduce_total_acc(
                total_correct, needs_reg, nsp_right, reg_right, reg_t_right)
            if 'plotqa' in params.get('dataset', ''):
                breakdown = reduce_breakdown(breakdown, dataset, batch,
                                             correct, t_correct, needs_reg)
                histogram = reduce_histogram(histogram, ans_reg5[needs_reg])
            if logger is not None:
                # snapshots for EVERY dataset: resume reloads them
                logger.save_tensors(breakdown, total_correct, histogram)
            if progress:
                print_acc_table(log_print, total_correct)
                if 'plotqa' in params.get('dataset', ''):
                    print_breakdown_table(params, log_print, breakdown)
                if progress == "examples" and dataset is not None:
                    # right-regression and wrong-classification samples
                    # (reference evaluation.py:360-382)
                    for i in np.nonzero(nsp_right & needs_reg & reg_right)[0]:
                        raw = dataset.get_raw(int(ids[i]))
                        log_print("{} [I{}] Q:{} output: {} || {} || loss: {}"
                                  .format(int(ids[i]), raw['image_index'],
                                          raw['question_string'],
                                          ans_reg_out[i], raw['answer'],
                                          ans_reg5[i]))
                    for i in np.nonzero(nsp_right & ~needs_reg)[0]:
                        raw = dataset.get_raw(int(ids[i]))
                        opts = dataset.get_possible_answers(raw['image_index'])
                        log_print("*{} <I{}> Q: {} . A: {} || {}".format(
                            int(ids[i]), raw['image_index'],
                            raw['question_string'],
                            opts[int(answers_idx[i])], raw['answer']))

    if inf_time[1]:
        log_print(f"Avg inference time: {inf_time[0] / inf_time[1]:.4f}s "
                  f"for {inf_time[1]} questions.")
    total_correct = allreduce(total_correct)
    breakdown = allreduce(breakdown)
    histogram = allreduce(histogram)
    return total_correct, breakdown, histogram


# ---------------------------------------------------------------------------
# table printers (reference evaluation.py:551-603)
# ---------------------------------------------------------------------------

def _safe_div(a, b):
    return a / b if b else float("nan")


def _cell(v) -> str:
    """One cell as pandas formats an object column of a DataFrame with an
    index: a float (not NaN) as ``f"{v: .6f}"`` with its trailing zeros
    trimmed, anything else after one space, NaN as "NaN"."""
    if isinstance(v, (float, np.floating)) and not np.isnan(v):
        s = f"{v: .6f}".rstrip("0")
        return s + "0" if s.endswith(".") else s
    if isinstance(v, (float, np.floating)):
        return " NaN"
    return f" {v}"


def frame_text(rows, index, columns) -> str:
    """The text of ``str(pandas.DataFrame(rows, index, columns))`` for the
    small tables of this module: the index left-justified, each column
    right-justified to its widest cell or header, one space between."""
    idx_w = max(len(str(i)) for i in index)
    cols = []
    for j, name in enumerate(columns):
        cells = [_cell(r[j]) for r in rows]
        w = max(len(str(name)), *(len(c) for c in cells))
        cols.append([str(name).rjust(w)] + [c.rjust(w) for c in cells])
    lines = [" " * idx_w] + [str(i).ljust(idx_w) for i in index]
    return "\n".join(
        " ".join([lines[r]] + [c[r] for c in cols])
        for r in range(len(lines)))


def print_acc_table(log_print, acc) -> None:
    frac = [[_safe_div(acc[3, 0], acc[3, 1]), _safe_div(acc[5, 0], acc[5, 1])],
            [_safe_div(acc[2, 0], acc[2, 1]), _safe_div(acc[4, 0], acc[4, 1])]]
    frac = [["%.5g" % v for v in row] for row in frac]
    log_print(frame_text(frac, ["Reg +-t", "Reg +-5%"],
                         ["Accuracy", "Total Accuracy"]))
    log_print("-" * 10)
    nsp = [["%.5g" % _safe_div(acc[0, 0], acc[0, 1]),
            "%.5g" % _safe_div(acc[1, 0], acc[1, 1])]]
    log_print(frame_text(nsp, [""], ["nsp", "reg_cls"]))
    log_print("-" * 20)


def print_breakdown_table(params, log_print, acc) -> None:
    table_ids = FIG_TABLE_IDS if params.get("dataset") != "dvqa" else {"Total": 0}
    for name, tid in table_ids.items():
        rows = []
        for ans_cat in range(acc.shape[1]):
            row = []
            for q_cat in range(acc.shape[2]):
                num, num_t, den = acc[tid, ans_cat, q_cat]
                if den == 0:
                    row.append("N/A")
                else:
                    s = "%.5g" % (num / den)
                    if num_t != num:
                        s += " | %.5g" % (num_t / den)
                    row.append(s)
            rows.append(row)
        rows.append([_safe_div(np.sum(acc[tid, :3, q, 0]),
                               np.sum(acc[tid, :3, q, -1]))
                     for q in range(3)])
        log_print("==================== {}: {} ======================="
                  .format(name, int(np.sum(acc[tid, :3, :, -1]))))
        log_print(frame_text(rows,
                             ["Yes/No", "Fixed Vocabulary",
                              "Open Vocabulary", "Regression", "Total"],
                             ["Structural", "Data Retrieval", "Reasoning"]))
    log_print("-" * 20)


def make_histogram_png(params, histogram) -> Optional[str]:
    """13-bin regression-error histogram PNG (reference make_hist,
    evaluation.py:389-431); None where matplotlib is not installed."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return None
    bars = ['0-5', '5-10', '10-15', '15-20', '20-30', '30-40', '40-50',
            '50-60', '60-70', '70-80', '80-90', '90-100', '100+']
    total = max(1, int(np.sum(histogram)))
    fig, ax = plt.subplots()
    ax.set_title("reg_acc: [{}/{}] {}%  all regression outputs".format(
        int(histogram[0]), total, round(histogram[0] / total * 100, 2)))
    ax.bar(range(len(bars)), height=list(histogram))
    plt.xticks(range(len(bars)), bars, rotation="vertical")
    out = os.path.join(params["save_path"],
                       f"Eval_hist_{params['eval_set']}.png")
    os.makedirs(params["save_path"], exist_ok=True)
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    return out
