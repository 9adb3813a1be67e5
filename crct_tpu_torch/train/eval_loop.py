"""Candidate scoring for the eval and serving paths.

The port of the scoring pieces of ``crct_tpu/train/eval_loop.py``
(:53-101, :207-338; reference CRCT/evaluation.py). Each question fans out
to all its candidate answers (padded to EVAL_PADDED_SIZE with a validity
mask); the valid candidate rows are packed host-side into fixed-size chunks,
scored by the model, and a per-question argmax over the candidates' NSP
probabilities picks the answer. The full evaluation loop with its accuracy
tables is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from crct_tpu_torch.models.crct import CRCTModel

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


def to_device(rows: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """numpy arrays (or tensors) -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in rows.items()}


def _scores(model: CRCTModel, rows: Dict[str, torch.Tensor]):
    out = model(rows)
    nsp_probs = torch.softmax(out.nsp_logits, dim=-1)[:, 0]
    return nsp_probs, out.reg_output, out.reg_5_dist, out.reg_l1


def make_eval_step(model: CRCTModel):
    """Scorer over a chunk of candidate rows: (nsp_prob_pos, reg_output,
    reg_5_dist, reg_l1) per row, the quantities the reference collects per
    sub-batch (evaluation.py:243-262)."""
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
        rows = to_device(text_rows, device)
        idx = torch.as_tensor(row_qidx).to(device, torch.long)
        for k, v in vis.items():
            rows[k] = v.index_select(0, idx)
        return _scores(model, rows)

    return eval_step


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
