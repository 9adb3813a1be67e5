"""The work of the model, counted from its widths and shapes.

``forward_flops``: useful matrix-multiply FLOPs only (2 a multiply-add), no
masked or padded work skipped and none added, no elementwise work, no
recompute; ``train_step_flops`` the forward and twice it for the
backward.

``attention_calls``: every call of the attention core one forward makes,
with its (B, H, Lq, Lk, D) and how many times it runs; ``attention_work``
the FLOPs and the bytes of one call, each input read once and each output
written once.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def _widths(cfg):
    m, d = cfg["model"], cfg["dataset"]
    return m, d, d["max_seq_len"], d["max_vis_features"]


def forward_flops(cfg, B: int) -> float:
    """Matmul FLOPs of one forward over ``B`` rows at the configuration's
    shapes."""
    m, d, L, R = _widths(cfg)
    H, FF = m["hidden_size"], m["intermediate_size"]
    VH, VFF, BI = m["v_hidden_size"], m["v_intermediate_size"], \
        m["bi_hidden_size"]
    n_co = len(m["v_biattention_id"])

    def mm(rows, k, n):
        return 2.0 * rows * k * n

    f = mm(B * L, 4, H) + mm(B * R, 4, VH)
    if d["dataset"] not in ("figure_qa", "dvqa"):
        f += mm(B * R, m["v_feature_size"], VH)
    if d["dataset"] == "figure_qa":
        f += mm(B * R, 1, VH)
    f += m["num_hidden_layers"] * (4 * mm(B * L, H, H) + 2 * mm(B * L, L, H)
                                   + 2 * mm(B * L, H, FF))
    f += m["v_num_hidden_layers"] * (4 * mm(B * R, VH, VH)
                                     + 2 * mm(B * R, R, VH)
                                     + 2 * mm(B * R, VH, VFF))
    f += n_co * (3 * mm(B * L, H, BI) + 3 * mm(B * R, VH, BI)
                 + 4 * mm(B * L, R, BI)
                 + mm(B * L, BI, H) + mm(B * R, BI, VH)
                 + 2 * mm(B * L, H, FF) + 2 * mm(B * R, VH, VFF))
    f += mm(B, H, BI) + mm(B, VH, BI) + mm(B, BI, 2)
    if not d["binary_answers"]:
        reg = (H * H + H * 512 + 512 * 256 + 256 * 256
               + VH * VH + VH * 512 + 512 * 256 + 256 * 256
               + 512 * 512 + 512 * 256 + 256 * 256 + 256 * 1)
        f += 2.0 * B * reg
    return f


def train_step_flops(cfg, B: int) -> float:
    return 3.0 * forward_flops(cfg, B)


def attention_calls(cfg, B: int) -> List[Tuple[Tuple[int, int, int, int, int],
                                               int]]:
    """((B, H, Lq, Lk, D), calls) of one forward, by shape."""
    m, d, L, R = _widths(cfg)
    th, vh, bh = (m["num_attention_heads"], m["v_num_attention_heads"],
                  m["bi_num_attention_heads"])
    n_co = len(m["v_biattention_id"])
    calls: Dict[Tuple[int, int, int, int, int], int] = {}

    def add(shape, n):
        if n:
            calls[shape] = calls.get(shape, 0) + n

    add((B, th, L, L, m["hidden_size"] // th), m["num_hidden_layers"])
    add((B, vh, R, R, m["v_hidden_size"] // vh), m["v_num_hidden_layers"])
    add((B, bh, L, R, m["bi_hidden_size"] // bh), n_co)
    add((B, bh, R, L, m["bi_hidden_size"] // bh), n_co)
    return sorted(calls.items())


def attention_work(shape, itemsize: int, backward: bool
                   ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one attention call: the forward's two products
    (q k^T and P v), the backward's five (the scores again, dP, dV, dQ and
    dK); bytes of q, k, v and the [B, Lk] fp32 mask read and the output
    written, in the backward the output's gradient read and dq, dk, dv
    written."""
    B, H, Lq, Lk, D = shape
    per = 2.0 * B * H * Lq * Lk * D
    q, kv, mask = B * H * Lq * D, B * H * Lk * D, 4.0 * B * Lk
    if backward:
        return 5 * per, (2 * q + 2 * kv) * itemsize * 2 + mask
    return 2 * per, (2 * q + 2 * kv) * itemsize + mask


def least_seconds(flops: float, nbytes: float, peak_flops: float,
                  peak_bytes: float) -> float:
    return max(flops / peak_flops, nbytes / peak_bytes)

