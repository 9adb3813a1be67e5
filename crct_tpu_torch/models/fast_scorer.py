"""Opt-in fast candidate scorer for evaluation and serving.

The port of ``crct_tpu/models/fast_scorer.py``. The reference scores every
(question, candidate) pair with a full two-stream forward: the x120
candidate fan-out is its eval bottleneck (CRCT/evaluation.py:243-262). The
fast scorer encodes chart + question ONCE per question (answer tokens masked
out of the attention), and this light head scores all candidate answers
against the fused pooled state. The head trains separately on a frozen
backbone (``train/fast_scorer_train.py``); its accuracy is not the
reference protocol's, a trade the user opts into with ``-fast_scorer``.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

NEG_INF = -1e9


class FastScorer(nn.Module):
    """Candidate-answer scorer over the fused pooled question encoding.

    cand_tokens [B, C, A] (0-padded WordPiece ids per candidate) are
    embedded, mean-pooled, MLP-projected and dot-scored against a
    projection of the fused pooled state, which is ``hidden`` wide (the
    model's bi_hidden_size)."""

    def __init__(self, vocab_size: int, emb_dim: int = 256,
                 hidden: int = 512):
        super().__init__()
        self.hidden = hidden
        self.cand_embeddings = nn.Embedding(vocab_size, emb_dim)
        self.cand_proj1 = nn.Linear(emb_dim, hidden)
        self.cand_proj2 = nn.Linear(hidden, hidden)
        self.question_proj = nn.Linear(hidden, hidden)

    def forward(self, fused_pooled: torch.Tensor, cand_tokens: torch.Tensor,
                cand_valid: torch.Tensor) -> torch.Tensor:
        dtype = self.cand_proj1.weight.dtype
        emb = self.cand_embeddings(cand_tokens.long()).to(dtype)   # [B,C,A,E]
        tok_mask = (cand_tokens > 0).to(emb.dtype)[..., None]
        denom = tok_mask.sum(dim=2).clamp(min=1.0)
        pooled = (emb * tok_mask).sum(dim=2) / denom               # [B,C,E]
        h = self.cand_proj2(F.gelu(self.cand_proj1(pooled)))       # [B,C,H]
        q = self.question_proj(fused_pooled.to(dtype))
        scores = torch.einsum("bh,bch->bc", q, h) / math.sqrt(self.hidden)
        return torch.where(cand_valid > 0, scores.float(),
                           torch.full_like(scores, NEG_INF, dtype=torch.float32))
