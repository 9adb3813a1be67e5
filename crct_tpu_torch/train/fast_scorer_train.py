"""Fast-scorer head training: listwise CE over each question's candidates.

The port of ``crct_tpu/train/fast_scorer_train.py``. Trains ONLY the
``fast_scorer`` head on top of a frozen, already-trained CRCT backbone: the
backbone runs once per question, answer-masked (the encoding the fast eval
path uses), in eval mode under ``torch.no_grad()``, so no dropout is drawn
and no gradient reaches it; a step costs about one eval forward. The head
keeps fp32 masters and trains with Adam (optax's ``adam``: b1 0.9, b2 0.999,
eps 1e-8 outside the square root), its candidate embeddings warm-started
from the backbone's word embeddings when the shapes match.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from crct_tpu_torch.models.crct import CRCTModel
from crct_tpu_torch.train.eval_loop import build_fast_rows, to_device


def make_head_train_step(model: CRCTModel, optimizer: torch.optim.Optimizer):
    """(fast rows as numpy, gt candidate ids) -> the step's CE on the
    model's device, after one optimizer step of the head."""
    device = next(model.parameters()).device
    head_autocast = model.compute_dtype != torch.float32

    def step(rows: Dict[str, np.ndarray], gt_id: np.ndarray) -> torch.Tensor:
        batch = to_device(rows, device)
        gt = torch.as_tensor(gt_id).to(device, torch.long).reshape(-1, 1)
        with torch.no_grad(), model.autocast(device.type):
            _, _, t_pooled, v_pooled = model.encode(batch)
            fused = model.cls.fuse(t_pooled, v_pooled)
        with torch.autocast(device.type, dtype=model.compute_dtype,
                            enabled=head_autocast):
            logits = model.fast_scorer(fused, batch["cand_tokens"],
                                       batch["cand_valid"])
        logp = torch.log_softmax(logits.float(), dim=-1)
        ce = -logp.gather(1, gt)[:, 0]
        # rows can be zero-padded: a padded row has no valid candidates ->
        # all logits NEG_INF -> uniform logp; weight by whether any
        # candidate is valid
        w = (batch["cand_valid"].sum(dim=-1) > 0).float()
        loss = (ce * w).sum() / w.sum().clamp(min=1.0)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def train_fast_scorer(params: Dict[str, Any], dataset, model: CRCTModel, *,
                      steps: int, lr: float = 1e-3, batch_questions: int = 32,
                      log_print=print):
    """Train ``model``'s fast-scorer head in place; returns (model, the CE
    of the last logged step). The head ends with fp32 parameters."""
    from crct_tpu_torch.data.dataset import DataLoader

    if not model.has_fast_scorer:
        raise ValueError("build the model with -fast_scorer: it has no "
                         "fast_scorer head")
    dataset.split = "train"
    dataset.get_all_answers = True
    loader = DataLoader(dataset, batch_size=batch_questions, shuffle=True,
                        drop_last=True,
                        num_workers=params.get("num_workers", 2) or 1)
    model.eval()
    for p in model.parameters():
        p.requires_grad_(False)
    head = model.fast_scorer.float()
    word = model.bert.embeddings.word_embeddings.weight
    if head.cand_embeddings.weight.shape == word.shape:
        with torch.no_grad():
            head.cand_embeddings.weight.copy_(word.float())
        log_print("[fast-scorer] candidate embeddings warm-started "
                  "from backbone word embeddings")
    for p in head.parameters():
        p.requires_grad_(True)
    optimizer = torch.optim.Adam(head.parameters(), lr=lr,
                                 betas=(0.9, 0.999), eps=1e-8)
    step_fn = make_head_train_step(model, optimizer)

    it = 0
    last = None
    try:
        while it < steps:
            it_at_epoch_start = it
            for batch in loader:
                if it >= steps:
                    break
                loss = step_fn(build_fast_rows(batch),
                               np.asarray(batch["gt_id"]).reshape(-1))
                if it % 20 == 0:
                    last = float(loss)
                    log_print(f"[fast-scorer {it}/{steps}] CE: {last:.4f}")
                it += 1
            if it == it_at_epoch_start:
                raise ValueError(
                    "fast-scorer loader yielded no batches (dataset smaller "
                    "than the question batch with drop_last) - lower "
                    "batch_size or add data")
    finally:
        loader.close()
        for p in head.parameters():
            p.requires_grad_(False)
    dataset.get_all_answers = False
    return model, last
