"""CRCT: backbone + NSP head + hybrid regressor + losses.

The port of ``crct_tpu/models/crct.py``. ``self.training`` plays the JAX
``train`` flag: in eval mode the forward fills every ``CRCTOutputs`` field
the eval path reads (L1 regression loss, the DVQA clip to the nearest legal
float); in training mode it applies dropout from the caller's generator,
takes SmoothL1 (beta 0.5, zeroed where |target| > 1) or, with ``use_l1``,
L1, and adds the NSP cross-entropy and the combined loss
``nsp_coeff * nsp + reg_coeff * mean(reg_loss)``. The regressor runs on
every row and its outputs are masked by ``needs_reg`` (fixed shapes, as in
the JAX package).

Mixed precision for training: with a bf16 config and fp32 parameters (what
``build_model(train=True)`` gives) the backbone computes under bf16
autocast, so AdamW updates fp32 masters, as the JAX package keeps
``param_dtype`` fp32 under ``-bf16``. Serving casts the parameters instead
(``set_compute_dtype``). The regressor and the losses stay fp32 either way.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from crct_tpu_torch.config import DVQA_FLOATS, CRCTModelConfig
from crct_tpu_torch.models.layers import DropoutRNG, init_weights
from crct_tpu_torch.models.regressor import CERegressor, HybridRegressor
from crct_tpu_torch.models.vilbert import (PreTrainingHeads,
                                           TwoStreamEncoderModel)
from crct_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class CRCTOutputs:
    """Per-row outputs (the reference's ``reg`` 5-tuple plus NSP); the
    regression entries are zero where needs_reg is False."""
    nsp_logits: torch.Tensor        # [B, 2] fp32
    reg_output: torch.Tensor        # [B] denormalized regression output
    reg_loss: torch.Tensor          # [B] per-row L1 (eval), masked
    reg_l1: torch.Tensor            # [B] |pred - target| in normalized units
    reg_5_dist: torch.Tensor        # [B] relative L1 distance
    correct_regs: torch.Tensor      # [B] bool, within 5%
    correct_t_regs: torch.Tensor    # [B] bool, within tolerance margin
    needs_reg: torch.Tensor         # [B] bool
    nsp_loss: Optional[torch.Tensor] = None   # scalar (training)
    loss: Optional[torch.Tensor] = None       # scalar combined (training)


class CRCTModel(nn.Module):
    """Backbone + heads (reference BertForMultiModalPreTraining)."""

    def __init__(self, config: CRCTModelConfig, categories: int = 228,
                 dataset: str = "plotqa", ce_reg: bool = False,
                 binary_answers: bool = False, tol_margin: float = 0.01,
                 mask_prob_img: float = 0.0, use_l1: bool = False,
                 nsp_loss_coeff: float = 1.0, reg_loss_coeff: float = 1.0):
        super().__init__()
        self.config = config
        self.dataset = dataset
        self.ce_reg = ce_reg
        self.tol_margin = tol_margin
        self.use_l1 = use_l1
        self.nsp_loss_coeff = nsp_loss_coeff
        self.reg_loss_coeff = reg_loss_coeff
        self.bert = TwoStreamEncoderModel(config, categories, dataset,
                                          mask_prob_img)
        self.cls = PreTrainingHeads(config)
        # reference condition (vilbert.py:1518)
        self.has_regressor = not binary_answers
        if self.has_regressor:
            self.regressor = (CERegressor if ce_reg else HybridRegressor)(
                config.hidden_size, config.v_hidden_size)

    @property
    def compute_dtype(self) -> torch.dtype:
        return (torch.bfloat16 if self.config.dtype == "bfloat16"
                else torch.float32)

    def set_compute_dtype(self) -> "CRCTModel":
        """Cast the backbone and the NSP head to the config's dtype; the
        regressor stays fp32, as in the JAX package."""
        self.bert.to(self.compute_dtype)
        self.cls.to(self.compute_dtype)
        return self

    def forward(self, batch: Dict[str, torch.Tensor],
                generator: Optional[torch.Generator] = None) -> CRCTOutputs:
        """``generator`` (a CPU ``torch.Generator``; torch's default one when
        None) drives every dropout draw of a training forward; in eval mode
        nothing is drawn."""
        tokens = batch["tokens"]
        rng = None
        if self.training:
            rng = DropoutRNG(generator or torch.default_generator,
                             tokens.device)
        autocast = (self.compute_dtype != torch.float32 and
                    self.cls.bi_seq_relationship.weight.dtype == torch.float32)
        with torch.autocast(tokens.device.type, dtype=self.compute_dtype,
                            enabled=autocast):
            t_seq, v_seq, nsp_logits = self._backbone(batch, rng)
        with torch.autocast(tokens.device.type, enabled=False):
            return self._heads(batch, t_seq[:, 0].float(),
                               v_seq[:, 0].float(), nsp_logits.float())

    def _backbone(self, batch, rng):
        dtype = self.compute_dtype
        tokens = batch["tokens"].long()
        token_types = batch["segments"].long()
        B, L = tokens.shape

        # attention mask from sep_indices/hist_len (encoder_decorator.py:118-120)
        if "attention_mask" in batch:
            attention_mask = batch["attention_mask"]
        else:
            sep_indices = batch["sep_indices"].long()
            hist_len = batch["hist_len"].long().reshape(B)
            seq_len = sep_indices.gather(1, hist_len[:, None])[:, 0] + 1
            attention_mask = (torch.arange(L, device=tokens.device)[None, :]
                              < seq_len[:, None])
        attention_mask = attention_mask.to(dtype)

        t_seq, v_seq, t_pooled, v_pooled = self.bert(
            tokens, token_types, batch["loc"], attention_mask,
            batch["image_feat"], batch["image_loc"],
            batch["image_target"].long(), batch["image_mask"],
            batch.get("area"), rng)
        return t_seq, v_seq, self.cls(t_pooled, v_pooled, rng)

    def _heads(self, batch, hw_0, hv_0, nsp_logits) -> CRCTOutputs:
        """Regression head on the CLS states (hw_0 text, hv_0 vision),
        masked outputs and, in training, the losses; all in fp32."""
        B = hw_0.shape[0]
        # ---- regression (always computed; masked by needs_reg) ----------
        R = batch["R"].float()                        # [B, 4]
        needs_reg = R[:, 1] > 0
        zeros = torch.zeros(B, device=R.device)
        out = dict(reg_output=zeros, reg_loss=zeros, reg_l1=zeros,
                   reg_5_dist=zeros,
                   correct_regs=torch.zeros(B, dtype=torch.bool,
                                            device=R.device))
        out["correct_t_regs"] = out["correct_regs"]
        if self.has_regressor:
            floats = torch.tensor(DVQA_FLOATS, dtype=torch.float32,
                                  device=R.device)
            if self.ce_reg:
                out.update(self._ce_outputs(self.regressor(hv_0, hw_0), R,
                                            needs_reg, floats))
            else:
                out.update(self._reg_outputs(
                    self.regressor(hv_0, hw_0).float(), R, needs_reg,
                    floats))
        if self.training and "next_sentence_labels" in batch:
            labels = batch["next_sentence_labels"].reshape(B).long()
            logp = torch.log_softmax(nsp_logits, dim=-1)
            out["nsp_loss"] = -logp.gather(1, labels[:, None]).mean()
            # combined loss: nsp + mean-over-batch reg loss, zeros of
            # non-regression rows included (encoder_decorator.py:147-153)
            out["loss"] = (self.nsp_loss_coeff * out["nsp_loss"]
                           + self.reg_loss_coeff * out["reg_loss"].mean())
        return CRCTOutputs(nsp_logits=nsp_logits, needs_reg=needs_reg, **out)

    @staticmethod
    def _ce_outputs(probs, R, needs_reg, floats) -> Dict[str, torch.Tensor]:
        targets_idx = R[:, 0].long().clamp(0, len(DVQA_FLOATS) - 1)
        target_vals = floats[targets_idx]
        # the reference feeds the softmax output to CrossEntropyLoss
        # (regressor.py:73 + vilbert.py:1521) -- behaviour preserved
        logp = torch.log_softmax(probs, dim=-1)
        ce = -logp.gather(1, targets_idx[:, None])[:, 0]
        chosen = probs.argmax(dim=-1)
        value = floats[chosen]
        l1 = (value - target_vals).abs()
        correct = (chosen == R[:, 0].long()) & needs_reg
        zero = value.new_zeros(())
        reg_l1 = torch.where(needs_reg, l1, zero)
        return dict(reg_output=torch.where(needs_reg, value, zero),
                    reg_loss=torch.where(needs_reg, ce, zero),
                    reg_l1=reg_l1, reg_5_dist=reg_l1, correct_regs=correct,
                    correct_t_regs=correct)

    def _reg_outputs(self, regression, R, needs_reg, floats
                     ) -> Dict[str, torch.Tensor]:
        y_scale = torch.where(R[:, 3] == 0, 1.0, R[:, 3])
        reg_targets = R[:, 0] / y_scale
        if self.dataset == "dvqa" and not self.training:
            # clip to the nearest legal float (vilbert.py:1619-1625)
            denorm = regression * y_scale
            nearest = floats[(denorm[:, None] - floats[None, :]).abs()
                             .argmin(dim=-1)]
            regression = nearest / y_scale
        l1 = (regression - reg_targets).abs()
        per_row_loss = l1
        if self.training and not self.use_l1:
            # SmoothL1 beta=0.5 (vilbert.py:1528), zeroed for impossible
            # answers (vilbert.py:1639-1641)
            per_row_loss = torch.where(l1 < 0.5, 0.5 * l1 * l1 / 0.5,
                                       l1 - 0.25)
            per_row_loss = torch.where(reg_targets.abs() > 1.0, 0.0,
                                       per_row_loss)
        # +-5% relative distance with zero special cases (vilbert.py:1630-1636)
        target_zero = reg_targets == 0
        d5 = l1 / torch.where(target_zero, 1.0, reg_targets.abs())
        d5 = torch.where(target_zero, 1.0, d5)
        both_zero = (regression == 0) & target_zero
        d5 = torch.where(both_zero, 0.0, d5)
        correct = (d5 <= 0.05) | both_zero
        correct_t = l1 <= self.tol_margin
        zero = l1.new_zeros(())
        reg_l1 = torch.where(needs_reg, l1, zero)
        return dict(reg_output=torch.where(needs_reg, regression * y_scale,
                                           zero),
                    reg_loss=torch.where(needs_reg, per_row_loss, zero),
                    reg_l1=reg_l1,
                    reg_5_dist=torch.where(needs_reg, d5, zero),
                    correct_regs=correct & needs_reg,
                    correct_t_regs=correct_t & needs_reg)


def build_model(params: Dict[str, Any],
                config: Optional[CRCTModelConfig] = None, *,
                device="cuda", train: bool = False) -> CRCTModel:
    """A CRCTModel from a params dict, its weights initialized from a
    ``torch.Generator`` seeded by ``params['seed']``, on ``device``: in eval
    mode with the parameters in the compute dtype, or with ``train`` in
    training mode with fp32 parameters."""
    device = resolve_device(device)
    if config is None:
        if params.get("model_config"):
            config = CRCTModelConfig.from_json_file(params["model_config"])
        else:
            config = CRCTModelConfig()
    if params.get("bf16"):
        config.dtype = "bfloat16"
    if params.get("fast_scorer"):
        raise NotImplementedError("-fast_scorer is not ported yet")
    model = CRCTModel(config, categories=params.get("categories", 228) or 228,
                      dataset=params.get("dataset", "plotqa"),
                      ce_reg=params.get("CE_REG", False),
                      binary_answers=params.get("binary_answers", False),
                      tol_margin=params.get("tol_margin", 0.01),
                      mask_prob_img=params.get("mask_prob_img", 0.0) or 0.0,
                      use_l1=params.get("L1", False),
                      nsp_loss_coeff=params.get("nsp_loss_coeff", 1.0),
                      reg_loss_coeff=params.get("reg_loss_coeff", 1.0))
    generator = torch.Generator().manual_seed(int(params.get("seed", 0)))
    init_weights(model, generator)
    if train:
        return model.to(device).train()
    return model.set_compute_dtype().to(device).eval()
