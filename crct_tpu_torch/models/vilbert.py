"""The two-stream (text/vision) co-attention encoder ("ViLBERT-style").

The port of ``crct_tpu/models/vilbert.py``: text embeddings with location
and chart-element-type embeddings, vision embeddings over detector RoI
features, the interleaved self-attention / co-attention schedule driven by
(v_biattention_id, t_biattention_id), CLS poolers, fusion and the NSP
answer-ranking head. Module attributes carry the reference torch names
(``bert.embeddings.*``, ``bert.encoder.layer.N``, ``bert.encoder.c_layer.N``).
In training mode, with a ``DropoutRNG``, the embeddings, the layers and the
pooled fusion apply dropout and the image embeddings the ``mask_prob_img``
keep draw, as in the JAX modules; in eval mode nothing is drawn.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from crct_tpu_torch.config import CRCTModelConfig
from crct_tpu_torch.models.layers import (ConnectionLayer, TransformerLayer,
                                          dropout, extended_attention_mask)


class TextEmbeddings(nn.Module):
    """word + position + chart-element-type + location embeddings
    (reference BertEmbeddingLocation, vilbert.py:297-358).

    Position ids count only Q (type -1) and A (type 1) tokens, starting at 0
    from the first such token; all other positions embed as zero. Location
    embeddings are zeroed where the 4-d loc is all-zero. Type embeddings use
    slot 0 for Q tokens and are zeroed for type-0 (CLS/padding) tokens.
    """

    def __init__(self, cfg: CRCTModelConfig):
        super().__init__()
        h = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, h)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, h)
        self.plotqa_type_embeddings = nn.Embedding(cfg.plotqa_vocab_types, h)
        self.txt_location_embeddings = nn.Linear(4, h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)
        self.hidden_dropout = cfg.hidden_dropout_prob

    def forward(self, input_ids, token_type_ids, loc, rng=None):
        B, L = input_ids.shape
        is_qa = ((token_type_ids == -1) | (token_type_ids == 1))[..., None]
        positions = torch.arange(L, device=input_ids.device).expand(B, L)
        # non-QA positions -> L, subtract the per-row min, then zero them
        masked_pos = torch.where(is_qa[..., 0], positions, L)
        first_qa = masked_pos.min(dim=-1, keepdim=True).values
        rel_pos = torch.where(is_qa[..., 0], masked_pos - first_qa, 0)

        word_emb = self.word_embeddings(input_ids)
        zero = word_emb.new_zeros(())
        pos_emb = torch.where(is_qa, self.position_embeddings(rel_pos), zero)
        loc_emb = self.txt_location_embeddings(loc.to(word_emb.dtype))
        loc_emb = torch.where((loc.abs().sum(dim=-1) == 0)[..., None], zero,
                              loc_emb)
        # type id -1 (Q) embeds from slot 0; nn.Embedding rejects -1
        type_ids = torch.where(token_type_ids == -1, 0, token_type_ids)
        type_emb = torch.where((token_type_ids == 0)[..., None], zero,
                               self.plotqa_type_embeddings(type_ids))
        emb = self.LayerNorm(word_emb + pos_emb + type_emb + loc_emb)
        return dropout(self, emb, self.hidden_dropout, rng)


class ImageEmbeddings(nn.Module):
    """Detector-feature embeddings (reference BertImageEmbeddings,
    vilbert.py:1444-1496): softmax over the RoI feature then a linear
    projection, plus 4-d location and class ("color") embeddings; figure_qa /
    dvqa drop the RoI features, figure_qa adds an area embedding. In
    training, each region's embedding is kept with probability
    1 - mask_prob_img before the LayerNorm (crct_tpu/models/vilbert.py:98-100)
    and dropout follows it."""

    def __init__(self, cfg: CRCTModelConfig, categories: int,
                 dataset: str = "plotqa", mask_prob_img: float = 0.0):
        super().__init__()
        h = cfg.v_hidden_size
        self.dataset = dataset
        self.mask_prob_img = mask_prob_img
        self.hidden_dropout = cfg.hidden_dropout_prob
        self.new_image_embeddings = nn.Linear(cfg.v_feature_size, h)
        self.new_loc_emb = nn.Linear(4, h)
        self.color_emb = nn.Embedding(categories + 1, h)
        if dataset == "figure_qa":
            self.areas_emp = nn.Linear(1, h)
        self.LayerNorm = nn.LayerNorm(h, eps=cfg.layer_norm_eps)

    def forward(self, image_feat, image_loc, image_class, areas=None,
                rng=None):
        dtype = self.new_loc_emb.weight.dtype
        loc_emb = self.new_loc_emb(image_loc.to(dtype))
        color_emb = self.color_emb(image_class)
        if self.dataset in ("figure_qa", "dvqa"):
            emb = loc_emb + color_emb
        else:
            img_emb = self.new_image_embeddings(
                F.softmax(image_feat.to(dtype), dim=-1))
            emb = img_emb + loc_emb + color_emb
        if areas is not None:
            emb = emb + self.areas_emp(areas.to(dtype)[..., None])
        if self.training and rng is not None and self.mask_prob_img > 0:
            keep = rng.uniform(emb.shape[:2]) >= self.mask_prob_img
            emb = emb * keep[..., None]
        return dropout(self, self.LayerNorm(emb), self.hidden_dropout, rng)


class TwoStreamEncoder(nn.Module):
    """Interleaved v/t self-attention + co-attention schedule
    (reference BertEncoder, vilbert.py:791-946): for plotqa t0..t5, then
    [c0, v0, t6, c1, v1, t7, ..., c5], then v5, t11."""

    def __init__(self, cfg: CRCTModelConfig):
        super().__init__()
        self.config = cfg
        eps = cfg.layer_norm_eps
        self.layer = nn.ModuleList(
            TransformerLayer(cfg.hidden_size, cfg.num_attention_heads,
                             cfg.intermediate_size, cfg.hidden_act, eps,
                             cfg.attention_probs_dropout_prob,
                             cfg.hidden_dropout_prob)
            for _ in range(cfg.num_hidden_layers))
        self.v_layer = nn.ModuleList(
            TransformerLayer(cfg.v_hidden_size, cfg.v_num_attention_heads,
                             cfg.v_intermediate_size, cfg.v_hidden_act, eps,
                             cfg.v_attention_probs_dropout_prob,
                             cfg.v_hidden_dropout_prob)
            for _ in range(cfg.v_num_hidden_layers))
        self.c_layer = nn.ModuleList(
            ConnectionLayer(cfg.v_hidden_size, cfg.hidden_size,
                            cfg.bi_hidden_size, cfg.bi_num_attention_heads,
                            cfg.v_intermediate_size, cfg.intermediate_size,
                            cfg.v_hidden_act, cfg.hidden_act, eps,
                            cfg.v_attention_probs_dropout_prob,
                            cfg.attention_probs_dropout_prob,
                            cfg.v_hidden_dropout_prob,
                            cfg.hidden_dropout_prob)
            for _ in range(len(cfg.v_biattention_id)))

    def forward(self, t_emb, v_emb, t_mask, v_mask, rng=None):
        cfg = self.config
        v_start = t_start = 0
        B = t_emb.shape[0]
        for count, (v_end, t_end) in enumerate(
                zip(cfg.v_biattention_id, cfg.t_biattention_id)):
            for idx in range(v_start, v_end):
                v_emb = self.v_layer[idx](v_emb, v_mask, rng)
                if idx < cfg.fixed_v_layer:
                    # frozen prefix (reference no_grad, vilbert.py:860-866)
                    v_emb = v_emb.detach()
            for idx in range(t_start, t_end):
                t_emb = self.layer[idx](t_emb, t_mask, rng)
                if idx < cfg.fixed_t_layer:
                    t_emb = t_emb.detach()
            if count == 0 and cfg.in_batch_pairs:
                # batch^2 expansion: every text paired with every image
                # (reference vilbert.py:888-895)
                v_emb = v_emb.repeat(B, 1, 1)
                v_mask = v_mask.repeat(B, 1, 1, 1)
                t_emb = t_emb.repeat_interleave(B, dim=0)
                t_mask = t_mask.repeat_interleave(B, dim=0)
            if count == 0 and cfg.fast_mode:
                # broadcast one text row over the image batch
                # (reference vilbert.py:897-899)
                t_emb = t_emb.expand((v_emb.shape[0],) + t_emb.shape[1:])
                t_mask = t_mask.expand((v_emb.shape[0],) + t_mask.shape[1:])
            if cfg.with_coattention:
                v_emb, t_emb = self.c_layer[count](v_emb, v_mask, t_emb,
                                                   t_mask, rng)
            v_start, t_start = v_end, t_end
        for idx in range(v_start, cfg.v_num_hidden_layers):
            v_emb = self.v_layer[idx](v_emb, v_mask, rng)
        for idx in range(t_start, cfg.num_hidden_layers):
            t_emb = self.layer[idx](t_emb, t_mask, rng)
        return t_emb, v_emb


class Pooler(nn.Module):
    """CLS-state pooler: Linear(->bi_hidden) + ReLU
    (reference BertTextPooler/BertImagePooler, vilbert.py:949-976)."""

    def __init__(self, hidden_size: int, bi_hidden_size: int):
        super().__init__()
        self.dense = nn.Linear(hidden_size, bi_hidden_size)

    def forward(self, hidden_states):
        return F.relu(self.dense(hidden_states[:, 0]))


class TwoStreamEncoderModel(nn.Module):
    """Full backbone: embeddings -> encoder -> poolers
    (reference BertModel, vilbert.py:1288-1441)."""

    def __init__(self, cfg: CRCTModelConfig, categories: int,
                 dataset: str = "plotqa", mask_prob_img: float = 0.0):
        super().__init__()
        self.embeddings = TextEmbeddings(cfg)
        self.v_embeddings = ImageEmbeddings(cfg, categories, dataset,
                                            mask_prob_img)
        self.encoder = TwoStreamEncoder(cfg)
        self.t_pooler = Pooler(cfg.hidden_size, cfg.bi_hidden_size)
        self.v_pooler = Pooler(cfg.v_hidden_size, cfg.bi_hidden_size)

    def forward(self, input_ids, token_type_ids, txt_loc, attention_mask,
                image_feat, image_loc, image_class, image_mask, areas=None,
                rng=None):
        dtype = self.t_pooler.dense.weight.dtype
        t_mask = extended_attention_mask(attention_mask, dtype)
        v_mask = extended_attention_mask(image_mask, dtype)
        t_emb = self.embeddings(input_ids, token_type_ids, txt_loc, rng)
        v_emb = self.v_embeddings(image_feat, image_loc, image_class, areas,
                                  rng)
        t_seq, v_seq = self.encoder(t_emb, v_emb, t_mask, v_mask, rng)
        return t_seq, v_seq, self.t_pooler(t_seq), self.v_pooler(v_seq)


class PreTrainingHeads(nn.Module):
    """Fusion (mul/sum) + dropout 0.1 in training + NSP answer-ranking head
    (reference BertPreTrainingHeads, vilbert.py:1038-1062)."""

    def __init__(self, cfg: CRCTModelConfig):
        super().__init__()
        if cfg.fusion_method not in ("sum", "mul"):
            raise ValueError(cfg.fusion_method)
        self.fusion_method = cfg.fusion_method
        self.bi_seq_relationship = nn.Linear(cfg.bi_hidden_size, 2)

    def forward(self, t_pooled, v_pooled, rng=None):
        pooled = (t_pooled + v_pooled if self.fusion_method == "sum"
                  else t_pooled * v_pooled)
        return self.bi_seq_relationship(dropout(self, pooled, 0.1, rng))
