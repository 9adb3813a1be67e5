"""Plain PyTorch reference of the CRCT QA model, its losses and its AdamW.

Written from the model's description (CRCT, arXiv:2111.14792: a ViLBERT
two-stream encoder with co-attention, CLS poolers fused by product, an NSP
answer-ranking head and a hybrid regressor) and the layout of the reference
repository's ``config/vilbert.json``. It is functional: the weights are a
dict of tensors under the reference's torch names, which the benchmark makes
from the seed and hands to the program and to this file alike. It imports
nothing of the program and nothing of JAX.

Every product goes through :func:`mm`, so that a control can compute the
same reference in a lower precision (``prec``): ``"fp32"`` (the reference:
fp32 with TF32 off), ``"tf32"`` (operands rounded to TF32, the precision
below fp32), ``"fp8"`` (the precision below bf16: the forward's
operands scaled per tensor into float8 e4m3, the backward's gradient into
e5m2) and ``"bf16"`` (every operand rounded to bf16: the rounding that the
configuration's precision itself brings, a scale for the others).

Dropout follows the configuration's stated scheme, so that the reference
draws the same masks as any implementation of it: every training forward
takes a CPU ``torch.Generator``; each attention call draws an int32 seed
from it for the murmur3 keep hash of the JAX package's attention kernels
(copied below), and the hidden dropouts draw U[0, 1) from one device
generator a forward, seeded from the CPU generator at its first draw. With
bf16 compute in the default attention mode the kept probabilities are
divided by bf16(1 - rate), as JAX's XLA path divides them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

MASK_VALUE = -10000.0
LN_EPS = 1e-12
INIT_STD = 0.02
B1, B2, EPS = 0.9, 0.999, 1e-8
EVAL_CHUNK = 240


# --------------------------------------------------------------------------
# configuration (a file of ``perfbench/configs``: "model" and "dataset")
# --------------------------------------------------------------------------

def param_spec(cfg: Dict[str, Any]) -> List[Tuple[str, Tuple[int, ...], str]]:
    """(name, shape, init) of every parameter, init one of "normal"
    (truncated normal, std 0.02, cut at two std), "zeros", "ones"."""
    m, d = cfg["model"], cfg["dataset"]
    H, VH, BI = m["hidden_size"], m["v_hidden_size"], m["bi_hidden_size"]
    FF, VFF = m["intermediate_size"], m["v_intermediate_size"]
    spec: List[Tuple[str, Tuple[int, ...], str]] = []

    def lin(name, i, o):
        spec.append((f"{name}.weight", (o, i), "normal"))
        spec.append((f"{name}.bias", (o,), "zeros"))

    def emb(name, n, h):
        spec.append((f"{name}.weight", (n, h), "normal"))

    def ln(name, h):
        spec.append((f"{name}.weight", (h,), "ones"))
        spec.append((f"{name}.bias", (h,), "zeros"))

    e = "bert.embeddings"
    emb(f"{e}.word_embeddings", m["vocab_size"], H)
    emb(f"{e}.position_embeddings", m["max_position_embeddings"], H)
    emb(f"{e}.plotqa_type_embeddings", m["plotqa_vocab_types"], H)
    lin(f"{e}.txt_location_embeddings", 4, H)
    ln(f"{e}.LayerNorm", H)
    v = "bert.v_embeddings"
    lin(f"{v}.new_image_embeddings", m["v_feature_size"], VH)
    lin(f"{v}.new_loc_emb", 4, VH)
    emb(f"{v}.color_emb", d["categories"] + 1, VH)
    if d["dataset"] == "figure_qa":
        lin(f"{v}.areas_emp", 1, VH)
    ln(f"{v}.LayerNorm", VH)

    def layer(p, h, ff):
        for n in ("query", "key", "value"):
            lin(f"{p}.attention.self.{n}", h, h)
        lin(f"{p}.attention.output.dense", h, h)
        ln(f"{p}.attention.output.LayerNorm", h)
        lin(f"{p}.intermediate.dense", h, ff)
        lin(f"{p}.output.dense", ff, h)
        ln(f"{p}.output.LayerNorm", h)

    for i in range(m["num_hidden_layers"]):
        layer(f"bert.encoder.layer.{i}", H, FF)
    for i in range(m["v_num_hidden_layers"]):
        layer(f"bert.encoder.v_layer.{i}", VH, VFF)
    for i in range(len(m["v_biattention_id"])):
        p = f"bert.encoder.c_layer.{i}"
        for n in ("query1", "key1", "value1"):
            lin(f"{p}.biattention.{n}", VH, BI)
        for n in ("query2", "key2", "value2"):
            lin(f"{p}.biattention.{n}", H, BI)
        lin(f"{p}.biOutput.dense1", BI, VH)
        ln(f"{p}.biOutput.LayerNorm1", VH)
        lin(f"{p}.biOutput.dense2", BI, H)
        ln(f"{p}.biOutput.LayerNorm2", H)
        lin(f"{p}.v_intermediate.dense", VH, VFF)
        lin(f"{p}.v_output.dense", VFF, VH)
        ln(f"{p}.v_output.LayerNorm", VH)
        lin(f"{p}.t_intermediate.dense", H, FF)
        lin(f"{p}.t_output.dense", FF, H)
        ln(f"{p}.t_output.LayerNorm", H)
    lin("bert.t_pooler.dense", H, BI)
    lin("bert.v_pooler.dense", VH, BI)
    lin("cls.bi_seq_relationship", BI, 2)
    if not d["binary_answers"]:
        for pipe, h in (("txt_pipe", H), ("vis_pipe", VH)):
            dims = (h, h, 512, 256, 256)
            for j in range(4):
                lin(f"regressor.{pipe}.{2 * j}", dims[j], dims[j + 1])
        dims = (512, 512, 256, 256, 1)
        for j in range(4):
            lin(f"regressor.fusion.{2 * j}", dims[j], dims[j + 1])
    return spec


# --------------------------------------------------------------------------
# precision of the products
# --------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to nearest on TF32's 10 mantissa bits."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _fp8(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """x scaled per tensor into the float8 format's range, rounded and
    back."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(fmt).max / amax
    return (x.float() * scale).to(fmt).float() / scale


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


ROUNDINGS = {
    # precision: (the forward's operands, the backward's gradient)
    "fp8": (_fp8, lambda g: _fp8(g, torch.float8_e5m2)),
    "bf16": (_bf16, _bf16),
}


class _RoundedMatmul(torch.autograd.Function):
    """a @ b with every operand rounded as a lower precision runs its
    products, fp32 sums: in fp8 e4m3 for the forward's operands and e5m2
    for the gradient that the backward's products take, as fp8 training
    does; in bf16 all of them."""

    @staticmethod
    def forward(ctx, a, b, prec):
        fwd, ctx.bwd = ROUNDINGS[prec]
        qa, qb = fwd(a), fwd(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = ctx.bwd(g)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        return _sum_to(ga, qa.shape), _sum_to(gb, qb.shape), None


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    if prec in ROUNDINGS:
        return _RoundedMatmul.apply(a, b, prec)
    if prec == "tf32":
        a = a + (_tf32(a.detach()) - a.detach())       # straight through
        b = b + (_tf32(b.detach()) - b.detach())
    return torch.matmul(a, b)


def linear(x, W, name, prec="fp32"):
    return mm(x, W[f"{name}.weight"].t(), prec) + W[f"{name}.bias"]


def layer_norm(x, W, name):
    return F.layer_norm(x, x.shape[-1:], W[f"{name}.weight"],
                        W[f"{name}.bias"], LN_EPS)


# --------------------------------------------------------------------------
# dropout: the configuration's keep hash and generators
# --------------------------------------------------------------------------

def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & 0xFFFFFFFF


def _uniform_hash(seed, i0, i1, i2) -> torch.Tensor:
    """U[0, 1) from the uint32 murmur3 finalizer of (seed, position)."""
    h = _mul32(i0, 0x9E3779B9)
    h = h ^ _mul32(i1, 0x85EBCA6B)
    h = h ^ _mul32(i2, 0xC2B2AE35)
    h = (h + _mul32(seed, 2654435761)) & 0xFFFFFFFF
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    bits = ((h >> 9) | 0x3F800000).to(torch.int32)
    return bits.view(torch.float32) - 1.0


def keep_mask(shape, seed: int, rate: float, device) -> torch.Tensor:
    """[B, H, Lq, Lk] bool: the keep draws of the attention kernels' grid,
    one program a (row, block of heads), heads in blocks of 8, 4, 2 or 1."""
    B, H, Lq, Lk = shape
    hb = next(h for h in (8, 4, 2, 1) if H % h == 0)
    i64 = dict(device=device, dtype=torch.int64)
    b = torch.arange(B, **i64).view(B, 1, 1, 1)
    h = torch.arange(H, **i64).view(1, H, 1, 1)
    prog = b * (H // hb) + h // hb
    prog_seed = ((seed & 0xFFFFFFFF) + _mul32(prog, 1000003)) & 0xFFFFFFFF
    i1 = torch.arange(Lq, **i64).view(1, 1, Lq, 1)
    i2 = torch.arange(Lk, **i64).view(1, 1, 1, Lk)
    u = _uniform_hash(prog_seed, h % hb, i1, i2)
    return u >= float(np.float32(rate))


class Draws:
    """The randomness of one training forward (see the module's doc)."""

    def __init__(self, generator: torch.Generator, device):
        self.generator = generator
        self.device = torch.device(device)
        self._dev: Optional[torch.Generator] = None

    def seed(self) -> int:
        return int(torch.randint(0, 2 ** 31 - 1, (),
                                 generator=self.generator))

    def uniform(self, shape) -> torch.Tensor:
        if self._dev is None:
            self._dev = torch.Generator(self.device)
            self._dev.manual_seed(self.seed())
        return torch.rand(tuple(shape), generator=self._dev,
                          device=self.device)

    def dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        keep = self.uniform(x.shape) >= p
        return torch.where(keep, x / (1.0 - p), x.new_zeros(()))


def _drop(x, p, draws):
    return draws.dropout(x, p) if draws is not None and p > 0 else x


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def attention(q, k, v, mask, rate, draws, keep_divisor, prec):
    """softmax(q k^T / sqrt(D) + mask) with the keep mask, times v; q, k, v
    [B, H, L, D] fp32."""
    scale = float(np.float32(1.0 / math.sqrt(q.shape[-1])))
    s = mm(q, k.transpose(-1, -2), prec) * scale + mask
    p = torch.softmax(s, dim=-1)
    if draws is not None and rate > 0:
        kept = keep_mask(tuple(p.shape), draws.seed(), rate, p.device)
        p = torch.where(kept, p / keep_divisor, p.new_zeros(()))
    return mm(p, v, prec)


def _heads(x, n):
    b, l, d = x.shape
    return x.view(b, l, n, d // n).transpose(1, 2)


def _merge(x):
    b, h, l, d = x.shape
    return x.transpose(1, 2).reshape(b, l, h * d)


class Forward:
    """One forward of the model under weights ``W`` (``ctx`` holds the
    configuration, the dropout draws and the precision)."""

    def __init__(self, cfg, W, draws=None, prec="fp32", keep_divisor=None):
        self.m, self.d = cfg["model"], cfg["dataset"]
        self.W, self.draws, self.prec = W, draws, prec
        rate = self.m["attention_probs_dropout_prob"]
        self.keep_divisor = keep_divisor or (1.0 - rate)

    def lin(self, x, name):
        return linear(x, self.W, name, self.prec)

    def output(self, h, residual, name, p):
        h = _drop(self.lin(h, f"{name}.dense"), p, self.draws)
        return layer_norm(h + residual, self.W, f"{name}.LayerNorm")

    def self_attention(self, x, mask, name, heads, p_attn, p_hidden):
        q = _heads(self.lin(x, f"{name}.attention.self.query"), heads)
        k = _heads(self.lin(x, f"{name}.attention.self.key"), heads)
        v = _heads(self.lin(x, f"{name}.attention.self.value"), heads)
        ctx = attention(q, k, v, mask, p_attn, self.draws, self.keep_divisor,
                        self.prec)
        return self.output(_merge(ctx), x, f"{name}.attention.output",
                           p_hidden)

    def layer(self, x, mask, name, heads, p_attn, p_hidden):
        x = self.self_attention(x, mask, name, heads, p_attn, p_hidden)
        h = F.gelu(self.lin(x, f"{name}.intermediate.dense"))
        return self.output(h, x, f"{name}.output", p_hidden)

    def connection(self, v_in, v_mask, t_in, t_mask, name):
        m, n = self.m, self.m["bi_num_attention_heads"]
        b = f"{name}.biattention"
        ctx1 = attention(_heads(self.lin(t_in, f"{b}.query2"), n),
                         _heads(self.lin(v_in, f"{b}.key1"), n),
                         _heads(self.lin(v_in, f"{b}.value1"), n), v_mask,
                         m["v_attention_probs_dropout_prob"], self.draws,
                         self.keep_divisor, self.prec)
        ctx2 = attention(_heads(self.lin(v_in, f"{b}.query1"), n),
                         _heads(self.lin(t_in, f"{b}.key2"), n),
                         _heads(self.lin(t_in, f"{b}.value2"), n), t_mask,
                         m["attention_probs_dropout_prob"], self.draws,
                         self.keep_divisor, self.prec)
        o = f"{name}.biOutput"
        h1 = _drop(self.lin(_merge(ctx2), f"{o}.dense1"),
                   m["v_hidden_dropout_prob"], self.draws)
        v_out = layer_norm(h1 + v_in, self.W, f"{o}.LayerNorm1")
        h2 = _drop(self.lin(_merge(ctx1), f"{o}.dense2"),
                   m["hidden_dropout_prob"], self.draws)
        t_out = layer_norm(h2 + t_in, self.W, f"{o}.LayerNorm2")
        v_out = self.output(F.gelu(self.lin(v_out,
                                            f"{name}.v_intermediate.dense")),
                            v_out, f"{name}.v_output",
                            m["v_hidden_dropout_prob"])
        t_out = self.output(F.gelu(self.lin(t_out,
                                            f"{name}.t_intermediate.dense")),
                            t_out, f"{name}.t_output", m["hidden_dropout_prob"])
        return v_out, t_out

    def text_embeddings(self, tokens, types, loc):
        W, e = self.W, "bert.embeddings"
        B, L = tokens.shape
        is_qa = (types == -1) | (types == 1)
        pos = torch.arange(L, device=tokens.device).expand(B, L)
        masked = torch.where(is_qa, pos, L)
        rel = torch.where(is_qa, masked - masked.min(-1, keepdim=True).values,
                          0)
        word = W[f"{e}.word_embeddings.weight"][tokens]
        pos_emb = torch.where(is_qa[..., None],
                              W[f"{e}.position_embeddings.weight"][rel], 0.0)
        loc_emb = self.lin(loc.float(), f"{e}.txt_location_embeddings")
        loc_emb = torch.where((loc.abs().sum(-1) == 0)[..., None], 0.0,
                              loc_emb)
        type_emb = torch.where(
            (types == 0)[..., None], 0.0,
            W[f"{e}.plotqa_type_embeddings.weight"][
                torch.where(types == -1, 0, types)])
        emb = layer_norm(word + pos_emb + type_emb + loc_emb, W,
                         f"{e}.LayerNorm")
        return _drop(emb, self.m["hidden_dropout_prob"], self.draws)

    def image_embeddings(self, feat, loc, cls, area):
        W, v = self.W, "bert.v_embeddings"
        emb = (self.lin(loc.float(), f"{v}.new_loc_emb")
               + W[f"{v}.color_emb.weight"][cls])
        if self.d["dataset"] not in ("figure_qa", "dvqa"):
            emb = emb + self.lin(torch.softmax(feat.float(), -1),
                                 f"{v}.new_image_embeddings")
        if area is not None:
            emb = emb + self.lin(area.float()[..., None], f"{v}.areas_emp")
        emb = layer_norm(emb, W, f"{v}.LayerNorm")
        return _drop(emb, self.m["hidden_dropout_prob"], self.draws)

    def encode(self, batch):
        m = self.m
        tokens = batch["tokens"].long()
        B, L = tokens.shape
        sep = batch["sep_indices"].long()
        hist = batch["hist_len"].long().reshape(B)
        seq_len = sep.gather(1, hist[:, None])[:, 0] + 1
        t_keep = (torch.arange(L, device=tokens.device)[None] < seq_len[:, None])
        t_mask = ((1.0 - t_keep.float()) * MASK_VALUE)[:, None, None, :]
        v_mask = ((1.0 - batch["image_mask"].float())
                  * MASK_VALUE)[:, None, None, :]
        t = self.text_embeddings(tokens, batch["segments"].long(),
                                 batch["loc"])
        v = self.image_embeddings(batch["image_feat"], batch["image_loc"],
                                  batch["image_target"].long(),
                                  batch.get("area"))
        tl = lambda x, i: self.layer(                       # noqa: E731
            x, t_mask, f"bert.encoder.layer.{i}", m["num_attention_heads"],
            m["attention_probs_dropout_prob"], m["hidden_dropout_prob"])
        vl = lambda x, i: self.layer(                       # noqa: E731
            x, v_mask, f"bert.encoder.v_layer.{i}",
            m["v_num_attention_heads"], m["v_attention_probs_dropout_prob"],
            m["v_hidden_dropout_prob"])
        v_start = t_start = 0
        for c, (v_end, t_end) in enumerate(zip(m["v_biattention_id"],
                                               m["t_biattention_id"])):
            for i in range(v_start, v_end):
                v = vl(v, i)
            for i in range(t_start, t_end):
                t = tl(t, i)
            v, t = self.connection(v, v_mask, t, t_mask,
                                   f"bert.encoder.c_layer.{c}")
            v_start, t_start = v_end, t_end
        for i in range(v_start, m["v_num_hidden_layers"]):
            v = vl(v, i)
        for i in range(t_start, m["num_hidden_layers"]):
            t = tl(t, i)
        return t, v

    def regressor(self, hv0, hw0):
        W = self.W

        def pipe(x, name, n):
            for j in range(n):
                x = linear(x, W, f"{name}.{2 * j}")
                if j < n - 1:
                    x = F.leaky_relu(x)
            return x

        pre = torch.cat([pipe(hv0, "regressor.vis_pipe", 4),
                         pipe(hw0, "regressor.txt_pipe", 4)], -1)
        x = pipe(pre, "regressor.fusion", 3)
        x = linear(F.leaky_relu(x), W, "regressor.fusion.6")
        return torch.tanh(x)[..., 0]

    def __call__(self, batch, train: bool) -> Dict[str, torch.Tensor]:
        t, v = self.encode(batch)
        t_pool = F.relu(self.lin(t[:, 0], "bert.t_pooler.dense"))
        v_pool = F.relu(self.lin(v[:, 0], "bert.v_pooler.dense"))
        fused = _drop(t_pool * v_pool, 0.1, self.draws)
        logits = self.lin(fused, "cls.bi_seq_relationship")
        out = {"nsp_logits": logits}
        R = batch["R"].float()
        needs = R[:, 1] > 0
        reg_loss = torch.zeros_like(R[:, 0])
        out["reg_output"] = torch.zeros_like(R[:, 0])
        if not self.d["binary_answers"]:
            reg = self.regressor(v[:, 0], t[:, 0])
            y = torch.where(R[:, 3] == 0, 1.0, R[:, 3])
            target = R[:, 0] / y
            l1 = (reg - target).abs()
            per_row = l1
            if train:
                per_row = torch.where(l1 < 0.5, l1 * l1, l1 - 0.25)
                per_row = torch.where(target.abs() > 1.0, 0.0, per_row)
            reg_loss = torch.where(needs, per_row, 0.0)
            out["reg_output"] = torch.where(needs, reg * y, 0.0)
            out["reg_norm"] = torch.where(needs, reg, 0.0)
        if train:
            labels = batch["next_sentence_labels"].reshape(-1).long()
            nsp = -torch.log_softmax(logits, -1).gather(
                1, labels[:, None]).mean()
            out["nsp_loss"] = nsp
            out["loss"] = nsp + reg_loss.mean()
        return out


# --------------------------------------------------------------------------
# training: forward, backward and AdamW
# --------------------------------------------------------------------------

def needs_decay(name: str) -> bool:
    return not (name.endswith(".bias") or "LayerNorm" in name)


def lr_at(hp: Dict[str, float], count: int) -> float:
    """Linear warm-up to ``lr``, linear decay to 0 over ``t_total``,
    floored at ``min_lr``, in fp32, at the update count before the update."""
    f32 = np.float32
    step = f32(count)
    warm = step / f32(max(1.0, float(hp["warmup"])))
    decay = max(f32(0.0), (f32(hp["t_total"]) - step)
                / f32(max(1.0, hp["t_total"] - hp["warmup"])))
    lr = f32(hp["lr"]) * (warm if step < hp["warmup"] else decay)
    return float(max(lr, f32(hp["min_lr"])))


SKETCH_ROWS = 4


def sketch(index: int, g: torch.Tensor) -> torch.Tensor:
    """``SKETCH_ROWS`` Gaussian projections of a leaf's gradient, the
    projections drawn from a generator seeded by the leaf's index: the
    same on both sides, so that the sketches' difference estimates the
    gradients' (a norm of the difference, which the norms' gap cannot
    see)."""
    gen = torch.Generator(g.device)
    gen.manual_seed(1000003 * (index + 1))
    r = torch.randn((SKETCH_ROWS, g.numel()), generator=gen, device=g.device)
    return r @ g.reshape(-1).float()


def train_steps(cfg, W0: Dict[str, torch.Tensor], batches: Sequence[Dict],
                generator: torch.Generator, hp: Dict[str, float],
                keep_divisor: float, prec: str = "fp32",
                rows: Optional[int] = None) -> Dict[str, Any]:
    """Train a copy of ``W0`` on ``batches``, one AdamW update each (4
    groups: decay on all but biases and LayerNorm, one learning rate
    schedule), drawing dropout from ``generator``. Returns each step's
    loss, the first step's gradient norm and sketch by leaf and the norm of
    each leaf's change over all the steps. ``rows`` keeps only the first rows
    of every batch (a fault: the rest of the batch left out). The leaves
    are taken in ``W0``'s order, which :func:`sketch` indexes."""
    W = {k: v.detach().clone().requires_grad_() for k, v in W0.items()}
    mu = {k: torch.zeros_like(v) for k, v in W.items()}
    nu = {k: torch.zeros_like(v) for k, v in W.items()}
    losses, grad_norms = [], None
    for count, batch in enumerate(batches):
        if rows is not None:
            batch = {k: v[:rows] for k, v in batch.items()}
        device = batch["tokens"].device
        out = Forward(cfg, W, Draws(generator, device), prec,
                      keep_divisor)(batch, train=True)
        for v in W.values():
            v.grad = None
        out["loss"].backward()
        losses.append(float(out["loss"].detach()))
        grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                 for k, v in W.items()}
        if grad_norms is None:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
            sketches = {k: sketch(i, g).cpu()
                        for i, (k, g) in enumerate(grads.items())}
        lr = lr_at(hp, count)
        c1 = float(1.0 - np.float32(B1) ** np.float32(count + 1))
        c2 = float(1.0 - np.float32(B2) ** np.float32(count + 1))
        with torch.no_grad():
            for k, p in W.items():
                g = grads[k]
                mu[k] = (1 - B1) * g + B1 * mu[k]
                nu[k] = B2 * nu[k] + (1 - B2) * g * g
                upd = (mu[k] / c1) / ((nu[k] / c2).sqrt() + EPS)
                if needs_decay(k) and hp["wd"] > 0:
                    upd = upd + hp["wd"] * p
                p.add_(upd, alpha=-lr)
        del out, grads
    with torch.no_grad():
        change = {k: float((W[k] - W0[k]).norm()) for k in W}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change,
            "grad_sketches": sketches}


# --------------------------------------------------------------------------
# evaluation: candidate rows scored in chunks
# --------------------------------------------------------------------------

@torch.no_grad()
def score_rows(cfg, W, rows: Dict[str, torch.Tensor], prec: str = "fp32",
               chunk: int = EVAL_CHUNK) -> Dict[str, torch.Tensor]:
    """Per row: the NSP probability of the positive class (what the
    candidates are ranked by), the regression output and the regression
    output in normalized units, in eval mode (no dropout)."""
    n = rows["tokens"].shape[0]
    outs: Dict[str, List[torch.Tensor]] = {"nsp_prob": [], "reg_output": [],
                                           "reg_norm": []}
    for s in range(0, n, chunk):
        piece = {k: v[s:s + chunk] for k, v in rows.items()}
        o = Forward(cfg, W, None, prec)(piece, train=False)
        outs["nsp_prob"].append(torch.softmax(o["nsp_logits"], -1)[:, 0])
        outs["reg_output"].append(o["reg_output"])
        outs["reg_norm"].append(o.get("reg_norm", o["reg_output"]))
    return {k: torch.cat(v) for k, v in outs.items()}


@contextlib.contextmanager
def fp32_matmuls():
    """Products in plain fp32 on the card (TF32 off) while the reference
    runs; restores the previous settings."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
