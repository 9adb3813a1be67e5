"""Building blocks: transformer layers and bi-attention, in PyTorch.

The port of ``crct_tpu/models/layers.py``. Attributes carry the reference
torch names (``attention.self.query``, ``biattention.query1``,
``biOutput.dense1``, ...; crct_tpu/utils/convert.py:75-108), so a JAX tree
carried across by ``utils.convert.flax_to_state_dict`` and a reference
``crct.ckpt`` both load with ``strict=True``. The JAX ``FeedForward`` is the
reference's (``intermediate``, ``output``) pair here, because its two halves
sit under those names in the state dict.

The attention core is :func:`crct_tpu_torch.ops.attention.fused_attention`:
the CUDA kernels on the card (forward and backward), their plain versions
on the CPU. Masks are additive (0 / -10000), [B, 1, 1, L] per stream.

Dropout runs only in training mode and only when the forward is handed a
:class:`DropoutRNG`: each attention call draws its own int32 seed for the
kernels' dropout hash (where the JAX layers call ``make_rng("dropout")``),
and hidden dropout follows the attention output and the FFN
(crct_tpu/models/layers.py:103,123). The eval path draws nothing.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from crct_tpu_torch.ops.attention import fused_attention

MASK_VALUE = -10000.0
LAYER_NORM_EPS = 1e-12

# reference init (init_bert_weights, vilbert.py:1099-1110): truncated normal
# for every Linear/Embedding weight, biases zero, LayerNorm (1, 0). As in
# flax's truncated_normal(stddev=0.02), 0.02 is the std of the normal before
# it is cut at two of its standard deviations.
INIT_STD = 0.02


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Deterministic reference init of every submodule from ``generator``."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Embedding)):
            nn.init.trunc_normal_(m.weight, std=INIT_STD, a=-2 * INIT_STD,
                                  b=2 * INIT_STD, generator=generator)
            if getattr(m, "bias", None) is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)


class DropoutRNG:
    """The randomness of one training forward, all of it drawn from one
    ``torch.Generator`` on the CPU that the trainer owns: an int32 seed per
    attention call for the kernels' dropout hash, and hidden-dropout masks
    from a generator on the activations' device seeded from it once."""

    def __init__(self, generator: torch.Generator, device):
        self.generator = generator
        self.device = torch.device(device)
        self._device_generator: Optional[torch.Generator] = None

    def seed(self) -> int:
        """A fresh seed in [0, 2**31 - 1), the range the JAX layers draw."""
        return int(torch.randint(0, 2 ** 31 - 1, (),
                                 generator=self.generator))

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        """U[0, 1) fp32 of ``shape`` on the device."""
        if self._device_generator is None:
            self._device_generator = torch.Generator(self.device)
            self._device_generator.manual_seed(self.seed())
        return torch.rand(tuple(shape), generator=self._device_generator,
                          device=self.device)

    def dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        """flax ``nn.Dropout``: keep with probability 1 - p, scaled up."""
        if p <= 0.0:
            return x
        keep = self.uniform(x.shape) >= p
        return torch.where(keep, x / (1.0 - p), x.new_zeros(()))


def dropout(module: nn.Module, x: torch.Tensor, p: float,
            rng: Optional[DropoutRNG]) -> torch.Tensor:
    """Hidden dropout of ``module``: only in training mode with an rng."""
    if module.training and rng is not None:
        return rng.dropout(x, p)
    return x


def attention_seed(module: nn.Module, p: float,
                   rng: Optional[DropoutRNG]) -> tuple:
    """(rate, seed) of one attention call: a fresh seed in training mode
    with an rng, else no dropout."""
    if module.training and rng is not None and p > 0.0:
        return p, rng.seed()
    return 0.0, 0


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU (reference vilbert.py:111-117)."""
    return F.gelu(x)


ACT2FN = {"gelu": gelu, "relu": F.relu, "swish": F.silu}


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, L, H*Dh] -> contiguous [B, H, L, Dh] (the kernel's layout)."""
    b, l, d = x.shape
    return (x.view(b, l, num_heads, d // num_heads).transpose(1, 2)
            .contiguous())


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


def extended_attention_mask(mask: torch.Tensor,
                            dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """[B, L] {0,1} -> additive [B, 1, 1, L] (reference vilbert.py:1380-1396)."""
    m = mask.to(dtype)
    return ((1.0 - m) * MASK_VALUE)[:, None, None, :]


class _QKV(nn.Module):
    """The query/key/value projections (reference BertSelfAttention)."""

    def __init__(self, hidden_size: int):
        super().__init__()
        self.query = nn.Linear(hidden_size, hidden_size)
        self.key = nn.Linear(hidden_size, hidden_size)
        self.value = nn.Linear(hidden_size, hidden_size)


class Output(nn.Module):
    """dense -> dropout -> LayerNorm(out + residual) (reference
    BertSelfOutput / BertOutput)."""

    def __init__(self, in_size: int, hidden_size: int,
                 eps: float = LAYER_NORM_EPS, hidden_dropout: float = 0.0):
        super().__init__()
        self.dense = nn.Linear(in_size, hidden_size)
        self.LayerNorm = nn.LayerNorm(hidden_size, eps=eps)
        self.hidden_dropout = hidden_dropout

    def forward(self, h: torch.Tensor, residual: torch.Tensor,
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        h = dropout(self, self.dense(h), self.hidden_dropout, rng)
        return self.LayerNorm(h + residual)


class Intermediate(nn.Module):
    """dense -> activation (reference BertIntermediate)."""

    def __init__(self, hidden_size: int, intermediate_size: int, act: str):
        super().__init__()
        self.dense = nn.Linear(hidden_size, intermediate_size)
        self.act = ACT2FN[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.dense(x))


class SelfAttention(nn.Module):
    """QKV self-attention + output projection + LN residual
    (reference BertAttention, vilbert.py:361-440)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 eps: float = LAYER_NORM_EPS, attn_dropout: float = 0.0,
                 hidden_dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_dropout = attn_dropout
        self.self = _QKV(hidden_size)
        self.output = Output(hidden_size, hidden_size, eps, hidden_dropout)

    def forward(self, x: torch.Tensor, additive_mask: Optional[torch.Tensor],
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        H = self.num_heads
        ctx = fused_attention(split_heads(self.self.query(x), H),
                              split_heads(self.self.key(x), H),
                              split_heads(self.self.value(x), H),
                              additive_mask,
                              *attention_seed(self, self.attn_dropout, rng))
        return self.output(merge_heads(ctx), x, rng)


class TransformerLayer(nn.Module):
    """Self-attention block + FFN (reference BertLayer / BertImageLayer)."""

    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int, hidden_act: str,
                 eps: float = LAYER_NORM_EPS, attn_dropout: float = 0.0,
                 hidden_dropout: float = 0.0):
        super().__init__()
        self.attention = SelfAttention(hidden_size, num_heads, eps,
                                       attn_dropout, hidden_dropout)
        self.intermediate = Intermediate(hidden_size, intermediate_size,
                                         hidden_act)
        self.output = Output(intermediate_size, hidden_size, eps,
                             hidden_dropout)

    def forward(self, x: torch.Tensor, additive_mask: Optional[torch.Tensor],
                rng: Optional[DropoutRNG] = None) -> torch.Tensor:
        x = self.attention(x, additive_mask, rng)
        return self.output(self.intermediate(x), x, rng)


class BiAttention(nn.Module):
    """Bi-directional cross attention between vision (1) and text (2)
    (reference BertBiAttention, vilbert.py:619-725). Text queries attend
    vision keys/values (ctx1) and vision queries attend text keys/values
    (ctx2)."""

    def __init__(self, v_hidden_size: int, t_hidden_size: int,
                 bi_hidden_size: int, num_heads: int,
                 v_attn_dropout: float = 0.0, t_attn_dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.v_attn_dropout = v_attn_dropout
        self.t_attn_dropout = t_attn_dropout
        self.query1 = nn.Linear(v_hidden_size, bi_hidden_size)
        self.key1 = nn.Linear(v_hidden_size, bi_hidden_size)
        self.value1 = nn.Linear(v_hidden_size, bi_hidden_size)
        self.query2 = nn.Linear(t_hidden_size, bi_hidden_size)
        self.key2 = nn.Linear(t_hidden_size, bi_hidden_size)
        self.value2 = nn.Linear(t_hidden_size, bi_hidden_size)

    def forward(self, v_input, v_mask, t_input, t_mask, rng=None):
        H = self.num_heads
        ctx1 = fused_attention(split_heads(self.query2(t_input), H),
                               split_heads(self.key1(v_input), H),
                               split_heads(self.value1(v_input), H), v_mask,
                               *attention_seed(self, self.v_attn_dropout, rng))
        ctx2 = fused_attention(split_heads(self.query1(v_input), H),
                               split_heads(self.key2(t_input), H),
                               split_heads(self.value2(t_input), H), t_mask,
                               *attention_seed(self, self.t_attn_dropout, rng))
        return merge_heads(ctx1), merge_heads(ctx2)


class BiOutput(nn.Module):
    """Per-stream projections of the bi-attention contexts
    (reference BertBiOutput, vilbert.py:746-758)."""

    def __init__(self, v_hidden_size: int, t_hidden_size: int,
                 bi_hidden_size: int, eps: float = LAYER_NORM_EPS):
        super().__init__()
        self.dense1 = nn.Linear(bi_hidden_size, v_hidden_size)
        self.LayerNorm1 = nn.LayerNorm(v_hidden_size, eps=eps)
        self.dense2 = nn.Linear(bi_hidden_size, t_hidden_size)
        self.LayerNorm2 = nn.LayerNorm(t_hidden_size, eps=eps)


class ConnectionLayer(nn.Module):
    """Co-attention block: bi-attention + per-stream projections + FFNs
    (reference BertConnectionLayer, vilbert.py:728-788).

    The reference's cross-wiring (vilbert.py:780): ctx2 (vision queries over
    text) is projected by dense1 onto the vision residual, ctx1 by dense2
    onto the text residual."""

    def __init__(self, v_hidden_size: int, t_hidden_size: int,
                 bi_hidden_size: int, bi_num_heads: int,
                 v_intermediate_size: int, t_intermediate_size: int,
                 v_hidden_act: str, t_hidden_act: str,
                 eps: float = LAYER_NORM_EPS, v_attn_dropout: float = 0.0,
                 t_attn_dropout: float = 0.0, v_hidden_dropout: float = 0.0,
                 t_hidden_dropout: float = 0.0):
        super().__init__()
        self.v_hidden_dropout = v_hidden_dropout
        self.t_hidden_dropout = t_hidden_dropout
        self.biattention = BiAttention(v_hidden_size, t_hidden_size,
                                       bi_hidden_size, bi_num_heads,
                                       v_attn_dropout, t_attn_dropout)
        self.biOutput = BiOutput(v_hidden_size, t_hidden_size, bi_hidden_size,
                                 eps)
        self.v_intermediate = Intermediate(v_hidden_size, v_intermediate_size,
                                           v_hidden_act)
        self.v_output = Output(v_intermediate_size, v_hidden_size, eps,
                               v_hidden_dropout)
        self.t_intermediate = Intermediate(t_hidden_size, t_intermediate_size,
                                           t_hidden_act)
        self.t_output = Output(t_intermediate_size, t_hidden_size, eps,
                               t_hidden_dropout)

    def forward(self, v_input, v_mask, t_input, t_mask, rng=None):
        ctx1, ctx2 = self.biattention(v_input, v_mask, t_input, t_mask, rng)
        out = self.biOutput
        h1 = dropout(self, out.dense1(ctx2), self.v_hidden_dropout, rng)
        v_out = out.LayerNorm1(h1 + v_input)
        h2 = dropout(self, out.dense2(ctx1), self.t_hidden_dropout, rng)
        t_out = out.LayerNorm2(h2 + t_input)
        v_out = self.v_output(self.v_intermediate(v_out), v_out, rng)
        t_out = self.t_output(self.t_intermediate(t_out), t_out, rng)
        return v_out, t_out
