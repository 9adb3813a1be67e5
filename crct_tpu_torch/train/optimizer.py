"""Optimizer + LR schedule (reference CRCT/utils.py:11-29,228-249).

The port of ``crct_tpu/train/optimizer.py``: AdamW over four parameter
groups, language or image times decay or no decay. Text-stream parameters
(the BERT-pretrained weights of ``configs/language_weights.json``, the port's
copy of the JAX package's list of flax paths, translated to torch keys by
``utils.convert.torch_key``) train at ``lr``, everything else at
``image_lr``; biases and LayerNorm parameters take no weight decay. Each
group's learning rate follows ``warmup_linear_min_schedule`` with
``t_total = iters_per_epoch * 20``, evaluated at the update count before the
update, as optax's ``scale_by_schedule`` does.

The update is optax's chain ``scale_by_adam -> add_decayed_weights ->
scale_by_learning_rate`` written out over ``torch._foreach_*`` ops: Adam
moments with bias correction and eps outside the square root, then
``+ wd * p``, then ``* -lr``. ``-opt_bf16_m`` keeps the first moments in
bf16 (second moments stay fp32), and ``every_k > 1`` is ``optax.MultiSteps``:
the running mean of ``every_k`` mini-step gradients feeds one update.
``torch.optim.AdamW`` cannot hold a bf16 first moment or apply the decay
after the Adam scaling, hence this small optimizer of the port's own.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Any, Dict, FrozenSet, List, Sequence, Tuple

import numpy as np
import torch

from crct_tpu_torch.utils.convert import torch_key

LANGUAGE_WEIGHTS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "configs", "language_weights.json")
GROUPS = ("lang_decay", "lang_nodecay", "image_decay", "image_nodecay")
B1, B2, EPS = 0.9, 0.999, 1e-8


@functools.lru_cache(maxsize=1)
def language_weight_keys() -> FrozenSet[str]:
    """The torch keys of the parameters that take ``lr``."""
    with open(LANGUAGE_WEIGHTS_PATH) as f:
        return frozenset(torch_key(p) for p in json.load(f))


def needs_decay(name: str) -> bool:
    """Torch no_decay = ['bias', 'LayerNorm.bias', 'LayerNorm.weight']
    (crct_tpu/train/optimizer.py:74-84 in torch names)."""
    return not (name.endswith(".bias") or "LayerNorm" in name)


def group_label(name: str) -> str:
    return (("lang" if name in language_weight_keys() else "image")
            + ("_decay" if needs_decay(name) else "_nodecay"))


def warmup_linear_min_schedule(base_lr: float, warmup_steps: int,
                               t_total: float, min_lr: float):
    """WarmupLinearScheduleNonZero (reference utils.py:11-29): linear 0->base
    over warmup, linear base->0 over the rest, floored at min_lr; in fp32,
    as the JAX schedule computes it."""
    f32 = np.float32

    def schedule(step: int) -> float:
        step = f32(step)
        warm = step / f32(max(1.0, float(warmup_steps)))
        decay = np.maximum(f32(0.0), (f32(t_total) - step)
                           / f32(max(1.0, t_total - warmup_steps)))
        factor = warm if step < warmup_steps else decay
        lr = f32(base_lr) * factor
        return float(lr if lr > f32(min_lr) else f32(min_lr))
    return schedule


def current_lr(params_dict: Dict[str, Any], iters_per_epoch: float,
               step: int) -> float:
    """The ``lr`` group's learning rate at update count ``step`` (callers
    divide mini-steps by batch_multiply), for logging."""
    schedule = warmup_linear_min_schedule(
        params_dict["lr"], params_dict["warmup"],
        float(iters_per_epoch) * 20.0, params_dict["min_lr"])
    return schedule(step)


class AdamW:
    """The 4-group AdamW of the JAX package over named parameters; reads
    ``p.grad`` (a parameter with no gradient counts as a zero gradient, as
    a stopped gradient is zero in JAX)."""

    def __init__(self, named_params: Sequence[Tuple[str, torch.nn.Parameter]],
                 params_dict: Dict[str, Any], iters_per_epoch: float,
                 every_k: int = 1):
        t_total = float(iters_per_epoch) * 20.0
        self.wd = float(params_dict["wd"])
        self.every_k = max(1, int(every_k))
        mu_dtype = torch.bfloat16 if params_dict.get("opt_bf16_m") else None
        self.groups: Dict[str, Dict[str, Any]] = {}
        for label in GROUPS:
            base = params_dict["lr" if label.startswith("lang") else
                               "image_lr"]
            self.groups[label] = dict(
                names=[], params=[], decay=label.endswith("_decay"),
                schedule=warmup_linear_min_schedule(
                    base, params_dict["warmup"], t_total,
                    params_dict["min_lr"]))
        for name, p in named_params:
            g = self.groups[group_label(name)]
            g["names"].append(name)
            g["params"].append(p)
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        for g in self.groups.values():
            for name, p in zip(g["names"], g["params"]):
                self.state[name] = {
                    "mu": torch.zeros_like(p, dtype=mu_dtype or p.dtype),
                    "nu": torch.zeros_like(p),
                    "acc": (torch.zeros_like(p) if self.every_k > 1
                            else None)}
        self.count = 0        # updates applied (optax's count)
        self.mini_step = 0    # gradients accumulated towards the next one

    def _grads(self, params: List[torch.Tensor]) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in params]

    @torch.no_grad()
    def step(self) -> None:
        """Take the gradients of this mini-step; apply an update every
        ``every_k``-th call."""
        if self.every_k > 1:
            n = self.mini_step
            for g in self.groups.values():
                if not g["params"]:
                    continue
                acc = [self.state[k]["acc"] for k in g["names"]]
                # Welford running mean, as optax.MultiSteps
                diff = torch._foreach_sub(self._grads(g["params"]), acc)
                torch._foreach_div_(diff, float(n + 1))
                torch._foreach_add_(acc, diff)
            self.mini_step = (n + 1) % self.every_k
            if self.mini_step:
                return
        for g in self.groups.values():
            if not g["params"]:
                continue
            names = g["names"]
            grads = ([self.state[k]["acc"] for k in names]
                     if self.every_k > 1 else self._grads(g["params"]))
            self._update(g, names, grads)
        if self.every_k > 1:
            torch._foreach_zero_([self.state[k]["acc"]
                                  for g in self.groups.values()
                                  for k in g["names"]])
        self.count += 1

    def _update(self, g, names, grads):
        params = g["params"]
        mus = [self.state[k]["mu"] for k in names]
        nus = [self.state[k]["nu"] for k in names]
        count = self.count + 1
        # mu <- b1 mu + (1 - b1) g as optax computes it: b1 mu in the
        # moment's dtype, with b1 itself rounded to that dtype (a weakly
        # typed scalar: 0.8984375 for a bf16 moment), the sum in fp32
        b1 = float(torch.tensor(B1, dtype=mus[0].dtype))
        mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - B1),
                                torch._foreach_mul(mus, b1))
        torch._foreach_mul_(nus, B2)
        torch._foreach_addcmul_(nus, grads, grads, value=1.0 - B2)
        c1 = float(1.0 - np.float32(B1) ** np.float32(count))
        c2 = float(1.0 - np.float32(B2) ** np.float32(count))
        upd = torch._foreach_div(mu, c1)
        denom = torch._foreach_sqrt(torch._foreach_div(nus, c2))
        torch._foreach_add_(denom, EPS)
        torch._foreach_div_(upd, denom)
        if g["decay"] and self.wd > 0:
            torch._foreach_add_(upd, params, alpha=self.wd)
        torch._foreach_mul_(upd, -g["schedule"](self.count))
        torch._foreach_add_(params, upd)
        for dst, src in zip(mus, mu):
            dst.copy_(src)

    def state_dict(self) -> Dict[str, Any]:
        return {"count": self.count, "mini_step": self.mini_step,
                "state": {k: {n: t for n, t in v.items() if t is not None}
                          for k, v in self.state.items()}}

    def load_state_dict(self, saved: Dict[str, Any]) -> None:
        """Restore moments, accumulators and counts by parameter name; every
        live parameter must be in ``saved``."""
        missing = set(self.state) - set(saved["state"])
        if missing:
            raise KeyError(f"optimizer state lacks {sorted(missing)[:5]}")
        with torch.no_grad():
            for name, slots in self.state.items():
                for slot, t in slots.items():
                    if t is not None and slot in saved["state"][name]:
                        t.copy_(saved["state"][name][slot])
        self.count = int(saved["count"])
        self.mini_step = int(saved.get("mini_step", 0))
