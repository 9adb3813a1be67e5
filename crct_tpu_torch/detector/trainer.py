"""Detector training (reference Detector/frcnn.py solver).

The port of ``crct_tpu/detector/trainer.py``: SGD with momentum 0.9 and
weight decay 1e-4 at the reference schedule (BASE_LR 2.5e-4, linear warmup
over 1000 iterations, x0.1 at 10k..70k), over the mean of the images'
Mask R-CNN losses. The frozen batch norms are buffers, which the optimizer
never sees. The trainer owns the generator of the samplers' noise (on the
card, so that sampling needs no host round trip). ``batch_multiply`` k is
``optax.MultiSteps``: the mean of k mini-steps' gradients feeds one update.

Under a process group (``parallel``: one rank per card, the JAX trainer's
mesh) each rank takes its ``batch_size / world`` images of every global
batch, starts from rank 0's weights, and averages its gradients with the
others' before the optimizer. Each image's losses divide by that image's
own sample counts, as the JAX trainer's per-image ``vmap`` does, so the
mean over the world of the ranks' image means is the JAX step's mean over
the global batch. Each rank draws its own sampling noise.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from crct_tpu_torch import parallel
from crct_tpu_torch.detector.mask_rcnn import MaskRCNN, init_detector_weights
from crct_tpu_torch.utils.device import resolve_device

SOLVER_STEPS = (10000, 20000, 30000, 40000, 50000, 60000, 70000)
BATCH_KEYS = ("image", "gt_boxes", "gt_classes", "gt_valid", "gt_masks28")


def detector_lr_schedule(base_lr: float = 2.5e-4, gamma: float = 0.1,
                         steps=SOLVER_STEPS, warmup_iters: int = 1000,
                         warmup_factor: float = 1e-3):
    """Step decay with Detectron2's default linear warmup (factor 1/1000
    over the first 1000 iterations), computed in fp32 as optax computes
    the JAX schedule."""
    f32 = np.float32

    def schedule(step: int) -> float:
        v = f32(base_lr)
        for boundary in sorted(int(s) for s in steps):
            if step >= boundary:
                v = f32(gamma) * v
        alpha = min(f32(step) / f32(warmup_iters), f32(1.0))
        warm = f32(warmup_factor) * (f32(1.0) - alpha) + alpha
        return float(f32(v * warm))

    return schedule


class DetectorSGD:
    """``optax.chain(add_decayed_weights(wd), sgd(schedule, momentum))`` of
    ``make_detector_optimizer``, over the model's parameters: g + wd * p
    into the momentum trace, then p -= lr(count) * trace. A parameter with
    no gradient (a frozen stage behind ``freeze_at``'s detach) takes a zero
    gradient and is still decayed, as in the JAX package. With
    ``every_k > 1`` it is ``optax.MultiSteps`` around that chain: the
    running mean of ``every_k`` mini-steps' gradients feeds one update, and
    the schedule counts updates."""

    def __init__(self, params: List[torch.nn.Parameter],
                 base_lr: float = 2.5e-4, weight_decay: float = 1e-4,
                 momentum: float = 0.9, every_k: int = 1):
        self.params = list(params)
        self.schedule = detector_lr_schedule(base_lr)
        self.weight_decay = weight_decay
        self.momentum = momentum
        self.every_k = max(1, int(every_k))
        self.trace = [torch.zeros_like(p) for p in self.params]
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if self.every_k > 1 else None)
        self.count = 0        # updates applied
        self.mini_step = 0    # gradients accumulated towards the next one

    @torch.no_grad()
    def step(self) -> None:
        """Take this mini-step's gradients; update every ``every_k``-th
        call."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.every_k > 1:
            # Welford running mean, as optax.MultiSteps
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step = (self.mini_step + 1) % self.every_k
            if self.mini_step:
                return
            grads = self.acc
        decayed = torch._foreach_add(grads, self.params,
                                     alpha=self.weight_decay)
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, decayed)
        torch._foreach_add_(self.params, self.trace,
                            alpha=-self.schedule(self.count))
        if self.every_k > 1:
            torch._foreach_zero_(self.acc)
        self.count += 1


def device_batch(batch: Dict[str, np.ndarray], device) -> Dict[str,
                                                              torch.Tensor]:
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device)
            for k in BATCH_KEYS if k in batch}


def make_detector_train_step(model: MaskRCNN, optimizer: DetectorSGD,
                             bf16: bool = False):
    """One step: the images' mean losses (bf16 autocast over fp32 params
    when asked; box decoding and losses stay fp32), backward, the
    gradients' mean over the process group, SGD. The losses returned are
    their means over the world."""
    params = list(model.parameters())

    def train_step(batch: Dict[str, torch.Tensor],
                   generator: Optional[torch.Generator]
                   ) -> Dict[str, torch.Tensor]:
        dev = batch["image"].device
        model.zero_grad(set_to_none=True)
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16):
            losses = model(batch["image"], train=True,
                           gt_boxes=batch["gt_boxes"],
                           gt_classes=batch["gt_classes"],
                           gt_valid=batch["gt_valid"],
                           gt_masks28=batch.get("gt_masks28"),
                           generator=generator)
        losses["total"].backward()
        parallel.allreduce_gradients(params)
        optimizer.step()
        with torch.no_grad():
            keys = list(losses)
            mean = parallel.allreduce_sum(torch.stack(
                [losses[k].detach().float() for k in keys]))
            mean = mean / parallel.world_size()
        return dict(zip(keys, mean.unbind()))

    return train_step


class DetectorTrainer:
    """The detector, its optimizer and its sampling generator on one
    device (the card unless ``device="cpu"``), one rank's under a process
    group; global batches of ``batch_size`` images come from the caller
    (``detector_batch_iterator``), and the world size must divide
    ``batch_size``. fp32 convolutions and matmuls run at full fp32
    precision: the trainer turns the process's TF32 switches off (cuDNN's
    is on by default)."""

    def __init__(self, *, num_classes: int, with_mask: bool = True,
                 depth: int = 50, batch_size: int = 2,
                 base_lr: float = 2.5e-4, seed: int = 0,
                 roi_batch: int = 256, post_nms_topk: int = 512,
                 batch_multiply: int = 1, stride_in_1x1: bool = False,
                 freeze_at: int = 0, bf16: bool = False,
                 fast_nms: bool = False, device="cuda"):
        self.device = resolve_device(device)
        if batch_size % parallel.world_size():
            raise ValueError(f"the world size {parallel.world_size()} must "
                             f"divide the image batch {batch_size}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.model = MaskRCNN(num_classes=num_classes, depth=depth,
                              with_mask=with_mask, roi_batch=roi_batch,
                              post_nms_topk_train=post_nms_topk,
                              post_nms_topk_test=post_nms_topk,
                              stride_in_1x1=stride_in_1x1,
                              freeze_at=freeze_at, fast_train_nms=fast_nms)
        init_detector_weights(self.model, torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        parallel.broadcast_module(self.model)
        self.optimizer = DetectorSGD(list(self.model.parameters()), base_lr,
                                     every_k=batch_multiply)
        self.step_fn = make_detector_train_step(self.model, self.optimizer,
                                                bf16)
        self.step = 0
        self.generator = torch.Generator(self.device).manual_seed(
            parallel.rank_seed(seed + 1))

    def run_step(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One step on a global batch, of which this rank takes its
        images."""
        mine = parallel.shard(len(batch["image"]))
        losses = self.step_fn(
            device_batch({k: batch[k][mine] for k in BATCH_KEYS
                          if k in batch}, self.device),
            self.generator)
        self.step += 1
        return {k: float(v) for k, v in losses.items()}


def detector_batch_iterator(dataset, batch_size: int, keys, max_iter: int,
                            *, seed: int = 0, prefetch: int = 2):
    """Background-threaded batch producer: one thread builds the next
    batches (PNG decode, resize, mask rasterization) while the card runs the
    current step. Shuffled epochs, wrapping around like the reference's
    infinite Detectron2 loader."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)

    def produce():
        try:
            rng = np.random.default_rng(seed)
            order, pos = rng.permutation(len(dataset)), 0
            for _ in range(max_iter):
                idx = []
                for _ in range(batch_size):
                    if pos >= len(order):
                        order, pos = rng.permutation(len(dataset)), 0
                    idx.append(int(order[pos]))
                    pos += 1
                examples = [dataset[i] for i in idx]
                q.put({k: np.stack([ex[k] for ex in examples])
                       for k in keys})
            q.put(None)
        except Exception as e:              # surface, don't hang the consumer
            q.put(e)

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if item is None:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


@torch.inference_mode()
def coco_evaluate(model: MaskRCNN, dataset, *, max_images: Optional[int] = None,
                  infer_batch: int = 8) -> Dict[str, float]:
    """Inference over a CocoDataset and its bbox mAP (the reference's
    ``--test`` mode, frcnn.py:200-202), ``infer_batch`` images a forward,
    without the mask branch."""
    from crct_tpu_torch.detector.coco import evaluate_detections

    device = next(model.parameters()).device
    dets, gts = [], []
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    for s in range(0, n, infer_batch):
        exs = [dataset[i] for i in range(s, min(s + infer_batch, n))]
        images = torch.from_numpy(np.stack([e["image"] for e in exs]))
        outs = model(images.to(device), train=False, compute_masks=False)
        outs = {k: v.float().cpu().numpy() if v.is_floating_point()
                else v.cpu().numpy() for k, v in outs.items()}
        for j, ex in enumerate(exs):
            valid = outs["valid"][j]
            dets.append({"boxes": outs["boxes"][j][valid] / ex["scale"],
                         "scores": outs["scores"][j][valid],
                         "classes": outs["classes"][j][valid]})
            gv = ex["gt_valid"]
            gts.append({"boxes": ex["gt_boxes"][gv] / ex["scale"],
                        "classes": ex["gt_classes"][gv]})
    return evaluate_detections(dets, gts, model.num_classes)
