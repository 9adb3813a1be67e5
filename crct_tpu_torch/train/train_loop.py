"""Training step and epoch loop (reference CRCT/train.py).

The port of ``crct_tpu/train/train_loop.py`` on one card: ``make_train_step``
carries the hot path (forward with dropout, losses, backward through the
attention kernels, the 4-group AdamW and the 9-slot metric vector), the
``Trainer`` owns the model, the optimizer, the dropout generator and the
checkpoints, and ``run_training`` is the epoch loop with its log lines, the
NaN guard, the SIGTERM preemption save, checkpoint retention, TensorBoard
scalars and ``-profile``. There is no mesh: ``-ddp`` is not ported yet.
"""

from __future__ import annotations

import glob
import os
import signal
import time
from collections import deque
from time import gmtime, strftime
from timeit import default_timer as timer
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from crct_tpu_torch.models.crct import CRCTModel, build_model
from crct_tpu_torch.train.optimizer import AdamW, current_lr
from crct_tpu_torch.utils.checkpoint import (checkpoint_name, epoch_from_name,
                                             epoch_iter_from_name,
                                             load_checkpoint, save_checkpoint,
                                             to_host, transfer_params)
from crct_tpu_torch.utils.device import resolve_device
from crct_tpu_torch.utils.logging import init_log_file, is_rank0, log_line

# batch keys the step consumes
STEP_KEYS = ["tokens", "segments", "loc", "sep_indices", "hist_len",
             "image_feat", "image_loc", "image_mask", "image_target", "R",
             "next_sentence_labels", "area"]
# metrics on the host every PRINT_EVERY steps (a log line) and every
# 10 optimizer updates (TensorBoard); each read waits for the card
PRINT_EVERY = 100


def device_batch(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """The step's arrays of a host batch, as tensors on ``device``."""
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device,
                                                         non_blocking=True)
            for k in STEP_KEYS if k in batch}


def make_train_step(model: CRCTModel, optimizer: AdamW
                    ) -> Callable[[Dict[str, torch.Tensor], torch.Generator],
                                  torch.Tensor]:
    """(batch on the model's device, dropout generator) -> the 9-slot metric
    vector on the device, after forward, backward and the optimizer step
    (an update every ``optimizer.every_k``-th call)."""

    def train_step(batch, generator):
        model.train()
        for p in model.parameters():
            p.grad = None
        out = model(batch, generator)
        out.loss.backward()
        optimizer.step()
        with torch.no_grad():
            num_regs = out.needs_reg.sum().float()
            denom = num_regs.clamp(min=1.0)
            zero = torch.zeros((), device=num_regs.device)
            # 9-slot metric vector (reference train.py:181-191):
            # [loss, lm_loss, nsp_loss, reg_loss, reg_5_dist, legend_loss,
            #  num_regs, reg_5_right, reg_t_right]
            return torch.stack([
                out.loss.detach(), zero, out.nsp_loss.detach(),
                out.reg_loss.sum() / denom, out.reg_5_dist.sum() / denom,
                zero, num_regs, out.correct_regs.sum().float(),
                out.correct_t_regs.sum().float()])

    return train_step


class Trainer:
    """Model, optimizer, dropout generator, step and checkpoints on one
    device (the card unless ``device="cpu"``)."""

    def __init__(self, params_dict: Dict[str, Any],
                 model: Optional[CRCTModel], iters_per_epoch: float,
                 device="cuda"):
        self.params_dict = params_dict
        self.device = resolve_device(device)
        self.model = (model or build_model(params_dict, device=self.device,
                                           train=True))
        self.model.to(self.device).train()
        self.iters_per_epoch = iters_per_epoch
        self.optimizer = AdamW(
            list(self.model.named_parameters()), params_dict,
            iters_per_epoch, every_k=params_dict.get("batch_multiply", 1))
        self.step = 0
        self.start_epoch = 0
        self._maybe_load_checkpoint()
        self.train_step = make_train_step(self.model, self.optimizer)
        # the dropout generator: every seed and mask of a step comes from it
        self.generator = torch.Generator().manual_seed(
            int(params_dict.get("seed", 0)) + 17)

    def _maybe_load_checkpoint(self) -> None:
        pd = self.params_dict
        ckpt = pd.get("start_checkpoint")
        if not ckpt:
            return
        loaded = load_checkpoint(ckpt)
        transfer_params(self.model, loaded["model_state_dict"])
        if pd.get("continue"):
            if "optimizer_state_dict" in loaded:
                self.optimizer.load_state_dict(loaded["optimizer_state_dict"])
            self.step = int(loaded.get("iter_id", 0))
            self.start_epoch = epoch_from_name(ckpt) + 1

    def run_step(self, batch: Dict[str, Any]) -> torch.Tensor:
        metrics = self.train_step(device_batch(batch, self.device),
                                  self.generator)
        self.step += 1
        return metrics

    def host_state(self):
        """(model state, optimizer state) copied to the CPU."""
        return (to_host(self.model.state_dict()),
                to_host(self.optimizer.state_dict()))

    def save(self, epoch: int) -> str:
        """Write an epoch checkpoint and apply ``-max_checkpoints``."""
        pd = self.params_dict
        os.makedirs(pd["save_path"], exist_ok=True)
        path = os.path.join(pd["save_path"], checkpoint_name(epoch, self.step))
        save_checkpoint(path, *self.host_state(), self.step)
        self._retention_cleanup()
        return path

    def _retention_cleanup(self) -> None:
        keep = int(self.params_dict.get("max_checkpoints") or 0)
        if keep > 0:
            # opt-in retention: drop the oldest epoch checkpoints beyond the
            # newest `keep` (the reference keeps every epoch)
            cks = sorted(glob.glob(os.path.join(
                self.params_dict["save_path"], "plotqa_encoder_*.ckpt")),
                key=epoch_iter_from_name)
            for old in cks[:-keep]:
                os.remove(old)


def run_training(params_dict: Dict[str, Any], dataset, eval_fn=None,
                 device="cuda") -> Trainer:
    """Multi-epoch training loop with logging and checkpoints (reference
    run_training_DDP, train.py:21-353), on one device."""
    from crct_tpu_torch.data.dataset import DataLoader

    if params_dict.get("ddp"):
        raise NotImplementedError("-ddp (data parallelism) is not ported "
                                  "yet: the port trains on one card")
    init_log_file(params_dict)
    log_line(params_dict, "De facto batch_size: {}*{}*{} = {}".format(
        params_dict["batch_size"], 1, params_dict["batch_multiply"],
        params_dict["batch_size"] * params_dict["batch_multiply"]))
    dataset.split = "train"
    loader = DataLoader(dataset, params_dict["batch_size"], shuffle=True,
                        seed=params_dict.get("seed", 0),
                        num_workers=params_dict.get("num_workers", 8) or 1,
                        drop_last=True)
    if len(loader) == 0:
        raise ValueError(
            f"empty dataloader: dataset has {len(dataset)} examples but the "
            f"batch size is {params_dict['batch_size']} with drop_last - "
            f"lower -batch_size or add data")
    iters_per_epoch = max(1, len(loader) / params_dict["batch_multiply"])
    trainer = Trainer(params_dict, None, iters_per_epoch, device)
    log_line(params_dict, f"len(dataloader)={len(loader)}")

    # preemption-safe checkpointing: SIGTERM requests a graceful stop; the
    # loop saves a resumable checkpoint at the next step boundary and
    # returns. The save carries epoch_id-1 in its name so `-continue` re-runs
    # the interrupted epoch from its (deterministically reshuffled) start.
    stop_requested = []
    prev_handler = None
    try:
        prev_handler = signal.signal(
            signal.SIGTERM, lambda *_: stop_requested.append(True))
    except ValueError:     # not the main thread
        pass
    try:
        return _run_epochs(params_dict, trainer, loader, dataset, eval_fn,
                           stop_requested, _maybe_tensorboard(params_dict),
                           iters_per_epoch)
    finally:
        # the handler must not outlive this call, even when the NaN guard
        # raises: it appends to a list nobody reads any more
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        loader.close()


def _run_epochs(params_dict, trainer, loader, dataset, eval_fn,
                stop_requested, tb_writer, iters_per_epoch):
    bm = max(1, params_dict["batch_multiply"])
    tb_every = 10 * bm
    loss_hist: deque = deque(maxlen=100)   # (reg, nsp) at metric reads
    start_t = timer()
    profile_dir = os.path.join(params_dict["save_path"], "profile")
    profiler = None
    for epoch_id in range(trainer.start_epoch, params_dict["num_epochs"]):
        loader.set_epoch(epoch_id)
        epoch_time = time.time()
        for iter_id, batch in enumerate(loader):
            if stop_requested:
                _preempt_save(params_dict, trainer, epoch_id)
                return trainer
            if params_dict.get("profile") and trainer.step == 10:
                profiler = _start_profiler(trainer.device)
            device_metrics = trainer.run_step(batch)
            if profiler is not None and trainer.step == 15:
                profiler.stop()
                os.makedirs(profile_dir, exist_ok=True)
                profiler.export_chrome_trace(
                    os.path.join(profile_dir, "train_steps_10_15.json"))
                profiler = None
                log_line(params_dict, f"profiler trace saved to {profile_dir}")
            need_tb = tb_writer is not None and iter_id % tb_every == 0
            if not (need_tb or iter_id % PRINT_EVERY == 0):
                continue
            metrics = device_metrics.cpu().numpy()
            (total_loss, _, nsp_loss, reg_loss, reg_5_dist, _, num_regs,
             reg_5_right, reg_t_right) = metrics
            if not params_dict.get("no_nan_guard") and \
                    not np.isfinite(total_loss):
                _nan_halt(params_dict, trainer, total_loss, epoch_id, iter_id)
            loss_hist.append((reg_loss, nsp_loss))
            if need_tb:
                tb_writer.add_scalar("Loss/Total Loss", total_loss, trainer.step)
                tb_writer.add_scalar("Loss/nsp", nsp_loss, trainer.step)
                tb_writer.add_scalar("Reg Loss/reg_MSE", reg_loss, trainer.step)
                tb_writer.add_scalar("Reg Loss/reg_5_dist", reg_5_dist,
                                     trainer.step)
                if num_regs > 0:
                    tb_writer.add_scalar("Accuracy/reg_acc",
                                         reg_5_right / num_regs, trainer.step)
                    tb_writer.add_scalar("Accuracy/reg_t_acc",
                                         reg_t_right / num_regs, trainer.step)
            if iter_id % PRINT_EVERY == 0:
                end_t = timer()
                cur_epoch = epoch_id + iter_id / max(1, len(loader))
                est = (len(loader) - iter_id) * (end_t - start_t) / PRINT_EVERY
                hist = np.asarray(loss_hist)
                log_line(params_dict,
                         "[Ep: %.2f][%s][lr: %.2e][Iter: %d][Time: %5.2fs]"
                         "[Est: %s][Loss: %.3g][NSP: %.3g][Reg: %.3g]"
                         "[Regs: %d/%d][Reg_acc: %.2g | %.2g]"
                         "[run mean r,n: (%.3g , %.3g)]" % (
                             cur_epoch, strftime("%a %X", gmtime()),
                             # the schedule advances once per optimizer
                             # update, not per mini-step
                             current_lr(params_dict, iters_per_epoch,
                                        trainer.step // bm),
                             trainer.step, end_t - start_t,
                             strftime("%H:%M", gmtime(est)), total_loss,
                             nsp_loss, reg_loss, num_regs, len(batch["R"]),
                             reg_5_right / max(1, num_regs),
                             reg_t_right / max(1, num_regs),
                             hist[:, 0].mean(), hist[:, 1].mean()))
                start_t = end_t

        log_line(params_dict, "Epoch Time: "
                 + strftime("%H:%M", gmtime(time.time() - epoch_time)))
        if is_rank0(params_dict):
            path = trainer.save(epoch_id)
            log_line(params_dict, f"     --> Saving model to: {path}")
        if not params_dict.get("no_eval") and eval_fn is not None:
            log_line(params_dict, "Starting evaluation (on sampled val set)...")
            t0 = time.time()
            eval_fn(trainer, dataset, epoch_id)
            log_line(params_dict,
                     f"     -> Eval time: {round(time.time() - t0, 2)}")
            dataset.split = "train"
    return trainer


def _start_profiler(device: torch.device):
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _preempt_save(params_dict, trainer: Trainer, epoch_id: int) -> None:
    if not is_rank0(params_dict):
        return
    os.makedirs(params_dict["save_path"], exist_ok=True)
    path = os.path.join(params_dict["save_path"],
                        checkpoint_name(epoch_id - 1, trainer.step))
    save_checkpoint(path, *trainer.host_state(), trainer.step)
    log_line(params_dict, f"SIGTERM: saved preemption checkpoint {path}; "
                          f"resume with -continue -start_checkpoint {path}")


def _nan_halt(params_dict, trainer: Trainer, total_loss, epoch_id: int,
              iter_id: int) -> None:
    """Failure detection (beyond the reference, which trains on through
    NaNs): freeze the blown state for diagnosis and stop."""
    diag = "the rank-0 process"
    if is_rank0(params_dict):
        os.makedirs(params_dict["save_path"], exist_ok=True)
        diag = os.path.join(params_dict["save_path"],
                            f"NANDIAG_step{trainer.step}.ckpt")
        save_checkpoint(diag, *trainer.host_state(), trainer.step)
    raise RuntimeError(
        f"non-finite loss {total_loss!r} at step {trainer.step} "
        f"(epoch {epoch_id}, iter {iter_id}): training halted by the NaN "
        f"guard. Blown state saved to {diag} for diagnosis; restart from "
        f"the last epoch checkpoint with -continue, or lower the lr. "
        f"(-no_nan_guard disables this check.)")


def _maybe_tensorboard(params_dict: Dict[str, Any]):
    if not is_rank0(params_dict) or not params_dict.get("tensorboard"):
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:     # no tensorboard package: no scalars
        return None
    return SummaryWriter(log_dir=os.path.join(
        params_dict["tensorboard"], params_dict.get("save_name", "")))
