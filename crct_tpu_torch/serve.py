"""HTTP batch serving for the QA stage, on the card.

The port of ``crct_tpu/serve.py``. Concurrent HTTP requests queue, one
scorer thread coalesces them into the fixed-size candidate-row chunks of the
eval path (``train/eval_loop.py``), the model scores every valid candidate
row, and the per-question pred dicts fan back out to their callers. The
per-question visual arrays go to the card once per coalesced batch and are
gathered per row there.

Surfaces:
  GET  /healthz                    -> {"status": "ok", dispatches, served,
                                      latency_ms_p50/p95 (rolling),
                                      mean_coalesced_batch}
  GET  /v1/figures                 -> ingested figure ids
  GET  /v1/figures/<id>/questions  -> known questions for a figure
  POST /v1/figures                 -> ingest a chart PNG: the detector and
                                      the extraction build the feature record
                                      in-process (crct_tpu_torch/ingest.py);
                                      needs -serve_detector_weights
  POST /v1/answer                  -> one pred dict (free-form question or a
                                      known question picked by index)
  POST /v1/answers                 -> list of pred dicts, scored as a batch

With ``-serve_no_dataset`` the server runs without feature shards or QA
files: every figure arrives over POST /v1/figures and every question is
free-form, the online PNG -> answer composition that the reference only
supports as an offline two-stage pipeline (Detector/extract_features.py,
then CRCT/Interactive_demo.py).

``-fast_scorer`` serves through the light candidate head (ONE backbone
pass per question instead of the x120 candidate-row fan-out); adding
``-fast_scorer_topk K`` rescores the K shortlisted candidates with the full
model, with the full protocol's candidate-order tie-breaking. It needs a
checkpoint that carries a trained head (``cli.train_fast_scorer``).

The pred dict mirrors the JAX server's (answer, cls_output, reg_output,
is_reg, confidence, optional ``top``); ``confidence`` is the model's raw
per-candidate NSP probability (fast-only: the head's softmax over the valid
candidates). Given several devices, the scorer holds one replica of the
model on each and splits every dispatch's rows across them (the JAX
server's local-mesh data parallelism): ``-mesh_shape N`` serves over the
first N cards.
"""

from __future__ import annotations

import base64
import copy
import io
import json
import queue
import threading
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from time import monotonic
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from crct_tpu_torch.data.dataset import ChartQADataset, collate
from crct_tpu_torch.data.example_builder import REG_TOKEN
from crct_tpu_torch.models.crct import CRCTModel, build_model
from crct_tpu_torch.train.eval_loop import (EVAL_TEXT_KEYS, EVAL_VIS_KEYS,
                                            _chunk_rows, _flatten_valid_rows,
                                            build_fast_rows, make_eval_step,
                                            make_eval_step_dedup,
                                            make_fast_eval_step,
                                            make_fast_eval_step_dedup,
                                            resolve_eval_chunk,
                                            segmented_argmax,
                                            shortlist_rescore_rows)
from crct_tpu_torch.utils.checkpoint import load_start_checkpoint
from crct_tpu_torch.utils.device import resolve_device


class InMemoryFigures:
    """Dataset stand-in for ingest-only serving (-serve_no_dataset).

    No feature shards, no QA file: every figure record arrives through
    POST /v1/figures and lands in ``QAScorer.figs``; this supplies the
    builder and tokenizer the scorer needs (the part of ChartQADataset the
    serving path touches)."""

    def __init__(self, params: Dict[str, Any], split: str = "test"):
        from crct_tpu_torch.data.example_builder import ExampleBuilder
        from crct_tpu_torch.data.tokenizer import load_tokenizer
        self.params = params
        self.tokenizer = load_tokenizer(params.get("vocab_file", ""))
        self.builder = ExampleBuilder(params, self.tokenizer)
        self.split = split
        self.qa: Dict[str, List[Dict[str, Any]]] = {split: []}

    def get_fig_feat(self, image_id: int) -> Dict[str, Any]:
        raise KeyError(image_id)    # only ingested figures exist

    def get_possible_answers(self, image_id: int,
                             fig_feat: Optional[Dict] = None) -> List[str]:
        if fig_feat is None:
            fig_feat = self.get_fig_feat(image_id)
        return self.builder.get_possible_answers(fig_feat)


class QAScorer:
    """Batched question scorer on the eval path.

    ``score`` takes a LIST of qa_pairs and answers them all through shared
    fixed-size dispatches. Runs on ``device`` (the card unless the caller
    asks for the CPU); the model's weights come from ``model``, else from
    ``-start_checkpoint`` (the port's, a reference ``crct.ckpt`` or the JAX
    package's; transfer mode, as the JAX scorer loads it), else a
    deterministic init seeded by ``-seed``.

    Low-latency modes mirror the eval CLI's (-fast_scorer /
    -fast_scorer_topk): the light candidate head scores every candidate
    from ONE backbone pass per question; with top-k the full model rescores
    only the K shortlisted rows.

    ``device`` may be a list of devices: one replica of the model on each,
    and every dispatch's rows split evenly across them, its size rounded up
    to a multiple of their number (the JAX scorer's local mesh)."""

    def __init__(self, params: Dict[str, Any], dataset: ChartQADataset,
                 model: Optional[CRCTModel] = None, *, device="cuda"):
        self.params = params
        self.dataset = dataset
        devices = [resolve_device(d) for d in
                   (device if isinstance(device, (list, tuple)) else
                    [device])]
        self.device = devices[0]
        self.fast = bool(params.get("fast_scorer"))
        self.topk = int(params.get("fast_scorer_topk") or 0) \
            if self.fast else 0
        if model is None:
            model = build_model(params, device=self.device)
            if params.get("start_checkpoint"):
                load_start_checkpoint(model, params["start_checkpoint"])
        if self.fast and not model.has_fast_scorer:
            raise ValueError("-fast_scorer serving needs a model with the "
                             "fast_scorer head")
        self.model = model.to(self.device).eval()
        # one replica a device; the first is self.model
        self.replicas = [self.model] + [copy.deepcopy(self.model).to(d)
                                        for d in devices[1:]]
        self.devices = devices
        # transfer-deduplicated dispatch: per-question visual arrays ship
        # once per coalesced batch and are gathered per row on the card
        self.dedup = bool(params.get("eval_dedup", True))
        make_step = make_eval_step_dedup if self.dedup else make_eval_step
        self.eval_step = make_step(self.model)
        self._eval_steps = [make_step(m) for m in self.replicas[1:]]
        # bf16 models: cast image_feat on the host (bit-identical: the
        # model's first touch casts it to bf16) and move half the bytes
        self.bf16_transfer = self.model.compute_dtype == torch.bfloat16
        # pad the question axis of the visual arrays to multiples of this
        # so coalesced batches of varying size keep a few shapes
        self.vis_pad = max(1, int(params.get("serve_max_batch", 32)))
        n = len(self.replicas)
        self.chunk = -(-resolve_eval_chunk(params) // n) * n
        if self.fast:
            make_fast = (make_fast_eval_step_dedup if self.dedup
                         else make_fast_eval_step)
            self.fast_step = make_fast(self.model)
            self._fast_steps = [make_fast(m) for m in self.replicas[1:]]
            # the fast dispatch is sized to the BATCHER cap: a coalesced
            # batch holds at most serve_max_batch questions, so one fast
            # dispatch covers it with bounded padding
            self.qchunk = -(-self.vis_pad // n) * n
        self.figs: Dict[int, Dict[str, Any]] = {}   # ingested overlay
        self.dispatches = 0
        self.served = 0

    def add_figure(self, record: Dict[str, Any]) -> int:
        """Register an ingested feature record; its image_id becomes a
        servable image_index (overlaying any shard figure of the same id).
        Bounded FIFO: beyond ``serve_max_figures`` (default 512) the oldest
        ingested record is evicted, so a long-running server's memory stays
        capped (a few hundred KB per record)."""
        image_id = int(record["image_id"])
        cap = max(1, int(self.params.get("serve_max_figures", 512) or 512))
        while len(self.figs) >= cap and image_id not in self.figs:
            self.figs.pop(next(iter(self.figs)))   # dicts keep insert order
        self.figs[image_id] = record
        return image_id

    def _vis_from_batch(self, batch: Dict[str, Any]
                        ) -> List[Dict[str, torch.Tensor]]:
        """Per-question visual arrays -> each replica's card, once per
        coalesced batch (the dedup layout of train/eval_loop.py), padded to
        ``vis_pad``."""
        nq = np.asarray(batch["tokens"]).shape[0]
        padded = -(-nq // self.vis_pad) * self.vis_pad
        vis = {}
        for k in EVAL_VIS_KEYS:
            if k not in batch:
                continue
            v = np.asarray(batch[k])[:, 0]
            if padded > nq:
                v = np.concatenate(
                    [v, np.zeros((padded - nq,) + v.shape[1:], v.dtype)])
            t = torch.from_numpy(np.ascontiguousarray(v))
            if k == "image_feat" and self.bf16_transfer:
                t = t.to(torch.bfloat16)
            vis[k] = t
        return [{k: t.to(d) for k, t in vis.items()} for d in self.devices]

    def _run_chunks(self, rows: Dict[str, np.ndarray], fast: bool = False,
                    chunk: int = 0, vis=None, qidx=None):
        """Dispatch rows through the full-model eval step (``fast``: the
        fast-scorer step) in fixed-size pieces (``chunk``, default
        ``self.chunk`` rows), each split evenly across the replicas; one
        host fetch per dispatch. Returns the first two outputs of the valid
        rows (NSP probabilities or candidate logits, and the regression
        outputs). ``vis``/``qidx`` select the dedup signature (text rows +
        each replica's per-question visual arrays + row -> question
        index)."""
        steps = ([self.fast_step] + self._fast_steps if fast
                 else [self.eval_step] + self._eval_steps)
        n = len(steps)
        if qidx is not None:
            rows = dict(rows, _qidx=np.asarray(qidx, np.int64))
        a_list, b_list = [], []
        chunk = -(-(chunk or self.chunk) // n) * n
        for piece, valid in _chunk_rows(rows, chunk):
            part = chunk // n
            outs = []
            for i, step in enumerate(steps):     # launch on every card
                sub = {k: v[i * part:(i + 1) * part]
                       for k, v in piece.items()}
                q = sub.pop("_qidx", None)
                outs.append(step(sub, vis[i], q) if q is not None
                            else step(sub))
            a_list.append(torch.cat([o[0].float().cpu() for o in outs])
                          [:valid].numpy())
            b_list.append(torch.cat([o[1].float().cpu() for o in outs])
                          [:valid].numpy())
            self.dispatches += 1
        return (np.concatenate(a_list) if a_list
                else np.zeros(0, np.float32),
                np.concatenate(b_list) if b_list
                else np.zeros(0, np.float32))

    def score(self, qa_pairs: List[Dict[str, Any]],
              top: int = 0) -> List[Dict[str, Any]]:
        ds = self.dataset
        items, opts_list = [], []
        errors: Dict[int, str] = {}
        pos: Dict[int, int] = {}        # qa index -> row in the batch
        for i, qa in enumerate(qa_pairs):
            idx = int(qa["image_index"])
            try:
                fig_feat = (self.figs[idx] if idx in self.figs
                            else ds.get_fig_feat(idx))
            except (KeyError, IndexError):
                # one unknown id must not poison the coalesced batch: the
                # other requests still score; this one carries the error
                errors[i] = f"unknown figure: {idx}"
                continue
            pos[i] = len(items)
            items.append(ds.builder.build(
                fig_feat, qa, split=ds.split, get_all_answers=True,
                qa_ind=-1, rng=np.random.default_rng(0)))
            opts_list.append(ds.get_possible_answers(idx, fig_feat))

        per_item: List[Dict[str, Any]] = []
        if items:
            batch = collate(items)
            per_item = (self._score_fast(batch, top) if self.fast
                        else self._score_full(batch, top))

        recs = []
        for i, qa in enumerate(qa_pairs):
            rec: Dict[str, Any] = {
                "image_index": int(qa["image_index"]),
                "question": str(qa.get("question_string", "")),
            }
            if i in errors:
                rec.update(error=errors[i], answer=None)
                recs.append(rec)
                continue
            d = per_item[pos[i]]
            rec["is_reg"] = d["is_reg"]
            if d["num_ans"] == 0:
                rec.update(answer=None, cls_output=None, confidence=None)
                recs.append(rec)
                continue
            opts = opts_list[pos[i]]
            ci = d["ci"]
            rec["confidence"] = d["conf"]
            rec["cls_output"] = str(opts[ci]) if ci < len(opts) else None
            if d["is_reg"] or rec["cls_output"] == REG_TOKEN:
                rec["reg_output"] = d["reg"]
                rec["answer"] = rec["reg_output"]
            else:
                rec["answer"] = rec["cls_output"]
            if top > 0:
                rec["top"] = [{"answer": str(opts[j]) if j < len(opts)
                               else None, "confidence": p}
                              for j, p in d["top_pairs"][:top]]
            recs.append(rec)
        self.served += len(qa_pairs)
        return recs

    def _score_full(self, batch: Dict[str, Any],
                    top: int) -> List[Dict[str, Any]]:
        """Reference protocol: every valid candidate row through the full
        model, per-question segmented argmax."""
        num_ans = np.asarray(batch["num_ans"]).reshape(-1)
        B = len(num_ans)
        if self.dedup:
            rows, offsets = _flatten_valid_rows(batch, keys=EVAL_TEXT_KEYS)
            qidx = np.repeat(np.arange(B), np.diff(offsets).astype(np.int64))
            nsp, reg_out = self._run_chunks(
                rows, vis=self._vis_from_batch(batch), qidx=qidx)
        else:
            rows, offsets = _flatten_valid_rows(batch)
            nsp, reg_out = self._run_chunks(rows)
        needs_reg = (np.asarray(batch["needs_reg"])
                     .reshape(B, -1)[:, 0].astype(bool))
        ans_rel = segmented_argmax(nsp, offsets)
        sel = offsets[:-1] + ans_rel
        per = []
        for b in range(B):
            d: Dict[str, Any] = {"num_ans": int(num_ans[b]),
                                 "is_reg": bool(needs_reg[b])}
            if num_ans[b] > 0:
                d["ci"] = int(ans_rel[b])
                d["conf"] = float(nsp[sel[b]])
                d["reg"] = float(reg_out[sel[b]])
                if top > 0:
                    probs = nsp[offsets[b]:offsets[b + 1]]
                    d["top_pairs"] = [(int(j), float(probs[j])) for j in
                                      np.argsort(-probs, kind="stable")]
            per.append(d)
        return per

    def _score_fast(self, batch: Dict[str, Any],
                    top: int) -> List[Dict[str, Any]]:
        """-fast_scorer serving: ONE backbone pass per question scores all
        candidates through the light head (the eval CLI's fast path); with
        -fast_scorer_topk the full model rescores only the K shortlisted
        rows."""
        frows = build_fast_rows(batch)
        if self.dedup:
            vis = self._vis_from_batch(batch)
            nq = len(np.asarray(batch["num_ans"]).reshape(-1))
            ftext = {k: v for k, v in frows.items()
                     if k not in EVAL_VIS_KEYS}
            cand_logits, reg_fast = self._run_chunks(
                ftext, fast=True, chunk=self.qchunk, vis=vis,
                qidx=np.arange(nq, dtype=np.int64))
        else:
            cand_logits, reg_fast = self._run_chunks(
                frows, fast=True, chunk=self.qchunk)
        num_ans = np.asarray(batch["num_ans"]).reshape(-1)
        B, P = cand_logits.shape
        needs_reg = (np.asarray(batch["needs_reg"])
                     .reshape(B, -1)[:, 0].astype(bool))
        cand_valid = frows["cand_valid"] > 0

        if self.topk:
            K = min(self.topk, P)
            top_idx = np.argsort(-cand_logits, axis=1,
                                 kind="stable")[:, :K]
            if self.dedup:
                # vis is already on the card from the fast pass above
                nsp, reg_out = self._run_chunks(
                    shortlist_rescore_rows(batch, top_idx,
                                           keys=EVAL_TEXT_KEYS),
                    vis=vis, chunk=min(self.chunk, self.vis_pad * K),
                    qidx=np.repeat(np.arange(B, dtype=np.int64), K))
            else:
                nsp, reg_out = self._run_chunks(
                    shortlist_rescore_rows(batch, top_idx))
            probs = np.where(
                np.take_along_axis(cand_valid, top_idx, axis=1),
                nsp[:B * K].reshape(B, K), -np.inf)
            per = []
            for b in range(B):
                d: Dict[str, Any] = {"num_ans": int(num_ans[b]),
                                     "is_reg": bool(needs_reg[b])}
                if not np.isfinite(probs[b]).any():
                    # no valid candidate made the shortlist (a NaN logit
                    # from a broken checkpoint): the no-candidates record
                    d["num_ans"] = 0
                elif num_ans[b] > 0:
                    # candidate-order tie-breaking, like the full
                    # protocol's segmented_argmax (first max wins)
                    corder = np.argsort(top_idx[b], kind="stable")
                    bk = int(corder[np.argmax(probs[b][corder])])
                    d["ci"] = int(top_idx[b, bk])
                    d["conf"] = float(probs[b, bk])
                    d["reg"] = float(reg_out[b * K + bk])
                    if top > 0:
                        row = probs[b][corder]
                        d["top_pairs"] = [
                            (int(top_idx[b][corder][k]), float(row[k]))
                            for k in np.argsort(-row, kind="stable")
                            if np.isfinite(row[k])]
                per.append(d)
            return per

        # fast-only: the head's listwise logits rank candidates; the
        # regression output comes from the same answer-masked pass (ONE
        # value per question). confidence = listwise softmax over valid
        # candidates (NOT the full protocol's per-row NSP probability)
        per = []
        for b in range(B):
            d = {"num_ans": int(num_ans[b]), "is_reg": bool(needs_reg[b])}
            if num_ans[b] > 0:
                v = np.where(cand_valid[b], cand_logits[b], -np.inf)
                e = np.exp(v - v.max())
                smax = e / max(e.sum(), 1e-30)
                # masked argmax: evaluate()'s raw argmax for any real head
                # output (invalid slots carry -1e9), but never a padding
                # candidate
                ci = int(np.argmax(v))
                d["ci"] = ci
                d["conf"] = float(smax[ci])
                d["reg"] = float(reg_fast[b])
                if top > 0:
                    d["top_pairs"] = [(int(j), float(smax[j]))
                                      for j in np.argsort(-v, kind="stable")
                                      [:int(num_ans[b])]]
            per.append(d)
        return per

    def warmup(self, qa_pair: Dict[str, Any]) -> None:
        """Build the kernels and warm the allocator BEFORE accepting
        traffic, so no caller's request waits on the build."""
        self.score([qa_pair])
        self.dispatches = 0
        self.served = 0


_CLOSE = object()


class DynamicBatcher:
    """Coalesce concurrent submissions into shared scorer calls.

    One consumer thread drains the queue: the first waiting request opens a
    window of ``max_delay_ms``; everything that arrives inside it (up to
    ``max_batch``) rides the same dispatch. Callers block on a Future, so
    request threads never touch the model: the scorer runs on exactly one
    thread."""

    def __init__(self, score_fn, max_batch: int = 32,
                 max_delay_ms: float = 5.0):
        self._score_fn = score_fn
        self._max_batch = max(1, int(max_batch))
        self._max_delay = max(0.0, float(max_delay_ms)) / 1000.0
        self._q: queue.Queue = queue.Queue()
        # rolling window: observability only, bounded
        self.batch_sizes: deque = deque(maxlen=2048)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, qa_pair: Dict[str, Any], top: int = 0) -> Future:
        fut: Future = Future()
        self._q.put((qa_pair, top, fut))
        return fut

    def close(self, timeout: float = 120.0) -> None:
        # the drain must outlast one full dispatch, or in-flight futures are
        # abandoned and their clients get connection resets
        self._q.put(_CLOSE)
        self._thread.join(timeout=timeout)

    def _loop(self) -> None:
        while True:
            first = self._q.get()
            if first is _CLOSE:
                return
            pending = [first]
            deadline = monotonic() + self._max_delay
            while len(pending) < self._max_batch:
                timeout = deadline - monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is _CLOSE:
                    self._flush(pending)
                    return
                pending.append(nxt)
            self._flush(pending)

    def _flush(self, pending) -> None:
        # ``top`` shapes only the host-side response, so mixed values can
        # share one dispatch: score at the batch max, trim per request
        top = max(p[1] for p in pending)
        try:
            recs = self._score_fn([p[0] for p in pending], top=top)
        except Exception as exc:  # surface to every caller, keep serving
            for _, _, fut in pending:
                fut.set_exception(exc)
            return
        self.batch_sizes.append(len(pending))
        for (_, want_top, fut), rec in zip(pending, recs):
            if want_top <= 0:
                rec.pop("top", None)
            elif "top" in rec:
                rec["top"] = rec["top"][:want_top]
            fut.set_result(rec)


class QAServer(ThreadingHTTPServer):
    """ThreadingHTTPServer carrying the scorer, batcher and question index."""

    daemon_threads = True
    # socketserver's default listen backlog of 5 drops connections the
    # moment more than a handful of clients connect in one batching window
    request_queue_size = 128
    # how long a request waits for its answer, and shutdown for in-flight
    # requests and the batcher's last dispatch
    answer_timeout = 120.0

    def __init__(self, addr, scorer: QAScorer, *, max_batch: int = 32,
                 max_delay_ms: float = 5.0, ingestor=None):
        super().__init__(addr, _Handler)
        self.scorer = scorer
        self.ingestor = ingestor
        self._ingest_lock = threading.Lock()
        self._next_fig_id = 10 ** 9       # auto ids clear of dataset ids
        self._qa_warm_kicked = False
        # rolling serving-latency window (ms, batch-level submit->result)
        self.latencies_ms: deque = deque(maxlen=2048)
        self.batcher = DynamicBatcher(scorer.score, max_batch=max_batch,
                                      max_delay_ms=max_delay_ms)
        # handler threads are daemons, invisible to socketserver's close
        # logic: server_close waits on this count so responses already
        # computed still reach their clients
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        self.img_to_qas: Dict[int, List[Dict[str, Any]]] = {}
        for qa in scorer.dataset.qa[scorer.dataset.split]:
            self.img_to_qas.setdefault(
                int(qa["image_index"]), []).append(qa)

    def ingest_figure(self, png_bytes: bytes, *,
                      image_id: Optional[int] = None,
                      annotation: Optional[Dict[str, Any]] = None,
                      ocr_mode: Optional[str] = None) -> Dict[str, Any]:
        """Decode, detect and extract one chart and register its record.

        Runs on the caller's HTTP thread; the ingestor serializes its use of
        the card, so concurrent uploads are safe."""
        if self.ingestor is None:
            raise ValueError("figure ingestion is disabled: start the "
                             "server with -serve_detector_weights")
        from PIL import Image, UnidentifiedImageError
        try:
            im = Image.open(io.BytesIO(png_bytes))
        except UnidentifiedImageError:
            raise ValueError("body does not decode as an image")
        if image_id is None:
            with self._ingest_lock:
                # skip ids a client already claimed explicitly: an auto id
                # never overwrites an existing figure
                while self._next_fig_id in self.scorer.figs:
                    self._next_fig_id += 1
                image_id = self._next_fig_id
                self._next_fig_id += 1
        record = self.ingestor.ingest(im, int(image_id),
                                      annotation=annotation,
                                      ocr_mode=ocr_mode)
        self.scorer.add_figure(record)
        if not self.img_to_qas and not self._qa_warm_kicked:
            # a server without known questions could not warm up at
            # startup: build the kernels now, off this thread; later
            # questions queue behind it on the batcher
            self._qa_warm_kicked = True
            self.batcher.submit({"question_string": "warmup ?",
                                 "image_index": int(record["image_id"]),
                                 "answer": None, "qid": None, "type": "dot"})
        return record

    def process_request_thread(self, request, client_address):
        with self._inflight_cv:
            self._inflight += 1
        try:
            super().process_request_thread(request, client_address)
        finally:
            with self._inflight_cv:
                self._inflight -= 1
                self._inflight_cv.notify_all()

    def server_close(self) -> None:  # shutdown drains the batcher too
        # socketserver calls server_close from a FAILED __init__ (port
        # already bound) before the batcher exists
        cv = getattr(self, "_inflight_cv", None)
        if cv is not None:
            deadline = monotonic() + self.answer_timeout
            with cv:
                while self._inflight > 0:
                    remaining = deadline - monotonic()
                    if remaining <= 0:
                        break
                    cv.wait(remaining)
        batcher = getattr(self, "batcher", None)
        if batcher is not None:
            batcher.close(timeout=self.answer_timeout)
        super().server_close()


class _Handler(BaseHTTPRequestHandler):
    server: QAServer

    def _json(self, code: int, payload: Dict[str, Any]) -> None:
        body = json.dumps(payload, default=str).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _read_json(self) -> Optional[Dict[str, Any]]:
        try:
            n = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(n))
        except (ValueError, json.JSONDecodeError):
            self._json(400, {"error": "invalid JSON body"})
            return None

    def _qa_pair(self, req: Dict[str, Any]) -> Dict[str, Any]:
        """Resolve a request into a qa_pair (raises ValueError -> 400)."""
        if "image_index" not in req:
            raise ValueError("missing 'image_index'")
        image_index = int(req["image_index"])
        known = self.server.img_to_qas.get(image_index)
        if "question_id" in req:
            if not known:
                raise ValueError(f"no known questions for figure "
                                 f"{image_index}")
            qi = int(req["question_id"])
            if not 0 <= qi < len(known):
                raise ValueError(f"question_id {qi} out of range "
                                 f"(figure has {len(known)})")
            return known[qi]
        if not req.get("question"):
            raise ValueError("provide 'question' text or a 'question_id'")
        # free-form question: the synthetic qa_pair the demo bot builds
        # (reference Interactive_demo.py:82-84)
        return {"question_string": str(req["question"]),
                "image_index": image_index, "answer": None,
                "qid": None, "type": "dot"}

    def _ingest(self, req: Dict[str, Any]) -> None:
        """POST /v1/figures: {"png_base64", "image_id"?, "annotation"?,
        "ocr_mode"?} -> the registered figure's id and a record summary."""
        from crct_tpu_torch.ingest import IngestError
        if not req.get("png_base64"):
            raise ValueError("missing 'png_base64' (base64-encoded image)")
        try:
            png = base64.b64decode(req["png_base64"], validate=True)
        except (ValueError, TypeError):
            raise ValueError("'png_base64' is not valid base64")
        image_id = req.get("image_id")
        try:
            record = self.server.ingest_figure(
                png, image_id=None if image_id is None else int(image_id),
                annotation=req.get("annotation"),
                ocr_mode=req.get("ocr_mode"))
        except IngestError as exc:   # image decoded but yields no record
            self._json(422, {"error": str(exc)})
            return
        except ValueError:
            raise                    # -> 400 (bad image / ingest disabled)
        except Exception as exc:     # noqa: BLE001
            # extraction runs over client-supplied bytes and annotation
            # JSON; malformed input can fail anywhere in the geometry and
            # OCR pipeline (a truncated PNG's OSError, an annotation's
            # TypeError/KeyError). Answer with an HTTP error instead of
            # dropping the connection.
            self._json(422, {"error": f"ingestion failed: "
                                      f"{type(exc).__name__}: {exc}"})
            return
        opts = self.server.scorer.dataset.get_possible_answers(
            record["image_id"], record)
        self._json(200, {
            "image_index": int(record["image_id"]),
            "n_elements": int(len(record["vis_feat"])),
            "n_possible_answers": len(opts),
            "title": str(record["text_feat"]
                         .get("title", {}).get("text", ""))})

    def _answer(self, reqs: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        t0 = monotonic()
        futs = [self.server.batcher.submit(self._qa_pair(r),
                                           top=int(r.get("top", 0)))
                for r in reqs]
        out = [f.result(timeout=self.server.answer_timeout) for f in futs]
        self.server.latencies_ms.append((monotonic() - t0) * 1e3)
        return out

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        parts = self.path.strip("/").split("/")
        if self.path == "/healthz":
            lat = np.asarray(list(self.server.latencies_ms))
            bs = self.server.batcher.batch_sizes
            self._json(200, {
                "status": "ok",
                "dispatches": self.server.scorer.dispatches,
                "served": self.server.scorer.served,
                "latency_ms_p50": round(float(np.percentile(lat, 50)), 1)
                if len(lat) else None,
                "latency_ms_p95": round(float(np.percentile(lat, 95)), 1)
                if len(lat) else None,
                "mean_coalesced_batch": round(float(np.mean(bs)), 2)
                if bs else None})
        elif self.path == "/v1/figures":
            # list() is atomic under the GIL; sorting the dict view
            # directly could race concurrent ingest inserts
            self._json(200, {
                "ingested": sorted(list(self.server.scorer.figs)),
                "ingest_enabled": self.server.ingestor is not None})
        elif (len(parts) == 4 and parts[:2] == ["v1", "figures"]
                and parts[3] == "questions"):
            try:
                image_index = int(parts[2])
            except ValueError:
                self._json(400, {"error": f"bad figure id {parts[2]!r}"})
                return
            qas = self.server.img_to_qas.get(image_index)
            if qas is None:
                self._json(404, {"error": f"unknown figure {image_index}"})
                return
            self._json(200, {"image_index": image_index, "questions": [
                str(qa["question_string"]) for qa in qas]})
        else:
            self._json(404, {"error": f"unknown path {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 (http.server API)
        req = self._read_json()
        if req is None:
            return
        try:
            if self.path == "/v1/answer":
                rec = self._answer([req])[0]
                # per-request scoring errors (unknown figure) are carried
                # in the rec so they can't poison coalesced batchmates
                self._json(404 if rec.get("error") else 200, rec)
            elif self.path == "/v1/answers":
                if not isinstance(req.get("questions"), list):
                    raise ValueError("body must carry a 'questions' list")
                # batch responses stay 200 with per-item "error" fields
                self._json(200, {"answers": self._answer(req["questions"])})
            elif self.path == "/v1/figures":
                self._ingest(req)
            else:
                self._json(404, {"error": f"unknown path {self.path}"})
        except ValueError as exc:
            self._json(400, {"error": str(exc)})
        except (TypeError, AttributeError) as exc:
            # wrong field TYPES in the JSON body: a malformed request
            self._json(400, {"error": f"malformed request: {exc}"})
        except KeyError as exc:
            self._json(404, {"error": f"unknown figure: {exc}"})
        except FuturesTimeout:
            self._json(503, {"error": "scoring timed out; retry"})

    def log_message(self, fmt: str, *args) -> None:  # quiet by default
        pass


def make_server(params: Dict[str, Any], *, dataset=None, model=None,
                port: Optional[int] = None, ingestor=None,
                device="cuda") -> QAServer:
    """Build the server on ``device`` (a list: a scorer replica on each;
    port 0 picks a free port). It scores one known question before it is
    returned, so the kernel build happens before traffic is accepted.
    ``ingestor`` (or -serve_detector_weights, whose detector runs on the
    first device) enables POST /v1/figures and
    runs one detect before the server is returned; -serve_no_dataset skips
    the feature shards entirely."""
    devices = device if isinstance(device, (list, tuple)) else [device]
    device = resolve_device(devices[0])
    if dataset is None:
        if params.get("serve_no_dataset"):
            dataset = InMemoryFigures(params, split=params["eval_set"])
        else:
            dataset = ChartQADataset(params, params["eval_set"],
                                     init_split=params["eval_set"])
            dataset.get_all_answers = True
    if ingestor is None and params.get("serve_detector_weights"):
        from crct_tpu_torch.detector.extract import parse_canvas
        from crct_tpu_torch.ingest import FigureIngestor
        ingestor = FigureIngestor.from_weights(
            params["serve_detector_weights"], dataset=params["dataset"],
            num_classes=params.get("categories") or 228,
            canvas=parse_canvas(params["serve_detector_canvas"]),
            short_edge=params.get("serve_short_edge", 800), device=device)
    scorer = QAScorer(params, dataset, model=model, device=devices)
    server = QAServer(("", params["port"] if port is None else port), scorer,
                      max_batch=params.get("serve_max_batch", 32),
                      max_delay_ms=params.get("serve_max_delay_ms", 5.0),
                      ingestor=ingestor)
    if server.img_to_qas:
        scorer.warmup(next(iter(server.img_to_qas.values()))[0])
    if ingestor is not None:
        ingestor.warmup()
    return server
