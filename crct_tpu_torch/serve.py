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
  GET  /v1/figures                 -> ingested figure ids (none: ingestion
                                      is not ported yet)
  GET  /v1/figures/<id>/questions  -> known questions for a figure
  POST /v1/figures                 -> 400 "figure ingestion is disabled"
  POST /v1/answer                  -> one pred dict (free-form question or a
                                      known question picked by index)
  POST /v1/answers                 -> list of pred dicts, scored as a batch

The pred dict mirrors the JAX server's (answer, cls_output, reg_output,
is_reg, confidence, optional ``top``); ``confidence`` is the model's raw
per-candidate NSP probability. Fast-scorer serving, figure ingestion and
data parallelism are not ported yet.
"""

from __future__ import annotations

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
                                            make_eval_step,
                                            make_eval_step_dedup,
                                            resolve_eval_chunk,
                                            segmented_argmax)
from crct_tpu_torch.utils.convert import load_torch_checkpoint
from crct_tpu_torch.utils.device import resolve_device


class QAScorer:
    """Batched question scorer on the eval path.

    ``score`` takes a LIST of qa_pairs and answers them all through shared
    fixed-size dispatches. Runs on ``device`` (the card unless the caller
    asks for the CPU); the model's weights come from ``model``, else from
    ``-start_checkpoint`` (a torch state dict in the reference layout), else
    a deterministic init seeded by ``-seed``."""

    def __init__(self, params: Dict[str, Any], dataset: ChartQADataset,
                 model: Optional[CRCTModel] = None, *, device="cuda"):
        if params.get("fast_scorer"):
            raise NotImplementedError("-fast_scorer serving is not ported yet")
        self.params = params
        self.dataset = dataset
        self.device = resolve_device(device)
        if model is None:
            model = build_model(params, device=self.device)
            if params.get("start_checkpoint"):
                model.load_state_dict(
                    load_torch_checkpoint(params["start_checkpoint"]),
                    strict=True)
        self.model = model.to(self.device).eval()
        # transfer-deduplicated dispatch: per-question visual arrays ship
        # once per coalesced batch and are gathered per row on the card
        self.dedup = bool(params.get("eval_dedup", True))
        self.eval_step = (make_eval_step_dedup(self.model) if self.dedup
                          else make_eval_step(self.model))
        # bf16 models: cast image_feat on the host (bit-identical: the
        # model's first touch casts it to bf16) and move half the bytes
        self.bf16_transfer = self.model.compute_dtype == torch.bfloat16
        # pad the question axis of the visual arrays to multiples of this
        # so coalesced batches of varying size keep a few shapes
        self.vis_pad = max(1, int(params.get("serve_max_batch", 32)))
        self.chunk = resolve_eval_chunk(params)
        self.dispatches = 0
        self.served = 0

    def _vis_from_batch(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        """Per-question visual arrays -> the card, once per coalesced batch
        (the dedup layout of train/eval_loop.py), padded to ``vis_pad``."""
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
            vis[k] = t.to(self.device)
        return vis

    def _run_chunks(self, rows: Dict[str, np.ndarray], vis=None, qidx=None):
        """Dispatch rows through the eval step in ``self.chunk``-row pieces;
        one host fetch per dispatch. Returns the NSP probabilities and the
        regression outputs of the valid rows. ``vis``/``qidx`` select the
        dedup signature (text rows + per-question visual arrays + row ->
        question index)."""
        if qidx is not None:
            rows = dict(rows, _qidx=np.asarray(qidx, np.int64))
        a_list, b_list = [], []
        for piece, valid in _chunk_rows(rows, self.chunk):
            q = piece.pop("_qidx", None)
            out = (self.eval_step(piece, vis, q) if q is not None
                   else self.eval_step(piece))
            a_list.append(out[0][:valid].float().cpu().numpy())
            b_list.append(out[1][:valid].float().cpu().numpy())
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
                fig_feat = ds.get_fig_feat(idx)
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

        per_item = self._score_full(collate(items), top) if items else []

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
                 max_delay_ms: float = 5.0):
        super().__init__(addr, _Handler)
        self.scorer = scorer
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
            self._json(200, {"ingested": [], "ingest_enabled": False})
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
                raise ValueError("figure ingestion is disabled: the port "
                                 "has no detector yet")
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
                port: Optional[int] = None, device="cuda") -> QAServer:
    """Build the server on ``device`` (port 0 picks a free port). It scores
    one known question before it is returned, so the kernel build happens
    before traffic is accepted."""
    device = resolve_device(device)
    if dataset is None:
        dataset = ChartQADataset(params, params["eval_set"],
                                 init_split=params["eval_set"])
        dataset.get_all_answers = True
    scorer = QAScorer(params, dataset, model=model, device=device)
    server = QAServer(("", params["port"] if port is None else port), scorer,
                      max_batch=params.get("serve_max_batch", 32),
                      max_delay_ms=params.get("serve_max_delay_ms", 5.0))
    if server.img_to_qas:
        scorer.warmup(next(iter(server.img_to_qas.values()))[0])
    return server
