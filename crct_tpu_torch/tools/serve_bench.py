"""Serving throughput and latency under load: the live HTTP server (the port
of ``tools/serve_bench.py``).

Measures what a production caller sees: concurrent POST /v1/answer requests
against ``crct_tpu_torch.serve.make_server`` with the FLAGSHIP model
(config/vilbert.json geometry, parameters in bf16), the dynamic batcher
coalescing them onto the eval path through K1. Complements the bench's
``eval_candidate_rows_per_sec_per_chip`` (the raw dispatch ceiling) with
everything serving adds on top: HTTP, JSON, per-question example building
on the batcher thread, and the candidate fan-out of synthetic-schema
figures. The kernels are built and the eval path warmed inside
``make_server``, before any timed request.

Prints ONE JSON line, the JAX tool's keys ({"serve_questions_per_sec_per_chip",
"latency_ms_p50", "latency_ms_p95", "mean_coalesced_batch", "dispatches",
"sequential_latency_ms_p50", ...}) with the card's name and power limit and
the K1 launches of the timed load.

Usage: python -m crct_tpu_torch.tools.serve_bench [--fast K]
       python -m crct_tpu_torch.tools.serve_bench --device cpu --tiny
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import threading
import time
import urllib.request

import numpy as np


def _post(base: str, payload: dict, timeout: float = 600.0) -> dict:
    req = urllib.request.Request(
        base + "/v1/answer", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--threads", type=int, default=16,
                    help="concurrent client threads")
    ap.add_argument("--requests", type=int, default=256,
                    help="total timed requests across all threads")
    ap.add_argument("--sequential", type=int, default=32,
                    help="extra single-thread requests for the unbatched "
                         "latency baseline (0 = skip)")
    ap.add_argument("--max-batch", type=int, default=64,
                    help="server-side dynamic batching cap")
    ap.add_argument("--chunk", type=int, default=480,
                    help="candidate rows per eval dispatch")
    ap.add_argument("--fast", type=int, default=0, metavar="K",
                    help="serve with -fast_scorer -fast_scorer_topk K "
                         "(throughput and latency only: the head is "
                         "random, so the ANSWERS are from a random "
                         "shortlist)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tiny", action="store_true",
                    help="the tiny model (a smoke run on the CPU)")
    args = ap.parse_args(argv)

    from crct_tpu_torch.bench import card_info, tiny_config
    from crct_tpu_torch.config import default_params
    from crct_tpu_torch.data.synthetic import generate_dataset
    from crct_tpu_torch.serve import make_server
    from crct_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)     # no card: raise before any work
    with tempfile.TemporaryDirectory(prefix="serve_bench_") as root:
        model_config = ""                    # the flagship's geometry
        if args.tiny:
            model_config = os.path.join(root, "tiny.json")
            with open(model_config, "w") as f:
                json.dump(dataclasses.asdict(tiny_config()), f)
        cfg = generate_dataset(root, n_images=16, division=8, n_questions=8,
                               feat_dim=1024, splits=("test",))
        params = default_params(
            figure_feat_path=cfg["figure_feat_path"],
            qa_parent_dir=cfg["qa_parent_dir"],
            dataset_config={
                "dataset_files_divisions": cfg["dataset_files_divisions"]},
            eval_set="test", eval_batch_size=args.chunk,
            save_path=os.path.join(root, "results"),
            model_config=model_config, bf16=not args.tiny,
            serve_max_batch=args.max_batch, serve_max_delay_ms=5.0,
            fast_scorer=bool(args.fast), fast_scorer_topk=args.fast)

        print(f"[serve_bench] building server + warmup "
              f"(flagship={'no' if args.tiny else 'yes'}, "
              f"chunk={args.chunk}"
              + (f", fast topk={args.fast}" if args.fast else "")
              + f", {device})...", flush=True)
        t0 = time.perf_counter()
        server = make_server(params, port=0, device=device)
        print(f"[serve_bench] server ready in {time.perf_counter() - t0:.1f}s",
              flush=True)
        srv_thread = threading.Thread(target=server.serve_forever,
                                      daemon=True)
        srv_thread.start()
        try:
            result = _load(server, args)
        finally:
            server.shutdown()
            server.server_close()
            srv_thread.join(timeout=60)
    result.update(card_info(device))
    print(json.dumps(result), flush=True)
    return result


def _load(server, args) -> dict:
    """The sequential baseline, then the concurrent load; the JAX tool's
    keys."""
    from crct_tpu_torch.bench import Launches

    base = f"http://127.0.0.1:{server.server_address[1]}"
    qas = [(int(img), qi) for img, lst in server.img_to_qas.items()
           for qi in range(len(lst))]

    # ---- sequential baseline (no coalescing possible) -------------------
    seq_lat = []
    for i in range(args.sequential):
        img, qi = qas[i % len(qas)]
        t = time.perf_counter()
        _post(base, {"image_index": img, "question_id": qi})
        seq_lat.append((time.perf_counter() - t) * 1e3)

    # ---- concurrent load -------------------------------------------------
    server.scorer.dispatches = 0
    server.batcher.batch_sizes.clear()
    latencies: list = []
    errors: list = []
    lock = threading.Lock()
    # distribute the remainder so exactly --requests requests are issued
    counts = [args.requests // args.threads +
              (1 if t < args.requests % args.threads else 0)
              for t in range(args.threads)]
    starts = list(np.cumsum([0] + counts[:-1]))

    def worker(tid: int) -> None:
        mine = []
        try:
            for i in range(counts[tid]):
                img, qi = qas[(starts[tid] + i) % len(qas)]
                t = time.perf_counter()
                rec = _post(base, {"image_index": img, "question_id": qi})
                mine.append((time.perf_counter() - t) * 1e3)
                if rec.get("answer") is None and \
                        rec.get("cls_output") is not None:
                    raise ValueError(f"no answer in {rec}")
        except Exception as exc:  # noqa: BLE001 - surfaced in the report
            with lock:
                errors.append(f"thread {tid}: {type(exc).__name__}: {exc}")
        with lock:
            latencies.extend(mine)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(args.threads)]
    with Launches() as launched:
        t_wall = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t_wall

    n = len(latencies)
    if n == 0:
        errors.append("no requests completed: percentiles unavailable")
    lat = np.asarray(latencies) if latencies else np.full(1, np.nan)
    batch_sizes = server.batcher.batch_sizes
    # one process serves from one card: the rate is the card's
    return {
        "serve_questions_per_sec_per_chip": n / wall,
        "latency_ms_p50": float(np.percentile(lat, 50)) if n else None,
        "latency_ms_p95": float(np.percentile(lat, 95)) if n else None,
        "sequential_latency_ms_p50":
            float(np.percentile(np.asarray(seq_lat), 50))
            if seq_lat else None,
        "mean_coalesced_batch":
            float(np.mean(batch_sizes)) if batch_sizes else 0.0,
        "dispatches": int(server.scorer.dispatches),
        "eval_rows_per_dispatch": args.chunk,
        "fast_topk": args.fast,
        "requests": n,
        "threads": args.threads,
        "wall_s": wall,
        "errors": errors,
        "launches": launched.record,
    }


if __name__ == "__main__":
    main()
