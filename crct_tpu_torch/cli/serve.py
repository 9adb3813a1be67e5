"""HTTP batch-serving entry point of the PyTorch port.

Serves the pred dicts of crct_tpu_torch/serve.py over HTTP with dynamic
batching onto the eval path, on the card unless ``-device cpu`` is given.

Usage:
    python -m crct_tpu_torch.cli.serve -qa_file qa_pairs_test.npy \\
        -dataset_config config/plotqa.json -eval_set test \\
        -start_checkpoint crct.ckpt -port 8373 -device cuda

``-start_checkpoint`` is one of the port's checkpoints, a reference
``crct.ckpt`` or a JAX package checkpoint (an Orbax directory, read with
tensorstore), loaded in transfer mode. ``-fast_scorer`` (with ``-fast_scorer_topk K``) serves through the
fast-scorer head of a ``cli.train_fast_scorer`` checkpoint.
``-serve_detector_weights det.ckpt`` (a port or JAX detector checkpoint, a
torch ``.pth``, a Detectron2 ``.pkl`` or ``none``) enables POST /v1/figures: chart
PNGs are ingested by the detector on the same device. With
``-serve_no_dataset`` the server loads no feature shards and serves only
ingested figures. ``-mesh_shape N`` serves over the first N cards: a
replica of the model on each, every dispatch's rows split across them.
"""

from __future__ import annotations

import signal
import threading

import torch

from crct_tpu_torch.config import read_command_line
from crct_tpu_torch.serve import make_server
from crct_tpu_torch.utils.device import params_device

def serving_devices(params):
    """The device of ``-device`` / ``-cuda_num``, or with ``-mesh_shape N``
    the first N cards (N replicas on the CPU with ``-device cpu``)."""
    if not params.get("mesh_shape"):
        return params_device(params)
    n = int(params["mesh_shape"])
    if params["device"] == "cpu":
        return ["cpu"] * n
    visible = torch.cuda.device_count()
    if n > visible:
        raise SystemExit(f"-mesh_shape {n}: only {visible} cards are "
                         f"visible")
    return [f"cuda:{i}" for i in range(n)]


def main(argv=None):
    params = read_command_line(argv)
    if params.get('serve_no_dataset') and \
            not params.get('serve_detector_weights'):
        raise SystemExit("-serve_no_dataset needs -serve_detector_weights: "
                         "with no feature shards, figures can only arrive "
                         "through POST /v1/figures ingestion")
    device = serving_devices(params)
    print(f"Loading the model on {device} and warming up...", flush=True)
    server = make_server(params, device=device)
    host, port = server.server_address[:2]
    ingest = " | POST /v1/figures (PNG ingest)" if server.ingestor else ""
    print(f"Serving QA on http://{host or '0.0.0.0'}:{port} "
          f"(max_batch={params['serve_max_batch']}, "
          f"max_delay={params['serve_max_delay_ms']}ms). "
          f"POST /v1/answer | POST /v1/answers | GET /healthz{ingest}",
          flush=True)

    # containerized deploys stop with SIGTERM: drain the batcher and close
    # the socket instead of dying mid-dispatch
    def _graceful(*_):
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _graceful)
    except ValueError:          # not the main thread
        pass
    try:
        server.serve_forever()
    except KeyboardInterrupt:  # pragma: no cover - interactive
        pass
    finally:
        server.server_close()
        print("Server stopped.", flush=True)


if __name__ == "__main__":
    main()
