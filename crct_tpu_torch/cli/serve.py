"""HTTP batch-serving entry point of the PyTorch port.

Serves the pred dicts of crct_tpu_torch/serve.py over HTTP with dynamic
batching onto the eval path, on the card unless ``-device cpu`` is given.

Usage:
    python -m crct_tpu_torch.cli.serve -qa_file qa_pairs_test.npy \\
        -dataset_config config/plotqa.json -eval_set test \\
        -start_checkpoint crct.ckpt -port 8373 -device cuda

``-start_checkpoint`` is a torch state dict in the reference layout (a
reference ``crct.ckpt``); Orbax checkpoints of the JAX package are not read
yet.
"""

from __future__ import annotations

import signal
import threading

from crct_tpu_torch.config import read_command_line
from crct_tpu_torch.serve import make_server

# flags of the JAX server that would change what the port serves
NOT_PORTED = ("fast_scorer", "fast_scorer_topk", "serve_detector_weights",
              "serve_no_dataset", "pallas", "mesh_shape")


def main(argv=None):
    params = read_command_line(argv)
    for flag in NOT_PORTED:
        if params.get(flag):
            raise SystemExit(f"-{flag} is not yet ported to the PyTorch "
                             f"server")
    device = params["device"]
    if device == "cuda" and params["cuda_num"] >= 0:
        device = f"cuda:{params['cuda_num']}"
    print(f"Loading the model on {device} and warming up...", flush=True)
    server = make_server(params, device=device)
    host, port = server.server_address[:2]
    print(f"Serving QA on http://{host or '0.0.0.0'}:{port} "
          f"(max_batch={params['serve_max_batch']}, "
          f"max_delay={params['serve_max_delay_ms']}ms). "
          f"POST /v1/answer | POST /v1/answers | GET /healthz", flush=True)

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
