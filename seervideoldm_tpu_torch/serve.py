"""Batched HTTP serving of image + text -> video generation, on the GPU
(port of the root ``serve.py``):

    python -m seervideoldm_tpu_torch.serve --config configs/serve.yaml \\
        --set serve_port=8000 --set serve_max_batch=4

then::

    curl -s localhost:8000/generate -d '{"prompt": "push the cup left",
        "image": "<base64 png/jpeg>"}' -o clip.gif

Takes the JAX entry's YAML keys.  Requests are batched by
``serving.DynamicBatcher`` and padded to ``serve_max_batch`` rows; the
sampling knobs (``ddim_steps``, ``scale``, ``sampler``, ``num_frames``,
PAB ...) are fixed per server.  Before it listens the server runs one
padded batch (the kernels build at their first use), then prints
``serving on http://<host>:<port>`` with the port it bound, so
``serve_port=0`` takes a free one.  SIGTERM or Ctrl-C stop it cleanly
(exit 0).  Runs on CUDA; ``--device cpu`` runs the plain PyTorch path.
One process on one card: ``mesh_shape`` is refused.
"""
from __future__ import annotations

import signal
import sys
import threading
from typing import Optional

from .config import check_serving, parse_args, sampling_kwargs_from
from .inference_img import build_pipeline
from .serving import GenerationService, make_server


def build_service(cfg, pipe, tokenizer) -> GenerationService:
    """The config's ``GenerationService`` over a built pipeline."""
    return GenerationService(
        pipe, tokenizer, resolution=int(cfg.resolution),
        cond_frames=int(cfg.cond_frames), num_frames=int(cfg.num_frames),
        ddim_steps=int(cfg.ddim_steps), guidance_scale=float(cfg.scale),
        max_batch=int(cfg.serve_max_batch),
        max_wait_ms=float(cfg.serve_max_wait_ms), seed=int(cfg.seed),
        sampling_kwargs=sampling_kwargs_from(cfg),
        total_frames=int(cfg.total_frames) if cfg.total_frames else None)


def main(argv: Optional[list[str]] = None, device=None) -> None:
    cfg = parse_args("Seer serving (PyTorch / CUDA port)",
                     extra_flags={"device": None}, argv=argv)
    check_serving(cfg)
    # build_pipeline sets the numerics (TF32 off, fp32 reductions) before
    # any batch runs; they are process-wide, the worker thread inherits them
    pipe, tokenizer, cfg = build_pipeline(cfg, device or cfg.get("device"),
                                          mesh=False)
    service = build_service(cfg, pipe, tokenizer)
    try:
        print("warmup: one padded batch ...", flush=True)
        service.warmup()
        server = make_server(service, host=cfg.serve_host,
                             port=int(cfg.serve_port))
    except BaseException:
        service.stop()
        raise
    print(f"serving on http://{cfg.serve_host}:{server.server_address[1]} "
          f"(max_batch={cfg.serve_max_batch}, steps={cfg.ddim_steps}, "
          f"sampler={cfg.sampler}, device={pipe.device})", flush=True)

    def _sigterm(*_args):
        # a service manager's stop: unwind as Ctrl-C does
        raise KeyboardInterrupt

    if threading.current_thread() is threading.main_thread():
        signal.signal(signal.SIGTERM, _sigterm)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.stop()
    print("stopped", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
