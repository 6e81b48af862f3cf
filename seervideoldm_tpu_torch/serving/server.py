"""HTTP serving of image + text -> video generation (port of
``seervideoldm_tpu/serving/server.py``).

A ``GenerationService`` owns a ``SeerPipeline`` and pads every request
group that ``DynamicBatcher`` forms to ``max_batch`` rows (row 0 repeated,
the extra rows sliced off after sampling), so a server runs one batch
shape: the JAX package's results for the same requests, and the one
static shape a CUDA graph around the UNet call needs.  The HTTP layer is
the standard library's ``ThreadingHTTPServer``.

API:
  GET  /healthz             -> {"ok": true, "batches": N, "requests": M,
                                "latency_p50_s": ..., "latency_p95_s": ...}
      batches / requests: the batches the batcher formed and the requests
      they carried; latency_p50_s / p95_s: over this service's completed
      ``serve.request`` spans still in the tracer's ring, submission to
      video.  Beside them, ``utils.profiling.counters()`` reads the
      serving counters where they are kept: ``serve.batches``,
      ``serve.requests``, ``serve.refused`` (requests refused as
      ``BatcherOverloaded``, 503), ``serve.failed_batches`` (batches whose
      handler raised, 500) and ``serve.padded_rows`` (rows added to fill
      ``max_batch``, the warm-up's included).
  POST /generate            body: {"prompt": str, "image": base64 png/jpeg,
                                   "negative_prompt": str (optional)}
                            -> image/gif (cond frames + generated frames)

With ``total_frames`` the server runs the autoregressive rollout per batch
(``SeerPipeline.generate_rollout``), and a prompt may chain per-chunk
instructions with "|".

Randomness: batch number ``counter`` (0, 1, 2, ... in the order the
batches run, the warm-up's included) samples with a ``torch.Generator`` on
the pipeline's device seeded ``((seed & 0xffffffff) << 32) | counter``,
drawn under a lock.  A restarted server with the same seed fed the same
requests in the same order returns the same videos.  (The JAX package
folds the counter into a PRNG key; the draws differ, the rule is the
same.)

The batch runs on the batcher's worker thread, under ``torch.no_grad()``
and on the pipeline's own device.  An error there (a kernel's included)
reaches every request of its batch, which the HTTP layer answers with 500.

Spans (``utils/profiling.py``): each request's ``serve.request``
(submission to result, on the client's thread) and ``serve.queue``
(submission to the start of its batch's handler call), each batch's
``serve.batch`` (the handler call: the batch counter, real and padded
rows, the request ids), under a mesh ``serve.broadcast``, and
``pipe.copy_out`` (the videos to the host).

Under a mesh (several ranks, ``parallel.distributed``) rank 0 is the front
end and the other ranks follow (``follow``).  Rank 0's worker thread
broadcasts each batch before it samples (``parallel.collectives.
broadcast_arrays``: a header of op, counter, real rows and chunk count,
then the padded cond frames and the token arrays, one tokenized batch per
chunk under ``total_frames``), and every rank makes the same pipeline call
with the generator of rank 0's counter; the pipeline splits the rows,
frames and weights and returns the whole batch on every rank; after it
every rank meets in one all-reduce, so no rank replies for a batch that
failed on another.  Rank 0 replies with its real rows.  Every collective
of the front end comes from that one worker thread: the warm-up and the
``stop`` broadcast run there through ``DynamicBatcher.call``, and after
``HEARTBEAT_S`` without a batch it broadcasts an ``idle`` header, so a
follower never waits longer than that in a collective.  Image decoding
and validation stay on the HTTP threads: a malformed body never reaches a
follower.  The one difference from one card: a batch that raises once
its broadcast has begun leaves the ranks' collectives out of step, so
the service marks itself failed (``failed``), answers that batch with
500, refuses every later one and calls ``on_failure``; the ``serve``
entry then ends every rank with a non-zero exit.
"""
from __future__ import annotations

import base64
import contextlib
import functools
import io
import itertools
import json
import sys
import threading
import traceback
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from ..data.transforms import image_to_model_input
from ..parallel.collectives import all_reduce_, broadcast_arrays, to_transport
from ..parallel.distributed import rank, world_size
from ..utils import profiling
from ..utils.viz import gif_bytes
from .batcher import BatcherOverloaded, DynamicBatcher

MAX_BODY_BYTES = 32 * 1024 * 1024
# seconds without a batch after which the front end broadcasts ``idle``:
# far below the process group's timeout, which a follower's wait for the
# next header would otherwise run into on an idle server
HEARTBEAT_S = 10.0
OP_BATCH, OP_IDLE, OP_STOP = 1, 2, 3
# request ids (every service's, so that a span names one request) and
# service ids (a service's spans among others')
_request_ids = itertools.count()
_service_ids = itertools.count()


@dataclass
class GenRequest:
    prompt: str
    image: np.ndarray  # (res, res, 3) float32 in [-1, 1]
    # the classifier-free guidance's negative direction: the uncond CLIP
    # embedding comes from this text instead of ""
    negative_prompt: str = ""
    request_id: int = -1
    submitted: Optional[int] = None  # profiling.now() at submission


def batch_seed(seed: int, counter: int) -> int:
    """The generator seed of batch ``counter`` of a server seeded ``seed``."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(counter) & 0xFFFFFFFF)


class GenerationService:
    """Batched generation: each request group padded to ``max_batch``."""

    def __init__(self, pipe, tokenizer, *, resolution: int, cond_frames: int,
                 num_frames: int, ddim_steps: int, guidance_scale: float,
                 sampler: str = "ddim", max_batch: int = 4,
                 max_wait_ms: float = 100.0, seed: int = 0,
                 sampling_kwargs: dict | None = None,
                 total_frames: int | None = None):
        self.pipe = pipe
        self.tokenizer = tokenizer
        self.resolution = resolution
        self.cond_frames = cond_frames
        self.num_frames = num_frames
        self.ddim_steps = ddim_steps
        self.guidance_scale = guidance_scale
        # per-call sampler knobs (config.sampling_kwargs_from); the dict's
        # sampler wins over the sampler= argument
        self.sampling_kwargs = dict(sampling_kwargs or {})
        self.sampling_kwargs.setdefault("sampler", sampler)
        # server-wide, so every request of a padded batch shares one chunk
        # count
        self.total_frames = int(total_frames) if total_frames else None
        if self.total_frames and num_frames - cond_frames < 1:
            raise ValueError("total_frames rollout needs num_frames > cond_frames")
        self.max_batch = max_batch
        self.seed = int(seed)
        self._counter = 0
        self._lock = threading.Lock()
        self._id = next(_service_ids)
        self.padded_rows = 0
        profiling.register_counters("serve", self, "padded_rows")
        self._tok_uc = tokenizer([""] * max_batch)
        self.ranks = world_size()
        # under a mesh: the error that put the ranks out of step, and what
        # to call then (the serve entry stops its HTTP server)
        self.failed: Optional[BaseException] = None
        self.on_failure: Optional[Callable[[], None]] = None
        self._stopped = False
        self.batcher = None
        if rank() == 0:
            self.batcher = DynamicBatcher(
                self._handle_batch, max_batch, max_wait_ms,
                idle_s=HEARTBEAT_S, on_idle=functools.partial(
                    self._send_op, OP_IDLE) if self.ranks > 1 else None
            ).start()

    def preprocess_image(self, data: bytes) -> np.ndarray:
        from PIL import Image

        with Image.open(io.BytesIO(data)) as img:
            return image_to_model_input(img, self.resolution)

    def generate(self, prompt: str, image_bytes: bytes,
                 negative_prompt: str = "",
                 timeout_s: float = 600.0) -> np.ndarray:
        """Blocking single-request API: (f, h, w, 3) video in [0, 1], the
        cond frames in front."""
        return self.generate_array(prompt, self.preprocess_image(image_bytes),
                                   negative_prompt, timeout_s)

    def generate_array(self, prompt: str, image: np.ndarray,
                       negative_prompt: str = "",
                       timeout_s: float = 600.0) -> np.ndarray:
        """As ``generate`` with a preprocessed (res, res, 3) [-1, 1] image,
        so the HTTP layer decodes the image in its own error class (a bad
        image is the client's 400, not a 500)."""
        rid = next(_request_ids)
        with profiling.coarse("serve.request", service=self._id,
                              request=rid) as rec:
            req = GenRequest(prompt=prompt, image=image,
                             negative_prompt=negative_prompt, request_id=rid,
                             submitted=rec.start)
            return self.batcher.submit(req).result(timeout=timeout_s)

    def stats(self) -> dict:
        lat = sorted((r["end"] - r["start"]) / 1e9
                     for r in profiling.spans("serve.request")
                     if r["ids"]["service"] == self._id
                     and "error" not in r["ids"])

        def pct(p):
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 3)

        return {
            "ok": True,
            "batches": self.batcher.batches,
            "requests": self.batcher.requests,
            "latency_p50_s": pct(0.50) if lat else None,
            "latency_p95_s": pct(0.95) if lat else None,
        }

    def _on_device(self):
        dev = torch.device(self.pipe.device)
        return (torch.cuda.device(dev) if dev.type == "cuda"
                else contextlib.nullcontext())

    def _handle_batch(self, reqs) -> list:
        if self.failed is not None or self._stopped:
            raise RuntimeError("the service has stopped" if self._stopped
                               else f"the service failed: {self.failed!r}")
        start = profiling.now()
        for r in reqs:
            if r.submitted is not None:
                profiling.record("serve.queue", r.submitted, start,
                                 request=r.request_id)
        pad = self.max_batch - len(reqs)
        self.padded_rows += pad
        with profiling.coarse("serve.batch", rows=len(reqs), padded=pad,
                              requests=[r.request_id for r in reqs]), \
                torch.no_grad(), self._on_device():
            return self._sample(reqs)

    def _sample(self, reqs) -> list:
        n = len(reqs)
        msg = self._pack(reqs)
        profiling.tag(batch=int(msg[0][1]))
        if self.ranks == 1:
            videos = self._run(msg)
        else:
            try:
                with profiling.span("serve.broadcast"):
                    broadcast_arrays(msg)
                videos = self._run(msg)
                _all_done()
            except BaseException as exc:
                self._fail(exc)
                raise
        cond01 = (msg[1] + 1.0) / 2.0
        return [np.concatenate([cond01[i], videos[i]], axis=0)
                for i in range(n)]

    def _pack(self, reqs) -> list:
        """The batch as the arrays every rank samples from: a header (op,
        batch counter, real rows, chunks), the cond frames padded to
        ``max_batch`` rows (row 0 repeated), then the prompt ids and masks
        (one pair per chunk under ``total_frames``) and the uncond pair."""
        n = len(reqs)
        pad = self.max_batch - n
        # one batch shape per server: row 0 repeated, sliced off after
        frames = np.stack([r.image for r in reqs] + [reqs[0].image] * pad)
        cond = frames[:, None].repeat(self.cond_frames, axis=1)
        prompts = [r.prompt for r in reqs] + [""] * pad
        negs = [r.negative_prompt for r in reqs] + [""] * pad
        tok_uc = self.tokenizer(negs) if any(negs) else self._tok_uc
        if self.total_frames:
            # chains padded with their last entry (or truncated) to the
            # server's chunk count, then tokenized per chunk
            f2 = self.num_frames - self.cond_frames
            n_chunks = -(-self.total_frames // f2)
            chains = [[s.strip() for s in p.split("|") if s.strip()] or [""]
                      for p in prompts]
            chains = [(c + [c[-1]] * n_chunks)[:n_chunks] for c in chains]
            toks = [self.tokenizer([c[i] for c in chains])
                    for i in range(n_chunks)]
        else:
            n_chunks, toks = 0, [self.tokenizer(prompts)]
        with self._lock:
            counter = self._counter
            self._counter += 1
        header = np.array([OP_BATCH, counter, n, n_chunks], np.int64)
        return [header, cond] + [t[k] for t in toks + [tok_uc]
                                 for k in ("input_ids", "attention_mask")]

    def _run(self, msg) -> np.ndarray:
        """The pipeline call of a packed batch: (B, f2, h, w, 3) in [0, 1]."""
        header, cond, *toks = msg
        counter, n_chunks = int(header[1]), int(header[3])
        generator = torch.Generator(device=self.pipe.device).manual_seed(
            batch_seed(self.seed, counter))
        common = dict(num_frames=self.num_frames, generator=generator,
                      ddim_steps=self.ddim_steps,
                      guidance_scale=self.guidance_scale,
                      **self.sampling_kwargs)
        uc_ids, uc_mask = toks[-2:]
        if n_chunks:
            prompts_tok = [{"input_ids": toks[2 * i],
                            "attention_mask": toks[2 * i + 1]}
                           for i in range(n_chunks)]
            videos = self.pipe.generate_rollout(
                cond, prompts_tok, uc_ids, uc_mask,
                total_frames=self.total_frames, **common)
        else:
            videos = self.pipe.generate(cond, toks[0], toks[1], uc_ids,
                                        uc_mask, **common)
        with profiling.span("pipe.copy_out", events=True):
            return videos.float().cpu().numpy()

    def warmup(self) -> None:
        """One padded batch before the server listens, on the worker thread
        (under a mesh a broadcast batch every rank runs): the kernels build
        at their first use, and the first request does not pay for it."""
        dummy = GenRequest(prompt="", image=np.zeros(
            (self.resolution, self.resolution, 3), np.float32))
        self.batcher.call(lambda: self._handle_batch([dummy])).result()

    def stop(self) -> None:
        """Drain the queue and stop the worker; under a mesh broadcast
        ``stop`` first, after the requests already queued (not after a
        failure: the followers are out of step)."""
        if self.batcher is None:
            return
        if self.ranks > 1:
            self.batcher.call(functools.partial(self._send_op,
                                                OP_STOP)).result()
        self.batcher.stop()

    def _send_op(self, op: int) -> None:
        """An ``idle`` or ``stop`` header to the followers, on the worker
        thread (``on_idle``, ``stop``); nothing after a failure or a stop.
        A failure to send fails the service."""
        if self.failed is not None or self._stopped:
            return
        with self._on_device():
            try:
                broadcast_arrays([np.array([op, 0, 0, 0], np.int64)])
            except Exception as exc:  # noqa: BLE001 -- recorded, reported
                self._fail(exc)
                return
        self._stopped = op == OP_STOP

    def _fail(self, exc: BaseException) -> None:
        if self.failed is not None:
            return
        self.failed = exc
        print(f"serving: rank {rank()} of {self.ranks}: a collective or a "
              "batch failed; the ranks are out of step:", file=sys.stderr)
        traceback.print_exception(exc, file=sys.stderr)
        sys.stderr.flush()
        if self.on_failure is not None:
            self.on_failure()

    def follow(self, give_up: Optional[Callable[[], bool]] = None) -> None:
        """A follower rank's loop: every batch rank 0 broadcasts, sampled
        as rank 0 samples it (the result dropped), until rank 0's ``stop``.
        ``give_up()``, asked after each ``idle`` header or batch, ends the
        wait with ``TimeoutError`` (the entry's bound after a SIGTERM)."""
        if self.batcher is not None:
            raise RuntimeError("rank 0 is the front end; follow() is for the "
                               "other ranks")
        with torch.no_grad(), self._on_device():
            while True:
                msg = broadcast_arrays(None)
                op = int(msg[0][0])
                if op == OP_STOP:
                    return
                if op == OP_BATCH:
                    self._run(msg)
                    _all_done()
                if give_up is not None and give_up():
                    raise TimeoutError("no stop from rank 0 in time after a "
                                       "stop signal")


def _all_done() -> None:
    """Every rank has finished the batch (an all-reduce): a rank whose
    batch failed has left, and this raises on the others."""
    all_reduce_(to_transport(torch.ones(1)))


class _Handler(BaseHTTPRequestHandler):
    service: GenerationService  # set by make_server

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode(), "application/json")

    def do_GET(self):  # noqa: N802 -- BaseHTTPRequestHandler API
        if self.path == "/healthz":
            self._send_json(200, self.service.stats())
        else:
            self._send_json(404, {"error": "not found"})

    def do_POST(self):  # noqa: N802
        if self.path != "/generate":
            self._send_json(404, {"error": "not found"})
            return
        length = int(self.headers.get("Content-Length", 0) or 0)
        if length > MAX_BODY_BYTES:
            self._send_json(413, {"error": f"body too large ({length} bytes)"})
            return
        try:
            payload = json.loads(self.rfile.read(length))
            prompt = payload.get("prompt", "")
            negative = payload.get("negative_prompt", "")
            if not isinstance(prompt, str) or not isinstance(negative, str):
                raise ValueError("prompt/negative_prompt must be strings")
            # line-wrapped base64 is tolerated; anything else is validated
            image_b64 = "".join(payload["image"].split())
            image_bytes = base64.b64decode(image_b64, validate=True)
            image = self.service.preprocess_image(image_bytes)
        except Exception as exc:  # noqa: BLE001 -- any malformed payload is
            # the client's error (non-dict JSON, non-str image, bad base64,
            # an undecodable image)
            self._send_json(400, {"error": f"bad request: {exc}"})
            return
        try:
            video = self.service.generate_array(prompt, image,
                                                negative_prompt=negative)
        except BatcherOverloaded as exc:
            self._send_json(503, {"error": f"overloaded: {exc}"})
            return
        except Exception as exc:  # noqa: BLE001 -- the request's failure,
            # reported to its client; the server keeps serving
            self._send_json(500, {"error": str(exc)})
            return
        self._send(200, gif_bytes(video), "image/gif")


def make_server(service: GenerationService, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """Build (not start) the HTTP server; the caller runs
    ``serve_forever()``."""
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)
