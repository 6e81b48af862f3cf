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
"""
from __future__ import annotations

import base64
import contextlib
import io
import json
import threading
import time
from collections import deque
from dataclasses import dataclass
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..data.transforms import image_to_model_input
from ..utils.viz import gif_bytes
from .batcher import BatcherOverloaded, DynamicBatcher

MAX_BODY_BYTES = 32 * 1024 * 1024


@dataclass
class GenRequest:
    prompt: str
    image: np.ndarray  # (res, res, 3) float32 in [-1, 1]
    # the classifier-free guidance's negative direction: the uncond CLIP
    # embedding comes from this text instead of ""
    negative_prompt: str = ""


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
        # end-to-end request latency (queue wait + sampling), last 256
        self._latencies: deque = deque(maxlen=256)
        self._tok_uc = tokenizer([""] * max_batch)
        self.batcher = DynamicBatcher(self._handle_batch, max_batch,
                                      max_wait_ms).start()

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
        req = GenRequest(prompt=prompt, image=image,
                         negative_prompt=negative_prompt)
        t0 = time.monotonic()
        result = self.batcher.submit(req).result(timeout=timeout_s)
        self._latencies.append(time.monotonic() - t0)
        return result

    def stats(self) -> dict:
        lat = sorted(self._latencies)

        def pct(p):
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 3)

        return {
            "ok": True,
            "batches": self.batcher.batches,
            "requests": self.batcher.requests,
            "latency_p50_s": pct(0.50) if lat else None,
            "latency_p95_s": pct(0.95) if lat else None,
        }

    def _next_generator(self) -> torch.Generator:
        with self._lock:
            counter = self._counter
            self._counter += 1
        return torch.Generator(device=self.pipe.device).manual_seed(
            batch_seed(self.seed, counter))

    def _handle_batch(self, reqs) -> list:
        dev = torch.device(self.pipe.device)
        on_card = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
        with torch.no_grad(), on_card:
            return self._sample(reqs)

    def _sample(self, reqs) -> list:
        n = len(reqs)
        pad = self.max_batch - n
        # one batch shape per server: row 0 repeated, sliced off after
        frames = np.stack([r.image for r in reqs] + [reqs[0].image] * pad)
        cond = frames[:, None].repeat(self.cond_frames, axis=1)
        prompts = [r.prompt for r in reqs] + [""] * pad
        negs = [r.negative_prompt for r in reqs] + [""] * pad
        tok_uc = self.tokenizer(negs) if any(negs) else self._tok_uc
        common = dict(num_frames=self.num_frames,
                      generator=self._next_generator(),
                      ddim_steps=self.ddim_steps,
                      guidance_scale=self.guidance_scale,
                      **self.sampling_kwargs)
        if self.total_frames:
            # chains padded with their last entry (or truncated) to the
            # server's chunk count, then tokenized per chunk
            f2 = self.num_frames - self.cond_frames
            n_chunks = -(-self.total_frames // f2)
            chains = [[s.strip() for s in p.split("|") if s.strip()] or [""]
                      for p in prompts]
            chains = [(c + [c[-1]] * n_chunks)[:n_chunks] for c in chains]
            prompts_tok = [self.tokenizer([c[i] for c in chains])
                           for i in range(n_chunks)]
            videos = self.pipe.generate_rollout(
                cond, prompts_tok, tok_uc["input_ids"],
                tok_uc["attention_mask"], total_frames=self.total_frames,
                **common)
        else:
            tok = self.tokenizer(prompts)
            videos = self.pipe.generate(
                cond, tok["input_ids"], tok["attention_mask"],
                tok_uc["input_ids"], tok_uc["attention_mask"], **common)
        videos = videos.float().cpu().numpy()  # (B, f2, h, w, 3) in [0, 1]
        cond01 = (cond + 1.0) / 2.0
        return [np.concatenate([cond01[i], videos[i]], axis=0)
                for i in range(n)]

    def warmup(self) -> None:
        """One padded batch before the server listens: the kernels build
        at their first use, and the first request does not pay for it."""
        dummy = GenRequest(prompt="", image=np.zeros(
            (self.resolution, self.resolution, 3), np.float32))
        self._handle_batch([dummy])

    def stop(self) -> None:
        self.batcher.stop()


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
