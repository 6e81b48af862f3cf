"""Closed-loop serving: ``clients`` threads each send one seeded image and
one instruction to the port's ``GenerationService`` in process
(``generate_array``), wait for the video, and send again.  HTTP and the
GIF are left out.

End-to-end: ``requests_per_s``, the requests completed in the window over
the time from the window's start to the last of them (requests complete
four at a time, so a rate over the whole window would jump by a batch in
eleven as the close falls before or after one); ``request_p95_s``, the
95th percentile of every request completed in the window, each timed
from its submission to its video.

``correct``: once the window has closed and the service has stopped, a
sample of the completed requests drawn from the seed is sampled again by
the plain reference from the same image and prompt, with the draws the
service's batch generator made for the request's batch and row
(``batch_seed(seed, counter)``: posterior noise, then x_T, at the padded
batch shape); the relative L2 gaps of the final latents and of the
predicted frames are held to the workload's limits.
"""
from __future__ import annotations

import sys
import threading
import time

import numpy as np
import torch

from seerbench import checks, harness
from seerbench.roofline import sampled_clip_flops, widths_of
from seerbench.weights import load_into_port, make_state


def batch_seed(seed: int, counter: int) -> int:
    """The service's generator seed of batch ``counter`` (its documented
    rule: ((seed & 0xffffffff) << 32) | counter)."""
    return ((int(seed) & 0xFFFFFFFF) << 32) | (int(counter) & 0xFFFFFFFF)


class _Batches:
    """Which requests each batch carried, when its pipeline call began,
    and the final latents it decoded: wrappers on the service's
    ``_pack`` / ``_run`` and the pipeline's ``vae_decode_video``."""

    def __init__(self, service, pipe):
        self.rows = {}        # id(image) -> (counter, row)
        self.packed_at = {}   # counter -> monotonic time
        self.latents = {}     # counter -> (B, f2, h', w', 4) tensor
        self._pending = []
        pack, run, decode = service._pack, service._run, pipe.vae_decode_video

        def packed(reqs):
            msg = pack(reqs)
            counter = int(msg[0][1])
            self.packed_at[counter] = time.monotonic()
            for row, r in enumerate(reqs):
                self.rows[id(r.image)] = (counter, row)
            return msg

        def ran(msg):
            out = run(msg)
            self.latents[int(msg[0][1])] = self._pending.pop()
            return out

        def decoded(latents):
            self._pending.append(latents.detach())
            return decode(latents)

        service._pack, service._run, pipe.vae_decode_video = packed, ran, decoded


def run(ctx: harness.Context) -> harness.Result:
    from seervideoldm_tpu_torch.inference_img import build_pipeline
    from seervideoldm_tpu_torch.serve import build_service

    config, wl = ctx.config, ctx.workload
    geo = harness.geometry(config, wl)
    cfg_dict = harness.port_config(config, wl, ctx.seed)
    marks = harness.Marks(ctx.t0)
    pipe, tok, cfg = build_pipeline(cfg_dict, device=ctx.device)
    marks("build")
    load_into_port(pipe.m, make_state(config, ctx.seed, ctx.device))
    harness.free_device()
    marks("weights")
    service = build_service(cfg, pipe, tok)
    batches = _Batches(service, pipe)
    service.warmup()
    marks("warmup")

    clients, per_client = int(wl["clients"]), int(wl["requests_per_client"])
    n_req = clients * per_client
    # one array object per request: the service keeps the object, so
    # id() maps a request to the batch and row that carried it
    pool = list(harness.images(harness.subseed(ctx.seed, "images"), n_req,
                               geo["res"]))
    texts = harness.prompts(harness.subseed(ctx.seed, "prompts"), n_req, wl)
    done, failures, exhausted = [], [], []
    lock = threading.Lock()

    probe = ctx.probe
    if probe is not None:
        probe.install()
    if ctx.device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t_open = time.monotonic()
    t_close = t_open + ctx.seconds
    if probe is not None:
        probe.open = True
    counters0 = (service.batcher.batches, service.batcher.requests)

    def client(c: int) -> None:
        for k in range(per_client):
            if time.monotonic() >= t_close:
                return
            i = c * per_client + k
            t_sub = time.monotonic()
            try:
                video = service.generate_array(texts[i], pool[i])
            except Exception as exc:  # noqa: BLE001 -- counted as failed
                with lock:
                    failures.append(repr(exc))
                return
            with lock:
                done.append(dict(i=i, t_sub=t_sub, t_done=time.monotonic(),
                                 video=video[geo["cond"]:]))
        if time.monotonic() < t_close:
            exhausted.append(c)

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for t in threads:
        t.start()
    time.sleep(max(0.0, t_close - time.monotonic()))
    counters1 = (service.batcher.batches, service.batcher.requests)
    for t in threads:
        t.join()
    if probe is not None:
        probe.open = False
    peak = torch.cuda.max_memory_allocated() if ctx.device == "cuda" else 0
    service.stop()
    if exhausted:
        raise RuntimeError(f"clients {exhausted} sent all their "
                           f"{per_client} requests inside the window: raise "
                           "requests_per_client")

    in_window = [d for d in done if d["t_done"] <= t_close]
    latency = np.asarray([d["t_done"] - d["t_sub"] for d in in_window])
    waits = [batches.packed_at[batches.rows[id(pool[d["i"]])][0]] - d["t_sub"]
             for d in in_window]
    n_done = len(in_window)
    unit_flops = sampled_clip_flops(widths_of(config), geo["frames"], geo["cond"],
                                    geo["res"], int(wl["unet_calls"]))
    last = max((d["t_done"] for d in in_window), default=t_open)
    e2e = {"requests_per_s": n_done / (last - t_open) if n_done else float("nan"),
           "request_p95_s": float(np.percentile(latency, 95)) if n_done else float("nan"),
           "setup_s": t_open - ctx.t0}
    record = {"window_s": ctx.seconds, "flops": unit_flops * n_done,
              "counters": {"batches": counters1[0] - counters0[0],
                           "requests": counters1[1] - counters0[1]},
              "queue_wait_s": waits}
    if probe is not None:
        record.update(probe.close())
        probe.uninstall()

    harness.note(setup=marks.seconds, e2e=e2e, memory_peak_bytes=peak,
                 window_s=record["window_s"], flops=record["flops"])
    # ------------------------------------------------------- correctness
    picked = harness.sample_indices(harness.subseed(ctx.seed, "check"),
                                    n_done, int(wl["check_requests"]))
    checked = []
    for d in (in_window[j] for j in picked):
        counter, row = batches.rows[id(pool[d["i"]])]
        checked.append(dict(image=pool[d["i"]], prompt=texts[d["i"]],
                            draw_seed=batch_seed(ctx.seed, counter),
                            draw_batch=int(cfg.serve_max_batch), row=row,
                            latents=batches.latents[counter][row].float().cpu(),
                            video=d["video"]))
    del service, pipe, batches
    harness.free_device()
    if failures:
        print(f"serve_closed: {len(failures)} failed: {failures[:3]}",
              file=sys.stderr)
    return harness.Result(attempted=len(done) + len(failures),
                          failed=len(failures), e2e=e2e,
                          checks=checks.compare(ctx, checked),
                          memory_peak_bytes=peak, record=record)
