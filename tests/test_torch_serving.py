"""The port's serving path (``seervideoldm_tpu_torch/serving/``, the
``serve`` entry) against the JAX package's, on the CPU.

- the dynamic batcher: the JAX package's five batcher cases
  (``tests/test_serving.py``) against the port's copy, one parametrised
  test;
- the service against the JAX ``GenerationService``, each over a
  recording fake pipeline (JAX's takes ``rng``, the port's ``generator``),
  the same requests: what each hands its pipeline (the padded cond frames,
  prompt and uncond token ids with negative prompts, the rollout's chained
  and padded per-chunk prompts, the knobs) and what it returns (the rows,
  cond frames in front) are equal; the refused rollout window;
- on a toy-width pipeline (fp32): a 2-request batch equals
  ``pipe.generate`` on the padded inputs with the service's generator for
  that batch, bit for bit; a restarted service reproduces it; a row does
  not depend on the other rows of its batch;
- HTTP end to end through ``make_server``: 200 with a GIF, 400, 404, 413,
  503 with the queue full, the ``/healthz`` counters;
- the ``serve`` entry as a subprocess on the CPU: it prints its port,
  answers one POST, and exits 0 on SIGTERM; serving under a mesh is
  refused by name.
"""
import base64
import http.client
import io
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from seervideoldm_tpu.serving import server as jserver
from seervideoldm_tpu.utils.tokenizer import DebugTokenizer as JTokenizer
from seervideoldm_tpu_torch.serving import batcher as tbatcher
from seervideoldm_tpu_torch.serving import server as tserver
from seervideoldm_tpu_torch.utils.tokenizer import DebugTokenizer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, COND, FRAMES = 16, 1, 4


# ------------------------------------------------------------- batcher

def _groups_and_orders():
    sizes = []

    def handler(items):
        sizes.append(len(items))
        return [x * 10 for x in items]

    b = tbatcher.DynamicBatcher(handler, max_batch=2, max_wait_ms=500).start()
    futs = [b.submit(i) for i in range(4)]
    assert [f.result(timeout=10) for f in futs] == [0, 10, 20, 30]
    b.stop()
    assert sum(sizes) == 4 and b.requests == 4
    assert b.batches <= 3 and max(sizes) == 2


def _error_propagates_to_all():
    def handler(items):
        raise RuntimeError("boom")

    b = tbatcher.DynamicBatcher(handler, max_batch=4, max_wait_ms=50).start()
    futs = [b.submit(i) for i in range(2)]
    for f in futs:
        with pytest.raises(RuntimeError, match="boom"):
            f.result(timeout=10)
    b.stop()


def _result_count_mismatch_is_an_error():
    b = tbatcher.DynamicBatcher(lambda items: [1], max_batch=2,
                                max_wait_ms=200).start()
    futs = [b.submit(i) for i in range(2)]
    errs = 0
    for f in futs:
        try:
            f.result(timeout=10)
        except RuntimeError:
            errs += 1
    assert errs == 2
    b.stop()


def _overload_sheds_requests():
    gate, entered = threading.Event(), threading.Event()

    def handler(items):
        entered.set()
        gate.wait(10)
        return items

    b = tbatcher.DynamicBatcher(handler, max_batch=1, max_wait_ms=1,
                                max_queue=2).start()
    first = b.submit(0)
    assert entered.wait(10)
    b.submit(1), b.submit(2)
    with pytest.raises(tbatcher.BatcherOverloaded):
        b.submit(3)
    gate.set()
    assert first.result(timeout=10) == 0
    b.stop()


def _submit_after_stop_raises():
    b = tbatcher.DynamicBatcher(lambda items: items, max_batch=1,
                                max_wait_ms=10).start()
    b.stop()
    with pytest.raises(RuntimeError, match="not started"):
        b.submit(1)


BATCHER_CASES = {"groups_and_orders": _groups_and_orders,
                 "error_propagates_to_all": _error_propagates_to_all,
                 "result_count_mismatch": _result_count_mismatch_is_an_error,
                 "overload_sheds_requests": _overload_sheds_requests,
                 "submit_after_stop_raises": _submit_after_stop_raises}


@pytest.mark.parametrize("case", sorted(BATCHER_CASES))
def test_batcher_cases_as_jax(case):
    BATCHER_CASES[case]()


# ------------------------------------------- service vs the JAX service

class _Recorder:
    """A fake pipeline: records what the service hands it and returns
    frames that are a function of the cond frames (row-wise), so a row's
    result shows which input it came from."""

    def __init__(self, torch_out: bool):
        self.calls = []
        self.torch_out = torch_out
        self.device = torch.device("cpu")

    def _frames(self, cond, n):
        cond = np.asarray(cond, np.float32)
        rows = (cond[:, -1:] + 1.0) / 4.0 + 0.25 * np.arange(n)[None, :, None,
                                                                 None, None] / n
        rows = np.clip(rows, 0.0, 1.0).astype(np.float32)
        return torch.from_numpy(rows) if self.torch_out else rows

    def generate(self, cond, ids, mask, uc_ids, uc_mask, num_frames, **kw):
        self.calls.append(dict(kind="generate", cond=np.asarray(cond),
                               ids=np.asarray(ids), mask=np.asarray(mask),
                               uc_ids=np.asarray(uc_ids), kw=kw))
        return self._frames(cond, num_frames - np.asarray(cond).shape[1])

    def generate_rollout(self, cond, prompts_tok, uc_ids, uc_mask, num_frames,
                         total_frames, **kw):
        self.calls.append(dict(kind="rollout", cond=np.asarray(cond),
                               chunks=[np.asarray(t["input_ids"])
                                       for t in prompts_tok],
                               uc_ids=np.asarray(uc_ids), kw=kw))
        return self._frames(cond, total_frames)


def _services(**kw):
    args = dict(resolution=RES, cond_frames=COND, num_frames=FRAMES,
                ddim_steps=2, guidance_scale=7.5, max_batch=3,
                max_wait_ms=50.0, seed=3,
                sampling_kwargs={"sampler": "ddim", "guidance_rescale": 0.5})
    args.update(kw)
    jsvc = jserver.GenerationService(_Recorder(False), JTokenizer(100, 16),
                                     **args)
    tsvc = tserver.GenerationService(_Recorder(True), DebugTokenizer(100, 16),
                                     **args)
    return jsvc, tsvc


def _image(seed):
    return np.random.RandomState(seed).uniform(-1, 1, (RES, RES, 3)).astype(
        np.float32)


def _compare_calls(jcall, tcall):
    assert jcall["kind"] == tcall["kind"]
    np.testing.assert_array_equal(jcall["cond"], tcall["cond"])
    np.testing.assert_array_equal(jcall["uc_ids"], tcall["uc_ids"])
    if jcall["kind"] == "generate":
        np.testing.assert_array_equal(jcall["ids"], tcall["ids"])
        np.testing.assert_array_equal(jcall["mask"], tcall["mask"])
    else:
        assert len(jcall["chunks"]) == len(tcall["chunks"])
        for a, b in zip(jcall["chunks"], tcall["chunks"]):
            np.testing.assert_array_equal(a, b)
    jkw = {k: v for k, v in jcall["kw"].items() if k != "rng"}
    tkw = {k: v for k, v in tcall["kw"].items() if k != "generator"}
    assert jkw == tkw
    assert isinstance(tcall["kw"]["generator"], torch.Generator)


@pytest.mark.parametrize("negatives", [False, True])
def test_service_hands_the_pipeline_what_jax_does(negatives):
    """Two batches (3 requests, then 1 padded to 3): cond frames padded
    with row 0, prompts padded with "", the uncond ids from the negative
    prompts (or the cached "" batch), the knobs, and the rows returned
    with the cond frames in front, equal to the JAX service's."""
    jsvc, tsvc = _services()
    try:
        batches = [[("push the cup", 0, "blurry" if negatives else ""),
                    ("pull", 1, ""), ("lift it up", 2, "dark")],
                   [("drop", 3, "")]]
        for batch in batches:
            jreqs = [jserver.GenRequest(p, _image(s), n) for p, s, n in batch]
            treqs = [tserver.GenRequest(p, _image(s), n) for p, s, n in batch]
            jrows = jsvc._handle_batch(jreqs)
            trows = tsvc._handle_batch(treqs)
            assert len(jrows) == len(trows) == len(batch)
            for a, b in zip(jrows, trows):
                assert b.shape == (FRAMES, RES, RES, 3)
                np.testing.assert_array_equal(a, b)
        assert len(jsvc.pipe.calls) == len(tsvc.pipe.calls) == 2
        for jcall, tcall in zip(jsvc.pipe.calls, tsvc.pipe.calls):
            _compare_calls(jcall, tcall)
        # the lone request is padded with its own frame and "" prompts
        lone = tsvc.pipe.calls[1]
        np.testing.assert_array_equal(lone["cond"][1], lone["cond"][0])
        assert tsvc._counter == 2
    finally:
        jsvc.stop()
        tsvc.stop()


def test_service_rollout_chains_as_jax():
    """Under ``total_frames`` each prompt's "|"-chained instructions are
    padded with their last entry (or cut) to the server's chunk count and
    tokenized per chunk, as the JAX service does."""
    jsvc, tsvc = _services(total_frames=7)   # f2 = 3: 3 chunks
    try:
        batch = [("pick | pour | place | extra", 0, ""), ("push", 1, "x"),
                 (" | ", 2, "")]
        jrows = jsvc._handle_batch([jserver.GenRequest(p, _image(s), n)
                                    for p, s, n in batch])
        trows = tsvc._handle_batch([tserver.GenRequest(p, _image(s), n)
                                    for p, s, n in batch])
        for a, b in zip(jrows, trows):
            assert b.shape == (COND + 7, RES, RES, 3)
            np.testing.assert_array_equal(a, b)
        _compare_calls(jsvc.pipe.calls[0], tsvc.pipe.calls[0])
        chunks = tsvc.pipe.calls[0]["chunks"]
        assert len(chunks) == 3
        tok = DebugTokenizer(100, 16)
        np.testing.assert_array_equal(chunks[2][0], tok(["place"])["input_ids"][0])
        np.testing.assert_array_equal(chunks[2][1], tok(["push"])["input_ids"][0])
    finally:
        jsvc.stop()
        tsvc.stop()


def test_service_refuses_rollout_without_future_frames():
    for module in (jserver, tserver):
        with pytest.raises(ValueError, match="num_frames > cond_frames"):
            module.GenerationService(None, None, resolution=RES, cond_frames=4,
                                     num_frames=4, ddim_steps=2,
                                     guidance_scale=7.5, total_frames=8)


def test_generator_seed_rule():
    assert tserver.batch_seed(0, 0) == 0
    assert tserver.batch_seed(3, 5) == (3 << 32) | 5
    assert tserver.batch_seed(-1, 1) == (0xFFFFFFFF << 32) | 1


# ------------------------------------------------- on a toy pipeline

@pytest.fixture(scope="module")
def toy_pipe():
    from seervideoldm_tpu_torch.models.clip_text import CLIPTextConfig
    from seervideoldm_tpu_torch.models.unet3d import SeerUNetConfig
    from seervideoldm_tpu_torch.models.vae import VAEConfig
    from seervideoldm_tpu_torch.pipelines.text_video import (SeerModels,
                                                             SeerPipeline)

    models = SeerModels.initialize(
        num_frames=FRAMES,
        unet_config=SeerUNetConfig(block_out_channels=(32, 64),
                                   layers_per_block=1, norm_num_groups=8,
                                   cross_attention_dim=32,
                                   attention_head_dim=4),
        vae_config=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                             norm_num_groups=8),
        clip_config=CLIPTextConfig(vocab_size=100, hidden_size=32,
                                   intermediate_size=64, num_hidden_layers=2,
                                   num_attention_heads=4,
                                   max_position_embeddings=16),
        fstext_kwargs=dict(n_heads=4, num_layers=1), dtype=torch.float32,
        device="cpu", seed=0)
    # non-zero proj_out, so the prompts reach the output
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in models.unet.named_parameters():
            if ".proj_out." in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return SeerPipeline(models)


def _toy_service(pipe, **kw):
    args = dict(resolution=RES, cond_frames=COND, num_frames=FRAMES,
                ddim_steps=2, guidance_scale=7.5, max_batch=4,
                max_wait_ms=50.0, seed=7,
                sampling_kwargs={"sampler": "ddim"})
    args.update(kw)
    return tserver.GenerationService(pipe, DebugTokenizer(100, 16), **args)


def _reqs(spec):
    return [tserver.GenRequest(p, _image(s)) for p, s in spec]


def test_batch_equals_generate_with_the_counters_generator(toy_pipe):
    """Batch 1 of a service (after the warm-up, batch 0) with 2 requests
    padded to 4 rows equals ``pipe.generate`` on the padded inputs with the
    generator seeded ``batch_seed(seed, 1)``, bit for bit; a restarted
    service (same seed, same requests in the same order) returns the same
    rows."""
    spec = [("push the cup", 0), ("pull it", 1)]
    runs = []
    for _ in range(2):
        svc = _toy_service(toy_pipe)
        try:
            svc.warmup()
            runs.append(svc._handle_batch(_reqs(spec)))
        finally:
            svc.stop()
    tok = DebugTokenizer(100, 16)
    frames = np.stack([_image(0), _image(1), _image(0), _image(0)])
    cond = frames[:, None].repeat(COND, axis=1)
    ids = tok(["push the cup", "pull it", "", ""])
    uc = tok([""] * 4)
    gen = torch.Generator().manual_seed(tserver.batch_seed(7, 1))
    want = toy_pipe.generate(cond, ids["input_ids"], ids["attention_mask"],
                             uc["input_ids"], uc["attention_mask"],
                             num_frames=FRAMES, generator=gen, ddim_steps=2,
                             guidance_scale=7.5, sampler="ddim").numpy()
    for rows in runs:
        for i, row in enumerate(rows):
            np.testing.assert_array_equal(row[:COND], (cond[i] + 1.0) / 2.0)
            np.testing.assert_array_equal(row[COND:], want[i])
    assert not np.array_equal(want[0], want[1])


def test_rows_are_independent(toy_pipe):
    """Row 0 of [A, B, C, D] equals row 0 of [A, E, F, G] under the same
    batch counter, bit for bit."""
    rows = []
    for spec in ([("push", 0), ("pull", 1), ("lift", 2), ("drop", 3)],
                 [("push", 0), ("spin", 4), ("tilt", 5), ("slide", 6)]):
        svc = _toy_service(toy_pipe)
        try:
            rows.append(svc._handle_batch(_reqs(spec)))
        finally:
            svc.stop()
    np.testing.assert_array_equal(rows[0][0], rows[1][0])
    assert not np.array_equal(rows[0][1], rows[1][1])


# --------------------------------------------------------------- HTTP

def _png_bytes(seed=0, size=24):
    arr = np.random.RandomState(seed).randint(0, 255, (size, size, 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def _post(port, payload, timeout=120):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.headers["Content-Type"], r.read()


def _status(fn):
    try:
        return fn()[0]
    except urllib.error.HTTPError as exc:
        return exc.code


def test_http_end_to_end(toy_pipe):
    from seervideoldm_tpu_torch.serving import make_server

    svc = _toy_service(toy_pipe, max_batch=2, max_wait_ms=400.0)
    server = make_server(svc, port=0)
    port = server.server_address[1]
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            health = json.loads(r.read())
        assert health == {"ok": True, "batches": 0, "requests": 0,
                          "latency_p50_s": None, "latency_p95_s": None}
        body = {"prompt": "push", "image": base64.b64encode(_png_bytes()).decode(),
                "negative_prompt": "blurry"}
        results = {}

        def post(key):
            results[key] = _post(port, body)

        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
            assert not th.is_alive()
        for status, ctype, data in results.values():
            assert status == 200 and ctype == "image/gif"
            with Image.open(io.BytesIO(data)) as gif:
                assert gif.size == (RES, RES) and 1 <= gif.n_frames <= FRAMES
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            health = json.loads(r.read())
        assert health["batches"] == 1 and health["requests"] == 2
        assert health["latency_p50_s"] > 0 and health["latency_p95_s"] > 0

        assert _status(lambda: _post(port, {"prompt": "x"})) == 400
        assert _status(lambda: _post(port, {"prompt": "x", "image": base64.b64encode(
            b"definitely not a png").decode()})) == 400
        assert _status(lambda: _post(port, {"prompt": 3, "image": ""})) == 400
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.putrequest("POST", "/generate")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(64 * 1024 * 1024))
        conn.endheaders()
        assert conn.getresponse().status == 413
        conn.close()
        assert _status(lambda: urllib.request.urlopen(
            f"http://127.0.0.1:{port}/nope", timeout=30)) == 404
        req = urllib.request.Request(f"http://127.0.0.1:{port}/other",
                                     data=b"{}")
        assert _status(lambda: urllib.request.urlopen(req, timeout=30)) == 404
    finally:
        server.shutdown()
        server.server_close()
        svc.stop()


def test_http_overload_is_503_and_batch_errors_are_500():
    """With the worker held and the queue (4 x max_batch) full, a POST is
    shed with 503; a pipeline error reaches every request of its batch as
    500, and the server keeps serving."""
    from seervideoldm_tpu_torch.serving import make_server

    gate, entered = threading.Event(), threading.Event()

    class Held(_Recorder):
        fail = False

        def generate(self, *a, **kw):
            entered.set()
            gate.wait(30)
            if self.fail:
                raise RuntimeError("kernel launch failed")
            return super().generate(*a, **kw)

    pipe = Held(True)
    svc = tserver.GenerationService(
        pipe, DebugTokenizer(100, 16), resolution=RES, cond_frames=COND,
        num_frames=FRAMES, ddim_steps=2, guidance_scale=7.5, max_batch=1,
        max_wait_ms=1.0)
    server = make_server(svc, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    body = {"prompt": "p", "image": base64.b64encode(_png_bytes()).decode()}
    codes = []

    def post():
        codes.append(_status(lambda: _post(port, body)))

    try:
        first = threading.Thread(target=post)
        first.start()
        assert entered.wait(30)
        queued = [threading.Thread(target=post) for _ in range(4)]
        for th in queued:
            th.start()
        deadline = time.monotonic() + 30
        while svc.batcher._q.qsize() < 4 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert _status(lambda: _post(port, body)) == 503
        pipe.fail = True
        gate.set()
        for th in [first] + queued:
            th.join(timeout=60)
            assert not th.is_alive()
        assert sorted(codes) == [500] * 5
        pipe.fail = False
        assert _status(lambda: _post(port, body)) == 200
    finally:
        gate.set()
        server.shutdown()
        server.server_close()
        svc.stop()


# ---------------------------------------------------------- the entry

TINY_OVERRIDES = {
    "unet": {"block_out_channels": [32, 64], "layers_per_block": 1,
             "norm_num_groups": 8, "cross_attention_dim": 32,
             "attention_head_dim": 4},
    "vae": {"block_out_channels": [16, 32], "layers_per_block": 1,
            "norm_num_groups": 8},
    "clip": {"vocab_size": 49408, "hidden_size": 32, "intermediate_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 4,
             "max_position_embeddings": 77},
    "fstext": {"n_heads": 4, "num_layers": 1},
}


def test_serve_entry_on_the_cpu():
    """``python -m seervideoldm_tpu_torch.serve --device cpu`` with
    ``configs/serve.yaml`` (PAB on) at toy widths: it warms up, prints the
    port it bound (``serve_port=0``), answers a POST with a GIF and
    ``/healthz``, and exits 0 on SIGTERM."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "seervideoldm_tpu_torch.serve", "--config",
         os.path.join(REPO, "configs", "serve.yaml"), "--device", "cpu",
         "--set", "serve_port=0", "--set", "resolution=16",
         "--set", "num_frames=4", "--set", "cond_frames=1",
         "--set", "ddim_steps=4", "--set", "serve_max_batch=2",
         "--set", f"model_overrides={json.dumps(TINY_OVERRIDES)}"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        port, lines = None, []
        deadline = time.monotonic() + 300
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
        assert port, "".join(lines) + proc.stderr.read()
        status, ctype, data = _post(port, {
            "prompt": "push", "image": base64.b64encode(_png_bytes()).decode()})
        assert status == 200 and ctype == "image/gif"
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            assert json.loads(r.read())["requests"] == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_serving_under_a_mesh_is_refused():
    from seervideoldm_tpu_torch.config import check_serving, config_from_dict

    with pytest.raises(ValueError, match="serving under mesh_shape"):
        check_serving(config_from_dict({"mesh_shape": {"data": 2}}))
    cfg = config_from_dict(yaml.safe_load(open(os.path.join(
        REPO, "configs", "serve.yaml"))))
    check_serving(cfg)
    assert (cfg.serve_host, cfg.serve_port, cfg.serve_max_batch,
            cfg.serve_max_wait_ms, cfg.pab) == ("127.0.0.1", 8000, 4, 100, True)
