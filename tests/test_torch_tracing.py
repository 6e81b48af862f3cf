"""The port's tracer (``seervideoldm_tpu_torch/utils/profiling.py``) on the
CPU, at the toy widths of the other ``test_torch_*`` files:

- a switched-off span leaves no record, no ``record_function`` and no
  allocation behind;
- under ``torch.profiler`` spans nest with their parents and ids, and each
  record lies within 50 us of its ``record_function`` twin in the exported
  trace (one clock);
- ``idle.txt`` puts a device gap down to the innermost program span;
- a served batch's request, queue and batch spans share request ids; the
  serving counters (padded rows, an overload refusal, a failed batch) are
  read through ``counters()``; ``/healthz`` keeps its keys;
- a DDIM-30 sample makes 31 ``unet.call`` spans, and its pipeline call's
  PAB counts are ``build_pab_schedule``'s;
- a train step under the detailed tier opens ``site.<kind>.bwd`` for each
  kind inside ``train.backward``, without overlap, and its loss and
  gradients equal the step's with the tier off, bit for bit;
- the benchmark's readers of these spans give their number from synthetic
  records and None from none.
"""
import importlib.util
import json
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from seervideoldm_tpu_torch.diffusion.pab import PABConfig, build_pab_schedule
from seervideoldm_tpu_torch.serving import batcher as tbatcher
from seervideoldm_tpu_torch.serving import server as tserver
from seervideoldm_tpu_torch.utils import profiling
from seervideoldm_tpu_torch.utils.tokenizer import DebugTokenizer

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, FRAMES = 16, 4
UNET = dict(block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
            cross_attention_dim=32, attention_head_dim=4)


@pytest.fixture(autouse=True)
def _clean():
    profiling.reset()
    profiling.set_enabled(None)
    yield
    profiling.set_enabled(None)
    profiling.reset()


def _models(trainable_scope=None):
    from seervideoldm_tpu_torch.models.clip_text import CLIPTextConfig
    from seervideoldm_tpu_torch.models.unet3d import SeerUNetConfig
    from seervideoldm_tpu_torch.models.vae import VAEConfig
    from seervideoldm_tpu_torch.pipelines.text_video import SeerModels

    models = SeerModels.initialize(
        num_frames=FRAMES, unet_config=SeerUNetConfig(**UNET),
        vae_config=VAEConfig(block_out_channels=(16, 32), layers_per_block=1,
                             norm_num_groups=8),
        clip_config=CLIPTextConfig(vocab_size=100, hidden_size=32,
                                   intermediate_size=64, num_hidden_layers=2,
                                   num_attention_heads=4,
                                   max_position_embeddings=16),
        fstext_kwargs=dict(n_heads=4, num_layers=1), dtype=torch.float32,
        device="cpu", seed=0, trainable_scope=trainable_scope)
    # non-zero proj_out, so every site reaches the output
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in models.unet.named_parameters():
            if ".proj_out." in name:
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return models


@pytest.fixture(scope="module")
def toy_pipe():
    from seervideoldm_tpu_torch.pipelines.text_video import SeerPipeline

    return SeerPipeline(_models())


def _image(seed):
    return np.random.RandomState(seed).uniform(-1, 1, (RES, RES, 3)).astype(
        np.float32)


# ------------------------------------------------------------- primitive

def test_a_switched_off_span_leaves_nothing(tmp_path):
    @profiling.span("pipe.decorated")
    def decorated(x):
        return x + 1

    blocks = sys.getallocatedblocks()
    for i in range(10000):
        with profiling.span("pipe.off", events=True, step=i):
            pass
    assert sys.getallocatedblocks() - blocks < 50
    assert decorated(1) == 2
    assert profiling.spans() == []
    profiling.set_enabled(False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("pipe.forced_off"):
            torch.ones(4).sum()
        assert decorated(2) == 3
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    names = {e.get("name") for e in json.loads(
        (tmp_path / "t.json").read_text())["traceEvents"]}
    assert not {"pipe.forced_off", "pipe.decorated"} & names
    assert profiling.spans() == []
    # a pipeline call still says the profiler recorded it
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.pipeline_call("pipe.generate"):
            pass
    (call,) = profiling.spans()
    assert call["counts"] == {"profiled": 1}


def test_counters_lose_no_update_across_threads():
    threads, per = 16, 2000
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def add():
            for _ in range(per):
                profiling.count("unet.calls")

        workers = [threading.Thread(target=add) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
            assert not w.is_alive()
    finally:
        sys.setswitchinterval(before)
    assert profiling.counters()["unet.calls"] == threads * per


def test_spans_nest_and_share_the_profilers_clock(tmp_path):
    @profiling.span("pipe.decorated")
    def decorated():
        torch.ones(8).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # the profiler's first event on a thread sets up its buffer (~0.1 ms
        # between the tracer's clock read and the profiler's own)
        with torch.profiler.record_function("first_event"):
            pass
        with profiling.pipeline_call("pipe.generate", rows=2) as call:
            with profiling.span("pipe.sample", events=True):
                for i in range(3):
                    with profiling.span("ddim.step", step=i):
                        torch.randn(64, 64) @ torch.randn(64, 64)
            decorated()
            with profiling.pipeline_call("pipe.rollout"):
                pass
    prof.export_chrome_trace(str(tmp_path / "t.json"))
    by_name = {}
    for s in profiling.spans():
        by_name.setdefault(s["name"], []).append(s)
    outer = by_name["pipe.generate"][0]
    assert outer["seq"] == call.seq and outer["parent"] is None
    assert outer["ids"] == {"rows": 2} and outer["counts"]["profiled"] == 1
    sample = by_name["pipe.sample"][0]
    assert sample["parent"] == outer["seq"] and sample["device_ms"] is None
    assert [s["ids"]["step"] for s in by_name["ddim.step"]] == [0, 1, 2]
    assert {s["parent"] for s in by_name["ddim.step"]} == {sample["seq"]}
    # a pipeline call inside another is a detailed span, not a second record
    assert by_name["pipe.rollout"][0]["counts"] is None
    assert by_name["pipe.rollout"][0]["parent"] == outer["seq"]
    assert by_name["pipe.decorated"][0]["parent"] == outer["seq"]

    trace = json.loads((tmp_path / "t.json").read_text())
    base = int(trace.get("baseTimeNanoseconds", 0))
    twins = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"] in by_name:
            twins.setdefault(e["name"], []).append(e)
    for name, recs in by_name.items():
        events = sorted(twins[name], key=lambda e: float(e["ts"]))
        assert len(events) == len(recs), name
        for rec, e in zip(sorted(recs, key=lambda r: r["start"]), events):
            start = base + float(e["ts"]) * 1e3
            end = start + float(e["dur"]) * 1e3
            assert abs(rec["start"] - start) < 50e3, name
            assert abs(rec["end"] - end) < 50e3, name


def test_idle_txt_puts_a_gap_down_to_its_innermost_span(tmp_path):
    def x(name, cat, ts, dur):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}

    trace = {"traceEvents": [
        x("pipe.generate", "user_annotation", 0, 1000),
        x("pipe.vae_decode", "user_annotation", 500, 300),
        x("profiled_region", "user_annotation", 0, 1000),
        x("aten::cat", "cpu_op", 550, 200),
        x("aten::empty", "cpu_op", 560, 5),
        x("gemm", "kernel", 100, 500),
        x("gemm", "kernel", 800, 100),     # idle 600 .. 800 us
        x("gemm", "kernel", 910, 10),      # idle 900 .. 910 us
    ]}
    gaps = profiling.idle_gaps(trace)
    assert gaps[0] == (0.2, "pipe.vae_decode", "aten::cat", 0.5)
    assert gaps[1][:3] == (pytest.approx(0.01), "pipe.generate",
                           "outside any op")
    assert profiling.idle_gaps({"traceEvents": []}) == []
    with profiling.trace(str(tmp_path)):
        with profiling.span("pipe.fstext"):
            torch.randn(32, 32).sum()
    lines = (tmp_path / "idle.txt").read_text().splitlines()
    assert lines[0] == "gap_ms\tspan\top\tat_ms"
    assert (tmp_path / "trace.json").is_file()


# --------------------------------------------------------------- serving

def test_served_batch_spans_share_request_ids_and_counters(toy_pipe):
    svc = tserver.GenerationService(
        toy_pipe, DebugTokenizer(100, 16), resolution=RES, cond_frames=1,
        num_frames=FRAMES, ddim_steps=2, guidance_scale=7.5, max_batch=4,
        max_wait_ms=2000.0, seed=7, sampling_kwargs={"sampler": "ddim"})
    try:
        svc.warmup()
        before = profiling.counters()
        threads = [threading.Thread(target=svc.generate_array,
                                    args=(f"push {i}", _image(i)))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
        after = profiling.counters()
        stats = svc.stats()
    finally:
        svc.stop()
    requests = profiling.spans("serve.request")
    queues = profiling.spans("serve.queue")
    batches = profiling.spans("serve.batch")
    rids = sorted(r["ids"]["request"] for r in requests)
    assert len(rids) == 2
    assert sorted(q["ids"]["request"] for q in queues) == rids
    assert len(batches) == 2 and batches[0]["ids"]["requests"] == [-1]
    last = batches[-1]
    assert sorted(last["ids"]["requests"]) == rids
    assert last["ids"]["rows"] == 2 and last["ids"]["padded"] == 2
    assert last["ids"]["batch"] == 1 and batches[0]["ids"]["batch"] == 0
    for q in queues:
        r = next(r for r in requests
                 if r["ids"]["request"] == q["ids"]["request"])
        assert r["start"] == q["start"] <= q["end"] <= last["start"]
        assert q["end"] <= r["end"]
    calls = profiling.spans("pipe.generate")
    assert len(calls) == 2 and calls[1]["parent"] == last["seq"]
    delta = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert delta["serve.batches"] == 1 and delta["serve.requests"] == 2
    assert delta["serve.padded_rows"] == 2
    assert after["serve.padded_rows"] >= 5      # the warm-up padded 3
    assert set(stats) == {"ok", "batches", "requests", "latency_p50_s",
                          "latency_p95_s"}
    assert stats["batches"] == 1 and stats["requests"] == 2
    assert 0 < stats["latency_p50_s"] <= stats["latency_p95_s"]


def test_overload_refusals_and_failed_batches_are_counted():
    gate = threading.Event()

    def handler(items):
        gate.wait(30)
        if items[0] == "bad":
            raise RuntimeError("boom")
        return items

    before = profiling.counters()
    b = tbatcher.DynamicBatcher(handler, max_batch=1, max_wait_ms=1,
                                max_queue=1).start()
    try:
        first = b.submit("bad")
        while b._q.qsize():          # the worker holds it in the handler
            pass
        queued = b.submit("ok")
        with pytest.raises(tbatcher.BatcherOverloaded):
            b.submit("refused")
        gate.set()
        with pytest.raises(RuntimeError, match="boom"):
            first.result(timeout=30)
        assert queued.result(timeout=30) == "ok"
    finally:
        b.stop()
    after = profiling.counters()
    assert (b.refused, b.failed_batches, b.batches) == (1, 1, 1)
    assert after["serve.refused"] - before.get("serve.refused", 0) == 1
    assert (after["serve.failed_batches"]
            - before.get("serve.failed_batches", 0)) == 1


def test_healthz_keeps_its_keys():
    svc = tserver.GenerationService(
        None, DebugTokenizer(100, 16), resolution=RES, cond_frames=1,
        num_frames=FRAMES, ddim_steps=2, guidance_scale=7.5)
    try:
        assert svc.stats() == {"ok": True, "batches": 0, "requests": 0,
                               "latency_p50_s": None, "latency_p95_s": None}
    finally:
        svc.stop()


# -------------------------------------------------------------- sampling

def test_ddim30_makes_31_unet_calls_and_pab_counts(toy_pipe):
    tok = DebugTokenizer(100, 16)
    t, uc = tok(["push the cup"]), tok([""])
    cond = torch.from_numpy(_image(0))[None, None]
    cfg = PABConfig(spatial_range=2, cross_range=6, temporal_range=4)
    profiling.set_enabled(True)
    toy_pipe.generate(cond, t["input_ids"], t["attention_mask"],
                      uc["input_ids"], uc["attention_mask"],
                      num_frames=FRAMES,
                      generator=torch.Generator().manual_seed(0),
                      ddim_steps=30, guidance_scale=7.5, pab_config=cfg)
    profiling.set_enabled(None)
    calls = profiling.spans("unet.call")
    assert [c["ids"]["call"] for c in calls] == list(range(31))
    assert len(profiling.spans("ddim.step")) == 31
    (call,) = profiling.spans("pipe.generate")
    counts = call["counts"]
    assert counts["unet.calls"] == 31 and counts["profiled"] == 1
    assert "unet.checked" not in counts        # no card: nothing to query
    for phase in ("pipe.rollout", "pipe.encode_text", "pipe.fstext",
                  "pipe.vae_encode", "pipe.sample", "pipe.vae_decode"):
        assert profiling.spans(phase), phase
    modes, idx = build_pab_schedule(31, cfg)
    unet = toy_pipe.m.unet
    sites = {"spatial": sum(1 for n, _ in unet.named_modules()
                            if n.endswith("transformer_blocks.0.attn2"))}
    sites["cross"] = sites["spatial"]
    sites["temporal"] = sum(1 for n, m in unet.named_modules()
                            if type(m).__name__ == "WindowTemporalAttention")
    for j, kind in enumerate(("spatial", "cross", "temporal")):
        reused = sum(modes[int(i)][j] for i in idx)
        assert counts[f"pab.reused.{kind}"] == reused * sites[kind], kind
        assert counts[f"pab.computed.{kind}"] == (31 - reused) * sites[kind]
    totals = profiling.counters()
    assert totals["unet.calls"] == 31
    assert totals["pab.reused.spatial"] == counts["pab.reused.spatial"]


# -------------------------------------------------------------- training

def _train_pass(enabled):
    from seervideoldm_tpu_torch.training import trainer as ttrainer

    models = _models(trainable_scope="reference")
    step = ttrainer.make_train_step(models, cond_frames=2)
    prepare = ttrainer.prepare_batch_fn(models)
    g = torch.Generator().manual_seed(3)
    video = torch.rand(2, FRAMES, RES, RES, 3, generator=g) * 2 - 1
    ids = torch.randint(0, 100, (2, 16), generator=g)
    batch = prepare(video, ids, torch.ones(2, 16, dtype=torch.long), 2,
                    noise=torch.randn(2 * FRAMES, 8, 8, 4, generator=g))
    noise = torch.randn(batch["latents"].shape, generator=g)
    profiling.set_enabled(enabled)
    loss, _, grads = step.loss_and_grads(list(models.masters), batch, noise,
                                         torch.tensor([10, 500]))
    profiling.set_enabled(None)
    return loss, grads


def test_train_step_backward_spans_nest_and_change_nothing():
    loss_off, grads_off = _train_pass(False)
    assert profiling.spans() == []
    loss_on, grads_on = _train_pass(True)
    assert torch.equal(loss_off, loss_on)
    assert grads_off.keys() == grads_on.keys()
    assert all(torch.equal(grads_off[k], grads_on[k]) for k in grads_off)
    (backward,) = profiling.spans("train.backward")
    (forward,) = profiling.spans("train.forward")
    assert forward["end"] <= backward["start"]
    bwd = sorted((s for s in profiling.spans() if s["name"].endswith(".bwd")),
                 key=lambda s: s["start"])
    assert {s["name"] for s in bwd} == {"site.resnet.bwd", "site.attn.bwd",
                                        "site.ff.bwd"}
    for s in bwd:
        assert s["parent"] == backward["seq"]
        assert backward["start"] <= s["start"] <= s["end"] <= backward["end"]
    assert all(a["end"] <= b["start"] for a, b in zip(bwd, bwd[1:]))
    fwd = [s for s in profiling.spans() if s["name"].startswith("site.")
           and not s["name"].endswith(".bwd")]
    assert all(s["parent"] is not None for s in fwd)
    assert len(bwd) <= len(fwd)


# --------------------------------------------------------------- readers

READERS = ("unet_bwd_ms.train", "resnet_bwd_ms.train", "attn_bwd_ms.train",
           "ff_bwd_ms.train", "starved_unet_share.serve",
           "starved_unet_share.sample", "pab_reuse_share.serve",
           "request_queue_ms.serve")


def _reader(name):
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    path = os.path.join(REPO, "seerbench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"reader_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rec(seq, name, start=0, end=0, device_ms=None, counts=None, **ids):
    return {"seq": seq, "name": name, "start": start, "end": end,
            "parent": None, "thread": 1, "ids": ids, "counts": counts,
            "device_ms": device_ms}


def _synthetic():
    recs = [_rec(0, "pipe.generate", counts={"unet.checked": 30,
                                             "unet.starved": 30,
                                             "pab.reused.cross": 93})]
    recs += [_rec(1 + i, "pipe.generate", counts={
        "profiled": int(i == 1), "unet.checked": 30, "unet.starved": 3 * i,
        "pab.reused.spatial": 11, "pab.computed.spatial": 20,
        "pab.reused.cross": 19, "pab.computed.cross": 12})
        for i in range(3)]
    recs += [_rec(10 + i, "train.backward", device_ms=300.0 + 20 * i)
             for i in range(2)]
    recs += [_rec(20 + i, f"site.{k}.bwd", device_ms=ms)
             for i, (k, ms) in enumerate((("resnet", 100.0), ("resnet", 60.0),
                                          ("attn", 50.0), ("ff", 40.0)))]
    recs += [_rec(30 + i, "serve.queue", start=0, end=int(ms * 1e6), request=i)
             for i, ms in enumerate((4000.0, 4400.0, 4300.0))]
    return recs


WANT = {"unet_bwd_ms.train": 310.0, "resnet_bwd_ms.train": 80.0,
        "attn_bwd_ms.train": 25.0, "ff_bwd_ms.train": 20.0,
        "starved_unet_share.serve": 10.0, "starved_unet_share.sample": 10.0,
        "pab_reuse_share.serve": 100.0 * 30 / 62,
        "request_queue_ms.serve": 4300.0}


@pytest.mark.parametrize("name", READERS)
def test_reader_of_the_programs_spans(monkeypatch, name):
    """From synthetic records: the first and the profiled pipeline calls are
    left out; from none: None."""
    reader = _reader(name)
    recs = _synthetic()

    def fake(wanted=None):
        return [r for r in recs if wanted is None or r["name"] == wanted]

    monkeypatch.setattr(profiling, "spans", fake)
    assert reader.read({}) == pytest.approx(WANT[name])
    recs = []
    assert reader.read({}) is None
