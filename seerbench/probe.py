"""The benchmark's own spans and counters around calls into the program's
layers, and the reduction of one profiled unit of work to device time.

Installed only for a ``--trace 1`` run, by wrapping (and afterwards
restoring) these names of the port:

- ``pipelines.text_video.SeerPipeline.generate``: the pipeline call, CUDA
  events around it; the profiled unit when the driver asks for one;
- ``models.unet3d.SeerUNet.forward``: CUDA events around each UNet call;
- the site classes ``ops.attention.CrossAttention`` and
  ``WindowTemporalAttention`` (kind ``attn``), ``models.transformer3d.
  FeedForward`` with the module functions ``ln_ff_residual`` and
  ``ln_ff_proj_residual``, whose fused kernels take the feed-forward's
  weights without calling its forward (kind ``ff``), and
  ``models.resnet3d.ResnetBlock3D`` (kind ``resnet``): while a unit is
  profiled, a ``record_function`` span around each forward, and the
  site's roofline bound from its shapes (``roofline.py``);
- ``training.optim.Optimizer.update``: CUDA events around each update.

A site's device time is the time of the kernels launched inside its span
(each kernel's launch matched to the span by the launching thread and
time, through the trace's correlation ids).  Autograd runs backward
kernels on its own thread outside every span, so a training step's sites
are its forward sites.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
import threading
import time
from collections import defaultdict

import torch

from . import roofline

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


def _resnet_bound(self, x, temb=None):
    b, f, h, w, cin = x.shape
    temb_ch = self.time_emb_proj.in_features if self.time_emb_proj is not None else 0
    return roofline.resnet_site(b * f, h, w, cin, self.conv1.out_channels, b,
                                temb_ch)


def _cross_bound(self, x, context=None, *args, **kwargs):
    batch, n, c = x.shape
    ctx = x if context is None else context
    return roofline.cross_attention_site(
        batch, n, ctx.shape[1], c, ctx.shape[2], self.heads, self.dim_head,
        causal=self.temporal and self.causal, self_attn=context is None)


def _temporal_bound(self, x, *args, **kwargs):
    b, f, h, w, c = x.shape
    return roofline.temporal_attention_site(b, f, h, w, c, self.heads,
                                            self.dim_head)


def _ff_bound(self, x):
    c = x.shape[-1]
    return roofline.ff_site(x.numel() // c, c, self.net[2].in_features)


def _ln_ff_bound(norm, ff, x, *rest):
    c = x.shape[-1]
    return roofline.ff_site(x.numel() // c, c, ff.net[2].in_features,
                            proj=bool(rest))


class Probe:
    """Spans, CUDA events and the profiled unit of one ``--trace 1`` run."""

    def __init__(self, profiled_unit: int = 1):
        self.open = False          # inside the measured window
        self.profiled_unit = profiled_unit
        self.units = 0             # pipeline calls / steps begun in the window
        self.profiling = False
        self.unet_events: list = []
        self.pipeline_events: list = []   # (start, end, unet events inside)
        self.optimizer_events: list = []  # (start, end) of sync updates
        self.site_bound_s: dict = defaultdict(float)
        self.site_calls: dict = defaultdict(int)
        self.trace = None          # the profiled unit's summary
        self._prof = None
        self._local = threading.local()
        self._restore: list = []

    # ------------------------------------------------------------ install

    def install(self) -> "Probe":
        """Wraps the port's names; call on the main thread (the profiler's
        first start initialises it there, before any worker thread starts
        one)."""
        from seervideoldm_tpu_torch.models import resnet3d, transformer3d, unet3d
        from seervideoldm_tpu_torch.ops import attention
        from seervideoldm_tpu_torch.pipelines import text_video
        from seervideoldm_tpu_torch.training import optim

        self._patch(text_video.SeerPipeline, "generate", self._pipeline)
        self._patch(unet3d.SeerUNet, "forward", self._unet)
        self._patch(optim.Optimizer, "update", self._optimizer)
        for owner, name, kind, bound in (
                (attention.CrossAttention, "forward", "attn", _cross_bound),
                (attention.WindowTemporalAttention, "forward", "attn",
                 _temporal_bound),
                (transformer3d.FeedForward, "forward", "ff", _ff_bound),
                (transformer3d, "ln_ff_residual", "ff", _ln_ff_bound),
                (transformer3d, "ln_ff_proj_residual", "ff", _ln_ff_bound),
                (resnet3d.ResnetBlock3D, "forward", "resnet", _resnet_bound)):
            self._patch(owner, name, self._site(kind, bound))
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts):
            torch.zeros(1, device="cuda").add_(1)
        return self

    def uninstall(self) -> None:
        for owner, name, real in reversed(self._restore):
            setattr(owner, name, real)
        self._restore.clear()

    def _patch(self, owner, name, make):
        real = getattr(owner, name)
        self._restore.append((owner, name, real))
        setattr(owner, name, make(real))

    # ----------------------------------------------------------- wrappers

    def _events(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        return start, end

    def _pipeline(self, real):
        probe = self

        def generate(*args, **kwargs):
            if not probe.open:
                return real(*args, **kwargs)
            unit, probe.units = probe.units, probe.units + 1
            with probe.profile_if(unit):
                start, end = probe._events()
                first = len(probe.unet_events)
                out = real(*args, **kwargs)
                end.record()
            probe.pipeline_events.append((start, end, first,
                                          len(probe.unet_events)))
            return out
        return generate

    def _unet(self, real):
        probe = self

        def forward(*args, **kwargs):
            if not probe.open:
                return real(*args, **kwargs)
            start, end = probe._events()
            out = real(*args, **kwargs)
            end.record()
            probe.unet_events.append((start, end))
            return out
        return forward

    def _optimizer(self, real):
        probe = self

        def update(*args, **kwargs):
            if not probe.open:
                return real(*args, **kwargs)
            start, end = probe._events()
            did_sync, gnorm = real(*args, **kwargs)
            end.record()
            if did_sync:
                probe.optimizer_events.append((start, end))
            return did_sync, gnorm
        return update

    def _site(self, kind, bound):
        probe = self

        def make(real):
            def site(*args, **kwargs):
                active = probe._active()
                if not probe.profiling or kind in active:
                    return real(*args, **kwargs)
                probe.site_bound_s[kind] += bound(*args, **kwargs)
                probe.site_calls[kind] += 1
                active.add(kind)
                try:
                    with torch.profiler.record_function(f"seerbench.site.{kind}"):
                        return real(*args, **kwargs)
                finally:
                    active.discard(kind)
            return site
        return make

    def _active(self) -> set:
        if not hasattr(self._local, "kinds"):
            self._local.kinds = set()
        return self._local.kinds

    # ----------------------------------------------------------- profiling

    def step(self):
        """A unit of work that is not a pipeline call (a training step):
        ``with probe.step(): ...``."""
        if not self.open:
            return contextlib.nullcontext()
        unit, self.units = self.units, self.units + 1
        return self.profile_if(unit)

    def profile_if(self, unit: int):
        if unit != self.profiled_unit or self.trace is not None:
            return contextlib.nullcontext()
        return self._profile()

    @contextlib.contextmanager
    def _profile(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            self.profiling = True
            try:
                with torch.profiler.record_function("seerbench.window"):
                    yield
                    torch.cuda.synchronize()
            finally:
                self.profiling = False
        # read after the window: exporting here would stall the caller
        self._prof = prof
        self.trace = {}

    # ------------------------------------------------------------- reading

    def close(self) -> dict:
        """After the window: every CUDA event read, as ms lists, and the
        profiled unit's trace summarised."""
        torch.cuda.synchronize()
        if self._prof is not None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as fh:
                    self.trace = summarize(json.load(fh)["traceEvents"])
            finally:
                os.remove(path)
            self._prof = None
            self.trace["site_bound_s"] = dict(self.site_bound_s)
            self.trace["site_calls"] = dict(self.site_calls)
        ms = lambda pair: pair[0].elapsed_time(pair[1])  # noqa: E731
        unet = [ms(p) for p in self.unet_events]
        pipelines = [(ms(p[:2]), sum(unet[p[2]:p[3]]))
                     for p in self.pipeline_events]
        return {"unet_ms": unet, "pipelines_ms": pipelines,
                "optimizer_ms": [ms(p) for p in self.optimizer_events],
                "trace": self.trace}


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events: list) -> dict:
    """The profiled unit's trace: busy and window seconds, device seconds
    of the kernels launched inside each site kind's spans, the device ops
    that took most time and the longest idle gaps with what the host was
    doing then."""
    window = [e for e in events if e.get("name") == "seerbench.window"
              and e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    if not window:
        raise RuntimeError("the profiled unit's span is not in the trace")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in DEVICE_CATS]
    if not device:
        raise RuntimeError("the trace holds no device activity: the profiler "
                           "did not see the card")
    busy = _merge([(max(w0, float(e["ts"])), min(w1, float(e["ts"]) + float(e["dur"])))
                   for e in device if float(e["ts"]) < w1
                   and float(e["ts"]) + float(e["dur"]) > w0])
    busy_us = sum(b - a for a, b in busy)

    launches = {}
    for e in events:
        if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (e.get("tid"), float(e["ts"]))
    spans = defaultdict(list)
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "user_annotation" and name.startswith("seerbench.site."):
            spans[e.get("tid")].append((float(e["ts"]),
                                        float(e["ts"]) + float(e["dur"]),
                                        name.rsplit(".", 1)[1]))
    starts = {}
    for tid in spans:
        spans[tid].sort()
        starts[tid] = [s[0] for s in spans[tid]]
    site_us = defaultdict(float)
    by_name = defaultdict(float)
    for e in device:
        dur = float(e["dur"])
        by_name[e.get("name", "?")] += dur
        corr = e.get("args", {}).get("correlation")
        if corr not in launches:
            continue
        tid, ts = launches[corr]
        if tid not in spans:
            continue
        i = bisect.bisect_right(starts[tid], ts) - 1
        if i >= 0 and spans[tid][i][1] >= ts:
            site_us[spans[tid][i][2]] += dur

    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]),
                  reverse=True)[:TOP]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("cpu_op", "user_annotation")
            and not e.get("name", "").startswith("seerbench.window")]
    idle = []
    for length, at in gaps:
        inner = [e for e in host if float(e["ts"]) <= at < float(e["ts"]) + float(e["dur"])]
        label = (min(inner, key=lambda e: float(e["dur"]))["name"]
                 if inner else "host outside any op")
        idle.append([label, length * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us * 1e-6, "window_s": (w1 - w0) * 1e-6,
            "site_device_s": {k: v * 1e-6 for k, v in site_us.items()},
            "device_ops": [[n, v * 1e-6] for n, v in ops],
            "idle_gaps": idle}
