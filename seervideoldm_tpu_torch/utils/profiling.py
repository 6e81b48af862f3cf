"""The port's tracer, counters and profiling hooks (beyond
``seervideoldm_tpu/utils/profiling.py``, which has only ``trace``,
``annotate`` and a step timer).

Usage::

    with span("pipe.vae_decode", events=True):   # a detailed span
        frames = decode(latents)

    with trace("outputs/trace"):                  # torch.profiler, CPU + CUDA
        run_steps()

    spans(), counters(), reset()                  # read and clear

**Two tiers of records.**

- *Always on*: counters (``count``: a Python int add) and a few coarse
  records, at most a few a second: one per request (``serve.request``,
  ``serve.queue``), batch (``serve.batch``), pipeline call
  (``pipeline_call``) and training step (``train.step``), each a pair of
  host timestamps.  A pipeline call's record carries its counts
  (``counts``): UNet calls, the dispatches checked for starvation and
  those found starved (``unet_meter``), PAB site evaluations computed and
  reused by type, and ``profiled``, whether a profiler recorded (or the
  detailed tier was forced on) at its start or end, forced off or not.
- *Detailed*: every other span.  It records only while a
  ``torch.profiler`` records on the calling thread (autograd's threads
  inherit that state for a backward called there), or after
  ``set_enabled(True)``; ``set_enabled(False)`` forces it off, ``None``
  returns to following the profiler.  Off, a span costs one check and
  leaves nothing.  On, it records its name, start and end, its parent (a
  stack per thread) and its ids, opens a ``record_function`` range (and an
  NVTX range on a card), so that it sits in any profiler trace beside the
  kernels, and with ``events=True`` a pair of CUDA timing events, read
  only when the records are read (``device_ms``).

Timestamps are ``time.time_ns()``: the clock the profiler's exported trace
is on (``baseTimeNanoseconds + ts``), so a record and its
``record_function`` twin agree to microseconds.  Records go into one
bounded ring (``RING_SIZE``, oldest evicted first).  While the current
CUDA stream is capturing a graph, nothing records or queries an event or
synchronises.

**Model sites** (``site``, a decorator of a site's forward): ``site.resnet``,
``site.attn``, ``site.ff``, the outermost of a kind only (a feed-forward
inside a fused FF site is part of it).  While the detailed tier is on and
the site's input and output need gradients, the site is bracketed by a
pair of identity autograd Functions, one at its output and one at its
input: in the backward they open and close ``site.<kind>.bwd`` on the
thread that runs it, with CUDA events.  A backward span's parent is the
span opened with ``autograd=True`` around the ``torch.autograd`` call
(``train.backward``).  Off, no node is inserted; on or off, outputs and
gradients are bit-identical.

**Counters** (``counters()``): the tracer's own (``unet.*``, ``pab.*``)
and, read where they are kept, never copied: the serving counters of each
live ``DynamicBatcher`` and ``GenerationService`` (``serve.*``,
``register_counters``), the kernel wrappers' launches
(``kernels.<name>.launches``; K11's ``kernels.group_norm.sharded`` too)
and the collectives' calls and bytes (``collectives.<op>.calls`` /
``.bytes``).  ``reset()`` clears the ring
and the tracer's own counters; the others belong to their owners.

Beside the tracer:

- ``trace``: ``torch.profiler`` over a region (CUDA activities when a card
  is visible); ``trace.json``, ``kernels.txt`` (the ``key_averages``
  table) and ``idle.txt`` (``idle_gaps``: the device's idle gaps, longest
  first, each put down to the innermost program span and the innermost op
  open on the host when it began, all read from the one exported trace) go
  to ``log_dir``;
- ``kernel_ms``: the CUDA kernel time of one call, summed from a profiler
  trace (what the floor budgets report beside the wall time);
- ``enable_nan_checks`` / ``disable_nan_checks``: forward hooks that raise
  on the first non-finite module output, naming the module, and autograd's
  anomaly mode for the backward.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
import weakref
from collections import deque
from typing import Iterator, Optional

import torch
import torch.nn as nn

# a 45 s serving or sampling run's coarse records (~150) and one profiled
# unit's detailed spans (~3400 for a 31-call sampling batch, ~700 for a
# training step of two micro-steps) fit many times over
RING_SIZE = 1 << 15
# the prefixes of the program's span names (``idle_gaps`` labels a gap
# with the innermost of these)
PREFIXES = ("serve.", "pipe.", "ddim.", "dpm.", "unet.", "site.", "train.")

_ring: deque = deque(maxlen=RING_SIZE)
_counts: dict = {}
_counts_lock = threading.Lock()
_forced: Optional[bool] = None
_seq = itertools.count()
_local = threading.local()
_profiling = torch._C._autograd._profiler_enabled
_sources: list = []            # (prefix, weakref to owner, attribute names)
_open_bwd: list = []           # backward spans open on any thread
_autograd_parent: list = []    # seqs of open ``autograd=True`` spans
_off_spans = ({}, {})          # [events][name] -> a shared switched-off span


def set_enabled(on: Optional[bool]) -> None:
    """Force the detailed tier on (True) or off (False); None follows the
    profiler again."""
    global _forced
    _forced = None if on is None else bool(on)


def detailed() -> bool:
    """Whether a detailed span opened now on this thread would record."""
    return _forced if _forced is not None else _profiling()


def _traced() -> int:
    """1 while a profiler records on this thread or the detailed tier is
    forced on, whatever ``set_enabled(False)`` says."""
    return int(_profiling() or bool(_forced))


def now() -> int:
    """The tracer's clock: ns on the profiler trace's host clock."""
    return time.time_ns()


def _capturing() -> bool:
    return (torch.cuda.is_initialized()
            and torch.cuda.is_current_stream_capturing())


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Record:
    """One span: ``name``, ``start`` / ``end`` (ns, ``now``), ``parent``
    (the ``seq`` of the span open around it), ``thread``, ``ids``,
    ``counts`` (a pipeline call's) and, for a span with events, its CUDA
    event pair until read."""

    __slots__ = ("seq", "name", "start", "end", "parent", "thread", "ids",
                 "counts", "events", "device_ms")

    def __init__(self, name: str, ids: dict, start: Optional[int] = None,
                 parent: Optional[int] = None):
        self.seq = next(_seq)
        self.name = name
        self.start = now() if start is None else start
        self.end = None
        stack = _stack()
        self.parent = stack[-1].seq if stack else parent
        self.thread = threading.get_ident()
        self.ids = ids
        self.counts = None
        self.events = None
        self.device_ms = None

    def as_dict(self) -> dict:
        if self.events is not None:
            start, end = self.events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self.events = None
        return {"seq": self.seq, "name": self.name, "start": self.start,
                "end": self.end, "parent": self.parent, "thread": self.thread,
                "ids": dict(self.ids), "counts": (dict(self.counts)
                                                  if self.counts is not None
                                                  else None),
                "device_ms": self.device_ms}


class _Off:
    """A switched-off span: enters and leaves without a trace; as a
    decorator, a span opened (or not) at each call."""

    __slots__ = ("name", "events")

    def __init__(self, name: str, events: bool):
        self.name, self.events = name, events

    def __enter__(self):
        pass

    def __exit__(self, exc_type, exc, tb):
        pass

    def __call__(self, fn):
        name, events = self.name, self.events

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name, events):
                return fn(*args, **kwargs)
        return run


class _Span:
    """An open span (``span`` when it records, ``coarse`` always)."""

    __slots__ = ("rec", "events", "autograd", "rf", "nvtx", "stack")

    def __init__(self, name: str, events: bool, ids: dict,
                 autograd: bool = False, parent: Optional[int] = None):
        self.rec = Record(name, ids, parent=parent)
        self.events, self.autograd = events, autograd
        self.rf = self.nvtx = self.stack = None

    def __enter__(self) -> Record:
        rec = self.rec
        rec.start = now()
        if detailed():
            self.rf = torch.profiler.record_function(rec.name)
            self.rf.__enter__()
        if self.rf is not None and torch.cuda.is_initialized():
            torch.cuda.nvtx.range_push(rec.name)
            self.nvtx = True
        if self.events and torch.cuda.is_initialized() and not _capturing():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rec.events = (start, torch.cuda.Event(enable_timing=True))
        self.stack = _stack()
        self.stack.append(rec)
        if self.autograd:
            _autograd_parent.append(rec.seq)
        return rec

    def __exit__(self, exc_type, *exc):
        rec = self.rec
        if self.autograd:
            _autograd_parent.remove(rec.seq)
            _close_open_bwd()
        if rec in self.stack:
            self.stack.remove(rec)
        if rec.events is not None:
            rec.events[1].record()
        if self.nvtx:
            torch.cuda.nvtx.range_pop()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        rec.end = now()
        if exc_type is not None:
            rec.ids["error"] = exc_type.__name__
        _ring.append(rec)
        return False

    def __call__(self, fn):
        return _Off(self.rec.name, self.events)(fn)


def span(name: str, events: bool = False, autograd: bool = False, **ids):
    """A detailed span (a context manager yielding its ``Record``, or None
    when off; as a decorator, a span around each call).  ``events``: CUDA
    timing events around the work it dispatches; ``autograd``: it encloses
    a ``torch.autograd`` call, and is the parent of the backward spans
    opened on autograd's threads inside it.  Off, a span shared by every
    call of that name is returned."""
    # ``detailed()`` inlined: the switched-off path is the hot one
    if not (_profiling() if _forced is None else _forced):
        return _off_spans[events].get(name) or _off(name, events)
    return _Span(name, events, ids, autograd)


def _off(name: str, events: bool) -> _Off:
    off = _off_spans[events][name] = _Off(name, events)
    return off


def coarse(name: str, **ids) -> _Span:
    """An always-on span (host timestamps; in the profiler trace too while
    the detailed tier is on)."""
    return _Span(name, False, ids)


def record(name: str, start: int, end: Optional[int] = None, **ids) -> Record:
    """An always-on record of a span already over (or ending now), opened
    at ``start`` (``now()``), possibly on another thread."""
    rec = Record(name, ids, start=start)
    rec.end = now() if end is None else end
    _ring.append(rec)
    return rec


def tag(**ids) -> None:
    """Add ids to the innermost span open on this thread."""
    stack = _stack()
    if stack:
        stack[-1].ids.update(ids)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``, and to the counts of the pipeline
    call open on this thread."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n
    call = getattr(_local, "call", None)
    if call is not None:
        call.counts[name] = call.counts.get(name, 0) + n


# ---------------------------------------------------------- pipeline calls

class pipeline_call:
    """The always-on record of the outermost pipeline call on this thread
    (``pipe.generate`` / ``pipe.rollout`` / ``pipe.edit``), carrying the
    counts made inside it; a call inside another is a detailed span.  A
    context manager, or a decorator."""

    __slots__ = ("name", "ids", "inner", "outer")

    def __init__(self, name: str, **ids):
        self.name, self.ids = name, ids
        self.inner = self.outer = None

    def __enter__(self):
        if getattr(_local, "call", None) is not None:
            self.inner = span(self.name, **self.ids)
            return self.inner.__enter__()
        self.outer = coarse(self.name, **self.ids)
        rec = self.outer.__enter__()
        rec.counts = {"profiled": _traced()}
        _local.call = rec
        return rec

    def __exit__(self, *exc):
        if self.inner is not None:
            return self.inner.__exit__(*exc)
        rec = self.outer.rec
        _local.call = None
        rec.counts["profiled"] = rec.counts["profiled"] or _traced()
        return self.outer.__exit__(*exc)

    def __call__(self, fn):
        name, ids = self.name, self.ids

        @functools.wraps(fn)
        def run(*args, **kwargs):
            with pipeline_call(name, **ids):
                return fn(*args, **kwargs)
        return run


class unet_meter:
    """The UNet calls of one sampling loop: ``with meter: ...`` around
    each.  Counts every call (``unet.calls``); at the entry of each
    call after the first, queries (never times) an event recorded at the
    end of the previous call's dispatch: if the card has finished it, the
    host let the card run dry (``unet.checked``, ``unet.starved``).  While
    the detailed tier is on, each call is a ``unet.call`` span with CUDA
    events."""

    __slots__ = ("cuda", "event", "n", "open")

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.event = None
        self.n = 0
        self.open = None

    def __enter__(self):
        count("unet.calls")
        if self.event is not None and not _capturing():
            count("unet.checked")
            if self.event.query():
                count("unet.starved")
        self.open = span("unet.call", True, call=self.n)
        self.n += 1
        return self.open.__enter__()

    def __exit__(self, *exc):
        self.open.__exit__(*exc)
        self.open = None
        if self.cuda and not _capturing():
            if self.event is None:
                self.event = torch.cuda.Event()
            self.event.record()
        return False


# ------------------------------------------------------------- model sites

def _close_open_bwd() -> None:
    """Close the backward spans whose last node never ran (autograd did
    not need it)."""
    while _open_bwd:
        _open_bwd.pop().__exit__(None, None, None)


_seq_nr = getattr(torch._C._autograd, "_get_sequence_nr", None)
_NO_SEQ = 1 << 63   # AccumulateGrad nodes carry the largest sequence number


class _BwdSpan:
    """A site's backward span, opened by a pre-hook on the site's output
    node and closed by a hook on the last of its nodes to run."""

    __slots__ = ("name", "open")

    def __init__(self, name: str):
        self.name, self.open = name, None

    def begin(self, grad_outputs):
        if _open_bwd:   # backward spans never nest: one left open ended
            _close_open_bwd()
        parent = _autograd_parent[-1] if _autograd_parent else None
        self.open = _Span(self.name, True, {}, parent=parent)
        self.open.__enter__()
        _open_bwd.append(self.open)

    def end(self, grad_inputs, grad_outputs):
        opened, self.open = self.open, None
        if opened is not None and opened in _open_bwd:
            _open_bwd.remove(opened)
            opened.__exit__(None, None, None)


def _bracket(out, first: int, kind_name: str) -> None:
    """Hook the backward of the autograd nodes made since sequence number
    ``first`` that ``out`` reaches: the output's node opens the span, the
    earliest made (the last to run: autograd runs the ready node made
    latest first) closes it.  No node is added."""
    head = getattr(out, "grad_fn", None)
    if head is None or not first <= head._sequence_nr() < _NO_SEQ:
        return
    last, seen, todo = head, {head}, [head]
    while todo:
        node = todo.pop()
        for nxt, _ in node.next_functions:
            if nxt is None or nxt in seen:
                continue
            seen.add(nxt)
            seq = nxt._sequence_nr()
            if first <= seq < _NO_SEQ:
                todo.append(nxt)
                if seq < last._sequence_nr():
                    last = nxt
    cell = _BwdSpan(kind_name)
    head.register_prehook(cell.begin)
    last.register_hook(cell.end)


def site(kind: str):
    """Decorator of a model site's forward: the ``site.<kind>`` span and,
    under autograd, the backward span described above."""
    name, bwd_name = f"site.{kind}", f"site.{kind}.bwd"

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not (_profiling() if _forced is None else _forced):
                return fn(*args, **kwargs)
            kinds = getattr(_local, "kinds", None)
            if kinds is None:
                kinds = _local.kinds = set()
            if kind in kinds:
                return fn(*args, **kwargs)
            kinds.add(kind)
            try:
                first = (_seq_nr() if _seq_nr is not None
                         and torch.is_grad_enabled() else None)
                with span(name):
                    out = fn(*args, **kwargs)
                if first is not None:
                    _bracket(out, first, bwd_name)
                return out
            finally:
                kinds.discard(kind)
        return run
    return wrap


# ---------------------------------------------------------------- reading

def register_counters(prefix: str, owner, *attrs: str) -> None:
    """``counters()`` reads ``owner.<attr>`` as ``<prefix>.<attr>`` (summed
    over live owners) for as long as ``owner`` lives."""
    _sources.append((prefix, weakref.ref(owner), attrs))


def counters() -> dict:
    """Every counter of the process, by name (see the module docstring)."""
    with _counts_lock:
        out = dict(_counts)
    live = []
    for prefix, ref, attrs in _sources:
        owner = ref()
        if owner is None:
            continue
        live.append((prefix, ref, attrs))
        for a in attrs:
            key = f"{prefix}.{a}"
            out[key] = out.get(key, 0) + int(getattr(owner, a))
    _sources[:] = live
    from ..ops.kernels import launch_counters
    from ..parallel.collectives import stats

    for name, fn in launch_counters().items():
        out[f"kernels.{name}.launches"] = fn.launches
        if hasattr(fn, "sharded"):
            out[f"kernels.{name}.sharded"] = fn.sharded
    for op, (calls, nbytes) in stats.items():
        out[f"collectives.{op}.calls"] = calls
        out[f"collectives.{op}.bytes"] = nbytes
    return out


def spans(name: Optional[str] = None) -> list:
    """The records in the ring (all, or those called ``name``), oldest
    first, as dicts; ``device_ms`` read from their CUDA events (which waits
    for them)."""
    return [r.as_dict() for r in list(_ring)
            if r.end is not None and (name is None or r.name == name)]


def reset() -> None:
    """Empty the ring and the tracer's own counters."""
    _ring.clear()
    with _counts_lock:
        _counts.clear()


# ------------------------------------------------------------ profiling

def _activities():
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _innermost(pool: list, times: list) -> list:
    """For each time of ``times`` (ascending), the name of the shortest
    event of ``pool`` open then on any thread, or None: one sweep per
    thread, whose events nest."""
    best = [None] * len(times)
    threads: dict = {}
    for e in pool:
        start = float(e["ts"])
        threads.setdefault(e.get("tid"), []).append(
            (start, -float(e["dur"]), start + float(e["dur"]), e["name"]))
    for events in threads.values():
        events.sort()
        stack, i = [], 0
        for k, t in enumerate(times):
            while i < len(events) and events[i][0] <= t:
                while stack and stack[-1][2] <= events[i][0]:
                    stack.pop()
                stack.append(events[i])
                i += 1
            while stack and stack[-1][2] <= t:
                stack.pop()
            if stack and (best[k] is None or -stack[-1][1] < best[k][0]):
                best[k] = (-stack[-1][1], stack[-1][3])
    return [b and b[1] for b in best]


def idle_gaps(trace: dict, top: int = 20) -> list:
    """The device's idle gaps in an exported Chrome trace (its dict),
    longest first: ``(ms, innermost program span, innermost host op, ms
    from the first device activity)``, the span and op those open on any
    host thread when the gap began.  Empty without device activity."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    busy = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in events if e.get("cat") in DEVICE_CATS)
    if not busy:
        return []
    merged = [list(busy[0])]
    for a, b in busy[1:]:
        if a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                   for i in range(len(merged) - 1)), reverse=True)[:top]
    times = sorted(at for _, at in gaps)
    spans_ = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(PREFIXES)]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    span_at = dict(zip(times, _innermost(spans_, times)))
    op_at = dict(zip(times, _innermost(ops, times)))
    t0 = merged[0][0]
    return [(length / 1e3, span_at[at] or "outside any span",
             op_at[at] or "outside any op", (at - t0) / 1e3)
            for length, at in gaps]


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the region into ``log_dir``: ``trace.json`` (Chrome trace),
    ``kernels.txt`` (the ``key_averages`` table) and ``idle.txt`` (the
    device's idle gaps by program span and host op)."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    sort = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
    with open(os.path.join(log_dir, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=80))
    with open(path) as f:
        gaps = idle_gaps(json.load(f))
    with open(os.path.join(log_dir, "idle.txt"), "w") as f:
        f.write("gap_ms\tspan\top\tat_ms\n")
        for length, sp, op, at in gaps:
            f.write(f"{length:.3f}\t{sp}\t{op}\t{at:.3f}\n")
        if not gaps:
            f.write("# the trace holds no device activity\n")


def kernel_ms(call) -> Optional[float]:
    """CUDA kernel time of ``call()`` in ms: the device self time of every
    CUDA event of a profiler trace around it, summed.  None without a card
    (there is no device time to read)."""
    if not torch.cuda.is_available():
        return None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    total = 0.0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            total += getattr(evt, "self_device_time_total",
                             getattr(evt, "self_cuda_time_total", 0.0))
    return total / 1e3


class NanChecks:
    """What ``enable_nan_checks`` installed: the hook handles and the
    anomaly mode to restore."""

    def __init__(self, handles, anomaly_before: bool):
        self.handles, self.anomaly_before = handles, anomaly_before


def _finite(out) -> bool:
    if isinstance(out, torch.Tensor):
        return not out.is_floating_point() or bool(torch.isfinite(out).all())
    if isinstance(out, (tuple, list)):
        return all(_finite(o) for o in out)
    if isinstance(out, dict):
        return all(_finite(o) for o in out.values())
    return True


def enable_nan_checks(model: nn.Module) -> NanChecks:
    """Debug mode (slow; dev only): raise on the first non-finite output of
    any submodule of ``model``, naming it, and turn on autograd's anomaly
    detection so a NaN in the backward names the forward op that made it."""
    def hook_for(name: str):
        def hook(module, inputs, output):
            if not _finite(output):
                raise FloatingPointError(
                    f"non-finite output from {name or 'the model'} "
                    f"({type(module).__name__})")
        return hook

    handles = [m.register_forward_hook(hook_for(n))
               for n, m in model.named_modules()]
    before = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    return NanChecks(handles, before)


def disable_nan_checks(checks: NanChecks) -> None:
    for h in checks.handles:
        h.remove()
    torch.autograd.set_detect_anomaly(checks.anomaly_before)
