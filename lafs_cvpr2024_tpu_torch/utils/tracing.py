"""Spans and counters of the program, kept in memory; off by default.

    from lafs_cvpr2024_tpu_torch.utils import tracing
    tracing.enable(True)
    with tracing.span("ssl.step", step=k):
        with tracing.span("ssl.tail", step=k), tracing.device_span("ssl.tail", dev):
            ...
    tracing.count("serve.rows", 512)
    tracing.count("sup.nonfinite", skipped)  # a 0-d tensor, read at export
    record = tracing.export()   # {"spans": [...], "counters": {...}}

Off, :func:`span` and :func:`device_span` return one shared null context
after a check of the module flag ``ON``, and :func:`count` returns after the
same check: no allocation, no profiler range, no CUDA event.

On, a span stamps its start and end with ``time.time_ns()`` and enters
``torch.profiler.record_function(name)``, so an active profiler session shows
it under the same name. ``time.time_ns()`` is the epoch clock that the
profiler's ``kineto_results.trace_start_ns()`` is read on (its events are
microseconds after that start) and that a client's ``time.time()`` reads: the
program's spans, a device trace and a client's timestamps share one clock.
A record holds the name, the start and end (ns), its own id, the id of the
span that encloses it on the same thread (``parent``, None at the top), the
thread (``threading.get_native_id``) and the ids given (``step=k``).

:func:`device_span` records a pair of CUDA events on the current stream and
synchronises nothing; :func:`export` turns each pair into ``device_ms`` once
the caller has synchronised (None for a pair the card has not reached yet).
Its record carries the host stamps of the two records as well.

Spans of any thread go into one list (``list.append`` holds the interpreter
lock); the counters are read-modify-write and are counted from one thread at
a time by the program.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from collections import Counter

import torch

from .. import _build

ON = False
_NULL = contextlib.nullcontext()
_ids = itertools.count()
_open = threading.local()  # the stack of open span ids of each thread
_spans: list = []
_devices: list = []
_counters: Counter = Counter()
_pending: dict = {}  # counters whose increments are tensors on the card
_launches0: Counter = Counter()


def enable(on: bool = True) -> None:
    """Turn the spans and counters on or off (records already made stay)."""
    global ON
    ON = bool(on)


def reset() -> None:
    """Drop every record and counter; ``launch.*`` counts from here."""
    _spans.clear()
    _devices.clear()
    _counters.clear()
    _pending.clear()
    _launches0.clear()
    _launches0.update(_build.LAUNCHES)


def _stack() -> list:
    st = getattr(_open, "stack", None)
    if st is None:
        st = _open.stack = []
    return st


class _Span:
    __slots__ = ("name", "ids", "id", "parent", "start", "range")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self):
        st = _stack()
        self.id = next(_ids)
        self.parent = st[-1] if st else None
        st.append(self.id)
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.range.__exit__(*exc)
        _stack().pop()
        _spans.append({"name": self.name, "id": self.id,
                       "parent": self.parent, "start_ns": self.start,
                       "end_ns": end, "thread": threading.get_native_id(),
                       "ids": self.ids})
        return False


class _DeviceSpan:
    __slots__ = ("name", "ids", "events", "start")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self):
        self.events = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
        self.events[0].record()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.events[1].record()
        st = _stack()
        _devices.append((self, st[-1] if st else None, time.time_ns(),
                         threading.get_native_id()))
        return False


def span(name: str, **ids):
    """A host span (and a profiler range) named ``name``; ``ids`` such as
    ``step=k`` or ``request=i`` go into its record."""
    if not ON:
        return _NULL
    return _Span(name, ids)


def device_span(name: str, device, **ids):
    """The card's time between entering and leaving, by a CUDA event pair on
    the current stream; nothing where ``device`` is not a CUDA device."""
    if not ON or torch.device(device).type != "cuda":
        return _NULL
    return _DeviceSpan(name, ids)


def count(name: str, n=1) -> None:
    """Add ``n`` to the counter ``name``. A 0-d tensor ``n`` is added where
    it lives (no wait for the card) and read by :func:`export`."""
    if not ON:
        return
    if isinstance(n, torch.Tensor):
        _pending[name] = n + _pending[name] if name in _pending else n
    else:
        _counters[name] += n


def _device_ms(events) -> float | None:
    a, b = events
    return a.elapsed_time(b) if b.query() else None


def export() -> dict:
    """``{"spans": [...], "counters": {...}}``: the finished spans in the
    order they ended, each device span with its ``device_ms``, and the
    counters (a tensor counter read, so after the caller's synchronise)
    with the kernel launches since :func:`reset` (the wrappers'
    ``_build.LAUNCHES``) as ``launch.<kernel>``."""
    spans = list(_spans)
    for d, parent, end, thread in list(_devices):
        spans.append({"name": d.name, "parent": parent,
                      "start_ns": d.start, "end_ns": end, "thread": thread,
                      "ids": d.ids, "device_ms": _device_ms(d.events)})
    counters = dict(_counters)
    for k, v in _pending.items():
        counters[k] = counters.get(k, 0) + int(round(float(v)))
    for k, v in (_build.LAUNCHES - _launches0).items():
        counters["launch." + k] = v
    return {"spans": spans, "counters": counters}


def write_chrome_trace(path, record: dict, prof=None) -> None:
    """Write ``record`` (an :func:`export`) as Chrome trace events (JSON,
    microseconds on the epoch clock), with the host operations and device
    kernels of the ``torch.profiler.profile`` session ``prof`` when given:
    one timeline for the program's spans and the card's work. Device spans
    (which have no place on the host clock) go into the trace's
    ``otherData``; the profiler's copies of the program's spans are left
    out."""
    pid = os.getpid()
    events = [{"name": s["name"], "ph": "X", "cat": "program", "pid": pid,
               "tid": s["thread"], "ts": s["start_ns"] / 1e3,
               "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
               "args": dict(s["ids"], id=s["id"], parent=s["parent"])}
              for s in record["spans"] if "device_ms" not in s]
    if prof is not None:
        base = prof.profiler.kineto_results.trace_start_ns() / 1e3
        for e in prof.events():
            if getattr(e, "is_user_annotation", False):
                continue
            on_card = e.device_type == torch.autograd.DeviceType.CUDA
            events.append({
                "name": e.name, "ph": "X",
                "cat": "kernel" if on_card else "op",
                "pid": f"cuda:{e.device_index}" if on_card else pid,
                "tid": e.thread, "ts": base + e.time_range.start,
                "dur": e.time_range.elapsed_us()})
    events.sort(key=lambda e: e["ts"])
    device = [{"name": s["name"], "ids": s["ids"], "device_ms": s["device_ms"]}
              for s in record["spans"] if "device_ms" in s]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"counters": record["counters"],
                                 "device_spans": device}}, f)
