"""Run timing: ``unix_time`` (parity: chiron/utils/unix_time.py:11-26) and
the program's span recorder.

A span marks one stage at a layer boundary: the call pipeline's stages in
each of its threads, the model's parts inside a decode step, the train
step's parts. The recorder is on exactly while a torch profiler is on
(``torch.autograd.profiler._is_profiler_enabled``, which every thread
reads); it has no switch of its own.

- Off, ``span`` returns one shared no-op context after that one attribute
  read: nothing is recorded and the device is never touched.
- On, each span appends a ``Span`` when it closes. Its times come from
  ``time.time_ns()``, the clock of the profiler's events, so the spans of
  threads the profiler does not record (the call's pools) line up with the
  kernels in its trace. Its parent is the innermost open span of the same
  thread, and a child inherits its parent's ids (a call's id, a step's
  index). Where the profiler records the calling thread (the main thread,
  and autograd's thread under a backward), the span also enters
  ``torch.profiler.record_function(name)``, so its range sits in the
  profiler's trace beside the kernels it launched.

``span_totals`` sums the spans by name; ``profiled`` runs a body under a
profiler and writes its trace and its spans (``call --profile``,
``train --profile``).
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import threading
import time
from typing import Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

# the recorder keeps at most this many spans; the rest are counted as dropped
MAX_SPANS = 1 << 20


def unix_time(function, args=tuple(), kwargs=None):
    """Return dict of real/sys/user seconds consumed by ``function``."""
    if kwargs is None:
        kwargs = {}
    start_time = time.time()
    start_resources = os.times()
    function(*args, **kwargs)
    end_resources = os.times()
    end_time = time.time()
    return {
        "real": end_time - start_time,
        "sys": end_resources.system - start_resources.system,
        "user": end_resources.user - start_resources.user,
    }


class Span(NamedTuple):
    """One closed span. ``child_ns`` is the time its children cover, so its
    self time is ``end_ns - start_ns - child_ns``; ``tid`` is the thread's
    native id (the profiler's ``tid`` of the main thread)."""
    name: str
    thread: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    ids: Dict[str, int]
    child_ns: int
    tid: int


_spans: List[Span] = []
_dropped = 0
_lock = threading.Lock()
_open = threading.local()  # .stack: this thread's open spans, innermost last


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def _append(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_spans) < MAX_SPANS:
            _spans.append(s)
        else:
            _dropped += 1


class _Span:
    __slots__ = ("name", "ids", "parent", "start_ns", "child_ns", "_range")

    def __init__(self, name: str, ids: Dict[str, int]):
        self.name = name
        self.ids = ids

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.parent is not None and self.parent.ids:
            self.ids = {**self.parent.ids, **self.ids}
        self.child_ns = 0
        self._range = None
        stack.append(self)
        self.start_ns = time.time_ns()
        if torch.autograd._profiler_enabled():
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self.parent is not None:
            self.parent.child_ns += end_ns - self.start_ns
        t = threading.current_thread()
        _append(Span(self.name, t.name, self.start_ns, end_ns,
                     self.parent.name if self.parent is not None else None, self.ids,
                     self.child_ns, t.native_id))
        return False


def span(name: str, **ids):
    """A context that records the stage ``name`` while a profiler is on;
    ``ids`` (a call's id, a step's index) tag it and its children."""
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name, ids)


def current_ids() -> Dict[str, int]:
    """The ids of this thread's innermost open span ({} where none is open),
    for a span that another thread records on its behalf (autograd's
    backward of a loss forward in a step)."""
    if not _profiler._is_profiler_enabled:
        return {}
    stack = _stack()
    return dict(stack[-1].ids) if stack else {}


def record(name: str, start_ns: int, end_ns: int, **ids) -> None:
    """Record a span the caller stamped itself with ``time.time_ns()`` (where
    the same stamps feed another clock, such as a read's ``.meta`` times),
    inside the innermost open span of this thread, if any."""
    if not _profiler._is_profiler_enabled:
        return
    stack = _stack()
    parent = stack[-1] if stack else None
    if parent is not None:
        parent.child_ns += end_ns - start_ns
        if parent.ids:
            ids = {**parent.ids, **ids}
    t = threading.current_thread()
    _append(Span(name, t.name, start_ns, end_ns,
                 parent.name if parent is not None else None, ids, 0, t.native_id))


def spans() -> List[Span]:
    """A copy of the spans recorded so far."""
    with _lock:
        return list(_spans)


def dropped_spans() -> int:
    return _dropped


def clear_spans() -> None:
    global _dropped
    with _lock:
        _spans.clear()
        _dropped = 0


def span_totals(recorded: Optional[List[Span]] = None) -> Dict[str, Dict[str, float]]:
    """For each span name of ``recorded`` (default: every span so far): its
    ``count``, ``seconds`` and ``self_seconds`` (the seconds its children in
    the same thread do not cover)."""
    out: Dict[str, Dict[str, float]] = {}
    for s in spans() if recorded is None else recorded:
        t = out.setdefault(s.name, {"count": 0, "seconds": 0.0, "self_seconds": 0.0})
        t["count"] += 1
        t["seconds"] += (s.end_ns - s.start_ns) / 1e9
        t["self_seconds"] += (s.end_ns - s.start_ns - s.child_ns) / 1e9
    return out


def trace_base_ns(trace_path: str) -> int:
    """The ``baseTimeNanoseconds`` of a profiler's exported Chrome trace (its
    events' ``ts`` are microseconds after it), read from the file's head or
    tail; 0 where it has none."""
    with open(trace_path, "rb") as f:
        head = f.read(1 << 20)
        f.seek(max(0, os.path.getsize(trace_path) - (1 << 20)))
        tail = f.read()
    m = re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head) or \
        re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', tail)
    return int(m.group(1)) if m else 0


def chrome_trace(path: str, recorded: List[Span], base_ns: int) -> None:
    """Write spans as Chrome trace events: one complete event a span, on a
    track per thread (the main thread's is the profiler's own), ``ts`` in
    microseconds after ``base_ns`` (``trace_base_ns`` of the profiler's
    trace, so that the two files' events share one clock); beside them
    their ``span_totals`` and the recorder's dropped count."""
    pid = os.getpid()
    events, named = [], set()
    for s in recorded:
        if s.tid not in named:
            named.add(s.tid)
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": s.tid,
                           "args": {"name": s.thread}})
        events.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                       "tid": s.tid, "ts": (s.start_ns - base_ns) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": dict(s.ids, parent=s.parent)})
    with open(path, "w") as f:
        json.dump({"displayTimeUnit": "ms", "baseTimeNanoseconds": base_ns,
                   "traceEvents": events, "totals": span_totals(recorded),
                   "dropped": _dropped}, f)


@contextlib.contextmanager
def profiled(out_dir: Optional[str]):
    """Run the body under a torch profiler (the CPU, and CUDA where a card is
    visible), then write ``out_dir``/trace.json, the profiler's Chrome trace,
    and ``out_dir``/spans.json, the body's spans (``chrome_trace``), so that
    the two files' ``traceEvents`` concatenate into one timeline. With
    ``out_dir`` None the body runs unprofiled."""
    if out_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    start_ns = time.time_ns()
    with profile(activities=acts) as prof:
        yield
    os.makedirs(out_dir, exist_ok=True)
    trace_path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(trace_path)
    chrome_trace(os.path.join(out_dir, "spans.json"),
                 [s for s in spans() if s.start_ns >= start_ns], trace_base_ns(trace_path))
