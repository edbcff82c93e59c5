"""The traced window: torch.profiler over the device, a sampler over the
host threads, and what the per-layer readers read from them.

With ``--trace 1`` the measured window runs inside a ``torch.profiler``
profile (CPU and CUDA activity, no Python stacks: the host pipeline makes
tens of millions of Python calls a window, and recording them would change
what is measured) and a ``bench.window`` range that marks its bounds in the
profiler's clock. A sampler thread reads every host thread's Python stack
every few milliseconds, so that each stretch in which the device was idle
can be named by what the host threads were doing meanwhile.

``TraceData`` holds the device activity clipped to the window (kernels,
copies and sets, as [name, start_s, seconds] from the window's start), the
busy seconds (the union of those intervals), the window's length, the
longest idle gaps by host activity and the device operations that took
most time.
"""

from __future__ import annotations

import bisect
import collections
import re
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

WINDOW_RANGE = "bench.window"
SAMPLE_PERIOD_S = 0.005
# frames of these files are a thread waiting, not working
_WAIT_FILES = ("threading.py", "queue.py", "selectors.py", "socket.py", "socketserver.py",
               "concurrent/futures/", "concurrent\\futures\\")
# activity on the device timeline that is not work: the ranges a run marks
_NOT_WORK = ("user_annotation",)


@dataclass
class TraceData:
    window_s: float
    kernels: List[Tuple[str, float, float]]  # (name, start_s, seconds) in the window
    busy_s: float
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)

    def seconds_of(self, names: Sequence[str]) -> float:
        """Device seconds of the kernels whose name holds one of ``names``."""
        return sum(d for n, _, d in self.kernels if any(s in n for s in names))


def union_seconds(intervals: Sequence[Tuple[float, float]]
                  ) -> Tuple[float, List[Tuple[float, float]]]:
    """(total covered seconds, merged [start, end] intervals)."""
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


def _thread_role(name: str) -> str:
    """A thread's name without the counters that differ from run to run."""
    return re.sub(r"[-_]?\d+", "", name).strip() or "thread"


def _frame_label(frame) -> Optional[str]:
    """The innermost frame of the program on this stack, or None if the
    thread is waiting."""
    f = frame
    innermost = f.f_code.co_filename
    if any(w in innermost for w in _WAIT_FILES):
        return None
    while f is not None:
        path = f.f_code.co_filename.replace("\\", "/")
        if "chiron_tpu_torch/" in path:
            mod = path.split("chiron_tpu_torch/", 1)[1]
            return f"{mod}:{f.f_code.co_name}"
        f = f.f_back
    return f"{frame.f_code.co_filename.rsplit('/', 1)[-1]}:{frame.f_code.co_name}"


class HostSampler:
    """Samples, every ``period`` seconds, which host threads run what."""

    def __init__(self, period: float = SAMPLE_PERIOD_S):
        self.period = period
        self.samples: List[Tuple[int, Tuple[str, ...]]] = []  # (time_ns, active labels)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="bench-sampler", daemon=True)

    def _run(self):
        me = threading.get_ident()
        while not self._stop.wait(self.period):
            names = {t.ident: t.name for t in threading.enumerate()}
            active = []
            for ident, frame in sys._current_frames().items():
                if ident == me:
                    continue
                label = _frame_label(frame)
                if label is not None:
                    active.append(f"{_thread_role(names.get(ident, 'thread'))}/{label}")
            self.samples.append((time.time_ns(), tuple(sorted(active))))

    def start(self):
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)


def _kineto_device_events(prof):
    """(window start ns, window end ns, [(name, start ns, end ns)]) from the
    profiler's raw events: every device activity that is work."""
    w0 = w1 = None
    dev = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if name == WINDOW_RANGE:
            if str(e.device_type()).endswith("CPU"):
                w0, w1 = e.start_ns(), e.start_ns() + e.duration_ns()
            continue
        if not str(e.device_type()).endswith("CUDA"):
            continue
        kind = str(getattr(e, "activity_type", lambda: "")()).lower()
        if e.is_user_annotation() or any(k in kind for k in _NOT_WORK):
            continue
        dev.append((name, e.start_ns(), e.start_ns() + e.duration_ns()))
    return w0, w1, dev


def label_gaps(gaps: Sequence[Tuple[int, int]], samples: Sequence[Tuple[int, Tuple[str, ...]]],
               top: int = 10) -> List[Tuple[str, float]]:
    """Idle seconds by what the host was doing: each gap [start, end] ns is
    named by the host activity most often sampled inside it (the last
    sample before its end where none falls inside), summed by name."""
    times = [t for t, _ in samples]
    out: Dict[str, float] = collections.defaultdict(float)
    for g0, g1 in gaps:
        lo = bisect.bisect_left(times, g0)
        hi = bisect.bisect_right(times, g1)
        votes = collections.Counter()
        for _, labels in samples[lo:hi]:
            votes.update(labels or ("(host idle)",))
        if not votes and hi > 0:
            votes.update(samples[hi - 1][1] or ("(host idle)",))
        name = votes.most_common(1)[0][0] if votes else "(no host sample)"
        out[name] += (g1 - g0) / 1e9
    return sorted(out.items(), key=lambda kv: -kv[1])[:top]


def reduce_trace(w0: int, w1: int, device: Sequence[Tuple[str, int, int]],
                 samples: Sequence[Tuple[int, Tuple[str, ...]]]) -> TraceData:
    """The window's ``TraceData`` from device intervals in ns and host samples
    in the same clock."""
    clipped = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    busy, merged = union_seconds([(s, e) for _, s, e in clipped])
    gaps, cur = [], w0
    for s, e in merged:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if w1 > cur:
        gaps.append((cur, w1))
    by_name: Dict[str, float] = collections.defaultdict(float)
    for n, s, e in clipped:
        by_name[n] += (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return TraceData(window_s=(w1 - w0) / 1e9,
                     kernels=[(n, (s - w0) / 1e9, (e - s) / 1e9) for n, s, e in clipped],
                     busy_s=busy / 1e9, idle_gaps=label_gaps(gaps, samples),
                     device_ops=[(n[:120], v) for n, v in ops])


class Window:
    """The measured window; with ``trace`` it is profiled and sampled.

    ``with Window(trace) as w: ...`` then ``w.data`` (None untraced)."""

    def __init__(self, trace: bool):
        self.trace = trace
        self.data: Optional[TraceData] = None
        self._prof = None
        self._range = None
        self._sampler = None
        self._host0 = 0

    def __enter__(self):
        if self.trace:
            from torch.profiler import ProfilerActivity, profile, record_function

            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()
            self._sampler = HostSampler()
            self._sampler.start()
            self._host0 = time.time_ns()
            self._range = record_function(WINDOW_RANGE)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if not self.trace:
            return False
        import torch

        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._sampler.stop()
        self._prof.__exit__(None, None, None)
        if exc[0] is None:
            w0, w1, dev = _kineto_device_events(self._prof)
            if w0 is None:
                raise RuntimeError(f"the profiler's trace holds no {WINDOW_RANGE!r} range")
            shift = w0 - self._host0  # host clock -> profiler clock
            samples = [(t + shift, labels) for t, labels in self._sampler.samples]
            self.data = reduce_trace(w0, w1, dev, samples)
        self._prof = None
        return False
