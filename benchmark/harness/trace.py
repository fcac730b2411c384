"""The device trace of a run's traced window, from ``torch.profiler``
(CUPTI): every device activity (kernels, copies, sets) as an interval,
and the benchmark's own host spans (``mwx.<name>`` annotations) on the
same clock.

``reduce`` gives the window's length, the union of device intervals
(``busy_s``), device seconds by kernel name, and the idle gaps labelled by
the innermost host span that covers them.  Events are read from the
profiler's raw results, not from its event tree, which is too slow at
hundreds of thousands of kernels.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Tuple

import torch

WINDOW = "mwx.window"


class DeviceTrace:
    def __init__(self):
        self._prof = None
        self._window = None
        self.result: Optional[Dict] = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._window = record_function(WINDOW)
        self._window.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._done, self._prof = self._prof, None

    def finish(self) -> Dict:
        """Reduce the trace (after the window: it takes a while)."""
        self.result = reduce(self._done.profiler.kineto_results.events())
        self._done = None
        return self.result

    @property
    def active(self) -> bool:
        return self._prof is not None


def warm_up() -> None:
    """Start and stop the profiler once on a trivial op: the first start
    in a process initialises CUPTI, which takes seconds."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(events) -> Dict:
    """Raw profiler events -> the traced window's numbers (seconds)."""
    from torch.autograd import DeviceType
    window = None
    device: List[Tuple[int, int, str]] = []
    host: List[Tuple[int, int, str]] = []
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.device_type() == DeviceType.CUDA:
            # the annotations' device-side copies are spans, not work
            if not (ev.is_user_annotation() or name.startswith("mwx.")):
                device.append((start, end, name))
        elif name == WINDOW:
            window = (start, end)
        elif name.startswith("mwx."):
            host.append((start, end, name[4:]))
    if window is None:
        raise RuntimeError("the trace holds no window annotation")
    w0, w1 = window
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in device
               if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in clipped])
    by_name: Dict[str, float] = collections.defaultdict(float)
    launches: Dict[str, int] = collections.Counter()
    for s, e, n in clipped:
        by_name[n] += (e - s) * 1e-9
        launches[n] += 1
    gaps = []
    cursor = w0
    for s, e in busy + [(w1, w1)]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    # label the gaps of 0.1 ms and more (the many shorter ones between
    # eager launches are summed apart)
    long_gaps = [g for g in gaps if g[1] - g[0] >= 100_000]
    labelled = []
    for s, e in long_gaps:
        mid = (s + e) // 2
        cover = [h for h in host if h[0] <= mid <= h[1]]
        label = min(cover, key=lambda h: h[1] - h[0])[2] if cover else "none"
        labelled.append((f"host:{label}", (e - s) * 1e-9))
    idle_by_label: Dict[str, float] = collections.defaultdict(float)
    for label, sec in labelled:
        idle_by_label[label] += sec
    idle_by_label["gaps_under_0.1ms"] = sum(
        e - s for s, e in gaps if e - s < 100_000) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "device_s_by_name": dict(by_name),
            "launches_by_name": dict(launches),
            "idle_by_label": dict(idle_by_label),
            "gaps": sorted(labelled, key=lambda g: -g[1])[:10]}


def kernel_seconds(result: Dict, match) -> Tuple[float, int]:
    """Device seconds and launches of the kernels whose name ``match``
    accepts."""
    secs, n = 0.0, 0
    for name, s in result["device_s_by_name"].items():
        if match(name):
            secs += s
            n += result["launches_by_name"][name]
    return secs, n


def breakdown(result: Dict) -> Dict:
    top = sorted(result["device_s_by_name"].items(), key=lambda kv: -kv[1])
    return {"device_ops": [[n[:160], s] for n, s in top[:10]],
            "idle_gaps": [[label, s] for label, s in result["gaps"]]}
