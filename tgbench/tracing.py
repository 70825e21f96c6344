"""The traced stretch of a ``--trace 1`` run: a ``torch.profiler`` trace of a
few whole operations inside the window, read from its Chrome-format export.

What the readers of per-layer metrics use:

* device operations (kernels, copies, sets) inside the stretch, each with
  the host time of the call that launched it (paired by correlation id);
* the program's ``tg.*`` ranges (``repro_torch.telemetry.annotate``), which
  record only while the port's telemetry is on;
* unions of intervals, so that busy time never counts an overlap twice.

An H100 trace loses the device records of its first few kernels, so a
trace opens with throwaway launches before the stretch starts.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

import torch

__all__ = ["OP", "STRETCH", "Trace", "open_trace", "union_s"]

STRETCH = "tgbench.stretch"
OP = "tgbench.op"     # one traced operation, inside the stretch
_PAD_LAUNCHES = 1024
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def open_trace():
    """Start a profiler of host and device activity and pad its start."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    for _ in range(_PAD_LAUNCHES):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()
    return prof


def union_s(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals, in the trace's µs,
    returned in seconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def _clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi]


class Trace:
    """The stretch of a stopped profiler, parsed."""

    def __init__(self, events: list):
        stretch = [e for e in events if e.get("name") == STRETCH and e.get("ph") == "X"
                   and e.get("cat") == "user_annotation"]
        if len(stretch) != 1:
            raise RuntimeError(f"the trace holds {len(stretch)} '{STRETCH}' ranges, not 1")
        self.lo = float(stretch[0]["ts"])
        self.hi = self.lo + float(stretch[0]["dur"])
        launch_ts = {}
        for e in events:
            if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args", {}):
                launch_ts[e["args"]["correlation"]] = float(e["ts"])
        # (start, end, name, launch host time or None) of each device operation
        self.device = []
        for e in events:
            if e.get("cat") in _DEVICE_CATS and e.get("ph") == "X":
                s = float(e["ts"])
                end = s + float(e.get("dur", 0.0))
                if end > self.lo and s < self.hi:
                    corr = e.get("args", {}).get("correlation")
                    self.device.append((s, end, e.get("name", ""), launch_ts.get(corr)))
        self.ranges = {}
        for e in events:
            name = e.get("name", "")
            if e.get("cat") == "user_annotation" and name.startswith("tg.") and e.get("ph") == "X":
                s = float(e["ts"])
                if self.lo <= s < self.hi:
                    self.ranges.setdefault(name, []).append((s, s + float(e["dur"])))
        for v in self.ranges.values():
            v.sort()
        self.ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                          if e.get("name") == OP and e.get("ph") == "X"
                          and e.get("cat") == "user_annotation"
                          and self.lo <= float(e["ts"]) < self.hi)
        self._starts = {name: [s for s, _ in v] for name, v in self.ranges.items()}

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.remove(path)
        return cls(events)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def busy_s(self, intervals=None) -> float:
        """Device busy seconds: the union of the device operations inside
        the stretch (or of ``intervals``)."""
        if intervals is None:
            intervals = [(s, e) for s, e, _, _ in self.device]
        return union_s(_clip(intervals, self.lo, self.hi))

    def count(self, name: str) -> int:
        return len(self.ranges.get(name, ()))

    def launched_in(self, name: str) -> list:
        """``(start, end)`` of the device operations whose launch call lies
        inside a ``name`` range."""
        spans, starts = self.ranges.get(name, []), self._starts.get(name, [])
        out = []
        for s, e, _, t in self.device:
            if t is None:
                continue
            j = bisect.bisect_right(starts, t) - 1
            if j >= 0 and t <= spans[j][1]:
                out.append((s, e))
        return out

    def _launched_between(self, lo: float, hi: float) -> list:
        return [(s, e) for s, e, _, t in self.device if t is not None and lo <= t <= hi]

    def complete_ops_s(self, name: str) -> list:
        """For each traced operation whose every ``name`` range launched
        device work that the trace recorded, the device busy seconds of
        what those ranges launched.  An operation with a ``name`` range
        whose launches or device records the trace lost is left out, so a
        share read from these never counts work without its time."""
        out = []
        for lo, hi in self.ops:
            spans = [(a, b) for a, b in self.ranges.get(name, []) if lo <= a <= hi]
            launched = [self._launched_between(a, b) for a, b in spans]
            if spans and all(launched):
                out.append(union_s(iv for part in launched for iv in part))
        return out

    def host_minus_device_s(self, name: str) -> float:
        """Σ over the ``name`` ranges of (the range's wall − the device busy
        time of the operations launched inside it, clipped to it)."""
        total = 0.0
        for lo, hi in self.ranges.get(name, []):
            total += (hi - lo) / 1e6 - union_s(_clip(self._launched_between(lo, hi), lo, hi))
        return total

    def innermost_range(self, t: float) -> str:
        """The innermost ``tg.*`` range open at host time ``t``."""
        best, best_len = "outside tg ranges", None
        for name, spans in self.ranges.items():
            j = bisect.bisect_right(self._starts[name], t) - 1
            if j >= 0 and t <= spans[j][1]:
                length = spans[j][1] - spans[j][0]
                if best_len is None or length < best_len:
                    best, best_len = name, length
        return best

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's
        idle time by the innermost range open on the host through it."""
        by_name = {}
        for s, e, name, _ in self.device:
            s, e = max(s, self.lo), min(e, self.hi)
            by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        edges = sorted({t for v in self.ranges.values() for span in v for t in span})
        gaps, cur = {}, self.lo
        busy = sorted((max(s, self.lo), min(e, self.hi)) for s, e, _, _ in self.device)
        for s, e in busy + [(self.hi, self.hi)]:
            if s > cur:
                cuts = edges[bisect.bisect_right(edges, cur):bisect.bisect_left(edges, s)]
                for a, b in zip([cur, *cuts], [*cuts, s]):
                    key = self.innermost_range((a + b) / 2)
                    gaps[key] = gaps.get(key, 0.0) + (b - a) / 1e6
            cur = max(cur, e)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": [[n, v] for n, v in idle]}
