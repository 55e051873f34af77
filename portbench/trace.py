"""The traced run's readings: the device's timeline from `torch.profiler`
(CUDA activity only, so the trace stays small) and the host's, from a
thread that samples the main thread's stack every millisecond.

Both clocks are the wall clock in nanoseconds: the profiler's events carry
CLOCK_REALTIME stamps (CUPTI's device stamps converted to it), and the
sampler stamps with `time.time_ns()`. From them:

    busy_s      the union of the intervals in which a device operation ran
    window_s    the traced window
    device_ops  operations (kernels, copies, sets) on the device, by name
    dtoh        device-to-host copies: each is a pull the host waited for
    idle_gaps   the device's idle time, by what the host was doing then
                (the innermost frame of the port, else of the harness)
"""

from __future__ import annotations

import bisect
import collections
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Tuple

_PKG = "blaze_tpu_torch"


def _frame_label(frame) -> str:
    """The innermost frame of the port as 'module/file.py:function', else
    the innermost of the harness, else the innermost at all."""
    first = harness = None
    f = frame
    while f is not None:
        path = f.f_code.co_filename
        if first is None:
            first = f
        if f"/{_PKG}/" in path:
            rel = path.split(f"/{_PKG}/", 1)[1]
            return f"{rel}:{f.f_code.co_name}"
        if harness is None and "/portbench/" in path:
            harness = f
        f = f.f_back
    pick = harness or first
    if pick is None:
        return "idle"
    return f"{Path(pick.f_code.co_filename).name}:{pick.f_code.co_name}"


class HostSampler(threading.Thread):
    """Samples the main thread's innermost port frame every `period_s`."""

    def __init__(self, period_s: float = 0.001) -> None:
        super().__init__(name="portbench-sampler", daemon=True)
        self.period_s = period_s
        self.samples: List[Tuple[int, str]] = []
        self._halt = threading.Event()
        self._main = threading.main_thread().ident

    def run(self) -> None:
        while not self._halt.wait(self.period_s):
            frame = sys._current_frames().get(self._main)
            self.samples.append((time.time_ns(), _frame_label(frame)))

    def stop(self) -> None:
        self._halt.set()
        self.join()


@dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    device_ops: int
    dtoh: int
    by_name: Dict[str, float] = field(default_factory=dict)
    idle_gaps: Dict[str, float] = field(default_factory=dict)


def _device_events(prof) -> List[Tuple[int, int, str]]:
    """(start ns, end ns, name) of every operation on the device."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if "CUDA" not in str(e.device_type()):
            continue
        start = int(e.start_ns())
        out.append((start, start + int(e.duration_ns()), e.name()))
    out.sort()
    return out


def reduce(prof, t0_ns: int, t1_ns: int,
           samples: List[Tuple[int, str]]) -> DeviceTrace:
    """The readings of one traced window [t0_ns, t1_ns]."""
    events = [(max(s, t0_ns), min(e, t1_ns), n)
              for s, e, n in _device_events(prof) if e > t0_ns and s < t1_ns]
    by_name: Dict[str, float] = collections.defaultdict(float)
    busy, gaps = 0, []
    cur_s = cur_e = None
    last_end = t0_ns
    for s, e, n in events:
        by_name[n] += (e - s) / 1e9
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
        last_end = max(last_end, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    if t1_ns > last_end:
        gaps.append((last_end, t1_ns))
    return DeviceTrace(
        window_s=(t1_ns - t0_ns) / 1e9, busy_s=busy / 1e9,
        device_ops=len(events),
        dtoh=sum(1 for _, _, n in events if n.startswith("Memcpy DtoH")),
        by_name=dict(by_name), idle_gaps=_attribute(gaps, samples))


def _attribute(gaps, samples) -> Dict[str, float]:
    """Idle seconds by host frame: each gap's time is shared among the
    samples taken inside it, or goes to the last sample before it."""
    out: Dict[str, float] = collections.defaultdict(float)
    if not samples:
        return {}
    stamps = [t for t, _ in samples]
    for a, b in gaps:
        lo = bisect.bisect_left(stamps, a)
        hi = bisect.bisect_right(stamps, b)
        inside = samples[lo:hi]
        if not inside:
            label = samples[max(lo - 1, 0)][1]
            out[label] += (b - a) / 1e9
            continue
        share = (b - a) / 1e9 / len(inside)
        for _, label in inside:
            out[label] += share
    return dict(out)


def top(d: Dict[str, float], k: int = 10) -> List[list]:
    """The k largest entries, each name cut to 96 characters (a kernel's
    name is its whole C++ signature)."""
    return [[name[:96], sec] for name, sec in
            sorted(d.items(), key=lambda kv: -kv[1])[:k]]
