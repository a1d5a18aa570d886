"""The traced run's reduction of a `torch.profiler` trace (CPU and CUDA
activities) to the device's busy time, the traced span and a breakdown.

  busy_s     the union of the device's activity intervals (kernels, copies,
             sets) inside the traced span
  window_s   the traced span: first to last event of either side
  device_ops the device operations that took most time, summed by name
  idle_gaps  the device's idle time inside the span, summed by what the
             host was doing at each gap's midpoint (its innermost recorded
             operation), longest first
"""

from __future__ import annotations

import time

import numpy as np
import torch

TOP = 10
GAPS_LABELLED = 5000


class Trace:
    def __init__(self):
        self._prof = None
        self.host_s = 0.0

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self._t0
        self._prof.stop()
        return False

    def reduce(self) -> dict:
        dev, host = [], []
        for e in self._prof.events():
            tr = e.time_range
            if tr.end <= tr.start:
                continue
            if e.device_type == torch.autograd.DeviceType.CUDA:
                dev.append((tr.start, tr.end, e.name))
            else:
                host.append((tr.start, tr.end, e.name))
        if not dev:
            return {"busy_s": 0.0, "window_s": self.host_s,
                    "device_ops": [], "idle_gaps": []}
        starts = [s for s, _, _ in dev + host]
        ends = [t for _, t, _ in dev + host]
        span0, span1 = min(starts), max(ends)
        iv = sorted((s, t) for s, t, _ in dev)
        busy, gaps = 0.0, []
        cur_s, cur_t = iv[0]
        if cur_s > span0:
            gaps.append((span0, cur_s))
        for s, t in iv[1:]:
            if s > cur_t:
                busy += cur_t - cur_s
                gaps.append((cur_t, s))
                cur_s, cur_t = s, t
            else:
                cur_t = max(cur_t, t)
        busy += cur_t - cur_s
        if span1 > cur_t:
            gaps.append((cur_t, span1))
        ops: dict = {}
        for s, t, name in dev:
            ops[name] = ops.get(name, 0.0) + (t - s) * 1e-6
        return {"busy_s": busy * 1e-6, "window_s": (span1 - span0) * 1e-6,
                "device_ops": _top(ops),
                "idle_gaps": _top(_label_gaps(gaps, host))}


def _top(d: dict) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]


def _label_gaps(gaps: list, host: list) -> dict:
    """Idle seconds by the host's innermost operation at each gap's middle
    (the GAPS_LABELLED longest gaps by name; the rest as one entry)."""
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])
    hs = np.array([h[0] for h in host], dtype=np.float64)
    he = np.array([h[1] for h in host], dtype=np.float64)
    names = [h[2] for h in host]
    out: dict = {}
    for k, (a, b) in enumerate(gaps):
        if k < GAPS_LABELLED and len(hs):
            mid = 0.5 * (a + b)
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            name = (names[cover[np.argmin(he[cover] - hs[cover])]]
                    if len(cover) else "host: no operation recorded")
        else:
            name = "shorter gaps"
        out[name] = out.get(name, 0.0) + (b - a) * 1e-6
    return out
