"""Shared timers of the probes: each runs its call once to warm it and
once to size the run, then times enough consecutive calls to fill at least
MIN_S (at least MIN_CALLS of them) and returns the mean ms of a call."""

import math
import time

import torch

MIN_S = 0.3
MIN_CALLS = 3


def _calls(fn, clock) -> int:
    fn()
    one = clock(fn, 1)
    return max(MIN_CALLS, math.ceil(MIN_S * 1e3 / max(one, 1e-3)))


def _events(fn, calls: int) -> float:
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def _host(fn, calls: int) -> float:
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    return 1e3 * (time.perf_counter() - t0) / calls


def device_ms(fn) -> float:
    """Mean ms between two CUDA events around consecutive calls (on a
    host without a card, a CPU rehearsal, the host's clock)."""
    clock = _events if torch.cuda.is_available() else _host
    return clock(fn, _calls(fn, clock))


def host_ms(fn) -> float:
    """Mean ms on the host's clock of consecutive calls that each end
    synchronised."""
    return _host(fn, _calls(fn, _host))
