"""Fault-handling policies for long training runs (``repro.dist.fault``,
copied: the port imports nothing of the JAX package).

- ``PreemptionGuard``: converts SIGTERM/SIGINT-style preemption notices into
  a "checkpoint now" flag the driver polls at step boundaries (no mid-step
  interrupts, so saves are always at a consistent state).
- ``StepWatchdog``: EMA-based straggler detector over per-step times
  (paper §VI operates at 1,500+ accelerators where slow hosts are routine).
  On CUDA the DBP driver feeds it each step's device-timeline span.
- ``retry_step``: bounded-retry wrapper for transient host-side failures
  (input pipeline hiccups, flaky interconnect RPCs). Exponential backoff
  with multiplicative jitter — linear ``backoff_s * attempt`` synchronized
  retry storms across stage workers that all saw the same hiccup.
"""
from __future__ import annotations

import random
import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple


class PreemptionGuard:
    """Latches preemption signals; drivers poll ``should_checkpoint`` at step
    boundaries and save before exiting.

    By default hooks SIGTERM (the usual cluster preemption notice). Pass
    ``signals=()`` to disable signal installation (e.g. in tests or when the
    host framework owns signal handling) and drive it via ``trigger()``.

    The handler CHAINS to the previously-installed handler: a host
    framework (launcher, logger, profiler) that also registered for the
    signal still sees it — the guard observes preemption, it does not own
    the signal.
    """

    def __init__(self, signals: Tuple[int, ...] = (signal.SIGTERM,)):
        self._flag = False
        self._installed: List[Tuple[int, Any]] = []
        self._prev: dict = {}
        for sig in signals:
            try:
                prev = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # non-main thread / exotic platform
                continue
            self._installed.append((sig, prev))
            self._prev[sig] = prev

    def _handler(self, signum, frame):
        self._flag = True
        prev = self._prev.get(signum)
        if callable(prev):  # chain; SIG_DFL/SIG_IGN/None have no callable
            prev(signum, frame)

    def trigger(self) -> None:
        """Manually latch the flag (tests; cooperative preemption APIs)."""
        self._flag = True

    @property
    def should_checkpoint(self) -> bool:
        return self._flag

    def restore(self) -> None:
        """Clear the flag and reinstall the previous signal handlers."""
        self._flag = False
        while self._installed:
            sig, prev = self._installed.pop()
            self._prev.pop(sig, None)
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass


@dataclass
class WatchdogEvent:
    step: int
    step_time_s: float
    ema_s: float


class StepWatchdog:
    """Flags steps slower than ``factor`` x the EMA of recent step times.

    The first ``warmup`` observations only seed the EMA (compile steps).
    Flagged outliers do NOT update the EMA, so one straggler does not mask
    the next.
    """

    def __init__(self, factor: float = 3.0, warmup: int = 3,
                 ema_decay: float = 0.9):
        self.factor = factor
        self.warmup = warmup
        self.ema_decay = ema_decay
        self.ema: Optional[float] = None
        self.events: List[WatchdogEvent] = []
        self._seen = 0

    def observe(self, step: int, step_time_s: float) -> bool:
        """Record one step time; returns True when the step is a straggler."""
        self._seen += 1
        if self.ema is None:
            self.ema = step_time_s
            return False
        if self._seen > self.warmup and step_time_s > self.factor * self.ema:
            self.events.append(WatchdogEvent(step, step_time_s, self.ema))
            return True
        self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * step_time_s
        return False


class RetryExhausted(RuntimeError):
    """Raised (chained from the last failure) when ``retry_step`` gives up.

    A distinct type so callers can tell "transient fault retried past its
    budget" from the underlying failure class — and a ``RuntimeError``
    subclass so existing ``except RuntimeError`` handling still catches it.
    """


def retry_step(fn: Callable, *args, retries: int = 3, backoff_s: float = 0.5,
               max_backoff_s: float = 30.0,
               retry_on: Tuple[type, ...] = (RuntimeError, OSError),
               on_retry: Optional[Callable[[int, BaseException], None]] = None,
               **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying transient failures up to
    ``retries`` times with capped exponential backoff + jitter.

    Attempt ``k`` (1-based) sleeps ``backoff_s * 2**(k-1)`` scaled by a
    uniform jitter in [0.5, 1.5), capped at ``max_backoff_s`` — the jitter
    decorrelates stage workers that all tripped on the same hiccup (a
    linear schedule re-synchronizes the retry storm). ``on_retry(attempt,
    exc)`` fires before each sleep (recovery counters). Exhaustion raises
    :class:`RetryExhausted` chained from the final failure, with the
    attempt count in the message.
    """
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as e:
            attempt += 1
            if attempt > retries:
                raise RetryExhausted(
                    f"{getattr(fn, '__name__', fn)!s} failed after "
                    f"{attempt} attempts: {e}") from e
            if on_retry is not None:
                on_retry(attempt, e)
            if backoff_s:
                delay = min(backoff_s * 2 ** (attempt - 1), max_backoff_s)
                time.sleep(delay * (0.5 + random.random()))
