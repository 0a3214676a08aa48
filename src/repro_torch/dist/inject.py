"""Deterministic fault injection for the chaos harness
(``repro.dist.inject``, copied: the port imports nothing of the JAX
package).

The injector is a *seam*: production code calls ``faults.fire("retrieve")``
at each hook point and the call is a no-op unless a schedule armed that
site. Faults are therefore reproducible — the same spec string replays the
same failure sequence run after run, which is what lets the chaos tests
assert *bit-exact* recovery instead of "it didn't crash".

Spec grammar (``NestPipeConfig.fault_inject`` / ``$REPRO_FAULT_INJECT``)::

    site:key=value[,key=value...][;site2:...]

    "retrieve:step=7"                 fail the 8th retrieve call (0-based)
    "commit:step=12,count=2"          fail commit calls 12 and 13
    "h2d:p=0.05,seed=3"               each h2d put fails w.p. 0.05 (seeded)
    "retrieve:step=2;commit:step=3"   independent per-site schedules

Sites are free-form strings; the ones wired today are ``plan``,
``retrieve``, ``commit``, ``h2d``, ``d2h`` (store stage calls + staging
puts, raised as :class:`InjectedFault` and absorbed by the store-boundary
retry), and ``ckpt_torn`` / ``ckpt_corrupt`` (checkpoint writer corruption
modes, consumed via the non-raising :meth:`FaultInjector.should`).

``step=N`` counts *calls to that site* (0-based), not training steps — a
lookahead pipeline retrieves ahead of the step counter, and a per-site
call index is the only clock every hook point shares. ``count=K`` arms
calls ``[N, N+K)``. ``p=x`` arms each call independently with probability
``x`` from a per-site ``random.Random(seed)`` (default seed 0), so
probabilistic chaos is still deterministic.
"""
from __future__ import annotations

import os
import random
import threading
from typing import Dict, Optional

__all__ = [
    "FaultInjector",
    "InjectedFault",
    "NULL_INJECTOR",
    "parse_fault_spec",
    "resolve_fault_inject",
]

_ENV = "REPRO_FAULT_INJECT"


class InjectedFault(RuntimeError):
    """Raised by :meth:`FaultInjector.fire` when a schedule arms the site.

    Subclasses ``RuntimeError`` so the injected failure flows through the
    SAME ``retry_on=(RuntimeError, OSError)`` recovery path a real
    transient (flaky RPC, allocator hiccup) would — the chaos harness
    exercises production code, not a parallel test-only path.
    """


def parse_fault_spec(spec: str) -> Dict[str, Dict[str, float]]:
    """Parse ``"site:k=v,k=v;site2:..."`` into ``{site: {key: value}}``.

    Raises ``ValueError`` on malformed specs (unknown keys, bad numbers,
    duplicate sites) so a typo'd ``$REPRO_FAULT_INJECT`` fails loudly at
    store construction instead of silently injecting nothing.
    """
    out: Dict[str, Dict[str, float]] = {}
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        site, sep, body = part.partition(":")
        site = site.strip()
        if not sep or not site or not body.strip():
            raise ValueError(f"fault spec entry {part!r}: want 'site:k=v,...'")
        if site in out:
            raise ValueError(f"fault spec: duplicate site {site!r}")
        kw: Dict[str, float] = {}
        for item in body.split(","):
            key, sep, val = item.partition("=")
            key = key.strip()
            if not sep or key not in ("step", "count", "p", "seed"):
                raise ValueError(
                    f"fault spec entry {part!r}: bad key {item.strip()!r} "
                    "(want step=N, count=K, p=x, seed=s)")
            try:
                kw[key] = float(val)
            except ValueError:
                raise ValueError(
                    f"fault spec entry {part!r}: non-numeric {item.strip()!r}")
        if "p" in kw and "step" in kw:
            raise ValueError(
                f"fault spec entry {part!r}: step= and p= are exclusive")
        if "p" not in kw and "step" not in kw:
            raise ValueError(
                f"fault spec entry {part!r}: need step=N or p=x")
        if "p" in kw and not (0.0 <= kw["p"] <= 1.0):
            raise ValueError(f"fault spec entry {part!r}: p must be in [0,1]")
        if kw.get("count", 1) < 1:
            raise ValueError(f"fault spec entry {part!r}: count must be >= 1")
        out[site] = kw
    return out


class _SiteSchedule:
    """Per-site arming decision + seeded RNG (probabilistic mode)."""

    def __init__(self, kw: Dict[str, float]):
        self.step = int(kw["step"]) if "step" in kw else None
        self.count = int(kw.get("count", 1))
        self.p = kw.get("p")
        self.rng = random.Random(int(kw.get("seed", 0)))

    def armed(self, call: int) -> bool:
        if self.step is not None:
            return self.step <= call < self.step + self.count
        return self.rng.random() < self.p


class FaultInjector:
    """Seeded, schedule-driven fault seam. Thread-safe; off by default.

    One injector instance is shared by every hook point of one store (and
    its executor/checkpoint paths), so the per-site call counters see the
    global call order. ``fire(site)`` raises :class:`InjectedFault` when
    the site's schedule arms the current call; ``should(site)`` is the
    non-raising variant for hook points that corrupt instead of raise
    (checkpoint torn-write / corrupt-payload).
    """

    def __init__(self, schedule: Optional[Dict[str, Dict[str, float]]] = None):
        self._lock = threading.Lock()
        self._sched = {site: _SiteSchedule(kw)
                       for site, kw in (schedule or {}).items()}
        self._calls: Dict[str, int] = {}
        self._injected: Dict[str, int] = {}

    @classmethod
    def from_spec(cls, spec: Optional[str]) -> "FaultInjector":
        """Build from a spec string; ``None``/empty returns the shared
        no-op :data:`NULL_INJECTOR` (zero overhead on the hot path)."""
        if not spec:
            return NULL_INJECTOR
        return cls(parse_fault_spec(spec))

    @property
    def active(self) -> bool:
        return bool(self._sched)

    def should(self, site: str) -> bool:
        """Advance ``site``'s call counter; True when the schedule arms
        this call. Never raises — for corruption-style hook points."""
        sched = self._sched.get(site)
        if sched is None:
            return False
        with self._lock:
            call = self._calls.get(site, 0)
            self._calls[site] = call + 1
            if sched.armed(call):
                self._injected[site] = self._injected.get(site, 0) + 1
                return True
        return False

    def fire(self, site: str) -> None:
        """Raise :class:`InjectedFault` when the schedule arms this call."""
        if self.should(site):
            raise InjectedFault(
                f"injected fault at site {site!r} "
                f"(call {self._calls[site] - 1})")

    def counters(self) -> Dict[str, float]:
        """``{"faults_injected": total}`` — empty when nothing fired yet
        and the injector is inactive, so the NULL injector adds no keys
        to ``metrics()``."""
        if not self._sched:
            return {}
        with self._lock:
            return {"faults_injected": float(sum(self._injected.values()))}


#: Shared no-op injector: inactive, empty counters, safe to share globally.
NULL_INJECTOR = FaultInjector()


def resolve_fault_inject(value: Optional[str]) -> Optional[str]:
    """Resolve a fault spec with the house config idiom: explicit value >
    ``$REPRO_FAULT_INJECT`` > off. ``"auto"``/``None`` fall through to the
    environment; ``""``/``"off"`` force off even when the env is set."""
    if value is not None and value != "auto":
        return None if value in ("", "off") else value
    env = os.environ.get(_ENV, "")
    return env or None
