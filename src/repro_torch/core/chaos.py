"""ChaosPlane: one seeded, deterministic fault injector for the whole pool.

The journal's ``fault_hook`` proved the write-ahead rule under crashes, but
it only covered one failure site (the segment flush path) and every other
experiment invented its own ad-hoc monkeypatch.  This module generalizes it
into a single *chaos plane* the supervisor, the providers, and the journals
all consult:

* **provider invoke errors** — ``run(request_id=...)`` raises
  :class:`ChaosError` for a seeded fraction of request ids;
* **provider status errors** — ``status()`` raises for a seeded fraction of
  (request id, poll time) pairs;
* **provider latency spikes** — real-clock sleeps injected ahead of an
  invocation (skipped under a VirtualClock, where wall-stalls are
  meaningless but the draw is still recorded);
* **fsync stalls** — a ``fault_hook`` factory that stalls a shard's journal
  on ``post-flush``;
* **shard kill plans** — ``plan_kill(shard, at)`` schedules a crash or hang
  that a :class:`~repro.core.supervisor.ShardSupervisor` executes.

Determinism contract
--------------------
Every fault decision is a **pure hash** of ``(seed, site, key)`` — *not* a
sequential RNG stream.  Call order differs across shard counts and thread
interleavings, but the key (an action ``request_id``, a poll timestamp)
does not, so the same seeded plane produces the *same fault timeline* at 1,
4, or 8 shards under a VirtualClock, and a failover re-dispatch of an
already-drawn request id deterministically repeats the original outcome —
which is exactly what makes the killed-shard ≡ uninterrupted differential
suite (tests/core/test_failover.py) possible.  Retries draw fresh: the
engine's attempt counter is part of the request id.

The injected-fault ``timeline`` records ``(site, key, effect)`` per
decision; compare ``sorted(plane.timeline)`` across runs to assert two
executions saw identical faults regardless of interleaving.
"""

from __future__ import annotations

import hashlib
import threading
import time as _time
from dataclasses import dataclass, field

from .clock import Clock
from .errors import AutomationError


def hash_uniform(seed: int, *key: object) -> float:
    """Deterministic draw in ``[0, 1)`` keyed on ``(seed, *key)``.

    A pure function of its arguments (SHA-256 over the stringified key), so
    the same logical event draws the same number no matter which thread,
    shard, or process asks — the property every chaos decision and the
    engine's decorrelated retry jitter rely on.
    """
    blob = "\x1f".join(str(part) for part in (seed, *key)).encode("utf-8")
    digest = hashlib.sha256(blob).digest()
    return int.from_bytes(digest[:8], "big") / 2.0**64


class ChaosError(AutomationError):
    """An injected provider fault (retryable like any AutomationError).

    Carries a distinct ``error_name`` so flows under test can target it
    with ``Retry``/``Catch`` ``ErrorEquals: ["ChaosError"]`` — or let
    ``States.ALL`` absorb it like a real outage.
    """

    error_name = "ChaosError"

    def __init__(self, message: str, site: str = "", key: str = ""):
        super().__init__(message)
        self.site = site
        self.key = key


@dataclass
class ChaosRule:
    """Fault mix for one injection site."""

    error_rate: float = 0.0    # fraction of keys that raise ChaosError
    latency_s: float = 0.0     # injected sleep (real clock only)
    latency_rate: float = 0.0  # fraction of keys that sleep
    stall_s: float = 0.0       # post-flush journal stall (real clock only)
    stall_rate: float = 0.0    # fraction of flushes that stall


@dataclass
class KillPlan:
    """One scheduled shard failure for the supervisor to execute."""

    shard_id: int
    at: float
    #: "crash" (reported) | "hang" (heartbeat-detected) | "sigkill"
    #: (real SIGKILL to a worker process — process backend only)
    mode: str = "crash"
    executed: bool = False


@dataclass
class ChaosPlane:
    """Seeded fault injector shared by providers, journals, and supervisor.

    Sites: ``provider.run``, ``provider.status``, ``journal.fsync``.
    Configure each with :meth:`configure`; arm the providers with
    :meth:`arm_providers`; hand the plane to a
    :class:`~repro.core.supervisor.ShardSupervisor` to execute kill plans.
    """

    seed: int = 0
    clock: Clock | None = None
    rules: dict[str, ChaosRule] = field(default_factory=dict)
    kills: list[KillPlan] = field(default_factory=list)
    #: injected-fault ledger: (site, key, effect) per decision, in
    #: injection order.  Compare sorted() across runs for determinism.
    timeline: list[tuple[str, str, str]] = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)

    # ------------------------------------------------------------ configure
    def configure(self, site: str, **rates: float) -> "ChaosPlane":
        """Set the fault mix for a site (returns self for chaining)."""
        self.rules[site] = ChaosRule(**rates)
        return self

    def plan_kill(self, shard_id: int, at: float, mode: str = "crash") -> KillPlan:
        """Schedule a shard failure at absolute clock time ``at``.

        ``mode="crash"``: the supervisor fails the shard immediately at
        ``at`` (the crash-report channel).  ``mode="hang"``: the shard's
        event loop freezes at ``at`` and the failure is only discovered by
        missed heartbeats (the sweep channel).  ``mode="sigkill"``: the
        process backend sends a real ``SIGKILL`` to the worker process
        hosting the shard at fire time — the plan itself stays a pure
        keyed draw (deterministic given the seed), only the delivery is a
        live signal.  Inline (thread) pools treat ``sigkill`` like
        ``crash``: there is no separate process to kill.
        """
        if mode not in ("crash", "hang", "sigkill"):
            raise ValueError(
                f"kill mode must be 'crash', 'hang' or 'sigkill', not {mode!r}"
            )
        plan = KillPlan(shard_id=shard_id, at=at, mode=mode)
        self.kills.append(plan)
        return plan

    def arm_providers(self, registry) -> None:
        """Point every registered provider's ``chaos`` attr at this plane."""
        for url in registry.urls():
            registry.lookup(url).chaos = self

    # ------------------------------------------------------------- draws
    def uniform(self, *key: object) -> float:
        return hash_uniform(self.seed, *key)

    def _record(self, site: str, key: str, effect: str) -> None:
        with self._lock:
            self.timeline.append((site, key, effect))

    def _sleep(self, seconds: float) -> None:
        # wall stalls are meaningless under a VirtualClock (the drain is
        # single-threaded and virtual time only moves between events); the
        # draw is still recorded so the timeline is clock-mode invariant
        if seconds > 0 and (self.clock is None or not self.clock.virtual):
            _time.sleep(seconds)

    # ------------------------------------------------------------ injection
    def invoke(self, site: str, *key: object) -> None:
        """Provider-side injection point; raises :class:`ChaosError` or
        sleeps according to the site's configured rule and the key's draw."""
        rule = self.rules.get(site)
        if rule is None:
            return
        key_str = "|".join(str(part) for part in key)
        if rule.latency_rate > 0 and (
            self.uniform(site, key_str, "latency") < rule.latency_rate
        ):
            self._record(site, key_str, "latency")
            self._sleep(rule.latency_s)
        if rule.error_rate > 0 and (
            self.uniform(site, key_str, "error") < rule.error_rate
        ):
            self._record(site, key_str, "error")
            raise ChaosError(
                f"chaos: injected {site} fault for {key_str}",
                site=site,
                key=key_str,
            )

    def journal_hook(self, shard_id: int, inner=None):
        """A ``Journal(fault_hook=...)`` that stalls ``post-flush`` flushes.

        Chains an existing hook (``inner``) so crash-point hooks and chaos
        stalls compose.  The stall draw keys on the shard plus a per-hook
        flush counter — deterministic given the shard's append sequence.
        """
        site = "journal.fsync"
        counter = {"n": 0}

        def hook(phase: str, batch) -> None:
            if inner is not None:
                inner(phase, batch)
            if phase != "post-flush":
                return
            rule = self.rules.get(site)
            if rule is None or rule.stall_rate <= 0:
                return
            counter["n"] += 1
            key_str = f"shard{shard_id}#{counter['n']}"
            if self.uniform(site, key_str, "stall") < rule.stall_rate:
                self._record(site, key_str, "stall")
                self._sleep(rule.stall_s)

        return hook

    # ------------------------------------------------------------- queries
    def schedule(self) -> list[tuple[str, str, str]]:
        """The injected-fault timeline as a sorted, comparable list."""
        with self._lock:
            return sorted(self.timeline)
