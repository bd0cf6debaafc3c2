"""Weighted-fair admission: per-tenant metering at the service edge.

The paper's hosted services multiplex "millions of users" onto shared
execution capacity, so one tenant's burst must not degrade another tenant's
latency.  This module is the pool's admission layer (ARCHITECTURE scaling
model): run submissions and trigger firings are metered **per tenant**
(:class:`~repro.core.auth.Tenant`) before they reach the shards.

Three composable mechanisms:

* :class:`TokenBucket` — per-tenant rate limiting (``rate_per_s`` refill,
  ``burst`` capacity) at the submission edge;
* :class:`FairAdmission` — a weighted **deficit-round-robin** queue in front
  of the shard pool.  Submissions that cannot be admitted immediately (rate
  exhausted, tenant at ``max_concurrency``, or the pool's global admission
  ``window`` full) are parked per tenant and released in DRR order: each
  visit grants a lane credit proportional to its tenant ``weight``, so a
  backlogged 10x-load tenant gets its share — and only its share — while a
  light tenant's occasional run is admitted almost immediately.  This
  replaces FIFO submission, and composes with the per-run Map admission
  window (invariant 8): a huge Map still counts as *one* admitted run here,
  and its fan-out is separately windowed inside the engine.
* :class:`StrideOrder` — weighted fair *ordering* for contenders served
  inline (the EventRouter's per-sweep trigger list), where queueing is
  already provided by the queue itself.

Everything is clock-driven (``Clock.now()`` only) and schedules its pump
through the pool scheduler, so admission decisions are deterministic under a
VirtualClock (invariant 4) and the release order is reproducible.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import TYPE_CHECKING, Callable

from .auth import Tenant
from .clock import Clock

if TYPE_CHECKING:  # pragma: no cover - annotation-only import
    from .engine import Run

#: mirrors engine.RUN_ACTIVE without importing the (heavy) engine module
_RUN_ACTIVE = "ACTIVE"


class TokenBucket:
    """Classic token bucket: ``rate_per_s`` refill up to ``burst`` capacity."""

    __slots__ = ("rate", "burst", "tokens", "stamp")

    def __init__(self, rate_per_s: float, burst: float | None = None):
        if rate_per_s <= 0:
            raise ValueError(f"rate_per_s must be > 0, got {rate_per_s}")
        self.rate = rate_per_s
        self.burst = burst if burst is not None else max(1.0, rate_per_s)
        self.tokens = self.burst
        self.stamp: float | None = None

    def _refill(self, now: float) -> None:
        if self.stamp is None:
            self.stamp = now
        elif now > self.stamp:
            self.tokens = min(self.burst, self.tokens + (now - self.stamp) * self.rate)
            self.stamp = now

    def try_take(self, now: float, n: float = 1.0) -> bool:
        self._refill(now)
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def next_available(self, now: float, n: float = 1.0) -> float:
        """Earliest time at which ``n`` tokens will be available."""
        self._refill(now)
        if self.tokens >= n:
            return now
        return now + (n - self.tokens) / self.rate


class _Lane:
    """Per-tenant admission state: FIFO backlog + DRR deficit + quotas."""

    __slots__ = ("tenant", "queue", "deficit", "inflight", "bucket")

    def __init__(self, tenant: Tenant):
        self.tenant = tenant
        self.queue: deque = deque()  # (run, release) pairs awaiting admission
        self.deficit = 0.0
        self.inflight = 0  # admitted, not yet terminal
        self.bucket = (
            TokenBucket(tenant.rate_per_s, tenant.burst)
            if tenant.rate_per_s is not None
            else None
        )


class FairAdmission:
    """Weighted deficit-round-robin admission queue for the shard pool.

    ``window`` caps the pool-wide count of admitted-but-unfinished metered
    runs — the backpressure that makes DRR meaningful: while the window is
    full, new submissions park in their tenant's lane and completions pull
    the next release in weighted order.  ``window=None`` disables the global
    cap (per-tenant quotas still apply).
    """

    def __init__(
        self,
        clock: Clock,
        scheduler,
        window: int | None = None,
    ):
        self.clock = clock
        self.scheduler = scheduler
        self.window = window
        self._lock = threading.Lock()
        self._lanes: dict[str, _Lane] = {}
        self._ring: deque[str] = deque()  # backlogged tenant ids, DRR order
        self._inflight_total = 0
        self._pump_queued = False  # a scheduler.submit'd pump is pending
        self._pump_at: float | None = None  # earliest timed pump scheduled
        self.stats = {
            "admitted_direct": 0,
            "queued": 0,
            "released": 0,
            "rate_deferred": 0,
            "cancelled_queued": 0,
        }

    # ------------------------------------------------------------- lanes
    def _lane(self, tenant: Tenant) -> _Lane:
        lane = self._lanes.get(tenant.tenant_id)
        if lane is None or lane.tenant is not tenant:
            keep = self._lanes.get(tenant.tenant_id)
            if keep is not None:
                lane = keep  # same id re-registered: keep live accounting
                lane.tenant = tenant
            else:
                lane = _Lane(tenant)
                self._lanes[tenant.tenant_id] = lane
        return lane

    def backlog(self, tenant_id: str | None = None) -> int:
        """Queued (not yet admitted) submissions, per tenant or total."""
        with self._lock:
            if tenant_id is not None:
                lane = self._lanes.get(tenant_id)
                return len(lane.queue) if lane else 0
            return sum(len(lane.queue) for lane in self._lanes.values())

    # --------------------------------------------------------- admission
    def admit_now(self, tenant: Tenant) -> bool:
        """Fast path: True consumes one admission slot for ``tenant``.

        Only succeeds when the tenant has no backlog and every gate (global
        window, tenant concurrency, tenant rate) passes — otherwise the
        caller must defer the run and :meth:`enqueue` it.
        """
        with self._lock:
            lane = self._lane(tenant)
            if lane.queue:
                return False  # FIFO within the tenant: queue behind backlog
            if self.window is not None and self._inflight_total >= self.window:
                return False
            if (
                tenant.max_concurrency is not None
                and lane.inflight >= tenant.max_concurrency
            ):
                return False
            if lane.bucket is not None and not lane.bucket.try_take(
                self.clock.now()
            ):
                return False
            lane.inflight += 1
            self._inflight_total += 1
            self.stats["admitted_direct"] += 1
            return True

    def credit(self, tenant_id: str) -> None:
        """Return one admission slot for ``tenant_id``.

        The cross-boundary slot-credit path: the process backend's parent
        keeps tenant metering here while runs execute in worker processes,
        so when a worker reports a terminal run over the pipe the parent
        credits the slot by tenant *id* — no Run object crosses the
        boundary.  Equivalent to the callback :meth:`attach` binds inline.
        """
        self._finish(tenant_id)

    def _slot_callback(self, tenant_id: str) -> Callable:
        def credit(_run):
            self.credit(tenant_id)

        # the engine's passivation path recognizes this marker: a parked
        # (dormant) run credits its slot back instead of staying resident
        credit.admission_slot = True
        return credit

    def attach(self, tenant: Tenant, run: "Run") -> None:
        """Bind a directly-admitted run's completion to its admission slot."""
        run.completion_callbacks.append(self._slot_callback(tenant.tenant_id))

    def readopt(self, tenant_id: str, run: "Run") -> None:
        """Re-attach a slot callback WITHOUT consuming a new slot.

        Failover path: a metered run rebuilt from a fenced shard's journal
        image lost its in-memory callbacks, but the slot its original
        admission took is still counted in this lane — re-binding (rather
        than re-admitting) keeps the window accounting exact, and the slot
        credits back when the re-homed run completes.
        """
        run.completion_callbacks.append(self._slot_callback(tenant_id))

    def enqueue(self, tenant: Tenant, run: "Run", release: Callable[[], None]) -> None:
        """Park a deferred run; the DRR pump will ``release()`` it in turn."""
        with self._lock:
            lane = self._lane(tenant)
            lane.queue.append((run, release))
            if tenant.tenant_id not in self._ring:
                self._ring.append(tenant.tenant_id)
            self.stats["queued"] += 1
        self._kick()

    def try_rate(self, tenant: Tenant | None) -> bool:
        """One-shot rate check for inline work (trigger firings).

        Consumes a bucket token when the tenant is rate-limited; unmetered
        tenants always pass.  Callers defer the work themselves (e.g. leave
        the message unacked for redelivery) when this returns False.
        """
        if tenant is None or tenant.rate_per_s is None:
            return True
        with self._lock:
            lane = self._lane(tenant)
            if lane.bucket.try_take(self.clock.now()):
                return True
            self.stats["rate_deferred"] += 1
            return False

    # ------------------------------------------------------------- pump
    def _finish(self, tenant_id: str) -> None:
        with self._lock:
            lane = self._lanes.get(tenant_id)
            if lane is not None and lane.inflight > 0:
                lane.inflight -= 1
            if self._inflight_total > 0:
                self._inflight_total -= 1
            backlog = any(len(ln.queue) for ln in self._lanes.values())
        if backlog:
            self._kick()

    def _kick(self) -> None:
        with self._lock:
            if self._pump_queued:
                return
            self._pump_queued = True
        self.scheduler.submit(self._pump)

    def _kick_at(self, t: float) -> None:
        with self._lock:
            if self._pump_at is not None and self._pump_at <= t:
                return
            self._pump_at = t
        self.scheduler.call_at(t, self._timed_pump)

    def _timed_pump(self) -> None:
        with self._lock:
            self._pump_at = None
        self._pump()

    def _pump(self) -> None:
        """Release parked runs in weighted deficit-round-robin order.

        Each visit to a backlogged lane grants it ``weight`` credit; one
        unit of credit admits one run.  Lanes blocked by their rate bucket
        are skipped (a timed pump is scheduled for the earliest refill);
        lanes blocked only by concurrency wait for a completion to re-kick.
        """
        released: list[Callable[[], None]] = []
        with self._lock:
            self._pump_queued = False
            now = self.clock.now()
            next_rate_at: float | None = None
            stalled_visits = 0
            while self._ring:
                if (
                    self.window is not None
                    and self._inflight_total >= self.window
                ):
                    break  # a completion will re-kick the pump
                if stalled_visits >= len(self._ring):
                    break  # full pass with no admissible lane
                tid = self._ring[0]
                lane = self._lanes[tid]
                if not lane.queue:
                    self._ring.popleft()
                    lane.deficit = 0.0
                    continue
                tenant = lane.tenant
                if (
                    tenant.max_concurrency is not None
                    and lane.inflight >= tenant.max_concurrency
                ):
                    self._ring.rotate(-1)
                    stalled_visits += 1
                    continue
                lane.deficit = min(
                    lane.deficit + tenant.weight, 4.0 * max(tenant.weight, 1.0)
                )
                if lane.deficit < 1.0:
                    # sub-unit weight still accumulating credit: not a
                    # stall — the cap (>= 4) guarantees it reaches 1.0
                    # within a bounded number of visits
                    self._ring.rotate(-1)
                    continue
                served = False
                while (
                    lane.queue
                    and lane.deficit >= 1.0
                    and (
                        self.window is None
                        or self._inflight_total < self.window
                    )
                    and (
                        tenant.max_concurrency is None
                        or lane.inflight < tenant.max_concurrency
                    )
                ):
                    run, release = lane.queue[0]
                    if run.status != _RUN_ACTIVE:
                        lane.queue.popleft()  # cancelled while parked
                        self.stats["cancelled_queued"] += 1
                        continue
                    if lane.bucket is not None and not lane.bucket.try_take(now):
                        avail = lane.bucket.next_available(now)
                        if next_rate_at is None or avail < next_rate_at:
                            next_rate_at = avail
                        break
                    lane.queue.popleft()
                    lane.deficit -= 1.0
                    lane.inflight += 1
                    self._inflight_total += 1
                    self.stats["released"] += 1
                    run.completion_callbacks.append(self._slot_callback(tid))
                    released.append(release)
                    served = True
                self._ring.rotate(-1)
                stalled_visits = 0 if served else stalled_visits + 1
            if next_rate_at is not None:
                rate_at = next_rate_at
            else:
                rate_at = None
        if rate_at is not None:
            self._kick_at(rate_at)
        for release in released:
            release()


class StrideOrder:
    """Weighted fair ordering for repeatedly-contending items.

    Stride scheduling: each key accumulates a virtual "pass" that advances
    by ``1/weight`` every time it is served, and each round serves keys in
    ascending pass order — so over repeated rounds a weight-3 key appears
    first three times as often as a weight-1 key.  Used by the EventRouter
    to order a sweep's trigger invocations across tenants.
    """

    def __init__(self):
        self._pass: dict[str, float] = {}

    def order(self, items: list, key_weight: Callable) -> list:
        """Return ``items`` in weighted-fair order and advance their passes.

        ``key_weight(item)`` returns ``(key, weight)``; ``key=None`` means
        unmetered (weight 1, shared lane).  Ties preserve submission order.
        """
        keyed = []
        for idx, item in enumerate(items):
            key, weight = key_weight(item)
            key = key if key is not None else ""
            weight = weight if weight and weight > 0 else 1.0
            keyed.append((self._pass.get(key, 0.0), idx, item, key, weight))
        keyed.sort(key=lambda kv: (kv[0], kv[1]))
        out = []
        for _pass, _idx, item, key, weight in keyed:
            self._pass[key] = self._pass.get(key, 0.0) + 1.0 / weight
            out.append(item)
        if len(self._pass) > 4096:  # bound the pass table for long uptimes
            floor = min(self._pass.values())
            self._pass = {
                k: v - floor for k, v in self._pass.items() if v - floor < 64.0
            }
        return out
