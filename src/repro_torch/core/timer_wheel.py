"""Hierarchical timer wheel: O(1) timer maintenance for millions of sleeps.

The flat scheduler heap pays O(log n) per insert and keeps every pending
event in one comparison-ordered structure — fine for thousands of events,
wasteful for the paper's regime of *millions* of dormant flows each holding
one far-future wake-up (flows span "seconds to weeks", §2).  This module
replaces the heap's storage with the classic hierarchical timer wheel
[Varghese & Lauck, SOSP '87]:

* **levels of buckets** — level ``l`` buckets are ``tick * span**l`` seconds
  wide; an entry is filed at the coarsest level whose bucket width does not
  swallow its remaining delay, so insertion is O(1) (a dict append) and a
  timer due in three weeks sits untouched in one coarse bucket until the
  wheel's cursor approaches it;
* **cascade on demand** — when the earliest bucket becomes *imminent* its
  entries cascade one level down (or, from level 0, into a small sorted
  heap), amortizing to O(levels) bucket moves per entry over its lifetime;
* **exact ordering** — every entry passes through the imminent heap before
  it is popped, so pops come out in exactly the flat heap's order:
  ``(due time, insertion seq)``.  This is the property the differential
  suite (tests/core/test_timer_wheel.py) checks against a flat-heap
  reference model, and what keeps
  :meth:`repro.core.shard_pool.PoolScheduler.drain`'s deterministic
  VirtualClock merge byte-identical across the swap.

The wheel is deliberately lock-free: :class:`~repro.core.engine.Scheduler`
already serializes access under its condition variable, and standalone users
(benchmarks, the differential tests) are single-threaded.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable


class TimerHandle:
    """One scheduled entry; ``cancel()``-able until it fires.

    ``arg`` lets a million dormant entries share one callback object (a
    cached bound method) instead of holding a million closures: when set,
    :meth:`fire` calls ``fn(arg)``; when ``None``, ``fn()``.
    """

    __slots__ = ("t", "seq", "fn", "arg", "cancelled")

    def __init__(
        self,
        t: float,
        seq: int,
        fn: Callable[..., None],
        arg: Any = None,
    ):
        self.t = t
        self.seq = seq
        self.fn = fn
        self.arg = arg
        self.cancelled = False

    def fire(self) -> None:
        if self.arg is None:
            self.fn()
        else:
            self.fn(self.arg)

    def __lt__(self, other: "TimerHandle") -> bool:
        # heap order == flat-heap order: due time, then insertion sequence
        return (self.t, self.seq) < (other.t, other.seq)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "cancelled" if self.cancelled else "pending"
        return f"TimerHandle(t={self.t}, seq={self.seq}, {state})"


class TimerWheel:
    """Hierarchical timer wheel with flat-heap-identical pop order.

    ``tick`` is the level-0 bucket width; level ``l`` buckets are
    ``tick * span**l`` wide.  ``levels`` bounds the hierarchy — delays past
    the top level's width land in the top level regardless (buckets are a
    dict keyed by absolute index, so there is no wrap-around horizon).

    Deterministic contract (the differential suite's invariants):

    * :meth:`pop` returns entries in ``(t, seq)`` order — time, then
      insertion order, exactly like ``heapq`` over ``(t, seq, fn)``;
    * :meth:`next_deadline` is *exact* (the true earliest pending due time,
      not a bucket lower bound), so a pool merge that compares shards'
      deadlines picks the same winner it would with flat heaps;
    * :meth:`advance_to` only moves the cursor forward; entries scheduled
      in the past fire immediately on the next pop.
    """

    def __init__(
        self,
        now: float = 0.0,
        tick: float = 1.0,
        span: int = 256,
        levels: int = 4,
    ):
        if tick <= 0:
            raise ValueError(f"tick must be > 0, got {tick}")
        if span < 2 or levels < 1:
            raise ValueError("span must be >= 2 and levels >= 1")
        self._now = float(now)
        self._tick = float(tick)
        self._span = span
        self._levels = levels
        #: per-level absolute-bucket-index -> entries (insertion order)
        self._buckets: list[dict[int, list[TimerHandle]]] = [
            {} for _ in range(levels)
        ]
        #: per-level min-heap of bucket indices (lazily pruned)
        self._bucket_heaps: list[list[int]] = [[] for _ in range(levels)]
        #: entries already cascaded to exact order, ready to pop
        self._imminent: list[TimerHandle] = []
        self._seq = 0
        self._live = 0
        #: cascade work performed (entries moved between levels) — the
        #: amortized-O(1) claim benchmarks assert against this counter
        self.cascades = 0

    # ------------------------------------------------------------------ sizing
    def _width(self, level: int) -> float:
        return self._tick * (self._span ** level)

    def _level_for(self, delay: float) -> int:
        """Coarsest level whose bucket width does not swallow ``delay``."""
        level = 0
        while level + 1 < self._levels and delay >= self._width(level + 1):
            level += 1
        return level

    # ------------------------------------------------------------------ insert
    def schedule(
        self, t: float, fn: Callable[..., None], arg: Any = None
    ) -> TimerHandle:
        """File one entry; O(1).  Returns a cancellable handle."""
        self._seq += 1
        handle = TimerHandle(float(t), self._seq, fn, arg)
        self._place(handle, reference=self._now)
        self._live += 1
        return handle

    def _place(self, handle: TimerHandle, reference: float) -> None:
        delay = handle.t - reference
        if delay < self._tick:
            heapq.heappush(self._imminent, handle)
            return
        level = self._level_for(delay)
        index = int(handle.t // self._width(level))
        bucket = self._buckets[level].get(index)
        if bucket is None:
            bucket = self._buckets[level][index] = []
            heapq.heappush(self._bucket_heaps[level], index)
        bucket.append(handle)

    def cancel(self, handle: TimerHandle) -> bool:
        """Mark ``handle`` dead; lazily reaped on cascade/pop.  O(1)."""
        if handle.cancelled:
            return False
        handle.cancelled = True
        self._live -= 1
        return True

    # ------------------------------------------------------------------ peek
    def _earliest_bucket(self) -> tuple[int, int] | None:
        """(level, index) of the bucket with the smallest start time."""
        best: tuple[float, int, int] | None = None
        for level in range(self._levels):
            heap = self._bucket_heaps[level]
            buckets = self._buckets[level]
            while heap and heap[0] not in buckets:
                heapq.heappop(heap)  # stale index from an emptied bucket
            if not heap:
                continue
            start = heap[0] * self._width(level)
            if best is None or start < best[0]:
                best = (start, level, heap[0])
        if best is None:
            return None
        return best[1], best[2]

    def _cascade(self, level: int, index: int) -> None:
        """Refile one bucket's entries a level down (or into the heap).

        Entries in a level-``l`` bucket all lie within one ``width(l)``
        window starting at ``index * width(l)``; refiling them relative to
        that window start lands each at level ``< l`` (or imminent), so the
        cascade always makes progress.
        """
        entries = self._buckets[level].pop(index)
        window_start = index * self._width(level)
        for handle in entries:
            if handle.cancelled:
                continue
            self.cascades += 1
            if level == 0:
                heapq.heappush(self._imminent, handle)
            else:
                self._place(handle, reference=max(window_start, self._now))

    def _settle(self) -> None:
        """Cascade until the imminent heap's top is globally earliest."""
        while True:
            while self._imminent and self._imminent[0].cancelled:
                heapq.heappop(self._imminent)
            earliest = self._earliest_bucket()
            if earliest is None:
                return
            level, index = earliest
            bucket_start = index * self._width(level)
            if self._imminent and self._imminent[0].t < bucket_start:
                return  # nothing in any bucket can precede the heap top
            # ties (top == bucket start) must cascade too: the bucket may
            # hold an equal-time entry with a smaller seq, and the heap is
            # what breaks ties in insertion order
            self._cascade(level, index)

    def next_deadline(self) -> float | None:
        """Exact earliest pending due time (None when empty)."""
        self._settle()
        if not self._imminent:
            return None
        return self._imminent[0].t

    # ------------------------------------------------------------------ pop
    def advance_to(self, t: float) -> None:
        """Move the wheel cursor forward (placement reference only)."""
        if t > self._now:
            self._now = t

    def pop(self, until: float | None = None) -> TimerHandle | None:
        """Pop the earliest entry due at or before ``until`` (None if none)."""
        deadline = self.next_deadline()
        if deadline is None or (until is not None and deadline > until):
            return None
        handle = heapq.heappop(self._imminent)
        self._live -= 1
        # a fired handle is dead: cancel() after the fact must be a no-op
        # (returning False), not a second decrement of the live count
        handle.cancelled = True
        self.advance_to(handle.t)
        return handle

    def __len__(self) -> int:
        return self._live

    def __bool__(self) -> bool:
        return self._live > 0

    # ------------------------------------------------------------------ debug
    def stats(self) -> dict[str, Any]:
        """Occupancy snapshot (benchmarks and tests)."""
        return {
            "live": self._live,
            "imminent": len(self._imminent),
            "buckets": [len(level) for level in self._buckets],
            "cascades": self.cascades,
        }
