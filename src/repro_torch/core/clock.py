"""Clock abstraction: real wall-clock time and deterministic virtual time.

The paper's flows span 10^0 to 10^6 seconds.  Reproducing e.g. Figure 8
(overhead of a 1024-second flow) in wall time is wasteful, so the engine is
written against a ``Clock`` interface:

* ``RealClock``   — ``time.time()`` / condition-variable waits; used by the
  concurrency benchmarks (Fig 7) and by real training flows.
* ``VirtualClock`` — discrete-event time.  ``sleep`` is forbidden; instead the
  scheduler advances the clock to the next due event.  This makes the
  long-horizon benchmarks (Fig 8, Table 1, Fig 10) deterministic and fast.
"""

from __future__ import annotations

import threading
import time


class Clock:
    """Interface: ``now()`` plus a wait primitive used by the scheduler."""

    virtual = False

    def now(self) -> float:
        raise NotImplementedError

    def advance_to(self, t: float) -> None:
        """Move virtual time forward to ``t``; a no-op on real clocks.

        Part of the base interface so scheduler drive loops (``Scheduler``,
        ``PoolScheduler``) can call it unconditionally instead of
        duck-typing with ``hasattr`` — real time advances on its own.
        """

    def wait(self, cv: threading.Condition, timeout: float | None) -> None:
        """Wait on ``cv`` for at most ``timeout`` seconds (already locked)."""
        raise NotImplementedError


class RealClock(Clock):
    virtual = False

    def now(self) -> float:
        return time.time()

    def wait(self, cv: threading.Condition, timeout: float | None) -> None:
        cv.wait(timeout)


class VirtualClock(Clock):
    """Deterministic discrete-event clock.

    Time only moves when the scheduler calls :meth:`advance_to`.  Waits with a
    timeout return immediately (the scheduler is expected to re-examine its
    heap and advance time itself); untimed waits behave like real waits so
    that client threads can still block on run completion if needed.
    """

    virtual = True

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def advance_to(self, t: float) -> None:
        with self._lock:
            if t > self._now:
                self._now = t

    def advance(self, dt: float) -> None:
        with self._lock:
            self._now += float(dt)

    def wait(self, cv: threading.Condition, timeout: float | None) -> None:
        if timeout is None:
            cv.wait()
        # Timed waits: no-op.  The virtual-time scheduler advances the clock
        # explicitly instead of blocking.


class MonotonicId:
    """Thread-safe monotonically increasing integer (tiebreak for heaps)."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._n += 1
            return self._n
