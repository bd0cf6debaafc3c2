"""The Timers service (paper §5.6).

A timer invokes an action/flow on a schedule: start time, interval, and
either a count or an end time.  Implementation mirrors the paper: timers live
in a priority queue ordered by next execution time; a dispatcher pops due
timers, posts invocations, computes the next execution, and re-inserts while
not expired.  Timer state is persisted so that "should the service be down at
the time of a scheduled timer, it will recover any missed timers and schedule
the required actions."

A timer can also feed the **event fabric** instead of invoking directly:
``create_timer(..., queue_id=...)`` sends the timer body to a queue on each
firing, where an :class:`~repro.core.triggers.EventRouter` trigger filters
and fans it out — the paper's timer→queue→trigger→flow composition.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

from .auth import AuthContext
from .clock import Clock, RealClock
from .engine import Scheduler
from .errors import NotFound


@dataclass
class Timer:
    timer_id: str
    name: str
    start: float
    interval: float
    body: dict
    count: int | None = None  # number of invocations, or None
    end: float | None = None  # absolute end time, or None
    owner: str = "anonymous"
    active: bool = True
    fired: int = 0
    missed_fired: int = 0
    next_due: float = 0.0
    #: dispatch-chain epoch: every scheduled ``_fire`` carries the epoch it
    #: was scheduled under and no-ops if the timer has moved on.  pause()
    #: and resume() bump it, so a paused timer's still-pending fire event
    #: and a resume's fresh one can never both invoke — the double-fire bug
    #: when resuming after the deadline has already passed
    epoch: int = 0
    last_results: list[Any] = field(default_factory=list)
    #: when set, each firing sends ``body`` to this queue (event fabric)
    #: instead of calling the service invoker directly
    queue_id: str | None = None


class TimerService:
    def __init__(
        self,
        invoker: Callable[[dict, AuthContext | None], str],
        clock: Clock | None = None,
        scheduler: Scheduler | None = None,
        persist_path: str | None = None,
        catch_up_missed: bool = True,
        queues=None,
    ):
        """``invoker(body, caller) -> run id`` starts the timer's flow/action.

        ``queues`` (a :class:`~repro.core.queues.QueueService`) enables the
        fabric path: timers created with ``queue_id=...`` send their body as
        a queue message instead of invoking directly.
        """
        self.invoker = invoker
        self.queues = queues
        self.clock = clock or RealClock()
        self.scheduler = scheduler or Scheduler(self.clock)
        self.persist_path = persist_path
        self.catch_up_missed = catch_up_missed
        self._timers: dict[str, Timer] = {}
        self._callers: dict[str, AuthContext | None] = {}
        self._lock = threading.RLock()
        if persist_path and os.path.exists(persist_path):
            self._load()

    # -- API ---------------------------------------------------------------------
    def create_timer(
        self,
        name: str,
        interval: float,
        body: dict,
        start: float | None = None,
        count: int | None = None,
        end: float | None = None,
        owner: str = "anonymous",
        caller: AuthContext | None = None,
        queue_id: str | None = None,
    ) -> Timer:
        if queue_id is not None and self.queues is None:
            raise ValueError(
                "queue_id requires TimerService(queues=QueueService(...))"
            )
        now = self.clock.now()
        timer = Timer(
            timer_id="timer-" + secrets.token_hex(8),
            name=name,
            start=start if start is not None else now,
            interval=float(interval),
            body=dict(body),
            count=count,
            end=end,
            owner=owner,
            queue_id=queue_id,
        )
        timer.next_due = timer.start
        with self._lock:
            self._timers[timer.timer_id] = timer
            self._callers[timer.timer_id] = caller
        self._persist()
        self._schedule_fire(timer)
        return timer

    def _schedule_fire(self, timer: Timer, at: float | None = None) -> None:
        self.scheduler.call_at(
            at if at is not None else timer.next_due,
            lambda tid=timer.timer_id, e=timer.epoch: self._fire(tid, e),
        )

    def get(self, timer_id: str) -> Timer:
        with self._lock:
            t = self._timers.get(timer_id)
        if t is None:
            raise NotFound(f"unknown timer {timer_id!r}")
        return t

    def pause(self, timer_id: str) -> None:
        timer = self.get(timer_id)
        with self._lock:
            timer.active = False
            timer.epoch += 1  # orphan the pending fire chain
        self._persist()

    def resume(self, timer_id: str, caller: AuthContext | None = None) -> None:
        timer = self.get(timer_id)
        with self._lock:
            timer.active = True
            # new epoch: exactly one live fire chain after a resume, even if
            # a pre-pause event is still sitting in the scheduler (resuming
            # while one was pending used to leave two chains — and two
            # invocations when the deadline had already passed)
            timer.epoch += 1
            if caller is not None:
                self._callers[timer_id] = caller
        self._persist()
        self._schedule_fire(timer, at=max(timer.next_due, self.clock.now()))

    def delete(self, timer_id: str) -> None:
        with self._lock:
            self._timers.pop(timer_id, None)
            self._callers.pop(timer_id, None)
        self._persist()

    def timers(self) -> list[Timer]:
        with self._lock:
            return list(self._timers.values())

    # -- dispatch -------------------------------------------------------------------
    def _expired(self, timer: Timer) -> bool:
        if timer.count is not None and timer.fired >= timer.count:
            return True
        if timer.end is not None and timer.next_due > timer.end:
            return True
        return False

    def _fire(self, timer_id: str, epoch: int = 0) -> None:
        with self._lock:
            timer = self._timers.get(timer_id)
            caller = self._callers.get(timer_id)
        if timer is None or not timer.active or timer.epoch != epoch:
            return  # deleted, paused, or superseded by a newer fire chain
        now = self.clock.now()
        if timer.next_due > now:  # stale wake-up within the live chain
            self._schedule_fire(timer)
            return
        if self._expired(timer):
            timer.active = False
            self._persist()
            return
        try:
            if timer.queue_id is not None:
                # event-fabric path: the firing is a queue message; triggers
                # downstream filter, transform, and invoke
                message_id = self.queues.send(
                    timer.queue_id, dict(timer.body), caller=caller
                )
                timer.last_results.append({"message_id": message_id, "t": now})
            else:
                run_id = self.invoker(dict(timer.body), caller)
                timer.last_results.append({"run_id": run_id, "t": now})
            if len(timer.last_results) > 20:
                timer.last_results.pop(0)
        except Exception as e:
            timer.last_results.append({"error": repr(e), "t": now})
        timer.fired += 1
        timer.next_due = timer.next_due + timer.interval
        # Missed-firing recovery: if the service was down across several
        # intervals, either catch up one-by-one (default) or skip ahead.
        if timer.next_due <= now and not self.catch_up_missed:
            periods = int((now - timer.next_due) // timer.interval) + 1
            timer.missed_fired += periods
            timer.next_due += periods * timer.interval
        if not self._expired(timer):
            self._schedule_fire(timer)
        else:
            timer.active = False
        self._persist()

    # -- persistence -------------------------------------------------------------------
    def _persist(self) -> None:
        if not self.persist_path:
            return
        with self._lock:
            doc = [
                {
                    "timer_id": t.timer_id,
                    "name": t.name,
                    "start": t.start,
                    "interval": t.interval,
                    "body": t.body,
                    "count": t.count,
                    "end": t.end,
                    "owner": t.owner,
                    "active": t.active,
                    "fired": t.fired,
                    "next_due": t.next_due,
                    "queue_id": t.queue_id,
                }
                for t in self._timers.values()
            ]
        tmp = self.persist_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, self.persist_path)

    def _load(self) -> None:
        with open(self.persist_path) as fh:
            doc = json.load(fh)
        if self.queues is None and any(td.get("queue_id") for td in doc):
            raise ValueError(
                "persisted timers use queue_id (event-fabric path); "
                "construct TimerService(queues=QueueService(...)) to restore"
            )
        for td in doc:
            timer = Timer(
                timer_id=td["timer_id"],
                name=td["name"],
                start=td["start"],
                interval=td["interval"],
                body=td["body"],
                count=td["count"],
                end=td["end"],
                owner=td["owner"],
                active=td["active"],
                fired=td["fired"],
                next_due=td["next_due"],
                queue_id=td.get("queue_id"),
            )
            self._timers[timer.timer_id] = timer
            self._callers[timer.timer_id] = None
            if timer.active:
                # recover missed timers (fire immediately if overdue)
                self._schedule_fire(
                    timer, at=max(timer.next_due, self.clock.now())
                )
