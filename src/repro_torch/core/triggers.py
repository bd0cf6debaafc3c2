"""The Triggers service (paper §5.5) on a shared, durable event fabric.

A trigger binds: a **queue** (event source), a **predicate** over message
properties, an **action/flow** to invoke on match, and a **transformation**
building the action input from the message.

Earlier revisions ran one independent poll chain per enabled trigger — N
triggers meant N timer chains and N separate ``QueueService.receive`` calls
per interval, and every trigger lived only in memory.  This module replaces
that with the :class:`EventRouter`, a single shared dispatcher:

* **push-first** — the router registers push subscriptions with
  :class:`~repro.core.queues.QueueService`, so ``send()`` wakes the router
  immediately (a deferred send wakes it at its delivery time) instead of
  waiting out a poll interval;
* **coalesced poll fallback** — everything a receive pass could not hand
  out is covered by one exact-time batched sweep per queue: remaining
  backlog behind a full batch, messages a failed invoker left unacked
  (swept at their visibility deadline), and deferred heads (swept at their
  delivery time).  The paper's adaptive backoff (*"increasing the polling
  interval when no messages are available and decreasing the interval when
  one or more messages are received"*) floors the sweep after an empty
  receive, so spurious wakes cannot busy-loop;
* **one pass per batch** — every predicate subscribed to a queue is
  evaluated in a single pass over each received batch: one ``receive`` call
  serves all of the queue's triggers;
* **durable** — trigger create/enable/disable and per-message ack-progress
  are journaled write-ahead (``trigger_created`` / ``trigger_enabled`` /
  ``trigger_disabled`` / ``trigger_resolved``), so
  :meth:`EventRouter.recover` restores enabled triggers — and skips events
  that already produced an invocation — exactly like run recovery.  The
  journal's group commit batches concurrent trigger records with run
  records in one fsync, and checkpoint compaction collapses a trigger's
  record history into a single image (lifecycle + ack-progress + stats)
  that :func:`~repro.core.journal.replay_triggers` seeds recovery from;
* **at-least-once into the action** — a message is acknowledged only after
  *every* subscribed trigger has resolved it (invoked, discarded, or hit a
  permanent transform error).  If an invoker raises, the message stays
  unacked and the visibility timeout redelivers it; triggers that already
  succeeded are skipped on redelivery via the resolved set.

:class:`TriggerService` remains as a thin, call-compatible facade over a
router for existing callers.
"""

from __future__ import annotations

import ast
import secrets
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

from . import predicate as predlang
from .auth import AuthContext
from .clock import Clock, RealClock
from .engine import Scheduler
from .errors import Forbidden, NotFound, QueueInvariantError
from .journal import Journal, TriggerImage, replay_triggers
from .admission import StrideOrder
from .queues import QueueService


@dataclass
class TriggerConfig:
    queue_id: str
    predicate: str
    action_invoker: Callable[[dict, AuthContext | None], str]
    """Invoked with (action_input, caller) -> run/action id."""
    transform: dict[str, str] = field(default_factory=dict)
    """Output parameter name -> expression over message properties."""
    poll_min_s: float = 0.5
    poll_max_s: float = 30.0
    batch: int = 10
    action_ref: str = ""
    """Durable name for the invoker (e.g. ``flow:<flow_id>``).  Journaled so
    :meth:`EventRouter.recover` can re-bind the callable after a restart."""
    wake_run_key: str | None = None
    """When set, a matching event *wakes a dormant run* instead of invoking
    the action: the run id is read from this key of the transformed input and
    handed to the router's ``run_waker``.  This is the external-event
    rehydration path for passivated runs — a parked run costs a stub until
    its event arrives on the fabric."""


@dataclass
class Trigger:
    trigger_id: str
    config: TriggerConfig
    owner: str = "anonymous"
    enabled: bool = False
    caller: AuthContext | None = None
    interval: float = 1.0
    stats: dict = field(
        default_factory=lambda: {
            "polls": 0,
            "events": 0,
            "matched": 0,
            "discarded": 0,
            "invocations": 0,
            "rate_deferred": 0,
            "errors": 0,
        }
    )
    recent_results: list[Any] = field(default_factory=list)
    #: predicate compiled once (closure tree; no per-event ast walk)
    _compiled: Any = None
    #: transform compiled once; None when any expression fails to compile
    #: (then _handle falls back to per-message transform() so the bad
    #: expression surfaces as a per-event permanent-error disposition,
    #: exactly like before — recovery must not die on a bad transform)
    _transform: Any = None


class _QueueSub:
    """Router-side state for one subscribed queue."""

    def __init__(self, queue_id: str):
        self.queue_id = queue_id
        self.trigger_ids: list[str] = []
        self.sub_id: str | None = None
        #: adaptive sweep interval (reset to min(poll_min) on activity)
        self.interval: float = 1.0
        #: due time of the earliest scheduled dispatch (coalescing token):
        #: a dispatch event only runs if its scheduled time still matches
        self.next_at: float | None = None
        #: per-in-flight-message resolution: message_id -> trigger ids done
        self.resolved: dict[str, set[str]] = {}


#: resolved-map entries kept per queue (in-flight dedup, not a full ledger)
_MAX_RESOLVED = 4096

#: dispatch-log entries kept (determinism checks need a window, not forever)
_DISPATCH_LOG_CAP = 65536


class EventRouter:
    """One shared dispatcher for every trigger (replaces per-trigger polls).

    ``journal_for`` maps a trigger id to the write-ahead journal segment that
    owns it — with an :class:`~repro.core.shard_pool.EngineShardPool` this is
    the owning shard's segment (triggers are hash-owned by shards like runs),
    so per-shard recovery restores each shard's triggers from its own file.
    """

    def __init__(
        self,
        queues: QueueService,
        clock: Clock | None = None,
        scheduler: Scheduler | None = None,
        journal: Journal | None = None,
        journal_for: Callable[[str], Journal] | None = None,
        run_waker: Callable[[str], bool] | None = None,
        admission=None,
    ):
        self.queues = queues
        #: shared FairAdmission (the pool's): per-tenant rate metering for
        #: trigger firings; None = unmetered dispatch (seed behavior)
        self.admission = admission
        #: weighted fair ordering of a sweep's trigger invocations across
        #: tenants (stride scheduling; see repro.core.admission)
        self._stride = StrideOrder()
        #: ``run_waker(run_id) -> bool`` rehydrates a dormant run (e.g.
        #: ``EngineShardPool.wake_run``); required by wake_run_key triggers
        self.run_waker = run_waker
        self.clock = clock or RealClock()
        self.scheduler = scheduler or Scheduler(self.clock)
        self._journal = journal
        self._journal_for = journal_for
        self._triggers: dict[str, Trigger] = {}
        self._subs: dict[str, _QueueSub] = {}
        self._lock = threading.RLock()
        self.stats = {"dispatches": 0, "push_wakes": 0, "sweeps": 0}
        #: dispatch log for determinism checks: (t, trigger_id, message_id,
        #: disposition) per resolution, in dispatch order.  Bounded: once
        #: ``_DISPATCH_LOG_CAP`` is exceeded the oldest half is dropped, so
        #: a long-running service keeps a recent window, not a full ledger.
        self.dispatch_log: list[tuple[float, str, str, str]] = []

    # ------------------------------------------------------------- journal
    def journal_for(self, trigger_id: str) -> Journal | None:
        if self._journal_for is not None:
            return self._journal_for(trigger_id)
        return self._journal

    def _append(self, trigger_id: str, record: dict) -> None:
        journal = self.journal_for(trigger_id)
        if journal is not None:
            journal.append(record)

    # ------------------------------------------------------------- trigger API
    def create_trigger(
        self,
        config: TriggerConfig,
        owner: str = "anonymous",
        trigger_id: str | None = None,
        _journal: bool = True,
    ) -> Trigger:
        trig = Trigger(
            trigger_id=trigger_id or "trig-" + secrets.token_hex(8),
            config=config,
            owner=owner,
            interval=config.poll_min_s,
        )
        try:
            trig._compiled = predlang.compile_expr(config.predicate)
        except predlang.PredicateError as exc:
            try:
                ast.parse(config.predicate, mode="eval")
            except (SyntaxError, TypeError):
                # unparseable predicates fail at create, as always
                raise exc from None
            # parseable but whitelist-violating: the parse-only compiler
            # accepted (and journaled) these, discarding every event at
            # match time — keep that per-event behaviour so recover() of
            # an old journal never dies on one bad trigger
            trig._compiled = config.predicate
        try:
            trig._transform = predlang.compile_transform(config.transform)
        except predlang.PredicateError:
            trig._transform = None  # surface per-message, not at create
        with self._lock:
            if trig.trigger_id in self._triggers:
                raise ValueError(f"duplicate trigger id {trig.trigger_id!r}")
            self._triggers[trig.trigger_id] = trig
            sub = self._sub(config.queue_id)
            sub.trigger_ids.append(trig.trigger_id)
        if _journal:
            self._append(
                trig.trigger_id,
                {
                    "type": "trigger_created",
                    "trigger_id": trig.trigger_id,
                    "queue_id": config.queue_id,
                    "predicate": config.predicate,
                    "transform": dict(config.transform),
                    "action_ref": config.action_ref,
                    "wake_run_key": config.wake_run_key,
                    "owner": owner,
                    "poll_min_s": config.poll_min_s,
                    "poll_max_s": config.poll_max_s,
                    "batch": config.batch,
                    "t": self.clock.now(),
                },
            )
        return trig

    def get(self, trigger_id: str) -> Trigger:
        with self._lock:
            trig = self._triggers.get(trigger_id)
        if trig is None:
            raise NotFound(f"unknown trigger {trigger_id!r}")
        return trig

    def triggers(self) -> list[Trigger]:
        with self._lock:
            return list(self._triggers.values())

    def enable(
        self,
        trigger_id: str,
        caller: AuthContext | None = None,
        _journal: bool = True,
    ) -> None:
        """Enable the trigger with the enabling user's delegated tokens.

        Paper: "the user must provide an access token that includes two
        dependent scopes: the Queues receive-message scope and the scope for
        running the action" — the ``caller`` wallet carries both here.
        """
        trig = self.get(trigger_id)
        # subscribe first: raises NotFound for a missing queue BEFORE the
        # enablement is journaled, so durable state never says "enabled on a
        # queue that was never subscribable"
        self._ensure_subscribed(trig.config.queue_id)
        with self._lock:
            trig.enabled = True
            trig.caller = caller
            trig.interval = trig.config.poll_min_s
            sub = self._sub(trig.config.queue_id)
            sub.interval = trig.config.poll_min_s
        if _journal:
            self._append(
                trigger_id,
                {
                    "type": "trigger_enabled",
                    "trigger_id": trigger_id,
                    "t": self.clock.now(),
                },
            )
        # initial sweep drains any backlog that predates the subscription
        self._schedule(trig.config.queue_id, self.clock.now())

    def disable(self, trigger_id: str, _journal: bool = True) -> None:
        trig = self.get(trigger_id)
        with self._lock:
            trig.enabled = False
        if _journal:
            self._append(
                trigger_id,
                {
                    "type": "trigger_disabled",
                    "trigger_id": trigger_id,
                    "t": self.clock.now(),
                },
            )

    # ------------------------------------------------------------- recovery
    def recover(
        self,
        invoker_for: Callable[[TriggerImage], Callable[[dict, AuthContext | None], str]],
        journals: list[Journal] | None = None,
        enable_filter: Callable[[TriggerImage], bool] | None = None,
    ) -> list[Trigger]:
        """Rebuild triggers from journal records after a restart.

        ``invoker_for(image)`` re-binds the action callable from the durable
        ``action_ref`` (callables cannot be journaled).  Enabled triggers are
        re-enabled — with no caller wallet; re-enable with a caller to restore
        delegated tokens — and their ack-progress (already-resolved message
        ids) seeds the redelivery dedup, so a crash between an invocation and
        its ack does not double-invoke.  Replay is checkpoint-aware: a
        compacted segment yields each trigger's collapsed image (plus the
        post-checkpoint tail) instead of its full record history, with
        identical recovered state.  ``enable_filter(image)`` can veto
        re-enabling (journaled as disabled) — it runs *before* the trigger is
        live, so a vetoed trigger never dispatches, even with worker threads
        racing the recovery loop.  Returns the recovered triggers.
        """
        if journals is None:
            journals = [self._journal] if self._journal is not None else []
        recovered: list[Trigger] = []
        for journal in journals:
            for image in replay_triggers(journal).values():
                if image.queue_id is None:
                    continue
                with self._lock:
                    if image.trigger_id in self._triggers:
                        # a trigger_rehomed record can land this trigger's
                        # image in a second segment: the first image won the
                        # rebuild, but the later one may carry ack-progress
                        # journaled after the split — merge it so a crash
                        # straddling a failover still never double-invokes
                        sub = self._sub(image.queue_id)
                        for mid in image.resolved_message_ids:
                            sub.resolved.setdefault(mid, set()).add(
                                image.trigger_id
                            )
                        continue
                config = TriggerConfig(
                    queue_id=image.queue_id,
                    predicate=image.predicate,
                    action_invoker=invoker_for(image),
                    transform=dict(image.transform),
                    poll_min_s=image.poll_min_s,
                    poll_max_s=image.poll_max_s,
                    batch=image.batch,
                    action_ref=image.action_ref,
                    wake_run_key=image.wake_run_key,
                )
                trig = self.create_trigger(
                    config,
                    owner=image.owner,
                    trigger_id=image.trigger_id,
                    _journal=False,
                )
                if image.stats:
                    trig.stats.update(image.stats)
                with self._lock:
                    sub = self._sub(image.queue_id)
                    for mid in image.resolved_message_ids:
                        sub.resolved.setdefault(mid, set()).add(image.trigger_id)
                if image.enabled:
                    if enable_filter is not None and not enable_filter(image):
                        self.disable(trig.trigger_id)  # vetoed: journal it
                    else:
                        try:
                            self.enable(trig.trigger_id, _journal=False)
                        except NotFound:
                            # the queue vanished: recover the trigger
                            # disabled (journaled, so the next restart
                            # agrees) instead of aborting recovery for
                            # every remaining trigger
                            self.disable(trig.trigger_id)
                recovered.append(trig)
        # the journal has no per-message ack record, so the seeded dedup maps
        # cover the trigger's whole history — prune to messages the queue
        # still holds (only those can ever be redelivered)
        with self._lock:
            subs = list(self._subs.values())
        for sub in subs:
            try:
                live = self.queues.unacked_message_ids(sub.queue_id)
            except NotFound:
                live = set()
            with self._lock:
                for mid in list(sub.resolved):
                    if mid not in live:
                        del sub.resolved[mid]
        return recovered

    # ------------------------------------------------------------- dispatch
    def _sub(self, queue_id: str) -> _QueueSub:
        sub = self._subs.get(queue_id)
        if sub is None:
            sub = self._subs[queue_id] = _QueueSub(queue_id)
        return sub

    def _ensure_subscribed(self, queue_id: str) -> None:
        with self._lock:
            sub = self._sub(queue_id)
            if sub.sub_id is not None:
                return
        # subscribe outside the lock (QueueService may call back); a racing
        # enable() on the same queue rolls its duplicate subscription back
        sub_id = self.queues.subscribe(queue_id, self._on_send)
        with self._lock:
            if sub.sub_id is None:
                sub.sub_id = sub_id
                sub_id = None
        if sub_id is not None:
            self.queues.unsubscribe(queue_id, sub_id)

    @staticmethod
    def _note(trig: Trigger, entry: dict) -> None:
        """Append to recent_results, keeping the window bounded on EVERY
        path — a poisoned message redelivers indefinitely, so error notes
        accumulate just like successes."""
        trig.recent_results.append(entry)
        if len(trig.recent_results) > 100:
            trig.recent_results.pop(0)

    def _disable_all(self, triggers: list[Trigger], error: str) -> None:
        """Disable triggers (journaled) with an error note on each."""
        with self._lock:
            for trig in triggers:
                trig.stats["errors"] += 1
                self._note(trig, {"error": error})
        for trig in triggers:
            if trig.enabled:
                self.disable(trig.trigger_id)

    def _on_send(self, queue_id: str, deliver_at: float) -> None:
        """Push wake-up: dispatch when the message becomes deliverable."""
        self.stats["push_wakes"] += 1
        self._schedule(queue_id, max(deliver_at, self.clock.now()))

    def _schedule(self, queue_id: str, at: float) -> None:
        """Schedule a dispatch, coalescing with any earlier-or-equal one."""
        with self._lock:
            sub = self._sub(queue_id)
            if sub.next_at is not None and sub.next_at <= at:
                return  # an earlier dispatch already covers this wake-up
            sub.next_at = at
        self.scheduler.call_at(at, lambda: self._dispatch(queue_id, at))

    def _dispatch(self, queue_id: str, scheduled_at: float) -> None:
        with self._lock:
            sub = self._subs.get(queue_id)
            if sub is None or sub.next_at != scheduled_at:
                return  # superseded by an earlier dispatch (coalesced)
            sub.next_at = None
            enabled = [
                self._triggers[tid]
                for tid in sub.trigger_ids
                if self._triggers[tid].enabled
            ]
        if not enabled:
            return
        self.stats["dispatches"] += 1
        # per-trigger authorization before the shared receive: the paper
        # requires each enabling user's token to carry the Queues receive
        # scope, so a trigger whose caller lacks the Receiver role must not
        # see message bodies received with another subscriber's wallet
        try:
            authorized = [
                t for t in enabled
                if self.queues.can_receive(queue_id, t.caller)
            ]
        except NotFound:
            self._disable_all(enabled, f"queue {queue_id} no longer exists")
            return
        denied = [t for t in enabled if t not in authorized]
        if denied:
            # mirror the old behaviour where a Forbidden poll killed the
            # trigger's chain — but durably, so recovery agrees
            self._disable_all(
                denied, f"Forbidden: no Receiver role on {queue_id}"
            )
        if not authorized:
            return
        # weighted-fair dispatch order (not FIFO): triggers are served in
        # stride order across their callers' tenants, so one tenant's
        # trigger storm cannot keep every sweep's front slots
        enabled = self._stride.order(authorized, _tenant_key_weight)
        for trig in enabled:
            trig.stats["polls"] += 1
        batch = max(t.config.batch for t in enabled)
        receive_caller = enabled[0].caller
        try:
            messages = self.queues.receive(
                queue_id, max_messages=batch, caller=receive_caller
            )
        except NotFound:
            self._disable_all(enabled, f"queue {queue_id} no longer exists")
            return
        except Forbidden:  # role revoked between the check and the receive
            self._disable_all(
                [enabled[0]], f"Forbidden: no Receiver role on {queue_id}"
            )
            self._schedule(queue_id, self.clock.now())  # retry with the rest
            return
        now = self.clock.now()
        for message in messages:
            self._route(sub, enabled, message, receive_caller)
        # adaptive backoff (paper §5.5): traffic resets the sweep interval,
        # an empty (spurious) receive doubles it toward the cap
        with self._lock:
            if messages:
                sub.interval = min(t.config.poll_min_s for t in enabled)
            else:
                cap = max(t.config.poll_max_s for t in enabled)
                sub.interval = min(sub.interval * 2.0, cap)
            for trig in enabled:
                trig.interval = sub.interval
            interval = sub.interval
        # One exact-time wake covers everything receive() could not hand out
        # this pass: backlog still receivable behind a full batch (wake ==
        # now), messages a failed invoker left unacked (their visibility
        # deadline), a deferred head (its delivery time), and receipts held
        # by a crashed consumer.  After an *empty* receive the backoff
        # interval is the floor, so spurious wakes cannot busy-loop; a
        # productive receive keeps draining immediately.
        try:
            wake = self.queues.next_wake_at(queue_id)
        except NotFound:  # queue deleted mid-dispatch
            return
        if wake is not None:
            floor = now + interval if not messages else now
            self.stats["sweeps"] += 1
            self._schedule(queue_id, max(wake, floor))
        # with no wake the queue is empty: go fully idle — the push
        # subscription fires on the next send

    def _route(
        self,
        sub: _QueueSub,
        enabled: list[Trigger],
        message: dict,
        receive_caller: AuthContext | None,
    ) -> bool:
        """Evaluate every enabled predicate against one message (one pass).

        Returns True when all triggers resolved it (→ ack), False when at
        least one invoker failed (→ leave unacked for redelivery).
        """
        message_id = message["message_id"]
        with self._lock:
            resolved = sub.resolved.setdefault(message_id, set())
        all_resolved = True
        for trig in enabled:
            if trig.trigger_id in resolved:
                continue  # already handled before a redelivery
            disposition = self._handle(trig, message)
            if disposition == "failed":
                all_resolved = False
            else:
                resolved.add(trig.trigger_id)
                tenant_id = (
                    trig.caller.tenant_id
                    if trig.caller is not None
                    and getattr(trig.caller, "tenant", None) is not None
                    else None
                )
                record = {
                    "type": "trigger_resolved",
                    "trigger_id": trig.trigger_id,
                    "message_id": message_id,
                    "disposition": disposition,
                    "t": self.clock.now(),
                    **({"tenant": tenant_id} if tenant_id is not None else {}),
                }
                if disposition != "discarded":
                    # stats snapshots ride the rare records (replay is
                    # last-wins); the bulk "discarded" stream stays slim —
                    # at most the trailing discard counts are lost to a crash
                    record["stats"] = dict(trig.stats)
                self._append(trig.trigger_id, record)
            self.dispatch_log.append(
                (self.clock.now(), trig.trigger_id, message_id, disposition)
            )
            if len(self.dispatch_log) > _DISPATCH_LOG_CAP:
                del self.dispatch_log[: _DISPATCH_LOG_CAP // 2]
        if all_resolved:
            try:
                self.queues.ack(
                    sub.queue_id, message["receipt"], receive_caller
                )
            except (QueueInvariantError, Forbidden):
                # receipt expired (or role revoked) mid-dispatch: the message
                # WILL redeliver, so the resolved set must survive to dedup
                pass
            except NotFound:
                # queue deleted mid-dispatch: nothing left to redeliver
                with self._lock:
                    sub.resolved.pop(message_id, None)
            else:
                with self._lock:
                    sub.resolved.pop(message_id, None)
        elif len(sub.resolved) > _MAX_RESOLVED:
            with self._lock:
                while len(sub.resolved) > _MAX_RESOLVED:
                    sub.resolved.pop(next(iter(sub.resolved)))
        return all_resolved

    def _handle(self, trig: Trigger, message: dict) -> str:
        """Run one trigger against one message; returns the disposition.

        ``"invoked"`` / ``"discarded"`` / ``"error"`` are *resolved* (the
        trigger is done with this message); ``"failed"`` means the action
        invoker raised — the message must stay unacked so the visibility
        timeout redelivers it (at-least-once into the action).
        """
        trig.stats["events"] += 1
        props = message["body"] if isinstance(message["body"], dict) else {
            "body": message["body"]
        }
        if not predlang.matches(trig._compiled, props):
            trig.stats["discarded"] += 1
            return "discarded"
        trig.stats["matched"] += 1
        try:
            if trig._transform is not None:
                action_input = trig._transform(props)
            else:
                action_input = predlang.transform(trig.config.transform, props)
        except predlang.PredicateError as e:
            # permanent: the same message can never transform differently
            trig.stats["errors"] += 1
            self._note(trig, {"error": str(e)})
            return "error"
        if trig.config.wake_run_key is not None:
            # wake-run path: the event carries a dormant run's id; rehydrate
            # it instead of starting anything new.  An unknown or already-
            # resident run resolves as "discarded" — the event is consumed
            # (waking is idempotent; there is nothing to retry into)
            # the transformed input wins; with no transform (or one that
            # drops the key) fall back to the raw message properties
            run_id = action_input.get(trig.config.wake_run_key)
            if run_id is None:
                run_id = props.get(trig.config.wake_run_key)
            if not isinstance(run_id, str) or self.run_waker is None:
                trig.stats["errors"] += 1
                self._note(
                    trig,
                    {"error": f"no run id at key {trig.config.wake_run_key!r}"
                     if self.run_waker is not None else "no run_waker wired"},
                )
                return "error"
            try:
                woke = self.run_waker(run_id)
            except Exception as e:
                trig.stats["errors"] += 1
                self._note(trig, {"error": repr(e)})
                return "failed"
            if not woke:
                trig.stats["discarded"] += 1
                return "discarded"
            trig.stats["invocations"] += 1
            self._note(trig, {"woke_run": run_id, "input": action_input})
            return "invoked"
        tenant = getattr(trig.caller, "tenant", None) if trig.caller else None
        if self.admission is not None and not self.admission.try_rate(tenant):
            # tenant over its admission rate: leave the message unacked so
            # the visibility timeout redelivers it once the bucket refills —
            # rate limiting with retry, not message loss
            trig.stats["rate_deferred"] += 1
            return "failed"
        try:
            run_id = trig.config.action_invoker(action_input, trig.caller)
        except Exception as e:
            # transient: leave the message unacked; the visibility timeout
            # redelivers it and only this trigger retries (at-least-once)
            trig.stats["errors"] += 1
            self._note(trig, {"error": repr(e)})
            return "failed"
        trig.stats["invocations"] += 1
        self._note(trig, {"run_id": run_id, "input": action_input})
        return "invoked"


def _tenant_key_weight(trig: Trigger) -> tuple[str | None, float]:
    """Stride key/weight for a trigger: its caller's tenant (None = shared)."""
    tenant = getattr(trig.caller, "tenant", None) if trig.caller else None
    if tenant is None:
        return None, 1.0
    return tenant.tenant_id, tenant.weight


class TriggerService:
    """Call-compatible facade over a private :class:`EventRouter`.

    Existing callers constructed a ``TriggerService(queues, clock=...,
    scheduler=...)`` per use; they now share one router under the hood and
    gain push delivery, shared batch dispatch, and (when a ``journal`` is
    wired) durable trigger state.
    """

    def __init__(
        self,
        queues: QueueService,
        clock: Clock | None = None,
        scheduler: Scheduler | None = None,
        journal: Journal | None = None,
    ):
        self.queues = queues
        self.clock = clock or RealClock()
        self.scheduler = scheduler or Scheduler(self.clock)
        self.router = EventRouter(
            queues, clock=self.clock, scheduler=self.scheduler, journal=journal
        )

    def create_trigger(
        self,
        config: TriggerConfig,
        owner: str = "anonymous",
        trigger_id: str | None = None,
    ) -> Trigger:
        return self.router.create_trigger(config, owner=owner, trigger_id=trigger_id)

    def get(self, trigger_id: str) -> Trigger:
        return self.router.get(trigger_id)

    def enable(self, trigger_id: str, caller: AuthContext | None = None) -> None:
        self.router.enable(trigger_id, caller=caller)

    def disable(self, trigger_id: str) -> None:
        self.router.disable(trigger_id)

    def recover(
        self,
        invoker_for: Callable[[TriggerImage], Callable[[dict, AuthContext | None], str]],
    ) -> list[Trigger]:
        return self.router.recover(invoker_for)
