"""The Queues service (paper §5.4).

Reliable, secure delivery of messages from senders to receivers with:

* **at-least-once** semantics — a received message carries a receipt; only an
  acknowledgement bearing that receipt removes the message; unacknowledged
  messages are redelivered after a visibility timeout;
* **in-order** delivery — messages become receivable in send order;
* **deferred delivery** — a send may specify a delay (SQS-style), which is
  how the paper's action queue implements polling backoff;
* **role-based access** — Administrator / Sender / Receiver roles per queue;
* optional JSONL **persistence** so queues survive restarts — snapshot
  writes ride the same :class:`~repro.core.journal.GroupCommitter` the
  write-ahead journal uses, so concurrent send/receive/ack bursts coalesce
  into one snapshot write instead of one per operation;
* **push subscriptions** — a subscriber callback is notified on every
  ``send`` with the message's delivery time, so event-driven consumers
  (:class:`~repro.core.triggers.EventRouter`) wake immediately instead of
  waiting out a poll interval.  Notifications are best-effort wake-ups, not
  deliveries: consumers still ``receive``/``ack`` for the at-least-once
  guarantee, and notifications are *not* persisted — after a restart the
  subscriber's recovery sweep drains the backlog.
"""

from __future__ import annotations

import json
import os
import secrets
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

from .auth import AuthContext, principal_matches
from .clock import Clock, RealClock
from .errors import Forbidden, NotFound, QueueInvariantError
from .journal import GroupCommitter

DEFAULT_VISIBILITY_TIMEOUT = 30.0


@dataclass
class _Message:
    message_id: str
    body: Any
    attributes: dict
    sent_at: float
    deliver_after: float
    sender: str
    receive_count: int = 0
    # invisible until this time while a receipt is outstanding
    invisible_until: float = 0.0
    receipt: str | None = None
    acked: bool = False


@dataclass
class Queue:
    queue_id: str
    label: str
    admins: list[str] = field(default_factory=list)
    senders: list[str] = field(default_factory=list)
    receivers: list[str] = field(default_factory=list)
    visibility_timeout: float = DEFAULT_VISIBILITY_TIMEOUT
    messages: list[_Message] = field(default_factory=list)
    delivered: int = 0
    lock: threading.RLock = field(default_factory=threading.RLock)


class QueueService:
    """In-process Queues service with SQS-compatible semantics."""

    def __init__(
        self,
        clock: Clock | None = None,
        auth=None,
        persist_path: str | None = None,
    ):
        self.clock = clock or RealClock()
        self.auth = auth
        self._queues: dict[str, Queue] = {}
        self._lock = threading.RLock()
        #: counters get their own lock so hot paths (send/receive/ack) do not
        #: contend on the service lock across unrelated queues
        self._stats_lock = threading.Lock()
        #: per-queue push subscribers: queue_id -> {sub_id: callback}
        self._subscribers: dict[str, dict[str, Callable[[str, float], None]]] = {}
        #: service-wide operation counters (receive-call pressure is what the
        #: event-fanout benchmark compares between polling and push routing)
        self.stats = {
            "sends": 0,
            "receives": 0,
            "empty_receives": 0,
            "messages_delivered": 0,
            "acks": 0,
            "notifies": 0,
        }
        self.persist_path = persist_path
        #: persistence rides the shared group-commit batcher: every mutation
        #: requests a snapshot write, concurrent requests coalesce into one
        #: leader-performed write (each snapshot covers every mutation made
        #: before it was built, so a caller whose ticket is flushed knows its
        #: change is on disk).  Non-poisoning: a failed snapshot write
        #: surfaces to that batch's callers and the next mutation retries
        #: with a fresh full snapshot.
        self._persist_batcher = GroupCommitter(
            lambda batch: self._write_snapshot(), poison_on_error=False
        )
        if persist_path and os.path.exists(persist_path):
            self._load()

    # -- queue management -----------------------------------------------------
    def create_queue(
        self,
        label: str,
        admins: list[str] | None = None,
        senders: list[str] | None = None,
        receivers: list[str] | None = None,
        visibility_timeout: float = DEFAULT_VISIBILITY_TIMEOUT,
        caller: AuthContext | None = None,
    ) -> Queue:
        creator = caller.identity.username if caller else "anonymous"
        q = Queue(
            queue_id="q-" + secrets.token_hex(8),
            label=label,
            admins=admins or [f"user:{creator}"],
            senders=senders or [f"user:{creator}"],
            receivers=receivers or [f"user:{creator}"],
            visibility_timeout=visibility_timeout,
        )
        with self._lock:
            self._queues[q.queue_id] = q
        self._persist()
        return q

    def delete_queue(self, queue_id: str, caller: AuthContext | None = None) -> None:
        q = self._queue(queue_id)
        self._require_role(q, q.admins, caller, "Administrator")
        with self._lock:
            del self._queues[queue_id]
        self._persist()

    def update_queue(
        self, queue_id: str, caller: AuthContext | None = None, **updates
    ) -> Queue:
        q = self._queue(queue_id)
        self._require_role(q, q.admins, caller, "Administrator")
        with q.lock:
            for key in ("label", "admins", "senders", "receivers", "visibility_timeout"):
                if key in updates:
                    setattr(q, key, updates[key])
        self._persist()
        return q

    def queues(self) -> list[Queue]:
        with self._lock:
            return list(self._queues.values())

    # -- messaging ----------------------------------------------------------------
    def send(
        self,
        queue_id: str,
        body: Any,
        attributes: dict | None = None,
        delay: float = 0.0,
        caller: AuthContext | None = None,
    ) -> str:
        q = self._queue(queue_id)
        self._require_role(q, q.senders, caller, "Sender")
        now = self.clock.now()
        msg = _Message(
            message_id="msg-" + secrets.token_hex(8),
            body=body,
            attributes=dict(attributes or {}),
            sent_at=now,
            deliver_after=now + max(0.0, delay),
            sender=caller.identity.username if caller else "anonymous",
        )
        with q.lock:
            q.messages.append(msg)
        self._persist()
        with self._lock:
            subscribers = list(self._subscribers.get(queue_id, {}).values())
        with self._stats_lock:
            self.stats["sends"] += 1
            self.stats["notifies"] += len(subscribers)
        # notify outside all locks: callbacks may call back into the service
        for callback in subscribers:
            callback(queue_id, msg.deliver_after)
        return msg.message_id

    # -- push subscriptions -------------------------------------------------------
    def subscribe(
        self, queue_id: str, callback: Callable[[str, float], None]
    ) -> str:
        """Register ``callback(queue_id, deliver_at)`` to fire on every send.

        The callback is a wake-up signal (push-first delivery): it must not
        assume the message is still present — it should ``receive`` and
        ``ack`` as usual.  Returns a subscription id for :meth:`unsubscribe`.
        """
        self._queue(queue_id)  # raises NotFound for unknown queues
        sub_id = "sub-" + secrets.token_hex(8)
        with self._lock:
            self._subscribers.setdefault(queue_id, {})[sub_id] = callback
        return sub_id

    def unsubscribe(self, queue_id: str, sub_id: str) -> None:
        with self._lock:
            self._subscribers.get(queue_id, {}).pop(sub_id, None)

    def receive(
        self,
        queue_id: str,
        max_messages: int = 1,
        visibility_timeout: float | None = None,
        caller: AuthContext | None = None,
    ) -> list[dict]:
        """Receive up to ``max_messages`` in send order.

        In-order guarantee: a message is only receivable if every earlier
        message has been acknowledged or is currently invisible (i.e. being
        processed) — FIFO-queue semantics.
        """
        q = self._queue(queue_id)
        self._require_role(q, q.receivers, caller, "Receiver")
        now = self.clock.now()
        # `is None`, not falsy: an explicit visibility_timeout=0 means "no
        # invisibility window" (the message is immediately redeliverable),
        # and sub-second overrides must not be coerced to the queue default
        timeout = (
            q.visibility_timeout if visibility_timeout is None
            else visibility_timeout
        )
        out: list[dict] = []
        with q.lock:
            for msg in q.messages:
                if len(out) >= max_messages:
                    break
                if msg.acked:
                    continue
                if msg.deliver_after > now:
                    break  # preserve order: later messages must wait too
                if msg.invisible_until > now:
                    continue  # outstanding receipt; skip but allow next
                msg.receipt = "rcpt-" + secrets.token_hex(8)
                msg.invisible_until = now + timeout
                msg.receive_count += 1
                q.delivered += 1
                out.append(
                    {
                        "message_id": msg.message_id,
                        "receipt": msg.receipt,
                        "body": msg.body,
                        "attributes": msg.attributes,
                        "receive_count": msg.receive_count,
                        "sent_at": msg.sent_at,
                        "deliver_after": msg.deliver_after,
                        # when an unacknowledged receipt expires and the
                        # message becomes redeliverable — consumers that leave
                        # a message unacked schedule their retry at this time
                        "invisible_until": msg.invisible_until,
                    }
                )
        with self._stats_lock:
            self.stats["receives"] += 1
            self.stats["messages_delivered"] += len(out)
            if not out:
                self.stats["empty_receives"] += 1
        if out:
            self._persist()
        return out

    def ack(self, queue_id: str, receipt: str, caller: AuthContext | None = None) -> None:
        q = self._queue(queue_id)
        self._require_role(q, q.receivers, caller, "Receiver")
        now = self.clock.now()
        acked = False
        with q.lock:
            for msg in q.messages:
                if msg.receipt == receipt and not msg.acked:
                    if msg.invisible_until <= now:
                        raise QueueInvariantError(
                            "receipt expired; message may have been redelivered"
                        )
                    msg.acked = True
                    self._gc(q)
                    acked = True
                    break
        if not acked:
            raise QueueInvariantError(
                f"unknown or already-acked receipt {receipt!r}"
            )
        # persist OUTSIDE q.lock: the snapshot batcher may make this caller
        # wait on another thread's leader, and that leader needs q.lock to
        # serialize this queue's messages
        self._persist()
        with self._stats_lock:
            self.stats["acks"] += 1

    def depth(self, queue_id: str) -> int:
        q = self._queue(queue_id)
        with q.lock:
            return sum(1 for m in q.messages if not m.acked)

    def can_receive(self, queue_id: str, caller: AuthContext | None) -> bool:
        """Whether ``caller`` holds the Receiver role (no message consumed).

        Shared consumers (the EventRouter) use this to authorize each
        subscriber before evaluating it against a batch received with
        another subscriber's wallet.
        """
        q = self._queue(queue_id)
        try:
            self._require_role(q, q.receivers, caller, "Receiver")
        except Forbidden:
            return False
        return True

    def unacked_message_ids(self, queue_id: str) -> set[str]:
        """Ids of every message not yet acknowledged (in flight or waiting)."""
        q = self._queue(queue_id)
        with q.lock:
            return {m.message_id for m in q.messages if not m.acked}

    def next_wake_at(self, queue_id: str) -> float | None:
        """Earliest time the next ``receive`` could return a message.

        ``None`` when the queue holds no unacked messages.  Respects the
        in-order guarantee: a deferred message gates everything behind it
        (its delivery time is the wake time), while an invisible message is
        skipped the way ``receive`` skips it (its visibility deadline only
        competes with later messages' own times).  Event-driven consumers
        use this after an empty ``receive`` to schedule exactly one wake-up
        instead of polling blind.
        """
        q = self._queue(queue_id)
        now = self.clock.now()
        best: float | None = None
        with q.lock:
            for m in q.messages:
                if m.acked:
                    continue
                if m.deliver_after > now:
                    # FIFO: later messages must wait for this one anyway
                    t = m.deliver_after
                    return t if best is None else min(best, t)
                if m.invisible_until > now:
                    t = m.invisible_until
                    best = t if best is None else min(best, t)
                    continue
                return now  # receivable immediately
        return best

    # -- internals ---------------------------------------------------------------
    def _gc(self, q: Queue) -> None:
        while q.messages and q.messages[0].acked:
            q.messages.pop(0)

    def _queue(self, queue_id: str) -> Queue:
        with self._lock:
            q = self._queues.get(queue_id)
        if q is None:
            raise NotFound(f"unknown queue {queue_id!r}")
        return q

    def _require_role(
        self, q: Queue, principals: list[str], caller: AuthContext | None, role: str
    ) -> None:
        if self.auth is None:
            return
        identity = caller.identity if caller else None
        if identity is None or not any(
            principal_matches(identity, p) for p in principals
        ):
            who = identity.username if identity else "anonymous"
            raise Forbidden(f"{who} lacks {role} role on queue {q.queue_id}")

    def _persist(self) -> None:
        """Request a durable snapshot (coalesced through the group batcher)."""
        if not self.persist_path:
            return
        self._persist_batcher.append_and_commit(None)

    def _write_snapshot(self) -> None:
        with self._lock:
            queues = list(self._queues.values())
        doc = []
        for q in queues:
            # per-queue lock: ack()'s _gc pops from q.messages concurrently;
            # an unlocked iteration could skip a live message and persist a
            # snapshot missing it.  No caller holds q.lock while waiting on
            # the batcher (see ack), so the ordering is deadlock-free.
            with q.lock:
                messages = [
                    {
                        "message_id": m.message_id,
                        "body": m.body,
                        "attributes": m.attributes,
                        "sent_at": m.sent_at,
                        "deliver_after": m.deliver_after,
                        "sender": m.sender,
                        "receive_count": m.receive_count,
                    }
                    for m in q.messages
                    if not m.acked
                ]
            doc.append(
                {
                    "queue_id": q.queue_id,
                    "label": q.label,
                    "admins": q.admins,
                    "senders": q.senders,
                    "receivers": q.receivers,
                    "visibility_timeout": q.visibility_timeout,
                    "messages": messages,
                }
            )
        tmp = self.persist_path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(doc, fh)
        os.replace(tmp, self.persist_path)

    def _load(self) -> None:
        with open(self.persist_path) as fh:
            doc = json.load(fh)
        for qd in doc:
            q = Queue(
                queue_id=qd["queue_id"],
                label=qd["label"],
                admins=qd["admins"],
                senders=qd["senders"],
                receivers=qd["receivers"],
                visibility_timeout=qd["visibility_timeout"],
            )
            for md in qd["messages"]:
                q.messages.append(
                    _Message(
                        message_id=md["message_id"],
                        body=md["body"],
                        attributes=md["attributes"],
                        sent_at=md["sent_at"],
                        deliver_after=md["deliver_after"],
                        sender=md["sender"],
                        receive_count=md["receive_count"],
                    )
                )
            self._queues[q.queue_id] = q
