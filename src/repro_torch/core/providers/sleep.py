"""Sleep action provider — the paper's Figure 8 workhorse.

An asynchronous action that completes after ``seconds`` of (clock) time.
Under a VirtualClock, completion is purely event-driven, which lets the
overhead benchmark sweep sleep times of 0..1024 s deterministically.
"""

from __future__ import annotations

from ..actions import ActionProvider, _Action
from ..auth import Identity


class SleepProvider(ActionProvider):
    title = "Sleep"
    subtitle = "Complete after a specified duration"
    url = "ap://sleep"
    scope_suffix = "sleep"
    input_schema = {
        "type": "object",
        "properties": {
            "seconds": {"type": "number", "minimum": 0},
        },
        "required": ["seconds"],
        "additionalProperties": True,
    }

    def __init__(self, clock=None, auth=None, scheduler=None):
        super().__init__(clock=clock, auth=auth)
        if scheduler is not None:
            self.scheduler = scheduler

    def _start(self, action: _Action, identity: Identity | None) -> None:
        seconds = float(action.body["seconds"])
        now = self.clock.now()
        action.details = {"seconds": seconds, "started": now}
        # ALWAYS asynchronous, even for 0-second sleeps: run() returns ACTIVE
        # and completion is only observable at the next status poll.  This is
        # the paper's no-op behaviour — its 2.88 s mean no-op overhead is the
        # 2 s first-poll delay plus queue/processing time (§6.1).
        action.completes_at = now + seconds
        action.display_status = f"sleeping {seconds}s"
