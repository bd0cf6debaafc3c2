"""User Selection action provider (paper §4.5, Fig 4): "an interactive action
that enables users to provide feedback via a list of options"; the selection
is returned to the flow.  This is the human-in-the-loop state used by the
publication use case (curator approval, §2.1.3 step 5).

The action stays ACTIVE until someone calls :meth:`respond` — or, for
benchmarks/tests, an ``auto_respond`` policy answers after a configured
(clock) delay, modeling curator think-time.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..actions import SUCCEEDED, FAILED, ActionProvider, _Action
from ..auth import Identity
from ..errors import Forbidden, NotFound


@dataclass
class AutoRespond:
    delay_s: float
    choice: str | int = 0  # option index or option string


class UserSelectionProvider(ActionProvider):
    title = "UserSelection"
    subtitle = "Request a human selection from a list of options"
    url = "ap://user_selection"
    scope_suffix = "user_selection"
    input_schema = {
        "type": "object",
        "properties": {
            "prompt": {"type": "string", "default": ""},
            "options": {"type": "array", "items": {"type": "string"}, "minItems": 1},
            "respondents": {"type": "array", "items": {"type": "string"}},
        },
        "required": ["options"],
        "additionalProperties": True,
    }

    def __init__(self, clock=None, auth=None, auto_respond: AutoRespond | None = None):
        super().__init__(clock=clock, auth=auth)
        self.auto_respond = auto_respond

    def pending(self) -> list[str]:
        with self._lock:
            return [a.action_id for a in self._actions.values() if a.status == "ACTIVE"]

    def respond(
        self, action_id: str, selection: str | int, responder: str = "anonymous"
    ) -> None:
        action = self._get(action_id)
        if action.status != "ACTIVE":
            raise NotFound(f"action {action_id} already completed")
        respondents = action.body.get("respondents")
        if respondents and responder not in respondents:
            raise Forbidden(f"{responder} may not respond to {action_id}")
        options = action.body["options"]
        if isinstance(selection, int):
            if not 0 <= selection < len(options):
                raise NotFound(f"option index {selection} out of range")
            choice = options[selection]
        else:
            if selection not in options:
                raise NotFound(f"{selection!r} is not one of the options")
            choice = selection
        self._complete(
            action,
            SUCCEEDED,
            details={"selection": choice, "responder": responder},
        )

    def _start(self, action: _Action, identity: Identity | None) -> None:
        action.display_status = f"awaiting selection: {action.body.get('prompt', '')}"
        if self.auto_respond is not None:
            options = action.body["options"]
            choice = self.auto_respond.choice
            choice_str = options[choice] if isinstance(choice, int) else choice
            action.details = {"selection": choice_str, "responder": "auto"}
            action.completes_at = self.clock.now() + self.auto_respond.delay_s

    def _cancel(self, action: _Action) -> None:
        self._complete(action, FAILED, details={"error": "selection cancelled"})
