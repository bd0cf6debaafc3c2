"""Echo action provider — "returns its input string, primarily used for
testing and demonstration" (paper §4.5).  Synchronous: run() returns a
completed status immediately."""

from __future__ import annotations

from ..actions import SUCCEEDED, ActionProvider, _Action
from ..auth import Identity


class EchoProvider(ActionProvider):
    title = "Echo"
    subtitle = "Return the input (testing and demonstration)"
    url = "ap://echo"
    scope_suffix = "echo"
    synchronous = True
    input_schema = {
        "type": "object",
        "properties": {
            "echo_string": {"type": ["string", "number", "boolean", "object", "array", "null"]},
        },
        "additionalProperties": True,
    }

    def _start(self, action: _Action, identity: Identity | None) -> None:
        self._complete(action, SUCCEEDED, details=dict(action.body))
