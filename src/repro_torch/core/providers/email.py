"""Email action provider (paper §4.5): "send a templated email with specified
sender, receiver(s), subject, and body.  Templates allow values from the flow
run Context to be included in the body."

Offline: messages land in an outbox (in memory + optional mbox-style file);
``${name}`` placeholders in subject/body are substituted from
``template_values``.
"""

from __future__ import annotations

import re
import threading

from ..actions import SUCCEEDED, ActionProvider, _Action
from ..auth import Identity

_PLACEHOLDER = re.compile(r"\$\{([A-Za-z0-9_.]+)\}")


def render(template: str, values: dict) -> str:
    def sub(m: re.Match) -> str:
        key = m.group(1)
        cur = values
        for part in key.split("."):
            if isinstance(cur, dict) and part in cur:
                cur = cur[part]
            else:
                return m.group(0)
        return str(cur)

    return _PLACEHOLDER.sub(sub, template)


class EmailProvider(ActionProvider):
    title = "Email"
    subtitle = "Send a templated notification"
    url = "ap://email"
    scope_suffix = "email"
    input_schema = {
        "type": "object",
        "properties": {
            "sender": {"type": "string"},
            "to": {"type": ["string", "array"]},
            "subject": {"type": "string", "default": ""},
            "body": {"type": "string", "default": ""},
            "template_values": {"type": "object", "default": {}},
        },
        "required": ["to"],
        "additionalProperties": True,
    }
    modeled_latency_s = 0.2

    def __init__(self, clock=None, auth=None, outbox_path: str | None = None):
        super().__init__(clock=clock, auth=auth)
        self.outbox: list[dict] = []
        self.outbox_path = outbox_path
        self._ob_lock = threading.Lock()

    def _start(self, action: _Action, identity: Identity | None) -> None:
        body = action.body
        values = body.get("template_values", {})
        to = body["to"]
        message = {
            "sender": body.get(
                "sender", identity.username if identity else "automation"
            ),
            "to": to if isinstance(to, list) else [to],
            "subject": render(body.get("subject", ""), values),
            "body": render(body.get("body", ""), values),
            "sent_at": self.clock.now(),
        }
        with self._ob_lock:
            self.outbox.append(message)
            if self.outbox_path:
                with open(self.outbox_path, "a") as fh:
                    fh.write(
                        f"From: {message['sender']}\nTo: {','.join(message['to'])}\n"
                        f"Subject: {message['subject']}\n\n{message['body']}\n---\n"
                    )
        details = {"sent": 1, "to": message["to"], "subject": message["subject"]}
        if self.modeled_latency_s > 0:
            action.details = details
            action.completes_at = self.clock.now() + self.modeled_latency_s
        else:
            self._complete(action, SUCCEEDED, details=details)
