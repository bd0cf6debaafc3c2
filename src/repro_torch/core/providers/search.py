"""Search action provider (paper §4.5): "add/delete entries to/from a search
index" — the catalog that production flows publish results into (Table 1's
Publish step; the SSX search catalog of §2.1.1).

Simple inverted-index semantics with subject-keyed entries, optional
visibility principals, and JSON persistence so catalogs survive restarts.
"""

from __future__ import annotations

import json
import os
import threading

from ..actions import FAILED, SUCCEEDED, ActionProvider, _Action
from ..auth import Identity
from ..errors import NotFound


class SearchProvider(ActionProvider):
    title = "Search"
    subtitle = "Ingest/delete catalog entries; query an index"
    url = "ap://search"
    scope_suffix = "search"
    input_schema = {
        "type": "object",
        "properties": {
            "operation": {
                "type": "string",
                "enum": ["ingest", "delete", "query"],
                "default": "ingest",
            },
            "index": {"type": "string"},
            "subject": {"type": "string"},
            "entry": {"type": "object"},
            "visible_to": {"type": "array", "items": {"type": "string"}},
            "q": {"type": "string"},
            "limit": {"type": "integer", "minimum": 1, "default": 10},
        },
        "required": ["index"],
        "additionalProperties": True,
    }
    #: modeled ingest latency (paper Fig 9 shows ~1s floor on Search ops)
    modeled_latency_s = 0.15

    def __init__(self, clock=None, auth=None, persist_dir: str | None = None):
        super().__init__(clock=clock, auth=auth)
        self._indexes: dict[str, dict[str, dict]] = {}
        self._ix_lock = threading.Lock()
        self.persist_dir = persist_dir
        if persist_dir:
            os.makedirs(persist_dir, exist_ok=True)
            for name in os.listdir(persist_dir):
                if name.endswith(".json"):
                    with open(os.path.join(persist_dir, name)) as fh:
                        self._indexes[name[:-5]] = json.load(fh)

    def create_index(self, name: str) -> None:
        with self._ix_lock:
            self._indexes.setdefault(name, {})
        self._persist(name)

    def entries(self, index: str) -> dict[str, dict]:
        with self._ix_lock:
            if index not in self._indexes:
                raise NotFound(f"unknown index {index!r}")
            return dict(self._indexes[index])

    def _persist(self, index: str) -> None:
        if not self.persist_dir:
            return
        with self._ix_lock:
            data = self._indexes.get(index, {})
            path = os.path.join(self.persist_dir, f"{index}.json")
            with open(path, "w") as fh:
                json.dump(data, fh)

    def _start(self, action: _Action, identity: Identity | None) -> None:
        body = action.body
        op = body.get("operation", "ingest")
        index = body["index"]
        with self._ix_lock:
            if index not in self._indexes:
                self._indexes[index] = {}
            ix = self._indexes[index]
        if op == "ingest":
            if "subject" not in body or "entry" not in body:
                self._complete(
                    action, FAILED, details={"error": "ingest needs subject+entry"}
                )
                return
            with self._ix_lock:
                ix[body["subject"]] = {
                    "entry": body["entry"],
                    "visible_to": body.get("visible_to", ["public"]),
                    "ingested_by": identity.username if identity else "anonymous",
                    "ingested_at": self.clock.now(),
                }
            self._persist(index)
            details = {"operation": "ingest", "subject": body["subject"], "index": index}
        elif op == "delete":
            with self._ix_lock:
                existed = ix.pop(body.get("subject", ""), None) is not None
            self._persist(index)
            details = {"operation": "delete", "deleted": existed, "index": index}
        else:  # query
            q = body.get("q", "").lower()
            hits = []
            with self._ix_lock:
                for subject, rec in ix.items():
                    blob = (subject + " " + json.dumps(rec["entry"])).lower()
                    if q in blob:
                        hits.append({"subject": subject, "entry": rec["entry"]})
                    if len(hits) >= body.get("limit", 10):
                        break
            details = {"operation": "query", "count": len(hits), "results": hits}
        action.details = details
        action.completes_at = self.clock.now() + self.modeled_latency_s
        if self.modeled_latency_s <= 0:
            self._complete(action, SUCCEEDED, details=details)
