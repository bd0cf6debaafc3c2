"""GenerateDOI action provider (paper §4.5): "obtain a DataCite DOI to assign
to a web-accessible object ... preconfigured with the appropriate namespace";
invocation passes through JSON metadata to associate with the DOI.

Offline DataCite: a per-namespace sequence generator plus a metadata registry
(persisted as JSON when a path is configured) — the publication flows'
persistent-identifier step (§2.1.3 step 6).
"""

from __future__ import annotations

import json
import os
import threading

from ..actions import SUCCEEDED, ActionProvider, _Action
from ..auth import Identity


class DOIProvider(ActionProvider):
    title = "GenerateDOI"
    subtitle = "Mint a persistent identifier with attached metadata"
    url = "ap://doi"
    scope_suffix = "doi"
    input_schema = {
        "type": "object",
        "properties": {
            "url": {"type": "string"},
            "metadata": {"type": "object", "default": {}},
        },
        "required": ["url"],
        "additionalProperties": True,
    }
    modeled_latency_s = 0.4  # DataCite round trip (Fig 9: ~1s class)

    def __init__(
        self,
        clock=None,
        auth=None,
        namespace: str = "10.90000",
        persist_path: str | None = None,
    ):
        super().__init__(clock=clock, auth=auth)
        self.namespace = namespace
        self.persist_path = persist_path
        self._seq = 0
        self._registry: dict[str, dict] = {}
        self._doi_lock = threading.Lock()
        if persist_path and os.path.exists(persist_path):
            with open(persist_path) as fh:
                saved = json.load(fh)
            self._seq = saved.get("seq", 0)
            self._registry = saved.get("registry", {})

    def resolve(self, doi: str) -> dict:
        with self._doi_lock:
            return dict(self._registry.get(doi, {}))

    def _start(self, action: _Action, identity: Identity | None) -> None:
        with self._doi_lock:
            self._seq += 1
            doi = f"{self.namespace}/repro.{self._seq:06d}"
            self._registry[doi] = {
                "url": action.body["url"],
                "metadata": action.body.get("metadata", {}),
                "minted_by": identity.username if identity else "anonymous",
                "minted_at": self.clock.now(),
            }
            if self.persist_path:
                with open(self.persist_path, "w") as fh:
                    json.dump({"seq": self._seq, "registry": self._registry}, fh)
        details = {"doi": doi, "url": action.body["url"]}
        if self.modeled_latency_s > 0:
            action.details = details
            action.completes_at = self.clock.now() + self.modeled_latency_s
        else:
            self._complete(action, SUCCEEDED, details=details)
