"""Transfer action provider (paper §4.5): "list directories, manage
permissions, delete data, transfer data between remote systems."

The data fabric is a set of named **endpoints** — directories with modeled
link characteristics (latency + bandwidth).  Transfers physically copy files
between endpoint roots (so downstream actions see real data: datasets,
checkpoints, analysis products) while the action's *duration* is modeled as
``latency + bytes/bandwidth`` against the engine clock, reproducing the
paper's behaviour where transfer time scales with data size (Table 1's
two-orders-of-magnitude spread).
"""

from __future__ import annotations

import os
import shutil
import threading
from dataclasses import dataclass, field

from ..actions import FAILED, SUCCEEDED, ActionProvider, _Action
from ..auth import Identity
from ..errors import NotFound


@dataclass
class Endpoint:
    name: str
    root: str
    bandwidth_bps: float = 500e6  # ~ the paper's 37 MB/s x >10 links
    latency_s: float = 0.5
    #: simple ACL: usernames allowed to write (empty = anyone)
    writers: set[str] = field(default_factory=set)

    def path(self, rel: str) -> str:
        p = os.path.normpath(os.path.join(self.root, rel.lstrip("/")))
        if not p.startswith(os.path.abspath(self.root)):
            raise NotFound(f"path escapes endpoint {self.name}: {rel}")
        return p


class TransferProvider(ActionProvider):
    title = "Transfer"
    subtitle = "Managed data movement between endpoints"
    url = "ap://transfer"
    scope_suffix = "transfer"
    input_schema = {
        "type": "object",
        "properties": {
            "operation": {
                "type": "string",
                "enum": ["transfer", "ls", "mkdir", "delete", "set_permissions"],
                "default": "transfer",
            },
            "source_endpoint": {"type": "string"},
            "destination_endpoint": {"type": "string"},
            "source_path": {"type": "string"},
            "destination_path": {"type": "string"},
            "endpoint": {"type": "string"},
            "path": {"type": "string"},
            "recursive": {"type": "boolean", "default": True},
            "principals": {"type": "array", "items": {"type": "string"}},
        },
        "additionalProperties": True,
    }

    def __init__(self, clock=None, auth=None, workspace: str | None = None):
        super().__init__(clock=clock, auth=auth)
        self._endpoints: dict[str, Endpoint] = {}
        self._ep_lock = threading.Lock()
        self.workspace = workspace

    # -- endpoint management -------------------------------------------------
    def add_endpoint(self, endpoint: Endpoint) -> Endpoint:
        os.makedirs(endpoint.root, exist_ok=True)
        endpoint.root = os.path.abspath(endpoint.root)
        with self._ep_lock:
            self._endpoints[endpoint.name] = endpoint
        return endpoint

    def create_endpoint(self, name: str, **kw) -> Endpoint:
        root = kw.pop("root", None)
        if root is None:
            if self.workspace is None:
                raise NotFound("no workspace configured for implicit endpoints")
            root = os.path.join(self.workspace, name)
        return self.add_endpoint(Endpoint(name=name, root=root, **kw))

    def endpoint(self, name: str) -> Endpoint:
        with self._ep_lock:
            ep = self._endpoints.get(name)
        if ep is None:
            raise NotFound(f"unknown endpoint {name!r}")
        return ep

    # -- the action ------------------------------------------------------------
    def _start(self, action: _Action, identity: Identity | None) -> None:
        op = action.body.get("operation", "transfer")
        try:
            handler = getattr(self, f"_op_{op}")
            details, duration = handler(action.body, identity)
        except NotFound as e:
            self._complete(action, FAILED, details={"error": str(e)})
            return
        except OSError as e:
            self._complete(action, FAILED, details={"error": f"{type(e).__name__}: {e}"})
            return
        action.details = details
        if duration <= 0:
            self._complete(action, SUCCEEDED, details=details)
        else:
            action.completes_at = self.clock.now() + duration
            action.display_status = f"{op} in progress ({duration:.2f}s modeled)"

    def _op_transfer(self, body: dict, identity):
        src = self.endpoint(body["source_endpoint"])
        dst = self.endpoint(body["destination_endpoint"])
        if dst.writers and (identity is None or identity.username not in dst.writers):
            raise NotFound(f"permission denied writing endpoint {dst.name}")
        sp = src.path(body["source_path"])
        dp = dst.path(body["destination_path"])
        nbytes = 0
        nfiles = 0
        if os.path.isdir(sp):
            for base, _dirs, files in os.walk(sp):
                for f in files:
                    full = os.path.join(base, f)
                    rel = os.path.relpath(full, sp)
                    target = os.path.join(dp, rel)
                    os.makedirs(os.path.dirname(target), exist_ok=True)
                    shutil.copyfile(full, target)
                    nbytes += os.path.getsize(full)
                    nfiles += 1
        elif os.path.isfile(sp):
            os.makedirs(os.path.dirname(dp), exist_ok=True)
            shutil.copyfile(sp, dp)
            nbytes = os.path.getsize(sp)
            nfiles = 1
        else:
            raise NotFound(f"source path not found: {body['source_path']}")
        bandwidth = min(src.bandwidth_bps, dst.bandwidth_bps)
        duration = src.latency_s + dst.latency_s + nbytes / max(bandwidth, 1.0)
        details = {
            "operation": "transfer",
            "files": nfiles,
            "bytes": nbytes,
            "source": f"{src.name}:{body['source_path']}",
            "destination": f"{dst.name}:{body['destination_path']}",
            "effective_bandwidth_bps": bandwidth,
        }
        return details, duration

    def _op_ls(self, body: dict, identity):
        ep = self.endpoint(body["endpoint"])
        p = ep.path(body.get("path", "/"))
        if not os.path.isdir(p):
            raise NotFound(f"not a directory: {body.get('path')}")
        entries = [
            {
                "name": name,
                "type": "dir" if os.path.isdir(os.path.join(p, name)) else "file",
                "size": os.path.getsize(os.path.join(p, name))
                if os.path.isfile(os.path.join(p, name))
                else 0,
            }
            for name in sorted(os.listdir(p))
        ]
        return {"operation": "ls", "path": body.get("path", "/"), "entries": entries}, ep.latency_s

    def _op_mkdir(self, body: dict, identity):
        ep = self.endpoint(body["endpoint"])
        os.makedirs(ep.path(body["path"]), exist_ok=True)
        return {"operation": "mkdir", "path": body["path"]}, ep.latency_s

    def _op_delete(self, body: dict, identity):
        ep = self.endpoint(body["endpoint"])
        p = ep.path(body["path"])
        if os.path.isdir(p):
            shutil.rmtree(p)
        elif os.path.isfile(p):
            os.remove(p)
        else:
            raise NotFound(f"path not found: {body['path']}")
        return {"operation": "delete", "path": body["path"]}, ep.latency_s

    def _op_set_permissions(self, body: dict, identity):
        ep = self.endpoint(body["endpoint"])
        principals = body.get("principals", [])
        ep.writers = {p[5:] for p in principals if p.startswith("user:")}
        return {
            "operation": "set_permissions",
            "endpoint": ep.name,
            "principals": principals,
        }, ep.latency_s
