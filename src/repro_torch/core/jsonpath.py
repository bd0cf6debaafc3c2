"""JSONPath subset used by flow definitions (paper §4.2.1).

The paper: *"The prefix ``$.`` on these values signals that they should be
treated as JSONPath references into the run Context."*  We implement the
subset that the Flows service actually uses:

* ``$``                  — the whole context
* ``$.a.b``              — dotted member access
* ``$.a[0].b``           — list indexing (non-negative and negative)
* ``$.a["key with.dot"]`` — quoted member access

plus *writes* (used by ``ResultPath``): intermediate objects are created as
needed, mirroring ASL semantics.

Two API tiers share one parser:

* :func:`compile_path` returns a reusable :class:`Selector` — the accessor
  list is parsed **once** and ``get``/``put``/``exists`` run straight off
  it.  ``asl.parse`` pre-compiles every path a flow mentions into selectors
  at publish time, so the engine's per-transition hot path never touches
  the string parser.
* the string functions (:func:`get`, :func:`put`, :func:`exists`) remain
  for external callers as thin wrappers over an LRU-cached
  :func:`compile_path`, so even ad-hoc string use re-parses a given path
  at most once per process.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Any

from .errors import StateMachineError


class JSONPathError(StateMachineError):
    error_name = "States.ParameterPathFailure"


def is_reference(value: Any) -> bool:
    """True if ``value`` is a JSONPath reference string."""
    return isinstance(value, str) and (value == "$" or value.startswith("$.") or value.startswith("$["))


def parse(path: str) -> list[Any]:
    """Parse a JSONPath into a list of accessors (str keys / int indices)."""
    if not isinstance(path, str) or not path.startswith("$"):
        raise JSONPathError(f"not a JSONPath: {path!r}")
    out: list[Any] = []
    i = 1
    n = len(path)
    while i < n:
        c = path[i]
        if c == ".":
            i += 1
            j = i
            while j < n and path[j] not in ".[":
                j += 1
            if j == i:
                raise JSONPathError(f"empty member name in {path!r}")
            out.append(path[i:j])
            i = j
        elif c == "[":
            j = path.find("]", i)
            if j < 0:
                raise JSONPathError(f"unterminated '[' in {path!r}")
            token = path[i + 1 : j].strip()
            if token and token[0] in "'\"":
                if len(token) < 2 or token[-1] != token[0]:
                    raise JSONPathError(f"bad quoted key in {path!r}")
                out.append(token[1:-1])
            else:
                try:
                    out.append(int(token))
                except ValueError:
                    raise JSONPathError(f"bad index {token!r} in {path!r}") from None
            i = j + 1
        else:
            raise JSONPathError(f"unexpected {c!r} at offset {i} in {path!r}")
    return out


_MISSING = ...


class Selector:
    """A compiled JSONPath: parse once, resolve many times.

    Immutable and thread-safe (resolution only reads the accessor tuple),
    so one selector compiled at flow-publish time serves every run of the
    flow concurrently.
    """

    __slots__ = ("path", "accessors")

    def __init__(self, path: str):
        self.path = path
        self.accessors: tuple[Any, ...] = tuple(parse(path))

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Selector({self.path!r})"

    def get(self, doc: Any, default: Any = _MISSING) -> Any:
        """Resolve this path against ``doc``.  Raises unless a default is given."""
        cur = doc
        for acc in self.accessors:
            try:
                if isinstance(acc, int):
                    if not isinstance(cur, list):
                        raise JSONPathError(f"{self.path}: indexing a non-list")
                    cur = cur[acc]
                else:
                    if not isinstance(cur, dict):
                        raise JSONPathError(
                            f"{self.path}: member access on non-object"
                        )
                    cur = cur[acc]
            except (KeyError, IndexError):
                if default is not _MISSING:
                    return default
                raise JSONPathError(
                    f"{self.path}: not present in context"
                ) from None
        return cur

    def exists(self, doc: Any) -> bool:
        return self.get(doc, default=_SENTINEL) is not _SENTINEL

    def put(self, doc: Any, value: Any) -> Any:
        """Write ``value`` at this path; returns the (possibly new) root.

        ``$`` replaces the whole document (ASL ``ResultPath: "$"``
        semantics).  Intermediate dicts are created; lists are extended
        only by one element.
        """
        accs = self.accessors
        if not accs:
            return value
        if not isinstance(doc, dict):
            raise JSONPathError("context root must be an object")
        cur = doc
        for k in range(len(accs) - 1):
            acc = accs[k]
            nxt = accs[k + 1]
            if isinstance(acc, int):
                if not isinstance(cur, list) or not -len(cur) <= acc < len(cur):
                    raise JSONPathError(f"{self.path}: cannot traverse index {acc}")
                if not isinstance(cur[acc], (dict, list)):
                    cur[acc] = {} if isinstance(nxt, str) else []
                cur = cur[acc]
            else:
                if not isinstance(cur, dict):
                    raise JSONPathError(f"{self.path}: member access on non-object")
                if acc not in cur or not isinstance(cur[acc], (dict, list)):
                    cur[acc] = {} if isinstance(nxt, str) else []
                cur = cur[acc]
        last = accs[-1]
        if isinstance(last, int):
            if not isinstance(cur, list):
                raise JSONPathError(f"{self.path}: indexing a non-list")
            if last == len(cur):
                cur.append(value)
            elif -len(cur) <= last < len(cur):
                cur[last] = value
            else:
                raise JSONPathError(f"{self.path}: index {last} out of range")
        else:
            if not isinstance(cur, dict):
                raise JSONPathError(f"{self.path}: member access on non-object")
            cur[last] = value
        return doc


_SENTINEL = object()


@lru_cache(maxsize=4096)
def compile_path(path: str) -> Selector:
    """Compile (and memoize) a JSONPath string into a :class:`Selector`."""
    return Selector(path)


def get(doc: Any, path: str, default: Any = ...) -> Any:
    """Resolve ``path`` against ``doc``.  Raises unless a default is given."""
    return compile_path(path).get(doc, default)


def exists(doc: Any, path: str) -> bool:
    return compile_path(path).exists(doc)


def put(doc: Any, path: str, value: Any) -> Any:
    """Write ``value`` at ``path``; returns the (possibly new) root."""
    return compile_path(path).put(doc, value)
