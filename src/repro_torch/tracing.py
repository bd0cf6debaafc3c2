"""The program's spans and counters, on the host's ``time.perf_counter_ns`` clock.

Off by default, and off costs one flag check a span: ``span()`` returns one
shared object whose methods do nothing (no tensor, no allocation, no profiler
call, no device sync).  ``enable()`` turns recording on; each span then keeps

* its name and id, and its parent: the innermost span open on the same thread;
* its trace id, shared by one unit of work: the root's key (a flow run's id)
  or, for a root opened by ``span()``, the root's own id (a served batch);
* the thread (``threading.get_native_id()``, the id a profiler trace gives
  its events) and ``perf_counter_ns()`` at its start and end;
* its attrs, the counts of what it did.  An attr may be a 0-dim device tensor
  (a sum made on the device): it is read only by ``drain()``, so a counter
  never waits for the device on the hot path.

``begin(name, key)`` and ``end(key)`` make a span that opens on one thread and
closes on another (a flow run, an action); ``inside(key)`` makes such an open
span the parent of what the block opens on this thread.  A span's
``grad_in(x)`` and ``grad_out(y)`` mark the tensors where its work begins and
ends: where autograd records, the backward of that work (run on autograd's
own thread) is then a span of the same name with ``backward=True``, from
y's gradient's arrival to x's gradient's departure.  While a
``torch.profiler`` runs, each span and ``inside`` block is also a
``record_function("repro_torch.<name>")`` range in its trace.

    from repro_torch import tracing
    tracing.enable()
    ...                        # serve, train, run flows
    spans = tracing.drain()    # the closed spans, as dicts; clears them
    tracing.disable()
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

_on = False
_ids = itertools.count(1)
_lock = threading.Lock()
_closed: list = []
_open: dict = {}  # key -> a span begun and not yet ended
_local = threading.local()


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; spans begun and not ended are dropped, closed ones are
    kept for ``drain()``."""
    global _on
    _on = False
    with _lock:
        _open.clear()


def enabled() -> bool:
    return _on


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _thread() -> int:
    """This thread's native id, asked of the system once a thread: the system
    call costs microseconds where system calls are slow."""
    tid = getattr(_local, "tid", None)
    if tid is None:
        tid = _local.tid = threading.get_native_id()
    return tid


def _profiled(name: str):
    """A ``record_function`` range entered, or None where no profiler runs."""
    if not torch.autograd._profiler_enabled():
        return None
    rf = torch.autograd.profiler.record_function(f"repro_torch.{name}")
    rf.__enter__()
    return rf


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass

    def grad_in(self, x):
        return x

    def grad_out(self, y):
        return y


_NOOP = _Noop()


class _Edge(torch.autograd.Function):
    """The identity; its backward begins (at a span's output) or ends (at its
    input) the span's backward."""

    @staticmethod
    def forward(ctx, x, key, name, attrs):
        ctx.key, ctx.name, ctx.attrs = key, name, attrs
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if ctx.name is None:
            end(ctx.key)
        else:
            begin(ctx.name, ctx.key, **ctx.attrs)
        return g, None, None, None


class Span:
    """One span; a context manager where ``span()`` made it."""

    __slots__ = ("name", "id", "parent", "trace", "thread", "start_ns", "end_ns", "attrs",
                 "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.id = next(_ids)
        self.parent = self.trace = self.thread = self._rf = None
        self.start_ns = self.end_ns = 0

    def _start(self, parent, root_trace) -> None:
        self.parent = parent.id if parent is not None else None
        self.trace = parent.trace if parent is not None else root_trace
        self.thread = _thread()
        self.start_ns = time.perf_counter_ns()

    def _finish(self) -> None:
        self.end_ns = time.perf_counter_ns()
        with _lock:
            _closed.append(self)

    def set(self, **attrs) -> None:
        """Counts known only inside the span, recorded at its end."""
        self.attrs.update(attrs)

    def grad_in(self, x):
        """``x``, where the span's work begins; its gradient leaving ends the
        span's backward."""
        if not (x.requires_grad and torch.is_grad_enabled()):
            return x
        return _Edge.apply(x, ("backward", self.id), None, None)

    def grad_out(self, y):
        """``y``, where the span's work ends; its gradient arriving begins the
        span's backward."""
        if not (y.requires_grad and torch.is_grad_enabled()):
            return y
        return _Edge.apply(y, ("backward", self.id), self.name,
                           dict(self.attrs, backward=True))

    def __enter__(self):
        stack = _stack()
        self._rf = _profiled(self.name)
        self._start(stack[-1] if stack else None, self.id)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        self._finish()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
            self._rf = None
        return False


def span(name: str, **attrs):
    """``with span(name, **attrs) as s: ...``; ``s.set(**more)`` inside."""
    if not _on:
        return _NOOP
    return Span(name, attrs)


def begin(name: str, key, under=None, **attrs) -> None:
    """Open a span that ``end(key)`` closes, on any thread.  Its parent is the
    span begun under the key ``under`` where that is open, else none; a root's
    trace id is ``key``."""
    if not _on:
        return
    s = Span(name, attrs)
    with _lock:
        parent = _open.get(under) if under is not None else None
    s._start(parent, key)
    with _lock:
        _open[key] = s


def end(key, **attrs) -> None:
    """Close the span begun under ``key`` (nothing if none is open)."""
    if not _on:
        return
    with _lock:
        s = _open.pop(key, None)
    if s is not None:
        s.attrs.update(attrs)
        s._finish()


class _Inside:
    __slots__ = ("span", "_rf")

    def __init__(self, s: Span):
        self.span, self._rf = s, None

    def __enter__(self):
        self._rf = _profiled(self.span.name)
        _stack().append(self.span)
        return self.span

    def __exit__(self, *exc):
        stack = _stack()
        if stack and stack[-1] is self.span:
            stack.pop()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        return False


def inside(key):
    """``with inside(key): ...``: the span begun under ``key`` is the parent of
    the spans the block opens on this thread."""
    if not _on:
        return _NOOP
    with _lock:
        s = _open.get(key)
    return _NOOP if s is None else _Inside(s)


def _read(tensors: list) -> list:
    """The values of 0-dim tensors (a DTensor whole), one host copy a device."""
    out = [None] * len(tensors)
    by_device: dict = {}
    for i, t in enumerate(tensors):
        t = t.detach()
        if hasattr(t, "full_tensor"):
            t = t.full_tensor()
        by_device.setdefault(t.device, []).append((i, t))
    for items in by_device.values():
        values = torch.stack([t.reshape(()).to(torch.float64) for _, t in items]).tolist()
        for (i, t), v in zip(items, values):
            out[i] = v if t.dtype.is_floating_point else int(v)
    return out


def drain() -> list[dict]:
    """The spans closed since the last drain, as dicts (``name``, ``id``,
    ``parent``, ``trace``, ``thread``, ``start_ns``, ``end_ns``, ``attrs``), in
    the order they closed; device-tensor attrs read as Python numbers."""
    with _lock:
        spans = list(_closed)
        _closed.clear()
    tensors = [(s, k, v) for s in spans for k, v in s.attrs.items()
               if isinstance(v, torch.Tensor)]
    values = _read([v for _, _, v in tensors])
    read = {(id(s), k): v for (s, k, _), v in zip(tensors, values)}
    return [{"name": s.name, "id": s.id, "parent": s.parent, "trace": s.trace,
             "thread": s.thread, "start_ns": s.start_ns, "end_ns": s.end_ns,
             "attrs": {k: read.get((id(s), k), v) for k, v in s.attrs.items()}}
            for s in spans]
