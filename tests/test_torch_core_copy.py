"""The port's copy of the control plane (``repro_torch.core``) against its
source (``repro.core``).

``repro.core`` is JAX-free and imports itself only relatively, so the port
keeps it as a copy (it imports nothing of ``repro``).  The copy must not
drift: every module equals its source byte for byte, except three docstring
lines of ``process_backend.py`` that cite the reference's history by pull
request number, which the copy rewords (the port's files cite none), and the
port's spans (``repro_torch.tracing``, imported as ``_tracing``) in
``engine.py`` and ``providers/compute.py``: with those statements taken out,
and each ``with _tracing...:`` block moved back one level, the module equals
its source line for line.  A flow also runs through
the copy end to end, inline and in worker processes whose registry spec names
the port (``repro_torch.core.process_backend:default_registry``).
"""

import re
from pathlib import Path

import pytest

# repro_torch's package init imports torch; without it these are not collected
pytest.importorskip("torch")

from repro_torch.core import ActionRegistry, FlowsService, VirtualClock, asl
from repro_torch.core.backend import make_backend
from repro_torch.core.providers import EchoProvider, SleepProvider

ROOT = Path(__file__).resolve().parents[1]
SRC, COPY = ROOT / "src" / "repro" / "core", ROOT / "src" / "repro_torch" / "core"

# a line of the source that cites a pull request by number; the copy rewords it
CITES_A_PULL_REQUEST = re.compile(r"\bPR \d")
REWORDED = {"process_backend.py": 3}  # such lines, by module
# the copy's tracing statements, by module (the import among them)
TRACED = {"engine.py": 7, "providers/compute.py": 2}
TRACING = re.compile(r"^\s*(with )?_tracing\.|^from \.+ import tracing as _tracing$")


def _modules(root: Path) -> list[str]:
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.py"))


def _without_tracing(lines: list[str]) -> tuple[list[str], int]:
    """(the lines with every tracing statement taken out, each ``with
    _tracing...:`` block moved back one level; the number of statements)."""
    out, statements, blocks, i = [], 0, [], 0
    while i < len(lines):
        line = lines[i]
        indent = len(line) - len(line.lstrip())
        while blocks and line.strip() and indent <= blocks[-1]:
            blocks.pop()
        if TRACING.match(line):
            statements += 1
            depth = line.count("(") - line.count(")")
            while depth > 0:
                i += 1
                depth += lines[i].count("(") - lines[i].count(")")
            if line.lstrip().startswith("with "):
                blocks.append(indent)
            i += 1
            continue
        shift = 4 * len(blocks)
        assert not line[:shift].strip(), line
        out.append(line[shift:])
        i += 1
    return out, statements


def test_copy_has_the_same_modules():
    assert _modules(SRC) == _modules(COPY)
    assert len(_modules(COPY)) > 30


@pytest.mark.parametrize("name", _modules(SRC))
def test_module_equals_its_source(name):
    source, copy = (SRC / name).read_bytes(), (COPY / name).read_bytes()
    if name in TRACED:
        lines, statements = _without_tracing(copy.decode().splitlines())
        assert statements == TRACED[name]
        assert lines == source.decode().splitlines()
        return
    if name not in REWORDED:
        assert copy == source
        return
    src_lines, copy_lines = source.decode().splitlines(), copy.decode().splitlines()
    assert len(copy_lines) == len(src_lines)
    differ = [(a, b) for a, b in zip(src_lines, copy_lines) if a != b]
    assert len(differ) == REWORDED[name]
    for a, b in differ:
        assert CITES_A_PULL_REQUEST.search(a) and not CITES_A_PULL_REQUEST.search(b), (a, b)


def test_taking_tracing_out_restores_the_block_and_nothing_else():
    copy = ["def f(x):", "    _tracing.begin(", "        'a', x,", "    )",
            "    with _tracing.span('b'):", "        y = g(x)", "", "        z = y",
            "    return z  # _tracing. in a comment stays"]
    lines, statements = _without_tracing(copy)
    assert statements == 2
    assert lines == ["def f(x):", "    y = g(x)", "", "    z = y",
                     "    return z  # _tracing. in a comment stays"]
    # a line the copy changed besides is still a difference
    assert _without_tracing(["    with _tracing.span('b'):", "        y = h(x)"])[0] != ["    y = g(x)"]


def test_flow_runs_through_the_copy(tmp_path):
    clock = VirtualClock()
    reg = ActionRegistry()
    reg.register(EchoProvider(clock=clock))
    reg.register(SleepProvider(clock=clock))
    svc = FlowsService(reg, clock=clock, shards=2, journal_path=str(tmp_path / "j.jsonl"))
    rec = svc.publish_flow({"StartAt": "E", "States": {"E": {
        "Type": "Action", "ActionUrl": "ap://echo", "Parameters": {"echo_string": "hi"},
        "ResultPath": "$.r", "End": True}}})
    run = svc.run_flow(rec.flow_id, {})
    svc.engine.run_to_completion(run.run_id)
    assert run.status == "SUCCEEDED"
    assert run.context["r"]["details"]["echo_string"] == "hi"
    svc.engine.shutdown()


def test_process_backend_resolves_the_ports_registry_spec(tmp_path):
    backend = make_backend("process", None, num_shards=2, journal_path=str(tmp_path / "j.jsonl"),
                           options={"registry_spec":
                                    "repro_torch.core.process_backend:default_registry",
                                    "num_workers": 1})
    try:
        flow = asl.parse({"StartAt": "E", "States": {"E": {
            "Type": "Action", "ActionUrl": "ap://echo", "Parameters": {"echo_string.$": "$.msg"},
            "ResultPath": "$.r", "End": True}}})
        handle = backend.start_run(flow, {"msg": "hi"}, flow_id="echo")
        assert backend.wait(handle.run_id, timeout=120).status == "SUCCEEDED"
    finally:
        backend.shutdown()
