"""Analysis of a traced step's graph of local ops: counterpart of
``repro/launch/hlo.py``.

The port has no HLO.  What the reference reads from a compiled module's
text, this reads from the ``torch.fx.Graph`` that
:func:`repro_torch.launch.dryrun.lower` records: every op that one rank runs
on its local shards (after DTensor has turned each global op into local ops
and ``_c10d_functional`` collectives), in the order it runs, each node's
``meta["val"]`` the fake tensor(s) it returned.  So every count here is per
device, as the reference's post-SPMD counts are.

* :func:`analyze_collectives`: per collective, its count and operand and
  result bytes, and the wire bytes of the standard ring algorithms (an
  all-reduce moves ~2x its operand, every other collective the larger of its
  operand and result), in the reference's schema and under its op names.
  An op that runs collectives inside it (the sLSTM's loop, which gathers
  among a head's ranks every step) adds those its registered formula
  counts (``sharding.register_collective_formula``): its fake
  implementation, which the trace runs, runs none.  Every collective that
  runs counts, a loop's once a trip, where the reference's HLO analysis
  counts a while loop's body once.
* :func:`cost_analysis_dict`: ``flops`` from ``torch.utils.flop_counter``'s
  formulas (matmuls, convolutions, attention; the hand kernels register
  theirs in :mod:`repro_torch.kernels.ops`) and ``bytes accessed``, the
  input and output bytes of every op that is not a view.  The latter is an
  unfused upper bound: eager PyTorch fuses nothing, and a fused program
  would move fewer bytes.
* :func:`memory_analysis`: argument, output and alias bytes, and the peak of
  the intermediates that a liveness walk over the graph finds live at once.
"""

from __future__ import annotations

import operator
from collections import defaultdict

import torch

#: ``_c10d_functional`` op name -> the reference's collective name
COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-broadcast",
}

# ops that move no bytes of their own: they return an alias, wait for one, or
# allocate without writing
_NO_TRAFFIC = {"wait_tensor", "empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "lift_fresh", "lift_fresh_copy"}


def _opname(target) -> str:
    return getattr(target, "_opname", None) or getattr(target, "__name__", str(target))


def _namespace(target) -> str:
    return getattr(target, "namespace", "")


def _tensors(val) -> list[torch.Tensor]:
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (tuple, list)):
        return [t for v in val for t in _tensors(v)]
    return []


def _nbytes(val) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(val))


def _ops(graph: torch.fx.Graph):
    """The call_function nodes of ``graph`` that ran an op (not the tuple
    unpacking the recorder adds after a multi-output op)."""
    return (n for n in graph.nodes
            if n.op == "call_function" and n.target is not operator.getitem)


def _arg_vals(node: torch.fx.Node):
    return torch.fx.node.map_arg((node.args, node.kwargs), lambda n: n.meta.get("val"))


def _input_bytes(node: torch.fx.Node) -> int:
    return sum(_nbytes(a.meta.get("val")) for a in node.all_input_nodes)


def collective_name(target) -> str | None:
    """The reference's name of a ``_c10d_functional`` collective, else None."""
    if _namespace(target) != "_c10d_functional":
        return None
    return COLLECTIVES.get(_opname(target))


def _collectives_of(node: torch.fx.Node) -> list[tuple[str, int, int, int]]:
    """(name, count, operand bytes, result bytes) of the collectives one op
    runs: a ``_c10d_functional`` collective itself, or those an op runs
    inside it by its registered formula
    (``sharding.register_collective_formula``)."""
    from repro_torch.parallel.sharding import COLLECTIVE_FORMULAS

    base = collective_name(node.target)
    if base is not None:
        return [(base, 1, _input_bytes(node), _nbytes(node.meta.get("val")))]
    formula = COLLECTIVE_FORMULAS.get(getattr(node.target, "overloadpacket", None))
    if formula is None:
        return []
    args, kwargs = _arg_vals(node)
    return formula(*args, **kwargs)


def analyze_collectives(graph: torch.fx.Graph, top_n: int = 12) -> dict:
    """Per-collective stats of one rank's graph (per-device bytes).  An op
    that runs ``count`` collectives inside it adds ``count`` to its kind's
    count and one entry to the top ops, its bytes summed over them."""
    stats: dict[str, dict] = defaultdict(
        lambda: {"count": 0, "operand_bytes": 0, "result_bytes": 0})
    ops: list[dict] = []
    for node in _ops(graph):
        for base, count, operand, res in _collectives_of(node):
            rec = stats[base]
            rec["count"] += count
            rec["operand_bytes"] += count * operand
            rec["result_bytes"] += count * res
            wire = 2 * operand if base == "all-reduce" else max(operand, res)
            ops.append({"op": base, "name": node.name, "count": count,
                        "operand_bytes": count * operand, "result_bytes": count * res,
                        "wire_bytes": count * wire})
    out = dict(stats)
    out["_total"] = {
        "count": sum(r["count"] for r in stats.values()),
        "wire_bytes_per_device": sum(o["wire_bytes"] for o in ops),
    }
    ops.sort(key=lambda o: -o["wire_bytes"])
    out["_top_ops"] = ops[:top_n]
    return out


def node_flops(node: torch.fx.Node) -> int:
    """FLOPs of one op by ``torch.utils.flop_counter``'s formula for it (0 for
    an op that has none: elementwise work is not counted, as in
    ``FlopCounterMode``)."""
    from torch.utils.flop_counter import flop_registry

    packet = getattr(node.target, "overloadpacket", None)
    formula = flop_registry.get(packet)
    if formula is None:
        return 0
    args, kwargs = _arg_vals(node)
    return int(formula(*args, **kwargs, out_val=node.meta.get("val")))


def cost_analysis_dict(graph: torch.fx.Graph) -> dict:
    """``{"flops", "bytes accessed"}`` of one rank's graph (per device)."""
    flops = traffic = 0
    for node in _ops(graph):
        flops += node_flops(node)
        if getattr(node.target, "is_view", False) or _opname(node.target) in _NO_TRAFFIC:
            continue
        traffic += _input_bytes(node) + _nbytes(node.meta.get("val"))
    return {"flops": float(flops), "bytes accessed": float(traffic)}


def top_flops(graph: torch.fx.Graph, top_n: int = 8) -> list[dict]:
    """The ops with the most FLOPs, summed by op and local input shapes."""
    by: dict[tuple, list] = {}
    for node in _ops(graph):
        flops = node_flops(node)
        if flops:
            shapes = tuple(tuple(a.meta["val"].shape) for a in node.all_input_nodes
                           if isinstance(a.meta.get("val"), torch.Tensor))
            entry = by.setdefault((str(node.target), shapes), [0, 0])
            entry[0] += 1
            entry[1] += flops
    rows = [{"op": op, "shapes": [list(s) for s in shapes], "count": n, "flops": float(f)}
            for (op, shapes), (n, f) in by.items()]
    return sorted(rows, key=lambda r: -r["flops"])[:top_n]


def count_instructions(graph: torch.fx.Graph, opcodes: tuple[str, ...]) -> dict:
    """How many nodes run each of ``opcodes``, given as op names (``"mm"``) or
    full names (``"aten.mm.default"``)."""
    counts: dict[str, int] = defaultdict(int)
    for node in _ops(graph):
        for name in (_opname(node.target), str(node.target)):
            if name in opcodes:
                counts[name] += 1
    return dict(counts)


def _storage(t: torch.Tensor) -> tuple[int, int]:
    st = t.untyped_storage()
    return st._cdata, st.nbytes()


def memory_analysis(graph: torch.fx.Graph, top_n: int = 8) -> dict:
    """Per-device bytes in the reference's ``memory_analysis()`` keys.

    ``argument``: the storages of the step's arguments (placeholders marked
    ``"argument"``); ``output``: the storages the graph's output holds;
    ``alias``: the output storages that are argument storages (updated in
    place); ``temp``: the peak, over the graph's order, of the storages the
    ops create that are live at once, each from the op that creates it to
    the last op that reads it (outputs and arguments excluded).  Beyond the
    reference's keys, ``temp_at_peak``: the storages live at that peak,
    summed by the op that made them and their shape and dtype, the
    ``top_n`` largest (op, shape, dtype, count, bytes)."""
    args: dict[int, int] = {}
    first: dict[int, tuple[int, int, tuple]] = {}  # storage -> (index created, bytes, what)
    last: dict[int, int] = {}
    outputs: dict[int, int] = {}
    order = list(graph.nodes)
    for i, node in enumerate(order):
        if node.op == "placeholder":
            if node.meta.get("kind") == "argument":
                for t in _tensors(node.meta.get("val")):
                    key, size = _storage(t)
                    args[key] = size
            continue
        if node.op == "output":
            for inp in node.all_input_nodes:
                for t in _tensors(inp.meta.get("val")):
                    key, size = _storage(t)
                    outputs[key] = size
            continue
        for inp in node.all_input_nodes:
            for t in _tensors(inp.meta.get("val")):
                last[_storage(t)[0]] = i
        for t in _tensors(node.meta.get("val")):
            key, size = _storage(t)
            first.setdefault(key, (i, size, (str(node.target), tuple(t.shape),
                                              str(t.dtype).removeprefix("torch."))))
    events: dict[int, int] = defaultdict(int)
    spans = []
    for key, (i, size, what) in first.items():
        if key in args or key in outputs:
            continue
        end = max(last.get(key, i), i) + 1
        events[i] += size
        events[end] -= size
        spans.append((i, end, size, what))
    live = peak = peak_at = 0
    for i in sorted(events):
        live += events[i]
        if live > peak:
            peak, peak_at = live, i
    at_peak: dict[tuple, list] = {}
    for i, end, size, what in spans:
        if i <= peak_at < end:
            entry = at_peak.setdefault(what, [0, 0])
            entry[0] += 1
            entry[1] += size
    top = sorted(at_peak.items(), key=lambda kv: -kv[1][1])[:top_n]
    return {
        "argument_size_in_bytes": sum(args.values()),
        "output_size_in_bytes": sum(outputs.values()),
        "alias_size_in_bytes": sum(size for key, size in outputs.items() if key in args),
        "temp_size_in_bytes": peak,
        "generated_code_size_in_bytes": None,
        "temp_at_peak": [{"op": op, "shape": list(shape), "dtype": dtype, "count": n,
                          "bytes": b} for (op, shape, dtype), (n, b) in top],
    }
