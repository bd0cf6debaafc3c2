"""Multi-pod dry-run: trace every (architecture x input shape) on the
production meshes without allocating, and extract the roofline inputs.
Counterpart of ``repro/launch/dryrun.py``.

Where the reference lowers and compiles on 512 placeholder XLA host devices,
this forms a *fake* process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: rank 0 of a world whose
collectives send nothing), builds the production ``DeviceMesh`` on it
(:func:`repro_torch.launch.mesh.make_production_mesh`), makes the step's
arguments as fake DTensors (:mod:`repro_torch.launch.specs`) and runs the step
once under ``FakeTensorMode``.  :func:`lower` records what rank 0 runs, op by
op, into a ``torch.fx.Graph`` of local ops: DTensor turns each global op into
ops on the local shards and ``_c10d_functional`` collectives, and the graph
holds those (and not the global-shape ops DTensor's sharding propagation runs
to learn output shapes).  The step runs eagerly, so each op appears once per
time it runs: a layer loop is counted at full depth (the reference unrolls
its scans for the same reason), the backward once, and remat's recompute
where it happens.  xLSTM's loops over chunks and over time are the
exception: each is one op with a FLOP formula, one node a call, as each is
one loop in the reference's compiled step; the sLSTM's, where it gathers
among a head's ranks every step, also registers those collectives.  :mod:`repro_torch.launch.hlo`
reads the graph.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch internlm2-1.8b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

The mesh's device type is ``--device`` (default ``cuda``, which needs a
card to set; no kernel runs either way).  Each cell writes
``build/dryrun/<arch>__<shape>__<mesh>.json``: memory, cost and collective
traffic per device, which :mod:`repro_torch.launch.roofline` reads.  A cell
whose trace fails, or records more than ``MAX_OPS`` ops, is written with
``status: "error"`` and its reason.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import operator
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils import _pytree as pytree

from repro_torch import configs
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import hlo as hlo_mod
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import make_production_mesh, mesh_chip_count
from repro_torch.models.model import Model, active_params_analytic, count_params_analytic
from repro_torch.parallel.sharding import PARAM_RULES, use_rules
from repro_torch.train.loop import make_train_step

RESULTS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "build", "dryrun",
)

#: a trace that records more local ops than this stops with an error (a
#: Python loop over time or chunks would record millions; xLSTM's two loops
#: are single ops for this, ``repro_torch.models.xlstm``)
MAX_OPS = 500_000


#: the hand kernels' custom ops (:mod:`repro_torch.kernels.ops`), counted in a
#: record's ``kernel_calls``
KERNEL_OPS = ("flash_attention", "mamba_scan", "gmm")


class TraceTooLarge(RuntimeError):
    pass


def _in_sharding_propagation() -> bool:
    """Whether DTensor's sharding propagator is on the stack: it runs each op
    on global-shape fake tensors to learn the output's shape, and those ops
    are no rank's work."""
    frame = sys._getframe(2)
    while frame is not None:
        if frame.f_code.co_filename.endswith("_sharding_prop.py"):
            return True
        frame = frame.f_back
    return False


# torch's own frames between an op's caller and the mode
_WRAPPERS = ("eval_frame.py", "_compile.py", "_python_dispatch.py")

#: torch releases on which the frames above, ``_sharding_prop.py`` and
#: ``placement_types.py`` were checked to be where the tracer looks for them
#: (2.11 on the card's machine, 2.13 on the CPU); :func:`lower` refuses others
CHECKED_TORCH = ("2.11", "2.13")


def _check_torch() -> None:
    release = ".".join(torch.__version__.split(".")[:2])
    if release not in CHECKED_TORCH:
        raise RuntimeError(
            f"dryrun: torch {torch.__version__} is not one of {CHECKED_TORCH}, on which the "
            "tracer's DTensor frame names were checked; check them and add the release")


def _placement_arithmetic() -> bool:
    """Whether the op was called from DTensor's placement arithmetic
    (``placement_types.py``), which computes a strided shard's sizes and
    offsets with small host tensors and reads them back (``tolist``): it
    must run on real tensors, which a fake one cannot read back."""
    frame = sys._getframe(2)
    while frame is not None and frame.f_code.co_filename.endswith(_WRAPPERS):
        frame = frame.f_back
    return frame is not None and frame.f_code.co_filename.endswith("placement_types.py")


def _key(t: torch.Tensor) -> tuple:
    """A tensor's identity for the graph: its storage and view.  Autograd
    unpacks a saved tensor as a new Python object over the same storage."""
    return (t.untyped_storage()._cdata, t.storage_offset(), tuple(t.shape),
            tuple(t.stride()), t.dtype)


class _LocalOps(TorchDispatchMode):
    """Records every op that runs on plain (local) tensors into a graph.

    A mode sees an op before any tensor subclass does; for an op on DTensors
    it steps aside (``NotImplemented``), DTensor's dispatch runs, and the
    local ops that dispatch makes come back to the mode on plain tensors."""

    def __init__(self):
        super().__init__()
        self.graph = torch.fx.Graph()
        self._nodes: dict[tuple, torch.fx.Node] = {}
        self._keep: list = []  # every recorded value, so no storage is reused
        self._first_op: torch.fx.Node | None = None
        self._n_ops = 0

    def placeholder(self, name: str, t: torch.Tensor, kind: str) -> torch.fx.Node:
        if self._first_op is None:
            node = self.graph.placeholder(name)
        else:
            with self.graph.inserting_before(self._first_op):
                node = self.graph.placeholder(name)
        node.meta.update(val=t, kind=kind)
        self._nodes[_key(t)] = node
        self._keep.append(t)
        return node

    def node_of(self, t: torch.Tensor) -> torch.fx.Node:
        node = self._nodes.get(_key(t))
        if node is None:  # a tensor made before the trace, not an argument
            node = self.placeholder(f"const_{len(self._keep)}", t, "constant")
        return node

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        inputs = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        if (all(not isinstance(t, FakeTensor) for t in inputs)
                and (inputs or _placement_arithmetic())):
            with unset_fake_temporarily():  # host arithmetic, no rank's work
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        outs = [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not outs or _in_sharding_propagation():
            return out
        n_args, n_kwargs = pytree.tree_map_only(torch.Tensor, self.node_of, (args, kwargs))
        node = self.graph.call_function(func, tuple(n_args), dict(n_kwargs))
        node.meta["val"] = out
        if self._first_op is None:
            self._first_op = node
        if isinstance(out, torch.Tensor):
            self._nodes[_key(out)] = node
        else:
            for i, t in enumerate(out):
                if isinstance(t, torch.Tensor):
                    item = self.graph.call_function(operator.getitem, (node, i))
                    item.meta["val"] = t
                    self._nodes[_key(t)] = item
        self._keep.append(out)
        self._n_ops += 1
        if self._n_ops > MAX_OPS:
            raise TraceTooLarge(f"the trace passed {MAX_OPS} local ops")
        return out


def _local(t):
    from torch.distributed.tensor import DTensor

    return t._local_tensor if isinstance(t, DTensor) else t


def _leaves_with_paths(tree, prefix: str = ""):
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], f"{prefix}.{k}" if prefix else str(k))
    elif isinstance(tree, (tuple, list)):
        fields = getattr(tree, "_fields", None)
        for i, v in enumerate(tree):
            name = fields[i] if fields else str(i)
            yield from _leaves_with_paths(v, f"{prefix}.{name}" if prefix else name)


def lower(fn, *args, **kwargs) -> torch.fx.Graph:
    """The graph of local ops that ``fn(*args, **kwargs)`` runs on this rank.

    Call it inside the ``FakeTensorMode`` that made ``args`` (fake tensors or
    fake DTensors).  Every tensor argument's local shard becomes a
    placeholder marked ``"argument"``, the graph's output holds the local
    tensors of what ``fn`` returns, and each op node's ``meta["val"]`` is
    its fake result."""
    _check_torch()
    rec = _LocalOps()
    for path, t in _leaves_with_paths((args, kwargs)):
        rec.placeholder(path.replace(".", "_"), _local(t), "argument")
    with rec:
        out = fn(*args, **kwargs)
    outs = [rec.node_of(_local(t)) for _, t in _leaves_with_paths(out)]
    rec.graph.output(tuple(outs))
    return rec.graph


@contextlib.contextmanager
def fake_world(world_size: int):
    """Rank 0 of a fake process group of ``world_size`` ranks, destroyed on
    exit.  Raises if a process group is already initialised."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def decode_position(shape) -> int:
    """The position a decode cell's step writes: the cache's last slot, so
    attention reads every position (the reference's static-shape decode
    attends over the whole cache whatever its traced position)."""
    return shape.seq_len - 1


def make_step_fn(cfg, shape, mesh, rules_override=None, tcfg=None, constrain_grads=False):
    """Build the function to trace for this cell."""
    model = Model(cfg)
    act_rules = specs_mod.act_rules_for(cfg, shape, mesh)
    if rules_override:
        act_rules = act_rules.merged(rules_override)
    param_rules = PARAM_RULES

    if shape.kind == "train":
        tcfg = tcfg or TrainConfig()
        grad_sh = None
        if constrain_grads:
            from repro_torch.models.model import param_axes, param_shapes
            from repro_torch.parallel.sharding import param_shardings

            grad_sh = param_shardings(param_axes(cfg), mesh, param_rules,
                                      param_shapes=param_shapes(cfg))
        step = make_train_step(model, tcfg, grad_shardings=grad_sh)

        def train_fn(state, batch):
            with use_rules(param_rules, act_rules, mesh):
                return step(state, batch)

        return train_fn

    if shape.kind == "prefill":
        def prefill_fn(params, batch):
            with use_rules(param_rules, act_rules, mesh), torch.no_grad():
                return model.prefill(params, batch, shape.seq_len)

        return prefill_fn

    def decode_fn(params, tokens_new, cache, position):
        with use_rules(param_rules, act_rules, mesh), torch.no_grad():
            return model.decode_step(params, tokens_new, cache, position)

    return decode_fn


def _analyze(graph: torch.fx.Graph, record: dict) -> None:
    record["memory"] = hlo_mod.memory_analysis(graph)
    record["cost"] = hlo_mod.cost_analysis_dict(graph)
    record["collectives"] = hlo_mod.analyze_collectives(graph)
    record["hlo_instructions"] = sum(1 for n in graph.nodes if n.op == "call_function")
    record["kernel_calls"] = hlo_mod.count_instructions(graph, KERNEL_OPS)
    record["top_flops"] = hlo_mod.top_flops(graph)


def run_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str,
    tcfg: TrainConfig | None = None,
    rules_override: dict | None = None,
    cfg_override: dict | None = None,
    constrain_grads: bool = False,
    save: bool = True,
    tag: str = "",
    device: str = "cuda",
    shape=None,
    mesh_shape: tuple[int, ...] | None = None,
) -> dict:
    """Trace one cell and return (and with ``save``, write) its record.

    Beyond the reference's arguments: ``device``, the mesh's device type;
    ``shape``, a ``ShapeConfig`` to use in place of
    ``configs.SHAPES[shape_name]``; ``mesh_shape``, a ``("data", "model")``
    mesh of another shape in place of the production one (a world of its
    size)."""
    cfg = configs.get(arch).replace(unroll_layers=True, **(cfg_override or {}))
    shape = shape or configs.SHAPES[shape_name]
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": mesh_kind,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "params_total": count_params_analytic(cfg),
        "params_active": active_params_analytic(cfg),
        "tag": tag,
    }
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if mesh_kind == "multi" else (16, 16)
    world = 1
    for d in mesh_shape:
        world *= d
    t0 = time.time()
    try:
        with fake_world(world):
            if mesh_shape in ((16, 16), (2, 16, 16)):
                mesh = make_production_mesh(multi_pod=len(mesh_shape) == 3, device_type=device)
            else:
                from repro_torch.launch.mesh import make_mesh

                mesh = make_mesh(mesh_shape, ("data", "model")[-len(mesh_shape):], device)
            record["mesh_shape"] = list(mesh.shape)
            record["chips"] = mesh_chip_count(mesh)
            with specs_mod.fake_mode():
                specs = specs_mod.input_specs(cfg, shape, mesh, overrides=rules_override)
                fn = make_step_fn(cfg, shape, mesh, rules_override, tcfg,
                                  constrain_grads=constrain_grads)
                if shape.kind == "train":
                    graph = lower(fn, specs["state"], specs["batch"])
                elif shape.kind == "prefill":
                    graph = lower(fn, specs["params"], specs["batch"])
                else:
                    graph = lower(fn, specs["params"], specs["tokens_new"], specs["cache"],
                                  decode_position(shape))
            record["lower_seconds"] = time.time() - t0
            t1 = time.time()
            _analyze(graph, record)
            record["compile_seconds"] = time.time() - t1
            record["status"] = "ok"
    except Exception as e:
        record["status"] = "error"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-4000:]
    record["total_seconds"] = time.time() - t0

    if save:
        os.makedirs(RESULTS_DIR, exist_ok=True)
        suffix = f"__{tag}" if tag else ""
        path = os.path.join(RESULTS_DIR, f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
        with open(path, "w") as fh:
            json.dump(record, fh, indent=1)
        record["path"] = path
    return record


def iter_cells(mesh_kinds):
    """The reference's production cells: its architectures' shapes."""
    for arch in configs.REFERENCE_ARCH_IDS:
        for shape in configs.shapes_for(arch):
            for mesh_kind in mesh_kinds:
                yield arch, shape.name, mesh_kind


def summary(rec: dict) -> str:
    ok = rec["status"] == "ok"
    line = (f"[{'OK ' if ok else 'ERR'}] {rec['arch']} × {rec['shape']} × "
            f"{rec['mesh']}  ({rec['total_seconds']:.1f}s")
    if ok:
        mem = rec.get("memory", {})
        line += (
            f", args/dev {mem.get('argument_size_in_bytes', 0)/2**30:.2f}"
            f" GiB, temp/dev {mem.get('temp_size_in_bytes', 0)/2**30:.2f}"
            f" GiB, flops {rec.get('cost', {}).get('flops', 0):.3g}"
            f", coll {rec['collectives']['_total']['wire_bytes_per_device']/2**20:.1f} MiB)"
        )
    else:
        line += f") {rec['error'][:200]}"
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--arch", default=None)
    parser.add_argument("--shape", default=None)
    parser.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    parser.add_argument("--all", action="store_true")
    parser.add_argument("--skip-existing", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="the mesh's device type (no kernel runs on it)")
    args = parser.parse_args(argv)

    mesh_kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = list(iter_cells(mesh_kinds))
    else:
        if not args.arch or not args.shape:
            parser.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape, mk) for mk in mesh_kinds]

    failures = 0
    for arch, shape_name, mesh_kind in cells:
        out_path = os.path.join(RESULTS_DIR, f"{arch}__{shape_name}__{mesh_kind}.json")
        if args.skip_existing and os.path.exists(out_path):
            with open(out_path) as fh:
                if json.load(fh).get("status") == "ok":
                    continue
        rec = run_cell(arch, shape_name, mesh_kind, device=args.device)
        failures += rec["status"] != "ok"
        if not args.quiet:
            print(summary(rec), flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
