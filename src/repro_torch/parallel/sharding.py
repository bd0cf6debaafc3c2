"""Logical-axis sharding over DTensor: counterpart of
``repro/parallel/sharding.py``.

Every parameter and key activation carries a tuple of *logical* axis names
("embed", "mlp", "heads", "batch", ...).  A :class:`ShardingRules` table maps
logical names to mesh-axis names (or ``None`` for replicated), through the
reference's rule engine, into a *spec*: a tuple with one entry per tensor dim,
each ``None``, a mesh-axis name or a tuple of them, trailing ``None`` dropped
(the reference's ``PartitionSpec``).  :func:`placements` turns a spec into
DTensor placements on a ``DeviceMesh`` whose ``mesh_dim_names`` are the
reference's axis names (``"pod"``, ``"data"``, ``"model"``).

Model code calls :func:`shard` at the reference's annotation points: under
:class:`use_rules` with a mesh it redistributes a DTensor to the placements
its logical axes resolve to (the reference's ``with_sharding_constraint``);
on a plain tensor, or with no active rules, it returns its argument, so the
unsharded path pays nothing.  Inputs enter the mesh through
:func:`distribute_input`.

Default rule sets implement:

* **FSDP** - parameter "embed" sharded over the data axes (``("pod",
  "data")`` on the multi-pod mesh); the optimizer state follows the params;
* **TP** - heads / mlp / experts / vocab over the "model" axis;
* **DP** - activation batch over the data axes;
* **SP** - the "kv_seq" hook of the reference's long-context cells (None
  here, as there).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Mapping, NamedTuple

import torch

AxisTarget = Any  # str | tuple[str, ...] | None
Spec = tuple  # one entry per tensor dim: None | str | tuple[str, ...]


@dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis names to mesh axes."""

    rules: Mapping[str, AxisTarget] = field(default_factory=dict)

    def spec(self, logical_axes: tuple[str | None, ...]) -> Spec:
        parts = []
        used: set[str] = set()
        for name in logical_axes:
            target = self.rules.get(name) if name is not None else None
            # a mesh axis may appear at most once in a spec
            if target is None:
                parts.append(None)
                continue
            targets = target if isinstance(target, tuple) else (target,)
            remaining = tuple(t for t in targets if t not in used)
            used.update(remaining)
            if not remaining:
                parts.append(None)
            elif len(remaining) == 1:
                parts.append(remaining[0])
            else:
                parts.append(remaining)
        while parts and parts[-1] is None:
            parts.pop()
        return tuple(parts)

    def merged(self, overrides: Mapping[str, AxisTarget]) -> "ShardingRules":
        return ShardingRules({**dict(self.rules), **dict(overrides)})


#: default parameter placement (single-pod and multi-pod meshes share these;
#: "fsdp" axes resolve to whichever of pod/data exist in the mesh)
PARAM_RULES = ShardingRules(
    {
        "embed": ("pod", "data"),       # FSDP: shard the big axis over data
        "mlp": "model",                  # TP
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "qkv": "model",
        "vocab": "model",
        "experts": "model",              # EP
        "expert_mlp": None,
        "layers": None,
        "blocks": None,
        "ssm_inner": "model",
        "ssm_state": None,
        "ssm_heads": "model",
        "conv": None,
        "lstm_heads": "model",
        "lstm_inner": "model",
        "rank": None,
    }
)

#: default activation placement
ACT_RULES = ShardingRules(
    {
        "batch": ("pod", "data"),
        "seq": None,
        "kv_seq": None,
        "embed": None,
        "mlp": "model",
        "heads": "model",
        "kv_heads": "model",
        "head_dim": None,
        "vocab": "model",
        "experts": "model",
        "expert_capacity": None,
        "ssm_heads": "model",
        "ssm_state": None,
        "ssm_inner": "model",
        "lstm_heads": "model",
        "lstm_inner": "model",
    }
)


class _Active(threading.local):
    def __init__(self):
        self.params: ShardingRules | None = None
        self.acts: ShardingRules | None = None
        self.mesh = None


_ACTIVE = _Active()


class use_rules:
    """Context manager activating (param_rules, act_rules) for model code, on
    the calling thread.

    With a ``mesh`` it also enters DTensor's ``implicit_replication``: the
    plain tensors model code makes on the fly (positions, masks, zeros) act as
    replicated on the mesh where they meet a DTensor, as a constant does
    under the reference's jit."""

    def __init__(self, param_rules: ShardingRules | None,
                 act_rules: ShardingRules | None, mesh=None):
        self.param_rules = param_rules
        self.act_rules = act_rules
        self.mesh = mesh

    def __enter__(self):
        self._saved = (_ACTIVE.params, _ACTIVE.acts, _ACTIVE.mesh)
        _ACTIVE.params = self.param_rules
        _ACTIVE.acts = self.act_rules
        _ACTIVE.mesh = self.mesh
        self._implicit = None
        if self.mesh is not None:
            self._implicit = implicit_replication()
            self._implicit.__enter__()
        return self

    def __exit__(self, *exc):
        if self._implicit is not None:
            self._implicit.__exit__(*exc)
        _ACTIVE.params, _ACTIVE.acts, _ACTIVE.mesh = self._saved
        return False


def active_rules() -> tuple[ShardingRules | None, ShardingRules | None]:
    return _ACTIVE.params, _ACTIVE.acts


def active_mesh():
    """The mesh of the active :class:`use_rules`, or None."""
    return _ACTIVE.mesh


def mesh_axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of any object with
    ``mesh_dim_names`` and ``shape``, such as a test's stand-in)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _mesh_axis_sizes() -> dict[str, int] | None:
    mesh = _ACTIVE.mesh
    return None if mesh is None else mesh_axis_sizes(mesh)


def assign_spec(
    logical_axes: tuple[str | None, ...],
    shape: tuple[int, ...],
    rules: ShardingRules,
    sizes: Mapping[str, int],
) -> Spec:
    """Single-pass divisibility-aware mesh-axis assignment.

    Joint assignment matters: if an earlier dim's rule targets a mesh axis
    it cannot actually use (absent, already taken, or non-divisible), the
    axis stays AVAILABLE for later dims (the reference's EXPERIMENTS.md
    §Perf iteration 1: a two-phase dedup-then-prune replicated the
    expert-MLP dim whenever n_experts < the model axis).
    """
    used: set[str] = set()
    parts: list = []
    for name, dim in zip(logical_axes, shape):
        target = rules.rules.get(name) if name is not None else None
        if target is None:
            parts.append(None)
            continue
        targets = target if isinstance(target, tuple) else (target,)
        kept: list[str] = []
        prod = 1
        for t in targets:
            size = sizes.get(t)
            if size is None or t in used or size <= 0:
                continue
            if dim % (prod * size) == 0:
                kept.append(t)
                prod *= size
        used.update(kept)
        if not kept:
            parts.append(None)
        elif len(kept) == 1:
            parts.append(kept[0])
        else:
            parts.append(tuple(kept))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _prune_spec_for_shape(spec: Spec, shape: tuple[int, ...]) -> Spec:
    """Legacy two-phase pruning against the active mesh (kept, as in the
    reference, for comparison experiments)."""
    sizes = _mesh_axis_sizes()
    if sizes is None:
        return spec
    parts = []
    for dim, target in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if target is None:
            parts.append(None)
            continue
        targets = target if isinstance(target, tuple) else (target,)
        kept = tuple(t for t in targets if t in sizes)
        total = 1
        for t in kept:
            total *= sizes[t]
        if not kept or dim % total:
            parts.append(None)
        elif len(kept) == 1:
            parts.append(kept[0])
        else:
            parts.append(kept)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(spec: Spec, mesh, shape: tuple[int, ...] | None = None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: a target on tensor dim
    ``d`` puts ``Shard(d)`` on each of its mesh dims (a tuple target such as
    ``("pod", "data")`` on both, nested in the tuple's order, which is the
    order DTensor's left-to-right placements give); every mesh dim that
    nothing targets gets ``Replicate()``.  Given the tensor's ``shape``, a
    dim of size 1 stays ``Replicate()``: the spec can only put mesh axes of
    size 1 there, the same layout, and DTensor refuses to view a sharded
    dim of size 1 away (a [1, T, D] @ [D, E] on a data axis of 1)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, target in enumerate(spec):
        if target is None or (shape is not None and shape[d] == 1):
            continue
        for t in (target if isinstance(target, tuple) else (target,)):
            i = names.index(t)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {t!r} used twice in spec {spec}")
            out[i] = Shard(d)
    return tuple(out)


def act_placements(x: torch.Tensor, *axes: str | None) -> tuple:
    """Placements of DTensor ``x`` by its logical axes under the active
    activation rules (the defaults when none are active)."""
    rules = _ACTIVE.acts or ACT_RULES
    mesh = x.device_mesh
    spec = assign_spec(axes, tuple(x.shape), rules, mesh_axis_sizes(mesh))
    return placements(spec, mesh, tuple(x.shape))


def follow(src: tuple, dims: dict[int, int]) -> tuple:
    """Placements that shard dim ``dims[d]`` wherever ``src`` shards dim
    ``d``, and replicate everything else."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims
                 else Replicate() for p in src)


def grad_placements(src: tuple, shard: dict[int, int], partial: set[int]) -> tuple:
    """The placements of a ``local_map`` input's gradient, from the placements
    ``src`` of the input it is computed beside: ``Shard(shard[d])`` where
    ``src`` shards dim ``d``, ``Partial("sum")`` where ``src`` shards a dim in
    ``partial`` (the ranks along it each add their share), ``Replicate()``
    elsewhere."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    def one(p):
        if isinstance(p, Shard) and p.dim in shard:
            return Shard(shard[p.dim])
        if isinstance(p, Shard) and p.dim in partial:
            return Partial("sum")
        return Replicate()

    return tuple(one(p) for p in src)


def untaken_axes(placements_: tuple, mesh, logical: str, *sizes: int) -> list[int]:
    """The mesh dims, of a size above 1, that the active activation rules
    give to ``logical`` but that ``placements_`` leave replicated (the dim
    could not take them), as many as every one of ``sizes`` divides by, in
    the mesh's order: the ranks along them hold the same data, and may split
    another dim of the work."""
    target = (_ACTIVE.acts or ACT_RULES).rules.get(logical)
    names = () if target is None else target if isinstance(target, tuple) else (target,)
    out, prod = [], 1
    for i, (name, p) in enumerate(zip(mesh.mesh_dim_names, placements_)):
        size = mesh.size(i)
        if (name in names and p.is_replicate() and size > 1
                and all(n % (prod * size) == 0 for n in sizes)):
            out.append(i)
            prod *= size
    return out


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """Annotate an activation with logical axes: a DTensor is redistributed
    to the placements they resolve to under the active rules; a plain tensor,
    or anything without active rules, comes back as it is."""
    rules = _ACTIVE.acts
    if rules is None:
        return x
    if len(logical_axes) != x.ndim:
        raise ValueError(f"shard(): {len(logical_axes)} axes for array of rank {x.ndim}")
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    spec = assign_spec(logical_axes, tuple(x.shape), rules, mesh_axis_sizes(mesh))
    target = placements(spec, mesh, tuple(x.shape))
    if tuple(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def distribute_input(x: torch.Tensor, *logical_axes: str | None) -> torch.Tensor:
    """A plain input tensor (the same on every rank) placed on the active mesh
    by its logical axes under the active activation rules; each rank keeps
    its slice, nothing is sent.  Without a mesh, or for a DTensor, ``x`` comes
    back as it is."""
    mesh, rules = _ACTIVE.mesh, _ACTIVE.acts
    if mesh is None or rules is None or is_dtensor(x):
        return x
    from torch.distributed.tensor import distribute_tensor

    spec = assign_spec(logical_axes, tuple(x.shape), rules, mesh_axis_sizes(mesh))
    return distribute_tensor(x, mesh, placements(spec, mesh, tuple(x.shape)),
                             src_data_rank=None)


def unshard_dims(x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with tensor dims ``dims`` whole on every rank (its other
    placements kept): for an op that has no sharding strategy over them."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    dims = {d % x.ndim for d in dims}
    target = tuple(Replicate() if isinstance(p, Shard) and p.dim in dims else p
                   for p in x.placements)
    if target == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its partial sums reduced (``Partial`` made ``Replicate``,
    its other placements kept), and its gradient reduced the same way.
    DTensor carries a partial sum through ops linear in it (a row product's
    output, a residual add, a scale), and where it meets a column-sharded
    weight it gathers the weight rather than reduce the activation, so every
    rank would run that product whole; the gradient of a replicated input
    comes back from the column products as partial sums, with the same
    effect on the backward products behind it.  Some DTensor versions also
    cannot add a shard to a partial sum (torch 2.11): reduce the partial
    operand of such an add first."""
    return _replicated_where(x, lambda p: p.is_partial())


def whole_rows(x: torch.Tensor) -> torch.Tensor:
    """:func:`reduce_partial`, and the last dim whole on every rank as well:
    for an op that reads whole rows, such as a norm.  A row may arrive split
    over a mesh axis (xLSTM's residual stream, scaled by a gain sharded along
    ``"lstm_inner"``); a mean over the split dim is ``Partial("avg")``, which
    flows on into the products behind the norm and whose gradient, a partial
    sum, DTensor cannot turn back into an average.  With both done here the
    products per rank are the reference's (``tests/test_torch_dryrun.py``,
    (j))."""
    last = x.ndim - 1
    return _replicated_where(x, lambda p: p.is_partial() or p.is_shard(last))


def _replicated_where(x: torch.Tensor, pick) -> torch.Tensor:
    """``x`` with each placement ``pick`` selects made ``Replicate``, and its
    gradient brought back to those placements."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    target = tuple(Replicate() if pick(p) else p for p in x.placements)
    if target != tuple(x.placements):
        x = x.redistribute(x.device_mesh, target)
    return grad_as_forward(x)


def logical_spec(
    logical_axes: tuple[str | None, ...],
    rules: ShardingRules,
    shape: tuple[int, ...] | None = None,
    mesh=None,
) -> Spec:
    """Resolve logical axes to a spec (divisibility-aware given shape and mesh)."""
    if shape is None or mesh is None:
        return rules.spec(logical_axes)
    return assign_spec(logical_axes, tuple(shape), rules, mesh_axis_sizes(mesh))


class Sharding(NamedTuple):
    """Where a leaf lives: ``distribute_tensor(t, *sharding)`` places it."""

    mesh: Any
    placements: tuple


def _effective(rules: ShardingRules, mesh_axes: set[str]) -> ShardingRules:
    # drop rule targets that reference axes absent from this mesh
    out = {}
    for k, v in rules.rules.items():
        if v is None:
            out[k] = None
        else:
            targets = v if isinstance(v, tuple) else (v,)
            kept = tuple(t for t in targets if t in mesh_axes)
            out[k] = kept if len(kept) > 1 else (kept[0] if kept else None)
    return ShardingRules(out)


def _map_axes(fn, axes, *others):
    if isinstance(axes, dict):
        return {k: _map_axes(fn, axes[k], *(o[k] for o in others)) for k in axes}
    return fn(axes, *others)


def param_specs(param_axes, mesh, rules: ShardingRules = PARAM_RULES, param_shapes=None):
    """The tree of specs of ``param_axes`` (nested dicts of logical-axis
    tuples) on ``mesh``: divisibility-aware when ``param_shapes`` is given."""
    eff = _effective(rules, set(mesh.mesh_dim_names))
    if param_shapes is None:
        return _map_axes(eff.spec, param_axes)
    return _map_axes(lambda axes, shape: logical_spec(axes, eff, tuple(shape), mesh),
                     param_axes, param_shapes)


def param_shardings(param_axes, mesh, rules: ShardingRules = PARAM_RULES,
                    param_shapes=None):
    """A tree of :class:`Sharding` (mesh, placements) pairs for the params,
    from their logical axes, the reference's ``NamedSharding`` tree."""
    return _map_axes(lambda spec: Sharding(mesh, placements(spec, mesh)),
                     param_specs(param_axes, mesh, rules, param_shapes))


def distribute_tree(tree, shardings):
    """Each tensor leaf of ``tree`` (the same on every rank) placed by the
    matching leaf of ``shardings`` (a tree of the same dicts); every rank
    keeps its slice, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return _map_axes(lambda sh, t: distribute_tensor(t, sh.mesh, sh.placements,
                                                     src_data_rank=None),
                     shardings, tree)


def implicit_replication():
    """DTensor's ``implicit_replication`` context: a plain tensor that meets a
    DTensor acts as replicated on its mesh.  Harmless where none is met."""
    from torch.distributed.tensor.experimental import implicit_replication as ctx

    return ctx()


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose gradient comes back contiguous.  DTensor wraps the
    local gradients ``local_map`` hands back as if they were laid out like
    the input, and its next view of one that is not (an einsum's transposed
    product) fails."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


class _GradAsForward(torch.autograd.Function):
    """Identity whose gradient is redistributed to the placements of its
    forward value before it flows on."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def grad_as_forward(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient (a DTensor) comes back in ``x``'s own placements.

    A reshape that merged a dim DTensor could not shard (4 heads on a model
    axis of 16, left whole) gets back a gradient sharded along the merged dim,
    which its backward cannot split into heads again; the gradient in the
    forward's placements can.  A plain tensor comes back as it is."""
    return _GradAsForward.apply(x) if is_dtensor(x) and x.requires_grad else x


def pointwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn`` DTensor has no strategy for
    (``F.logsigmoid``): per rank on ``x``'s shards, partial sums reduced
    first.  A plain tensor goes straight to ``fn``."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import Replicate

    placements = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return local_map(fn, placements, (placements,), x.device_mesh)(x)


def local_map(fn, out_placements, in_placements, mesh, in_grad_placements=None):
    """DTensor's ``local_map`` of ``fn``: each rank runs ``fn`` on its local
    tensors, inputs redistributed to ``in_placements`` first, outputs and
    input gradients made contiguous.  ``out_placements`` is one output's
    placements (a tuple of Placement) or a tuple of them, one per output.
    ``in_grad_placements`` (one entry per input, None for the default): what
    an input's local gradient is on the mesh, where it is not its input
    placements, e.g. ``Partial("sum")`` for an input every rank reads whole
    but uses only in part."""
    from torch.distributed.tensor.experimental import local_map as _local_map

    if out_placements and not isinstance(out_placements[0], (tuple, list)):
        out_placements = list(out_placements)  # local_map's form for one output

    def local(*args):
        args = [_ContiguousGrad.apply(a) if isinstance(a, torch.Tensor) and a.requires_grad
                else a for a in args]
        out = fn(*args)
        if isinstance(out, tuple):
            return tuple(o.contiguous() if isinstance(o, torch.Tensor) else o for o in out)
        return out.contiguous()

    if in_grad_placements is not None:
        in_grad_placements = tuple(g if g is not None else p
                                   for g, p in zip(in_grad_placements, in_placements))
    return _local_map(local, out_placements=out_placements, in_placements=in_placements,
                      in_grad_placements=in_grad_placements, device_mesh=mesh,
                      redistribute_inputs=True)


def replicated(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` as a DTensor whole on every rank of ``mesh`` (a plain tensor,
    the same on every rank, is wrapped without a copy being sent)."""
    if is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, distribute_tensor

    return distribute_tensor(x, mesh, [Replicate()] * mesh.ndim, src_data_rank=None)


def full_tensor(x):
    """The whole of a DTensor on every rank of its mesh (a collective); a
    plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def local_rank_along(mesh, placements_: tuple, dim: int) -> tuple[int, int]:
    """(index, count) of this rank's slice of tensor dim ``dim`` under
    ``placements_`` on ``mesh``: the mesh dims sharding it nest left to
    right, as DTensor lays them out."""
    from torch.distributed.tensor import Shard

    index, count = 0, 1
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements_):
        if isinstance(p, Shard) and p.dim == dim:
            size = mesh.size(i)
            index = index * size + coord[i]
            count *= size
    return index, count


def split_group(mesh, dim: int, size: int):
    """The process group of this rank and the other ranks of its run of
    ``size`` along mesh dim ``dim`` (coordinates ``size * j`` to
    ``size * (j + 1) - 1`` there, its other coordinates the same): the view
    of that dim as (runs, ``size``), which a DeviceMesh dim cannot be.
    Every run's group is made once a mesh, by every rank in one order."""
    import torch.distributed as dist

    groups = mesh.__dict__.setdefault("_split_groups", {})
    if (dim, size) not in groups:
        lines = mesh.mesh.movedim(dim, -1).reshape(-1, mesh.size(dim)).tolist()
        runs = [line[j:j + size] for line in lines for j in range(0, len(line), size)]
        if any(run != sorted(run) for run in runs):
            raise ValueError(f"split_group: ranks along mesh dim {dim} do not ascend")
        mine = dist.get_rank()
        for run in runs:
            group = dist.new_group(run)
            if mine in run:
                groups[dim, size] = group
    return groups[dim, size]


def _waited(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(t)


def run_all_gather(x: torch.Tensor, group_name: str, size: int) -> torch.Tensor:
    """Each rank's ``x`` side by side along the last dim, in the order of
    the ranks of the group named ``group_name`` (``size`` ranks, a run of
    :func:`split_group`).  For use inside an op on plain tensors: the
    collective resolves its group by name, and has no gradient."""
    out = torch.ops._c10d_functional.all_gather_into_tensor(x.contiguous(), size, group_name)
    out = torch.ops._c10d_functional.wait_tensor(out)
    return out.reshape(size, *x.shape).movedim(0, -2).reshape(*x.shape[:-1], -1)


def run_reduce_scatter(x: torch.Tensor, group_name: str, size: int) -> torch.Tensor:
    """The sum of ``x`` over the ranks of the group named ``group_name``,
    each keeping its block of the last dim (one of ``size``, in the group's
    rank order): :func:`run_all_gather`'s transpose."""
    blocks = x.reshape(*x.shape[:-1], size, -1).movedim(-2, 0).contiguous()
    out = torch.ops._c10d_functional.reduce_scatter_tensor(blocks, "sum", size, group_name)
    return torch.ops._c10d_functional.wait_tensor(out).reshape(*x.shape[:-1], -1)


#: op overload packet -> its collective formula (:func:`register_collective_formula`)
COLLECTIVE_FORMULAS: dict = {}


def register_collective_formula(op):
    """Register ``formula(*args, **kwargs)`` for ``op`` (a custom op's
    overload packet): a list of ``(collective name, count, operand bytes,
    result bytes)``, one entry per kind of collective the op runs inside
    its own implementation on those arguments, where a traced step, which
    runs the op's fake implementation, cannot see them (a loop op that
    gathers every step).  ``repro_torch.launch.hlo`` adds them to a trace's
    collectives, as ``register_flop_formula`` adds an op's FLOPs."""

    def register(formula):
        COLLECTIVE_FORMULAS[op] = formula
        return formula

    return register


class _GroupSum(torch.autograd.Function):
    """The sum over a group's ranks of each rank's ``x``, on every rank; the
    gradient is summed the same way (each rank's output feeds its own
    work)."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol

        ctx.group = group
        return _waited(funcol.all_reduce(x.contiguous(), "sum", group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol

        return _waited(funcol.all_reduce(g.contiguous(), "sum", ctx.group)), None


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Local ``x`` summed over the ranks of ``group`` (a run of a mesh dim,
    :func:`split_group`), with its gradient, inside :func:`local_map`."""
    return _GroupSum.apply(x, group)


class _RunGrad(torch.autograd.Function):
    """Identity on a DTensor; see :func:`run_grad`."""

    @staticmethod
    def forward(ctx, x, dim, mesh_dim, size):
        ctx.dim, ctx.mesh_dim, ctx.size = dim, mesh_dim, size
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor import DTensor, Shard

        mesh, dim, md, size = g.device_mesh, ctx.dim, ctx.mesh_dim, ctx.size
        runs = mesh.size(md) // size
        block = g.shape[dim] // runs
        run = mesh.get_coordinate()[md] // size
        local = g.to_local().narrow(dim, run * block, block)
        scatter = getattr(funcol, "reduce_scatter_single", None) or funcol.reduce_scatter_tensor
        piece = _waited(scatter(local.contiguous(), "sum", dim, split_group(mesh, md, size)))
        placements = tuple(Shard(dim) if i == md else p for i, p in enumerate(g.placements))
        piece = DTensor.from_local(piece, mesh, placements, shape=g.shape, stride=g.stride())
        return _replicated_where(piece, lambda p: p.is_partial()), None, None, None


def run_grad(x: torch.Tensor, dim: int, mesh_dim: int, size: int) -> torch.Tensor:
    """``x`` as it is, for a :func:`local_map` that reads it whole along
    ``mesh_dim`` and hands back its gradient as ``Partial("sum")`` there, in
    which each run of ``size`` ranks (:func:`split_group`) writes only its
    run's block of tensor dim ``dim`` (one of as many blocks as there are
    runs).  That gradient comes back summed over the run alone, each rank
    keeping its ``Shard(dim)`` slice, its partial sums over other mesh dims
    reduced on that slice: a reduce-scatter over the run, where DTensor
    would reduce the whole, mostly zero, tensor over the mesh dim."""
    if not (is_dtensor(x) and x.requires_grad):
        return x
    return _RunGrad.apply(x, dim % x.ndim, mesh_dim, size)
