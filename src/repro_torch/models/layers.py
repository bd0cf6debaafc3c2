"""Primitive layers: norms, projections, embeddings, RoPE, MLPs.

Counterpart of ``repro/models/layers.py``, for the layers the serving path
uses.  Parameters are plain nested dicts of tensors with the JAX package's
keys and layouts (a dense weight is ``[d_in, d_out]`` for ``x @ w``), so that
weights cross between the two packages as a copy (:mod:`repro_torch.bridge`).
Every ``init_*`` returns a tree of :class:`ParamSpec`, each carrying the
reference's logical axes; :func:`spec_axes` reads them out for
:mod:`repro_torch.parallel.sharding`.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import shard


@dataclasses.dataclass
class ParamSpec:
    """A parameter leaf's shape, logical axes and initialiser (init-time only)."""

    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float = 1.0


def flatten_specs(tree, prefix: tuple[str, ...] = ()):
    """(path, leaf) pairs in sorted-key order, the order of ``jax.tree_util``."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from flatten_specs(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {key: map_tree(fn, sub) for key, sub in tree.items()}
    return fn(tree)


def spec_axes(specs):
    """The tree of logical-axis tuples of a tree of ParamSpec."""
    return map_tree(lambda s: s.axes, specs)


def spec_shapes(specs):
    """The tree of shapes of a tree of ParamSpec."""
    return map_tree(lambda s: s.shape, specs)


def unflatten(pairs) -> dict:
    """The nested dict of ``(path, leaf)`` pairs: the inverse of flatten_specs."""
    tree: dict = {}
    for path, leaf in pairs:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def value_and_grad(loss_fn, params, *args):
    """``(loss, grads)`` of ``loss_fn(params, *args)``, as ``jax.value_and_grad``:
    ``grads`` has params' structure, the gradient of each floating-point leaf
    (zeros for a leaf the loss does not use), None for any other leaf.  The
    leaves are differentiated through detached aliases, so params themselves
    need not, and do not come to, require grad."""
    pairs = [(path, t.detach().requires_grad_(t.is_floating_point()))
             for path, t in flatten_specs(params)]
    loss = loss_fn(unflatten(pairs), *args)
    wrt = [t for _, t in pairs if t.requires_grad]
    grads = iter(torch.autograd.grad(loss, wrt, allow_unused=True, materialize_grads=True))
    return loss.detach(), unflatten((path, next(grads) if t.requires_grad else None)
                                    for path, t in pairs)


def _make(generator: torch.Generator, spec: ParamSpec, dtype, device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
    std = spec.scale / math.sqrt(fan_in)
    out = torch.empty(spec.shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (out.mul_(std)).to(dtype)


def materialize(generator: torch.Generator, specs, dtype, device):
    """Build the params tree from a matching tree of ParamSpec, on ``device``.

    Truncated normal at +-3, std = scale / sqrt(fan_in), as the reference
    does; the draws come from ``generator`` (on ``device``) and do not
    reproduce JAX's bits.
    """
    params: dict = {}
    for path, spec in flatten_specs(specs):
        node = params
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _make(generator, spec, dtype, device)
    return params


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(d: int, norm_type: str, use_bias: bool = False):
    spec = {"scale": ParamSpec((d,), ("embed",), init="ones")}
    if norm_type == "layernorm" and use_bias:
        spec["bias"] = ParamSpec((d,), ("embed",), init="zeros")
    return spec


def apply_norm(params, x: torch.Tensor, norm_type: str, eps: float) -> torch.Tensor:
    x32 = sharding.whole_rows(x).float()
    if norm_type == "rmsnorm":
        var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
    else:
        mean = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.var(x32, dim=-1, keepdim=True, correction=0)
        y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float()
    if "bias" in params:
        y = y + params["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Dense / Embedding
# ---------------------------------------------------------------------------


def init_dense(d_in: int, d_out: int, axes: tuple[str | None, str | None],
               use_bias: bool = False, scale: float = 1.0):
    spec = {"w": ParamSpec((d_in, d_out), axes, scale=scale)}
    if use_bias:
        spec["b"] = ParamSpec((d_out,), (axes[1],), init="zeros")
    return spec


def apply_dense(params, x: torch.Tensor) -> torch.Tensor:
    # the weight is cast to the compute dtype on every call, as the reference
    # does (layers.py:98); caching a cast copy is left to a later change
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def init_embedding(vocab: int, d: int):
    return {"table": ParamSpec((vocab, d), ("vocab", "embed"), scale=1.0)}


def apply_embedding(params, tokens: torch.Tensor, compute_dtype) -> torch.Tensor:
    # the table's gradient comes back in its own placements from each use, so
    # that a tied table's two gradients add (some DTensor versions cannot
    # turn one's shard into the other's partial sum: whisper's train_4k)
    table = sharding.grad_as_forward(params["table"]).to(compute_dtype)
    if not sharding.is_dtensor(table):
        return table[tokens]
    # DTensor's index and index_put (the lookup's backward) lack a working
    # sharding strategy in some versions: every rank gathers the table and
    # looks up its own tokens; its gradient of the table is a partial sum over
    # the ranks that split the tokens
    mesh = table.device_mesh
    tokens = sharding.replicated(tokens, mesh)
    dims = set(range(tokens.ndim))
    tp = sharding.follow(tokens.placements, {d: d for d in dims})
    grad = sharding.grad_placements(tp, {}, dims)
    return sharding.local_map(lambda t, ids: t[ids], tp, (sharding.follow(tp, {}), tp), mesh,
                              in_grad_placements=(grad, None))(table, tokens)


def apply_unembed(params, x: torch.Tensor,
                  logit_softcap: float | None = None) -> torch.Tensor:
    """Project to vocabulary (optionally shared with the embedding table)."""
    logits = x @ sharding.grad_as_forward(params["table"]).to(x.dtype).T
    if logit_softcap:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    return logits


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    base = torch.tensor(theta, dtype=torch.float32, device=device)
    return 1.0 / torch.pow(base, exponent)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq].

    Split-half convention: the first and second halves of head_dim rotate
    as pairs, computed in fp32.
    """
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs  # [..., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(d_model: int, d_ff: int, mlp_type: str, use_bias: bool = False):
    if mlp_type == "swiglu":
        return {
            "gate": init_dense(d_model, d_ff, ("embed", "mlp"), use_bias),
            "up": init_dense(d_model, d_ff, ("embed", "mlp"), use_bias),
            "down": init_dense(d_ff, d_model, ("mlp", "embed"), use_bias),
        }
    return {
        "up": init_dense(d_model, d_ff, ("embed", "mlp"), use_bias),
        "down": init_dense(d_ff, d_model, ("mlp", "embed"), use_bias),
    }


def apply_mlp(params, x: torch.Tensor, mlp_type: str) -> torch.Tensor:
    if mlp_type == "swiglu":
        h = F.silu(apply_dense(params["gate"], x)) * apply_dense(params["up"], x)
    else:
        h = F.gelu(apply_dense(params["up"], x), approximate="tanh")
    h = shard(h, *(("batch",) + ("seq",) * (h.ndim - 2) + ("mlp",)))
    return apply_dense(params["down"], h)


# ---------------------------------------------------------------------------
# Softmax cross-entropy
# ---------------------------------------------------------------------------


def _token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold


def _token_nll_per_shard(logits, labels) -> torch.Tensor:
    """:func:`_token_nll` of DTensor logits, per rank on its positions: the
    vocabulary is gathered whole (DTensor's gather over a vocab-sharded dim
    leaves a masked partial that its reduction mishandles), the labels follow
    the logits' other placements."""
    mesh = logits.device_mesh
    lp = sharding.follow(logits.placements, {d: d for d in range(logits.ndim - 1)})
    return sharding.local_map(_token_nll, lp, (lp, lp), mesh)(
        logits, sharding.replicated(labels, mesh))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean next-token loss in f32.  logits [..., V]; labels int [...]; the
    optional mask weights each position (the mean over its sum, at least 1)."""
    logits = logits.float()
    if sharding.is_dtensor(logits):
        nll = _token_nll_per_shard(logits, labels)
    else:
        nll = _token_nll(logits, labels)
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
