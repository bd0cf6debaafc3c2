"""Gradient compression: counterpart of ``repro/parallel/compression.py``.

Two mechanisms:

* ``bf16`` - gradients are taken with respect to a bfloat16 copy of the
  parameters, so the whole backward runs in bf16, and with it the gradient
  redistributions DTensor inserts under a mesh (half the bytes).  The f32
  master copy is touched only by the optimizer.
* ``int8`` + error feedback - for the elastic trainer's cross-pod sync path:
  symmetric per-tensor scaling, the residual carried in an error-feedback
  buffer so that compression noise does not accumulate.  ``torch.round``
  rounds half to even, as ``jnp.round`` does, so ``q`` is the reference's
  bit for bit.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L


def grads_in_bf16(loss_fn, params, *args):
    """``(loss, grads)`` of ``loss_fn`` with respect to a bf16 copy of every
    floating-point leaf of ``params``; the gradients are bf16."""
    params_bf16 = L.map_tree(
        lambda p: p.detach().to(torch.bfloat16) if p.is_floating_point() else p, params)
    return L.value_and_grad(loss_fn, params_bf16, *args)


# ---------------------------------------------------------------------------
# int8 + error feedback (cross-pod sync path)
# ---------------------------------------------------------------------------


def init_error_feedback(params):
    return L.map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def compress_int8(x: torch.Tensor, error: torch.Tensor):
    """Returns (q: int8 tensor, scale: f32 scalar, new_error)."""
    x32 = x.float() + error
    scale = torch.clamp(torch.max(torch.abs(x32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    decoded = q.float() * scale
    return q, scale, x32 - decoded


def decompress_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale


def compress_tree_int8(tree, error_tree):
    """Compress a gradient tree; returns (payload, new_error_tree).

    ``payload`` has the tree's structure with a ``(q, scale)`` pair at each
    leaf: 4x smaller on the wire than f32.
    """
    pairs = [(path, compress_int8(x, e)) for (path, x), (_, e)
             in zip(L.flatten_specs(tree), L.flatten_specs(error_tree))]
    payload = L.unflatten((path, (q, scale)) for path, (q, scale, _) in pairs)
    return payload, L.unflatten((path, err) for path, (_, _, err) in pairs)


def decompress_tree_int8(payload):
    return L.map_tree(lambda qs: decompress_int8(*qs), payload)
