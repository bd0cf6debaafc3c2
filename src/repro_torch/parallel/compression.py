"""Gradient compression: counterpart of ``repro/parallel/compression.py``.

Only the bf16 mechanism is ported: gradients are taken with respect to a
bfloat16 copy of the parameters, so the whole backward runs in bf16 (in the
reference that halves the bytes of the FSDP and data-parallel gradient
collectives XLA inserts).  The f32 master copy is touched only by the
optimizer.  The int8 error-feedback path of the elastic trainer comes with
sharding (ROADMAP.md).
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
