"""The benchmark's weights, drawn from ``--seed`` on the device.

The draw rules are a frozen copy of the port's ``redraw_params_``
(``repro_torch/testing.py``): weights (2-D and up) N(0, 1/d_in) with d_in
their second-to-last axis, gains (norm scales) U(0.5, 1.5), biases
N(0, 0.1^2).  One ``torch.Generator`` on the device draws every leaf in
sorted-key order, one call a leaf (a leaf stacks all layers), in the dtype the
weights are served in.  The same seed gives the same tensors, so the
reference can draw them again instead of keeping a copy.
"""

from __future__ import annotations

import torch

BIASES = ("b", "bias", "conv_b", "b_z", "b_i", "b_f", "b_o")
GAINS = ("D", "scale", "norm_scale", "head_norm", "skip")


def leaves(tree, prefix: tuple = ()):
    """(path, leaf) pairs in sorted-key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaves(tree[key], prefix + (key,))
    else:
        yield prefix, tree


def draw_into(params, seed: int) -> None:
    """Draws every leaf of ``params`` in place from ``seed``."""
    pairs = list(leaves(params))
    gen = torch.Generator(pairs[0][1].device).manual_seed(int(seed))
    with torch.no_grad():
        for path, t in pairs:
            name = path[-1]
            if name in GAINS:
                t.uniform_(0.5, 1.5, generator=gen)
            elif name in BIASES:
                t.normal_(0.0, 0.1, generator=gen)
            elif t.dim() >= 2:
                t.normal_(0.0, t.shape[-2] ** -0.5, generator=gen)
            else:
                raise ValueError(f"no draw rule for the 1-D leaf {'/'.join(path)}")


def draw(shapes, seed: int, device, dtype=torch.float32):
    """A new tree of tensors of the given shapes (a nested dict of tuples),
    drawn from ``seed``."""
    def make(tree):
        if isinstance(tree, dict):
            return {k: make(v) for k, v in tree.items()}
        return torch.empty(tuple(tree), dtype=dtype, device=device)

    params = make(shapes)
    draw_into(params, seed)
    return params
