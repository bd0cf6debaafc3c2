"""Weights for tests and for the checks on the card.

``Model.init``, like the reference's init, takes a weight's fan-in from its
first axis, which for stacked leaves is the stacking axis (2 for zamba2
SMOKE's ``groups``, 13 at full depth); the weights then come out several
times too large, and zamba2's stack amplifies f32 rounding some 10^4-fold,
past any useful tolerance.  Init also leaves some leaves inert: ``A_log``
ones (every head shares one A, so a wrong head index would pass), ``D`` ones,
``dt_bias``, ``conv_b`` and every bias zeros, and the LoRA
``qkv_b``/``mlp_b`` zeros (a LoRA fault could not show).  xLSTM stacks its mLSTM blocks
twice, so their fan-in is the number of super-blocks.
:func:`redraw_params_` draws every leaf anew.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L


# biases: dense and norm biases, xLSTM's per-gate b_z, b_i, b_f, b_o
BIASES = ("b", "bias", "conv_b", "b_z", "b_i", "b_f", "b_o")
# per-channel gains: norm scales, Mamba2's D, xLSTM's head_norm and skip
GAINS = ("D", "scale", "norm_scale", "head_norm", "skip")


def redraw_params_(params, seed: int) -> None:
    """Redraws every leaf of ``params`` in place from ``seed``, on the params'
    device, in ``jax.tree_util``'s leaf order: weights (2-D and up) N(0, 1/d_in)
    with d_in their second-to-last axis; ``A_log`` U(-1, 1); gains (``GAINS``)
    U(0.5, 1.5); ``dt_bias`` N(0, 0.5^2); biases (``BIASES``) N(0, 0.1^2)."""
    leaves = list(L.flatten_specs(params))
    gen = torch.Generator(leaves[0][1].device).manual_seed(seed)
    for path, t in leaves:
        name = path[-1]
        if name == "A_log":
            t.uniform_(-1.0, 1.0, generator=gen)
        elif name in GAINS:
            t.uniform_(0.5, 1.5, generator=gen)
        elif name == "dt_bias":
            t.normal_(0.0, 0.5, generator=gen)
        elif name in BIASES:
            t.normal_(0.0, 0.1, generator=gen)
        else:
            t.normal_(0.0, t.shape[-2] ** -0.5, generator=gen)
