"""The numbers that decide ``correct``, from the program's outputs and the
reference's."""

from __future__ import annotations

import statistics

import torch


def gaps(ref_logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """At every position, the gap by which the logit the reference gives the
    chosen token lies below the reference's best: 0 where they agree.
    ref_logits [B, n, V] f32, tokens [B, n] -> [B, n]."""
    chosen = ref_logits.gather(-1, tokens.long().to(ref_logits.device)[..., None])[..., 0]
    return ref_logits.amax(-1) - chosen


def widest_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    return float(gaps(ref_logits, tokens).max())


def serve_numbers(ref_logits: torch.Tensor, tokens: torch.Tensor,
                  logits: torch.Tensor) -> dict:
    """The served batch's numbers, from the reference's f32 logits, the served
    tokens and the logits the program chose them from (all [B, n, ...]):

    * served_gap: the widest gap, over every served token, by which its
      reference logit lies below the reference's best;
    * logits_rel_l2: the program's logits against the reference's,
      ||program - reference|| / ||reference|| over every served position;
    * served_not_argmax: how many served tokens are not the first largest of
      the program's own logits (greedy decoding): exactly 0.
    """
    logits = logits.to(ref_logits.device).float()
    diff = torch.linalg.vector_norm((logits - ref_logits).double())
    chosen = logits.argmax(-1).cpu()
    return {"served_gap": widest_gap(ref_logits, tokens),
            "logits_rel_l2": float(diff / torch.linalg.vector_norm(ref_logits.double())),
            "served_not_argmax": float((chosen != tokens.long().cpu()).sum())}


def _leaf_gap(prog: dict, ref: dict, keys) -> float:
    """The worst leaf's gap between the two sides' norms, over the larger of
    that leaf's reference norm and the median leaf's."""
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keys)


def train_numbers(prog: dict, ref: dict) -> dict:
    """loss_gap: the worst step's relative gap of the loss; grad_gap: of the
    first gradient's norm, by the worst leaf; change_gap: of the parameters'
    change after the steps, by the worst leaf, leaving out leaves whose
    reference gradient is under a thousandth of the median leaf's (they move
    by round-off alone)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moving = [k for k in g if g[k] >= 1e-3 * med]
    return {"loss_gap": loss_gap,
            "grad_gap": _leaf_gap(prog["grad_norms"], g, list(g)),
            "change_gap": _leaf_gap(prog["change_norms"], ref["change_norms"], moving)}
