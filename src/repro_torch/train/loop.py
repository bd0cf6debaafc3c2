"""Evaluation step: counterpart of ``make_eval_step`` in
``repro/train/loop.py:102-107``.  The training step, microbatching and the
optimizer come with the training slice (see ROADMAP.md).
"""

from __future__ import annotations

import torch

from repro_torch.models.model import Model


def make_eval_step(model: Model):
    """``eval_step(params, batch) -> {"loss": f32 scalar}``, run without autograd."""

    @torch.inference_mode()
    def eval_step(params, batch):
        return {"loss": model.loss(params, batch).float()}

    return eval_step
