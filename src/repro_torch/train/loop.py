"""Train loop: ``TrainState``, the train step with microbatch accumulation, and
the evaluation step.  Counterpart of ``repro/train/loop.py``.

``make_train_step(model, train_cfg)`` returns ``train_step(state, batch) ->
(state, metrics)``, a function of tensors, run eagerly (the reference jits
the same function).  Gradients come from ``torch.autograd.grad`` with respect
to every floating-point leaf of the params
(:func:`repro_torch.models.layers.value_and_grad`), or with respect to their
bf16 copies under ``grad_compression="bf16"``.  With ``microbatches`` > 1 the
batch is split along its first axis and the gradients are summed in f32 and
divided by the count, as the reference's ``lax.scan`` does.  The optimizer
updates the state's params, m and v in place
(:func:`repro_torch.train.optimizer.adamw_update`); a caller that needs the
state before the step keeps a copy (a checkpoint, or ``clone``).  The
reference's ``grad_shardings`` comes with sharding (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.parallel.compression import grads_in_bf16
from repro_torch.train import optimizer as opt


class TrainState(NamedTuple):
    params: dict
    opt: opt.AdamWState

    @property
    def step(self) -> torch.Tensor:
        return self.opt.step


def init_state(model: Model, generator: torch.Generator, device=None) -> TrainState:
    """Params from ``model.init(generator, device)`` and a zeroed AdamW state.
    (The reference also returns the params' logical sharding axes, which the
    port does not have yet.)"""
    params = model.init(generator, device=device)
    return TrainState(params=params, opt=opt.init_adamw(params))


def _split_microbatches(batch: dict, n: int) -> dict:
    def split(x):
        b = x.shape[0]
        assert b % n == 0, f"global batch {b} % microbatches {n} != 0"
        return x.reshape(n, b // n, *x.shape[1:])

    return {key: split(x) for key, x in batch.items()}


def make_train_step(model: Model, tcfg: TrainConfig):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm", "lr"})``,
    the metrics 0-dim f32 tensors on the params' device; the state passed in
    is updated in place and returned with its new step."""

    def grad_fn(params, mb):
        if tcfg.grad_compression == "bf16":
            return grads_in_bf16(model.loss, params, mb)
        return L.value_and_grad(model.loss, params, mb)

    def train_step(state: TrainState, batch: dict):
        if tcfg.microbatches > 1:
            mbs = _split_microbatches(batch, tcfg.microbatches)
            loss_sum = torch.zeros((), dtype=torch.float32, device=state.step.device)
            grads = L.map_tree(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                     device=p.device), state.params)
            for i in range(tcfg.microbatches):
                loss, mb_grads = grad_fn(state.params, {k: v[i] for k, v in mbs.items()})
                for (_, acc), (_, g) in zip(L.flatten_specs(grads),
                                            L.flatten_specs(mb_grads)):
                    acc.add_(g.float())
                loss_sum = loss_sum + loss
            loss = loss_sum / tcfg.microbatches
            for _, g in L.flatten_specs(grads):
                g.div_(tcfg.microbatches)
        else:
            loss, grads = grad_fn(state.params, batch)

        params, opt_state, metrics = opt.adamw_update(state.params, grads, state.opt, tcfg)
        return TrainState(params, opt_state), {"loss": loss.float(), **metrics}

    return train_step


def make_eval_step(model: Model):
    """``eval_step(params, batch) -> {"loss": f32 scalar}``, run without autograd."""

    @torch.inference_mode()
    def eval_step(params, batch):
        return {"loss": model.loss(params, batch).float()}

    return eval_step
