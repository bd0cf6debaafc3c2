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
state's ``buffers`` (:meth:`repro_torch.models.model.Model.init_buffers`:
DeepSeek-V3's router correction biases) get no gradient and no AdamW: the
forward reads them, and after AdamW each bias takes its balance rule's step
from the step's expert counts (:meth:`repro_torch.models.moe.Balance.update_`).

Sharded training: the params (and so m and v) are DTensors placed by
:func:`repro_torch.parallel.sharding.param_shardings`, and the step is called
under ``use_rules(PARAM_RULES, ACT_RULES, mesh)``
(:class:`repro_torch.train.fabric.TrainingFabric` does both).  Each
microbatch, split from the plain batch, enters the mesh by its "batch" axis
(:func:`repro_torch.parallel.sharding.distribute_input`); the gradients are
redistributed to ``grad_shardings`` (else to their params' placements) right
after the backward.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import tracing
from repro_torch.configs.base import TrainConfig
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.parallel import sharding
from repro_torch.parallel.compression import grads_in_bf16
from repro_torch.train import optimizer as opt


class TrainState(NamedTuple):
    params: dict
    opt: opt.AdamWState
    buffers: dict = {}  # no leaf for a model without any, as the reference lays it out

    @property
    def step(self) -> torch.Tensor:
        return self.opt.step


def init_state(model: Model, generator: torch.Generator, device=None) -> TrainState:
    """Params from ``model.init(generator, device)`` and a zeroed AdamW state.

    The reference returns ``(state, axes)``; this returns the state alone, and
    the params' logical axes come from
    :func:`repro_torch.models.model.param_axes` (``param_axes(model.cfg)``),
    which builds them without making a tensor."""
    params = model.init(generator, device=device)
    return TrainState(params=params, opt=opt.init_adamw(params),
                      buffers=model.init_buffers(device))


def _split_microbatches(batch: dict, n: int) -> dict:
    def split(x):
        b = x.shape[0]
        assert b % n == 0, f"global batch {b} % microbatches {n} != 0"
        return x.reshape(n, b // n, *x.shape[1:])

    return {key: split(x) for key, x in batch.items()}


def _place_grads(grads, params, grad_shardings):
    """Each DTensor gradient redistributed to its leaf of ``grad_shardings``
    (a tree of ``(mesh, placements)``), or without one to its param's
    placements, which the in-place optimizer needs."""
    def place(g, p, sh):
        if not sharding.is_dtensor(g):
            return g
        mesh, target = sh if sh is not None else (p.device_mesh, tuple(p.placements))
        return g if tuple(g.placements) == tuple(target) else g.redistribute(mesh, target)

    shs = grad_shardings if grad_shardings is not None else L.map_tree(lambda _: None, params)
    return L.unflatten((path, place(g, p, sh)) for (path, g), (_, p), (_, sh) in zip(
        L.flatten_specs(grads), L.flatten_specs(params), L.flatten_specs(shs)))


def make_train_step(model: Model, tcfg: TrainConfig, grad_shardings=None):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm", "lr"})``,
    the metrics 0-dim f32 tensors on the params' device (whole on every rank
    under a mesh); the state passed in is updated in place and returned with
    its new step.

    ``grad_shardings`` (a tree of :class:`repro_torch.parallel.sharding.Sharding`
    matching the params): the placements the gradients are redistributed to
    right after the backward, the reference's ``with_sharding_constraint``
    on them (a reduce-scatter where the backward left a partial sum)."""

    def grad_fn(params, mb, balance):
        with tracing.span("train.grad"):
            mb = {k: sharding.distribute_input(v, "batch", *(None,) * (v.dim() - 1))
                  for k, v in mb.items()}
            # a model without buffers is called as it always was, (params, batch)
            args = (mb,) if balance is None else (mb, balance)
            if tcfg.grad_compression == "bf16":
                loss, grads = grads_in_bf16(model.loss, params, *args)
            else:
                loss, grads = L.value_and_grad(model.loss, params, *args)
            if balance is not None:
                balance.end_forward()
            return loss, _place_grads(grads, params, grad_shardings)

    def train_step(state: TrainState, batch: dict):
        balance = model.balance(state.buffers)
        if tcfg.microbatches > 1:
            mbs = _split_microbatches(batch, tcfg.microbatches)
            loss_sum = torch.zeros((), dtype=torch.float32, device=state.step.device)
            grads = L.map_tree(lambda p: torch.zeros_like(p, dtype=torch.float32),
                               state.params)
            for i in range(tcfg.microbatches):
                loss, mb_grads = grad_fn(state.params, {k: v[i] for k, v in mbs.items()},
                                         balance)
                for (_, acc), (_, g) in zip(L.flatten_specs(grads),
                                            L.flatten_specs(mb_grads)):
                    acc.add_(g.float())
                loss_sum = loss_sum + loss
            loss = loss_sum / tcfg.microbatches
            for _, g in L.flatten_specs(grads):
                g.div_(tcfg.microbatches)
        else:
            loss, grads = grad_fn(state.params, batch, balance)

        with tracing.span("train.adamw"):
            params, opt_state, metrics = opt.adamw_update(state.params, grads, state.opt, tcfg)
        if balance is not None:
            balance.update_(model.cfg.moe.bias_update)
        return TrainState(params, opt_state, state.buffers), {
            "loss": sharding.full_tensor(loss).float(), **metrics}

    return train_step


def make_eval_step(model: Model):
    """``eval_step(params, batch, buffers={}) -> {"loss": f32 scalar}``, run
    without autograd: under ``torch.inference_mode``, or under
    ``torch.no_grad`` for DTensor params (some DTensor versions cannot take a
    view of an ordinary DTensor under inference mode).  ``buffers``: the
    state's, whose router biases pick the experts."""

    def eval_step(params, batch, buffers=None):
        sharded = sharding.is_dtensor(next(L.flatten_specs(params))[1])
        balance = model.balance(buffers or {})
        with torch.no_grad() if sharded else torch.inference_mode():
            batch = {k: sharding.distribute_input(v, "batch", *(None,) * (v.dim() - 1))
                     for k, v in batch.items()}
            args = (batch,) if balance is None else (batch, balance)
            return {"loss": sharding.full_tensor(model.loss(params, *args)).float()}

    return eval_step
