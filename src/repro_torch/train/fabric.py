"""TrainingFabric: the compute-plane object the automation flows drive.
Counterpart of ``repro/train/fabric.py:39-210``.

The paper's pattern is funcX-mediated: flows invoke *registered functions*
on *compute endpoints*.  ``TrainingFabric`` owns a model, its optimizer state
and a data source on one device and exposes exactly such functions
(``train_steps``, ``evaluate``, ``save_checkpoint``, ``restore_latest``,
``export_metrics``), which launchers register with the Compute action
provider of the port's control plane (:mod:`repro_torch.core`).  Fault
tolerance: ``inject_failure_at`` makes a training action raise
:class:`repro_torch.core.errors.NodeFailure` at a chosen step; flows catch it
and route to a restore state.

``mesh`` (a ``DeviceMesh`` with the reference's axis names, see
:mod:`repro_torch.launch.mesh`): params, m and v are DTensors placed by
``param_shardings(param_axes, mesh, PARAM_RULES, param_shapes=)``, the step
stays a plain tensor equal on every rank (replicated), and the train step runs
under ``use_rules(PARAM_RULES, ACT_RULES, mesh)``.  Every rank of the mesh
builds the same fabric and calls the same functions in the same order (SPMD).
``reshard(mesh)`` is the elastic rescale: it restores the latest checkpoint
onto the new mesh's placements.  A rank outside the new mesh drops its state
and reports ``member: False``; the mesh itself must have been built by every
rank of the world (:func:`repro_torch.launch.mesh.make_mesh`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device, tracing
from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.errors import NodeFailure
from repro_torch.models.model import Model, param_axes, param_shapes
from repro_torch.parallel.sharding import (
    ACT_RULES,
    PARAM_RULES,
    distribute_tree,
    param_shardings,
    use_rules,
)
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.data import SyntheticTokens
from repro_torch.train.loop import TrainState, init_state, make_eval_step, make_train_step
from repro_torch.train.optimizer import AdamWState, init_adamw


class TrainingFabric:
    def __init__(
        self,
        model_cfg: ModelConfig,
        train_cfg: TrainConfig,
        batch: int,
        seq_len: int,
        ckpt_dir: str,
        data=None,
        seed: int = 0,
        device=None,
        mesh=None,
    ):
        """``device``: where the state lives and the steps run (default CUDA;
        under a CUDA mesh, the rank's current CUDA device).  The params are
        drawn from ``train_cfg.seed``, the same on every rank, the synthetic
        data (when no ``data`` is given) from ``seed``."""
        self.model_cfg = model_cfg
        self.train_cfg = train_cfg
        self.batch = batch
        self.seq_len = seq_len
        self.ckpt_dir = ckpt_dir
        self.device = resolve_device(device)
        self.mesh = mesh
        self.axes, self.shapes = param_axes(model_cfg), param_shapes(model_cfg)
        self.data = data or SyntheticTokens(model_cfg.vocab_size, batch, seq_len, seed=seed)
        self.model = Model(model_cfg)
        self.state: TrainState | None = None
        self.history: list[dict] = []
        self.inject_failure_at: int | None = None
        self.checkpointer = ckpt.AsyncCheckpointer(ckpt_dir)
        self._build()

    # ------------------------------------------------------------- plumbing
    def _shardings(self):
        """(params' shardings, the state's: m and v follow the params, the
        step is left plain), or (None, None) without a mesh."""
        if self.mesh is None:
            return None, None
        p_sh = param_shardings(self.axes, self.mesh, PARAM_RULES, param_shapes=self.shapes)
        return p_sh, TrainState(params=p_sh, opt=AdamWState(step=None, m=p_sh, v=p_sh))

    def _build(self):
        if self.state is None:
            gen = torch.Generator(self.device).manual_seed(self.train_cfg.seed)
            if self.mesh is None:
                self.state = init_state(self.model, gen, self.device)
            else:
                # placed before the moments are made, which then follow them
                params = distribute_tree(self.model.init(gen, self.device),
                                         self._shardings()[0])
                self.state = TrainState(params, init_adamw(params),
                                        self.model.init_buffers(self.device))
        grad_sh = self._shardings()[0]
        train_step = make_train_step(self.model, self.train_cfg, grad_shardings=grad_sh)
        eval_step = make_eval_step(self.model)
        if self.mesh is not None:
            mesh = self.mesh

            def in_rules(fn):
                def wrapped(*args):
                    with use_rules(PARAM_RULES, ACT_RULES, mesh):
                        return fn(*args)
                return wrapped

            train_step, eval_step = in_rules(train_step), in_rules(eval_step)
        self._train_step, self._eval_step = train_step, eval_step
        self._data_iter = iter(self.data)

    def _to_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    # ------------------------------------------------------------ functions
    def train_steps(self, n_steps: int = 10, **_) -> dict:
        """Run n training steps; raises NodeFailure at the injected step."""
        t0 = time.perf_counter()
        metrics = {}
        with tracing.span("fabric.train_steps", n_steps=n_steps):
            for _ in range(n_steps):
                with tracing.span("fabric.step") as step_span:
                    with tracing.span("fabric.step_sync"):
                        step_now = int(self.state.step)
                    if self.inject_failure_at is not None and step_now >= self.inject_failure_at:
                        self.inject_failure_at = None
                        raise NodeFailure(f"simulated device loss at step {step_now}")
                    with tracing.span("fabric.batch"):
                        batch = self._to_device(next(self._data_iter))
                    step_span.set(step=step_now, tokens=batch["tokens"].numel())
                    self.state, metrics = self._train_step(self.state, batch)
            metrics = {k: float(v) for k, v in metrics.items()}
        record = {"step": int(self.state.step), "seconds": time.perf_counter() - t0,
                  **metrics}
        self.history.append(record)
        return record

    def evaluate(self, n_batches: int = 2, **_) -> dict:
        losses = [
            float(self._eval_step(self.state.params,
                                  self._to_device(self.data.batch_at(10_000 + i)),
                                  self.state.buffers)["loss"])
            for i in range(n_batches)
        ]
        return {"eval_loss": float(np.mean(losses)), "step": int(self.state.step)}

    def save_checkpoint(self, synchronous: bool = True, **_) -> dict:
        step = int(self.state.step)
        if synchronous:
            path = ckpt.save(self.ckpt_dir, step, self.state)
        else:
            self.checkpointer.save(step, self.state)
            path = f"{self.ckpt_dir}/step_{step:08d} (async)"
        return {"checkpoint": path, "step": step}

    def restore_latest(self, **_) -> dict:
        """The latest checkpoint, each leaf placed straight onto the mesh's
        placements (or plain without a mesh)."""
        self.checkpointer.wait()
        self.state, meta = ckpt.restore(self.ckpt_dir, self.state,
                                        shardings=self._shardings()[1])
        return {"restored_step": meta["step"]}

    def reshard(self, mesh, **_) -> dict:
        """Elastic rescale: rebuild the step for ``mesh`` (or None) and restore
        the latest checkpoint onto it.  Returns the old and new mesh shapes,
        the restored step and whether this rank is in the new mesh; a rank
        that is not drops its state (its flow should end there)."""
        self.checkpointer.wait()
        old = tuple(self.mesh.shape) if self.mesh is not None else None
        new = tuple(mesh.shape) if mesh is not None else None
        self.mesh = mesh
        if mesh is not None and mesh.get_coordinate() is None:
            self.state = None
            return {"old_mesh": old, "new_mesh": new, "member": False}
        self._build()
        return {"old_mesh": old, "new_mesh": new, "member": True, **self.restore_latest()}

    def export_metrics(self, **_) -> dict:
        return {"history": self.history[-20:], "step": int(self.state.step)}

    # -------------------------------------------------------- registration
    def register_all(self, compute_provider, endpoint_name="training-fabric",
                     mode="inline") -> dict:
        """Register every fabric function with a Compute action provider.

        Returns {"endpoint_id": ..., "functions": {name: function_id}}.
        """
        eid = compute_provider.register_endpoint(endpoint_name, mode=mode)
        fns = {}
        for name in ("train_steps", "evaluate", "save_checkpoint",
                     "restore_latest", "export_metrics"):
            fns[name] = compute_provider.register_function(getattr(self, name), name=name)
        return {"endpoint_id": eid, "functions": fns}
