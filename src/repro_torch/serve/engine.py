"""Batched serving engine: prefill + lockstep decode with KV/state caches.

Counterpart of ``repro/serve/engine.py`` for every family: the attention
families keep a KV cache, zamba2 its SSM states, conv windows and the shared
block's KV caches, xLSTM its mLSTM and sLSTM states, whisper a decoder
self-cache and the cross K/V of the encoded frames, all behind
``Model.prefill``/``decode_step``.  Whisper's frames go to ``generate``
directly; ``BatchAccumulator`` does not pass them on (it drops a request's
keyword arguments, as the reference's does).
Requests are grouped into generation batches (arrival-window batching); each
batch is prefilled once and decoded in lockstep, with per-row EOS masking.
Left-pad tokens are attended to, as in the reference.

Greedy decoding takes the argmax of the last position (ties go to the first
index, as in JAX).  Sampled decoding is Gumbel-max on the logits with noise
from a ``torch.Generator`` seeded by ``seed``: the same distribution as
``jax.random.categorical``, not the same bits.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch import resolve_device, tracing
from repro_torch.models.model import Model


class ServeEngine:
    def __init__(
        self,
        model: Model,
        params,
        max_len: int = 512,
        eos_token: int | None = None,
        greedy: bool = True,
        seed: int = 0,
        device=None,
    ):
        self.model = model
        self.params = params
        self.max_len = max_len
        self.eos = eos_token
        self.greedy = greedy
        self.device = resolve_device(device)
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.stats = {"requests": 0, "batches": 0, "tokens_generated": 0,
                      "prefill_tokens": 0}

    # ------------------------------------------------------------------
    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        last = logits[:, -1, :].float()
        if not self.greedy:
            u = torch.rand(last.shape, generator=self.generator, device=self.device)
            u = u.clamp_(min=torch.finfo(torch.float32).tiny)
            last = last - torch.log(-torch.log(u))  # + Gumbel noise
        return torch.argmax(last, dim=-1).to(torch.int32).cpu().numpy()

    @torch.inference_mode()
    def generate(
        self,
        prompts: np.ndarray,                     # [B, S_prompt] int32
        max_new_tokens: int = 32,
        frames: np.ndarray | None = None,        # encdec
        pixel_embeds: np.ndarray | None = None,  # vlm
    ) -> dict:
        """Generate for a batch of equal-length prompts."""
        B, S = prompts.shape
        self.stats["requests"] += B
        self.stats["batches"] += 1
        self.stats["prefill_tokens"] += int(B * S)
        with tracing.span("serve.generate", B=B, S=S) as phase:
            batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long,
                                               device=self.device)}
            if frames is not None:
                batch["frames"] = torch.as_tensor(frames, device=self.device)
            if pixel_embeds is not None:
                batch["pixel_embeds"] = torch.as_tensor(pixel_embeds, device=self.device)
            with tracing.span("serve.prefill"):
                logits, cache = self.model.prefill(self.params, batch, self.max_len)
            position = S

            out = []
            done = np.zeros(B, bool)
            for step in range(max_new_tokens):
                # the sample's copy to the host, and the next token's back
                with tracing.span("serve.sample"):
                    cur = self._sample(logits)
                    out.append(np.where(done, self.eos or 0, cur))
                    if self.eos is not None:
                        done |= cur == self.eos
                    last = step == max_new_tokens - 1 or (self.eos is not None
                                                          and bool(done.all()))
                    if not last:
                        tokens = torch.as_tensor(cur[:, None], dtype=torch.long,
                                                 device=self.device)
                if last:
                    break
                with tracing.span("serve.decode_step", step=step):
                    logits, cache = self.model.decode_step(self.params, tokens, cache,
                                                           position)
                position += 1
            generated = np.stack(out, axis=1) if out else np.zeros((B, 0), np.int32)
            phase.set(new_tokens=int(generated.shape[1]))
        self.stats["tokens_generated"] += int(generated.size)
        return {"tokens": generated, "prompt_len": S}


class BatchAccumulator:
    """Arrival-window request batching: collect up to ``max_batch`` requests
    (left-padding prompts to the longest in the batch) before dispatching to
    the engine."""

    def __init__(self, engine: ServeEngine, max_batch: int = 8,
                 pad_token: int = 0):
        self.engine = engine
        self.max_batch = max_batch
        self.pad = pad_token
        self._pending: list[tuple[np.ndarray, dict, int]] = []

    def submit(self, prompt: np.ndarray, **kw) -> None:
        # the submit time (perf_counter_ns) where tracing is on, for queue waits
        t = time.perf_counter_ns() if tracing.enabled() else 0
        self._pending.append((np.asarray(prompt, np.int32), kw, t))

    def _batch_attrs(self, chunk: list, width: int) -> dict:
        """serve.batch's counts: requests, width, prompt and pad tokens, and the
        requests' queue waits (submit to the batch's start, seconds)."""
        real = sum(len(p) for p, _, _ in chunk)
        now = time.perf_counter_ns()
        waits = [(now - t) * 1e-9 for _, _, t in chunk if t]
        return {"requests": len(chunk), "width": width, "prompt_tokens": real,
                "pad_tokens": len(chunk) * width - real,
                "queue_wait_s_sum": sum(waits), "queue_wait_s_max": max(waits, default=0.0)}

    def flush(self, max_new_tokens: int = 32) -> list[dict]:
        results = []
        while self._pending:
            chunk = self._pending[: self.max_batch]
            self._pending = self._pending[self.max_batch:]
            width = max(len(p) for p, _, _ in chunk)
            attrs = self._batch_attrs(chunk, width) if tracing.enabled() else {}
            with tracing.span("serve.batch", **attrs):
                batch = np.full((len(chunk), width), self.pad, np.int32)
                for i, (p, _, _) in enumerate(chunk):
                    batch[i, width - len(p):] = p  # left-pad
                out = self.engine.generate(batch, max_new_tokens=max_new_tokens)
            for i in range(len(chunk)):
                results.append(
                    {"tokens": out["tokens"][i], "prompt_len": len(chunk[i][0])}
                )
        return results
