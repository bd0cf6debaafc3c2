#!/usr/bin/env python3
"""Runs the PyTorch port's serving, evaluation and training paths on one NVIDIA
GPU and checks them.

    python3 chip_smoke.py

Phases, each of which raises on failure (a non-zero exit):

1. device   - the card's name and power limit; TF32 off for the comparisons;
2. build    - compiles the three CUDA kernels from ``src/repro_torch/kernels/csrc``
              into ``build/``, one nvcc per source, started together, and
              prints each kernel's registers, shared memory and spills; no
              bf16 kernel of the three may spill;
3. kernels  - each kernel's wrapper against its plain PyTorch version on the
              card, at its path's shape and at edge cases, with the route
              each case takes and times of the kernel, the plain version, the
              PyTorch library call that computes the same function (where
              one exists) and the card's bound; training's causal attention
              pair (forward with log-sum-exp, backward) at internlm2-1.8b's
              training shape, at moonlight's latent attention (q.k 192, v
              128) and edge cases, dq, dk and dv within one bf16 step of the
              plain backward;
4. serve    - full-width, full-depth internlm2-1.8b (random weights from a
              seed, bf16 compute, attention_impl="flash") serves 16 requests
              through BatchAccumulator and ServeEngine; flash_attention must
              launch 24 times per prefill batch; prefill logits through the
              kernel are held against the same port with attention_impl="xla",
              and a SMOKE model on the card against the same model on the CPU;
5. evaluate - full-width, full-depth zamba2-7b (81 Mamba2 layers, weights
              drawn from seed 0, f32 params, bf16 compute, "flash") runs
              make_eval_step on 2 batches of 8 x 512 tokens; mamba_scan must
              launch 81 times per batch; forward logits through the kernel are
              held against the same port with "xla" (ssd_chunked); one batch is
              profiled;
6. serve zamba2 - the same model serves 16 requests with no kernel launch, and
              a zamba2 SMOKE model on the card is held against the CPU;
7. mixtral-8x7b - full width, 8 of its 32 layers (f32 params, weights drawn
              from seed 0, bf16 compute, "flash"): make_eval_step on 2 batches
              of 8 x 512 tokens (flash_attention 8 launches a batch, gmm none),
              16 requests served (flash 8 a prefill batch, gmm none: no model
              path sets use_gmm, as in the reference), then
              apply_moe(use_gmm=True) against use_gmm=False on layer 0's real
              input (gmm 3 launches a call), and a mixtral SMOKE model on the
              card held against the CPU;
8. whisper-medium - full size (24 + 24 layers, d 1024, 16 heads of 64, f32
              params drawn from seed 0, bf16 compute, "flash"): make_eval_step
              on 2 batches of 8 x (1500 frames, 448 tokens), flash_attention 48
              launches a batch, 24 of them non-causal (the encoder); logits
              through flash held against xla (f32 at full depth, bf16 at the
              first encoder and decoder layer); ServeEngine.generate(frames=)
              on 2 batches of 8 requests (prompts of 4 and 64 tokens, 32 new
              tokens), 48 launches a prefill batch; a SMOKE model on the card
              held against the CPU;
    xlstm-1.3b - full size (42 mLSTM + 6 sLSTM blocks, d 2048, f32 params drawn
              from seed 0, bf16 compute): make_eval_step on 2 batches of 8 x
              512 with no kernel launched and the sLSTM blocks' share of a
              batch; 16 requests served through BatchAccumulator; 2 steps of
              make_train_step (remat "full"), finite loss and gradients in
              every leaf; a SMOKE model on the card held against the CPU;
    launcher - ``repro_torch.launch.serve.main`` for internlm2-1.8b, zamba2-7b,
              mixtral-8x7b and xlstm-1.3b, and ``--via-flows``, whose flow
              must end SUCCEEDED;
9. phi3-mini-3.8b - full width and depth (32 heads of 96, f32 params drawn
              from seed 0, bf16 compute, "flash"): one prefill batch of 8 x 512
              launches flash_attention 32 times, and its logits are held
              against attend_xla at internlm2's limits;
10. train   - full-width, full-depth internlm2-1.8b (1.889 B params, f32
              params and AdamW state, bf16 compute, "xla", remat "full", the
              config's own; weights drawn from seed 0) takes 5 steps of
              make_train_step on 8 x 512 SyntheticTokens batches: finite
              losses that fall, none of the three kernels launched (their
              Pallas originals have no backward) and the training attention
              pair 48 forward and 24 backward launches a step, step ms,
              tokens/s, model FLOP/s,
              peak memory, one step without remat and one saving the
              projections, a one-step profile; at 2 layers in f32 one step
              with microbatches=1 against microbatches=2; the training flow
              (FlowsService -> ap://compute -> TrainingFabric, 2 layers, a
              NodeFailure caught and restored from a checkpoint, checkpoint
              bytes and save and restore seconds); the training launcher at
              SMOKE; and a backward through each kernel route, which raises.
11. shard   - a world of one NCCL rank and a (1, 1) ("data", "model") mesh on
              the card (repro_torch.launch.mesh): internlm2-1.8b training at
              full size through TrainingFabric(mesh=...) against the
              unsharded fabric (2 steps, losses within 1e-3, step ms and
              peak memory of both); its flash prefill on the mesh (24
              launches a batch, per shard through local_map) against the
              unsharded one; SMOKE zamba2-7b eval (the scan per shard) and
              mixtral-8x7b apply_moe(use_gmm=True) (gmm per shard) against
              their unsharded runs; whisper-medium's flash prefill at full
              size (48 launches a batch, 24 non-causal, per shard) and
              xlstm-1.3b at full width and one super-block deep (2 training
              steps), each against its unsharded run; and the elastic flow at 2 layers, a
              NodeFailure caught and the state resharded onto the 1-D
              ("data",) mesh, which must end SUCCEEDED.
12. dryrun  - repro_torch.launch.dryrun on fake worlds of 256 and 512 ranks
              (the production meshes on "cuda", fake tensors, no allocation,
              no kernel launch): internlm2-1.8b train_4k, mixtral-8x7b
              prefill_32k, zamba2-7b long_500k on the 512-rank mesh and
              internlm2-1.8b prefill_32k through the flash kernel's custom op
              (one traced call a layer), xlstm-1.3b train_4k,
              whisper-medium prefill_32k, mixtral-8x7b decode_32k and
              xlstm-1.3b decode_32k must end ok, each with its roofline row,
              and the xLSTM cells and mixtral's decode under a ceiling of
              FLOPs a card (``DRYRUN_FLOP_CEILINGS``); each xLSTM cell is
              traced again with each head whole on its model ranks (every
              split of xLSTM's work over a head's ranks off), printed with
              its count of collectives and temp memory beside that trace's,
              and its wire bytes a card may exceed neither that trace's nor,
              for train_4k and decode_32k, ``DRYRUN_WIRE_CEILINGS``; then
              phase 10's step traced on a (1, 1) world, whose
              compute term may not exceed phase 10's measured median step.

The last seven lines of standard output are the xLSTM, training, shard and
dry-run phases' JSON records, the kernels' JSON record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --flash-ablation
    python3 chip_smoke.py --scan-ablation

time the bf16 attention kernel with its products, its softmax or its K/V
loads switched off, beside the full kernel and SDPA, and the bf16 scan with
its inter term, intra term or state update switched off, beside the full
kernel and the eager ssd_chunked: where their time goes.  They need CUDA and
the repository's ``src/``; without either they exit non-zero.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# the card's published peaks (H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
# f32: the reference's own tolerance (tests/kernels/test_kernels.py:20-21); bf16:
# both sides read the same bf16 inputs, compute in f32 and round the output
# once; the attention kernel also rounds P to bf16 before the PV product (up to
# 2^-9 of each term), so they differ by about one bf16 step of the output
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# Prefill logits through the kernel against the same port through attend_xla
# (relative L2).  In f32 at full depth the two differ only in summation order.
# In bf16 every layer rounds its activations, and both round P to bf16 before
# the PV product but at other points: the kernel rounds each tile's
# unnormalised p and divides by the f32 row sum at the end, attend_xla rounds
# the normalised softmax.  24 layers of random weights amplify that to several
# percent (the JAX package's own bf16 path does the same, see
# tests/test_torch_bf16.py), so bf16 is held at the first layer only.
PREFILL_F32_TOL = 1e-3
PREFILL_SHALLOW_BF16_TOL = 2e-2
SHALLOW_LAYERS = 1
# SMOKE model, f32, card vs CPU (kernel vs plain version inside)
SMOKE_TOL = 1e-4
# zamba2-7b forward logits through mamba_scan against ssd_chunked (relative
# L2): f32 at full depth, where the two differ only in summation order; bf16 at
# the first super-block (6 Mamba2 layers and one shared application), where
# each side rounds y to bf16 and a rare flip spreads through the later bf16
# layers.  The bf16 limit is twice the larger of the port's own flash-vs-xla
# distances on the CPU at reduced width, 1.67e-2 (d 448) and 1.87e-2 (d 896),
# from `python tests/test_torch_zamba.py`.
EVAL_F32_TOL = 1e-3
SUPERBLOCK_BF16_TOL = 3.75e-2
# mixtral-8x7b at full width and 8 of its 32 layers: 11.87 B params, 47.5 GB in
# f32, which leaves room on one 80 GB card for the per-call bf16 cast of one
# layer's experts (2.8 GB) and the eval logits
MIXTRAL_LAYERS = 8
# apply_moe(use_gmm=True) against use_gmm=False on the same input: f32 at the
# reference's own tolerance (tests/kernels/test_kernels.py:190).  bf16
# (relative L2): the two routes round at the same places and differ only where
# their f32 sums land on two sides of a bf16 rounding step.  The limit is twice
# the largest of the port's own distances on the CPU (gmm_ref against the bf16
# einsums, 8 experts top-2, `python tests/test_torch_moe.py`): 1.96e-4 to
# 3.48e-4 as the width doubles from d 512 to 2048, 3.83e-4 at d 2048 with the
# full d_ff 14336 (the down product's sum length) and 3.00e-4 at the full d
# 4096 with d_ff 3584 (the gate and up sum length).
GMM_ROUTE_F32_TOL = 2e-4
GMM_ROUTE_BF16_TOL = 7.7e-4


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call: CUDA events around ``iters`` calls.  The stream
    is first held by a spin kernel long enough for the host to enqueue them
    all (up to 50 ms), so a call that takes longer to issue than to run is
    timed by what it runs, not by its host overhead."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(min(iters * host_s, 0.05) * 2e9))  # cycles at <= 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

# name, dtype, B, S, T, H, K, D, causal, window, softcap.  Timed: internlm2's
# prefill (the slice shape of the kernels' JSON line), mixtral's eval and
# prefill (window 4096 >= T, so the mask is the causal one), the slice shape in
# f32, which runs on the FMA kernel, the two head dims whose rows are not a
# whole number of 128-byte slabs: phi3-mini's prefill (32 heads of 96) and
# zamba2's shared block (32 heads of 112), in bf16 and f32, and whisper-medium's
# bidirectional encoder (16 heads of 64 over 1500 frames).
SLICE_CASE = ("slice", "bfloat16", 8, 512, 512, 16, 8, 128, True, None, None)
WHISPER_ENCODER_CASE = ("whisper_encoder", "bfloat16", 8, 1500, 1500, 16, 16, 64, False, None,
                        None)
FLASH_TIMED = [
    SLICE_CASE,
    ("mixtral", "bfloat16", 8, 512, 512, 32, 8, 128, True, 4096, None),
    ("slice_f32", "float32", 8, 512, 512, 16, 8, 128, True, None, None),
    ("phi3_d96", "bfloat16", 8, 512, 512, 32, 32, 96, True, None, None),
    ("phi3_d96_f32", "float32", 8, 512, 512, 32, 32, 96, True, None, None),
    ("zamba2_d112", "bfloat16", 8, 512, 512, 32, 32, 112, True, None, None),
    ("zamba2_d112_f32", "float32", 8, 512, 512, 32, 32, 112, True, None, None),
    # whisper-medium's encoder: bidirectional over 1500 frames, ragged against
    # the 64-row and 64-column tiles in both directions, every K block visited
    WHISPER_ENCODER_CASE,
]
EDGE_CASES = [
    ("ragged", "bfloat16", 2, 100, 100, 16, 8, 128, True, None, None),
    ("ragged_f32", "float32", 2, 100, 100, 4, 2, 64, True, None, None),
    ("mha", "bfloat16", 2, 256, 256, 8, 8, 128, True, None, None),
    ("mqa", "bfloat16", 2, 256, 256, 8, 1, 128, True, None, None),
    ("d64", "bfloat16", 2, 256, 256, 8, 2, 64, True, None, None),
    ("d32_f32", "float32", 2, 128, 128, 4, 2, 32, True, None, None),
    ("d16_f32", "float32", 2, 128, 128, 4, 2, 16, True, None, None),
    ("window64", "bfloat16", 2, 300, 300, 8, 2, 128, True, 64, None),
    ("softcap30", "bfloat16", 2, 256, 256, 8, 2, 64, True, None, 30.0),
    ("noncausal", "bfloat16", 2, 200, 200, 8, 4, 128, False, None, None),
    ("s_lt_t_f32", "float32", 1, 64, 192, 4, 2, 64, True, None, None),
    # the bf16 tensor-core tiling: every head dim, lengths that are not
    # multiples of 16, S < T, a window off the 64-row tiles, G 4 with softcap
    ("d16", "bfloat16", 2, 128, 128, 4, 2, 16, True, None, None),
    ("d32", "bfloat16", 2, 128, 128, 4, 2, 32, True, None, None),
    ("s_lt_t", "bfloat16", 2, 64, 192, 8, 2, 128, True, None, None),
    ("s1", "bfloat16", 2, 1, 1, 8, 2, 128, True, None, None),
    ("s37", "bfloat16", 2, 37, 37, 8, 2, 64, True, None, None),
    ("s37_noncausal", "bfloat16", 2, 37, 100, 8, 2, 32, False, None, None),
    ("window100", "bfloat16", 2, 300, 300, 8, 2, 128, True, 100, None),
    ("g4_softcap", "bfloat16", 2, 256, 256, 16, 4, 128, True, None, 30.0),
    # head dims that are not 16, 32, 64 or 128: the bf16 tile's 64-byte (D 96)
    # and 32-byte (D 48, 80, 112) slabs and the per-slab PV products, in both
    # dtypes, with a window, a softcap, ragged lengths and S < T
    *[(f"d{d}{sfx}", dtype, 2, 128, 128, 4, 2, d, True, None, None)
      for d in (48, 80) for dtype, sfx in (("bfloat16", ""), ("float32", "_f32"))],
    *[(f"d{d}_{kind}{sfx}", dtype, 2, 300 if kind == "window" else 256,
       300 if kind == "window" else 256, 8, 2, d, True, 100 if kind == "window" else None,
       30.0 if kind == "softcap" else None)
      for d in (96, 112) for kind in ("window", "softcap")
      for dtype, sfx in (("bfloat16", ""), ("float32", "_f32"))],
    ("d80_s37", "bfloat16", 2, 37, 37, 8, 2, 80, True, 16, None),
    ("d112_s_lt_t", "bfloat16", 2, 64, 192, 8, 4, 112, True, None, None),
    ("d96_noncausal", "bfloat16", 2, 100, 200, 8, 8, 96, False, None, None),
]


def attention_bound_ms(case) -> tuple[float, str]:
    """Least time for the function: each input read once and the output written
    once at the HBM rate, or the QK^T and PV products over the unmasked pairs at
    the dtype's peak, whichever is larger."""
    import torch

    _, dtype, B, S, T, H, K, D, causal, window, _ = case
    esize = torch.finfo(getattr(torch, dtype)).bits // 8
    nbytes = esize * (2 * B * S * H * D + 2 * B * T * K * D)
    qp, kp = torch.arange(S)[:, None], torch.arange(T)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    flops = 4 * B * H * D * int(mask.sum())
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def check_attention_kernel() -> dict:
    """flash_attention against attention_ref at the timed shapes and edge
    cases; returns the timed cases' records by name."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator("cuda").manual_seed(0)
    records = {}
    for case in FLASH_TIMED + EDGE_CASES:
        name, dtype, B, S, T, H, K, D, causal, window, softcap = case
        dt = getattr(torch, dtype)
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, T, K, D, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, T, K, D, generator=gen, device="cuda").to(dt)
        kw = dict(causal=causal, window=window, logit_softcap=softcap)
        out = fa.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        expected = ref.attention_ref(q, k, v, **kw)
        check(out.dtype == dt and out.shape == q.shape, f"{name}: bad output")
        err = (out.float() - expected.float()).abs().max().item()
        torch.testing.assert_close(out.float(), expected.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype],
                                   msg=lambda m, n=name: f"flash_attention {n}: {m}")
        print(f"  flash_attention {name:11s} {dtype:8s} B{B} S{S} T{T} H{H} K{K} "
              f"D{D} causal={causal} window={window} softcap={softcap}: "
              f"max|err| {err:.3e} (tol {TOL[dtype]})")
        if case in FLASH_TIMED:
            rec = {"max_abs_err": err}
            rec["ms"] = time_ms(lambda: fa.flash_attention(q, k, v, **kw))
            rec["plain_ms"] = time_ms(lambda: ref.attention_ref(q, k, v, **kw))
            # the library yardstick: SDPA with the case's causality (every
            # timed window covers T, and S = T, so SDPA's causal mask is the
            # kernel's) on the same tensors, laid out [B,H,S,D] outside the
            # timed region; the port never calls it.  Its f32 check is looser:
            # it only shows that SDPA computes the same function, by whatever
            # arithmetic.
            check((window is None or window >= T) and (not causal or S == T),
                  f"{name}: SDPA mask differs")
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=True)
            lib_tol = TOL[dtype] if dtype == "bfloat16" else 1e-3
            torch.testing.assert_close(lib.transpose(1, 2).float(), expected.float(),
                                       rtol=lib_tol, atol=lib_tol)
            rec["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
            rec["bound_ms"], rec["bound_by"] = attention_bound_ms(case)
            print(f"    kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, SDPA "
                  f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}); kernel at {100 * rec['bound_ms'] / rec['ms']:.1f} % "
                  f"of its bound, {rec['library_ms'] / rec['ms']:.2f}x SDPA's speed")
            records[name] = rec
            del qt, kt, vt, lib
    return records


# Training's causal self-attention (the xla route's kernels): name, B, S = T,
# H, K, the q.k width D, v's DV, bf16.  Timed at internlm2-1.8b's training
# shape and at moonlight-16b-a3b's latent attention in moonlight-train-2k
# (16 x 2048); the edge cases take ragged lengths, D 64, MHA and MQA.
TRAIN_ATTN_CASE = ("train", 8, 2048, 16, 8, 128, 128)
MLA_TRAIN_ATTN_CASE = ("mla", 16, 2048, 16, 16, 192, 128)
TRAIN_ATTN_EDGE_CASES = [
    ("ragged", 2, 100, 4, 2, 128, 128),
    ("s37_d64", 2, 37, 4, 2, 64, 64),
    ("s2", 2, 2, 4, 2, 128, 128),
    ("d64", 2, 256, 8, 2, 64, 64),
    ("mha", 2, 192, 4, 4, 128, 128),
    ("mqa", 1, 320, 8, 1, 128, 128),
    # the (192, 128) pair streams 32-row tiles in its backward: S off both
    # 64 and 32, S a multiple of 32 and not of 64, grouped heads
    ("mla_ragged", 2, 100, 4, 4, 192, 128),
    ("mla_s37", 2, 37, 4, 4, 192, 128),
    ("mla_s2", 2, 2, 4, 4, 192, 128),
    ("mla_s160", 1, 160, 4, 4, 192, 128),
    ("mla_gqa", 2, 320, 8, 2, 192, 128),
]


def bf16_steps(err: float, expected) -> float:
    """``err`` in bf16 steps at ``expected``'s largest magnitude (a step is
    2^(e - 7) for magnitudes in [2^e, 2^(e+1)))."""
    import math

    top = expected.float().abs().max().item()
    return err / 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else float(err > 0)


def train_attention_bound_ms(case) -> dict:
    """The least time of the forward (its two products over the causal pairs:
    S over D, PV over DV) and of the backward (five: S again, dQ and dK over
    D, dP and dV over DV) at the bf16 peak, or their bytes at the HBM rate,
    whichever is larger."""
    from repro_torch.kernels.ops import attended_pairs

    _, B, S, H, K, D, DV = case
    pairs = B * H * attended_pairs(S, S, True, None)
    # bf16 bytes of a D-wide and a DV-wide tensor: q and out, k and v
    q_pair, kv_pair = 2 * B * S * H * (D + DV), 2 * B * S * K * (D + DV)
    out = {}
    for name, flops, nbytes in (("fwd", 2 * (D + DV) * pairs, q_pair + kv_pair),
                                ("bwd", 2 * (3 * D + 2 * DV) * pairs, 3 * q_pair + 2 * kv_pair)):
        t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS["bfloat16"]
        out[f"{name}_bound_ms"] = 1e3 * max(t_bytes, t_flops)
        out[f"{name}_bound_by"] = "bytes" if t_bytes >= t_flops else "operations"
    return out


def check_train_attention_kernel() -> dict:
    """The training pair (flash_attention_fwd_lse, flash_attention_bwd)
    against its plain versions at the training shapes and the edge cases: the
    output within TOL, the log-sum-exp within 1e-3, and dQ, dK and dV within
    one bf16 step at their largest magnitude of the plain backward fed the
    kernel's own output and log-sum-exp.  At internlm2's shape (D 128) and at
    moonlight's latent attention (q.k 192, v 128) it times the forward and the
    backward, the plain versions and SDPA (forward, and its backward as
    forward-and-backward less forward; the port never calls it).  Returns
    internlm2's timed record, with moonlight's under "mla"."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref

    gen = torch.Generator("cuda").manual_seed(0)
    records = {}
    for case in [TRAIN_ATTN_CASE, MLA_TRAIN_ATTN_CASE] + TRAIN_ATTN_EDGE_CASES:
        name, B, S, H, K, D, DV = case
        q, k = (torch.randn(B, S, n, D, generator=gen, device="cuda").to(torch.bfloat16)
                for n in (H, K))
        v = torch.randn(B, S, K, DV, generator=gen, device="cuda").to(torch.bfloat16)
        dout = torch.randn(B, S, H, DV, generator=gen, device="cuda").to(torch.bfloat16)
        out, lse = fa.flash_attention_fwd_lse(q, k, v)
        grads = fa.flash_attention_bwd(dout, q, k, v, out, lse)
        torch.cuda.synchronize()
        want_out, want_lse = ref.causal_attention_fwd_ref(q, k, v)
        torch.testing.assert_close(out.float(), want_out.float(), rtol=TOL["bfloat16"],
                                   atol=TOL["bfloat16"],
                                   msg=lambda m, n=name: f"flash_attention_fwd_lse {n}: {m}")
        torch.testing.assert_close(lse, want_lse, rtol=1e-3, atol=1e-3,
                                   msg=lambda m, n=name: f"flash_attention_fwd_lse {n} lse: {m}")
        want = ref.causal_attention_bwd_ref(dout, q, k, v, out, lse)
        rec = {"out_max_abs_err": (out.float() - want_out.float()).abs().max().item(),
               "lse_max_abs_err": (lse - want_lse).abs().max().item()}
        for gname, got, exp in zip(("dq", "dk", "dv"), grads, want):
            check(got.dtype == exp.dtype and got.shape == exp.shape, f"{name}: bad {gname}")
            err = (got.float() - exp.float()).abs().max().item()
            rec[f"{gname}_bf16_steps"] = steps = bf16_steps(err, exp)
            check(steps <= 1.0, f"flash_attention_bwd {name}: {gname} is {steps:.2f} bf16 "
                                f"steps from the plain backward (max|err| {err:.3e})")
        print(f"  train attention {name:10s} B{B} S{S} H{H} K{K} D{D} DV{DV}: out max|err| "
              f"{rec['out_max_abs_err']:.3e}, lse {rec['lse_max_abs_err']:.3e}; dq, dk, dv "
              f"{rec['dq_bf16_steps']:.2f}, {rec['dk_bf16_steps']:.2f}, "
              f"{rec['dv_bf16_steps']:.2f} bf16 steps from the plain backward")
        if case in (TRAIN_ATTN_CASE, MLA_TRAIN_ATTN_CASE):
            rec["fwd_ms"] = time_ms(lambda: fa.flash_attention_fwd_lse(q, k, v), iters=10)
            rec["bwd_ms"] = time_ms(lambda: fa.flash_attention_bwd(dout, q, k, v, out, lse),
                                    iters=10)
            rec["plain_fwd_ms"] = time_ms(lambda: ref.causal_attention_fwd_ref(q, k, v),
                                          iters=2, warmup=1)
            rec["plain_bwd_ms"] = time_ms(
                lambda: ref.causal_attention_bwd_ref(dout, q, k, v, out, lse), iters=2, warmup=1)
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
            dot = dout.transpose(1, 2).contiguous()

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)

            def sdpa_both():
                torch.autograd.grad(sdpa(), (qt, kt, vt), dot)

            with torch.no_grad():
                rec["library_fwd_ms"] = time_ms(sdpa, iters=10)
            rec["library_bwd_ms"] = time_ms(sdpa_both, iters=10) - rec["library_fwd_ms"]
            rec.update(train_attention_bound_ms(case))
            print(f"    forward {rec['fwd_ms']:.4f} ms (bound {rec['fwd_bound_ms']:.4f}, "
                  f"{rec['fwd_bound_by']}: {100 * rec['fwd_bound_ms'] / rec['fwd_ms']:.1f} %), "
                  f"backward {rec['bwd_ms']:.4f} ms (bound {rec['bwd_bound_ms']:.4f}, "
                  f"{rec['bwd_bound_by']}: {100 * rec['bwd_bound_ms'] / rec['bwd_ms']:.1f} %); "
                  f"plain {rec['plain_fwd_ms']:.3f} / {rec['plain_bwd_ms']:.3f} ms; SDPA "
                  f"{rec['library_fwd_ms']:.4f} / {rec['library_bwd_ms']:.4f} ms")
            records[name] = rec
            del qt, kt, vt, dot
        del q, k, v, dout, out, lse, grads, want, want_out, want_lse
        torch.cuda.empty_cache()
    return {**records[TRAIN_ATTN_CASE[0]], "mla": records[MLA_TRAIN_ATTN_CASE[0]]}


def ptxas_usage(report: str) -> dict[str, dict]:
    """Registers, static shared memory and spill stores and loads (bytes) by
    (mangled) entry function, from nvcc's -Xptxas -v report."""
    usage, entry = {}, None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            usage[entry] = {"registers": 0, "smem": 0, "spills": (0, 0)}
        elif (found := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            usage[entry]["spills"] = (int(found[1]), int(found[2]))
        elif (found := re.search(r"Used (\d+) registers", line)):
            usage[entry]["registers"] = int(found[1])
            smem = re.search(r"(\d+) bytes smem", line)
            usage[entry]["smem"] = int(smem[1]) if smem else 0
    return usage


# the bf16 kernels of the three (the tensor-core ones keep their tiles in
# registers): a spill is a fault
NO_SPILL_ENTRIES = ("flash_attention_bf16_kernel", "flash_attention_bwd_dkdv_kernel",
                    "flash_attention_bwd_dq_kernel", "gmm_tma_kernel", "gmm_bf16_kernel",
                    "mamba_scan_tc_kernel", "mamba_scan_kernel<bfloat16>")


def kernel_name(entry: str) -> str:
    """A mangled entry's kernel name (the <length><name> that ends in
    ``_kernel``) and its template arguments, for printing."""
    for found in re.finditer(r"\d+", entry):
        digits, end = found.group(), found.end()
        for i in range(len(digits)):
            n = int(digits[i:])
            name = entry[end:end + n]
            if len(name) == n and name.endswith("_kernel"):
                args = re.match(r"I((?:L[ib]\d+E|f|13__nv_bfloat16)+)E", entry[end + n:])
                if not args:
                    return name
                found_args = re.findall(r"L[ib](\d+)E|(f)|13__nv_(bfloat16)", args[1])
                return f"{name}<{', '.join(''.join(a) for a in found_args)}>"
    return entry


# name, dtype, B, S, H, P, N, chunk, dt shift (softplus(randn + shift)), strided
# (True: views of one packed tensor, as the model gives them; "odd": the same
# with one more column, so rows are not 16-byte multiples)
SSD_SLICE = ("slice", "bfloat16", 8, 512, 112, 64, 64, 128, 0.0, True)
SSD_EDGE_CASES = [
    ("slice_f32", "float32", 8, 512, 112, 64, 64, 128, 0.0, True),
    ("ragged100", "bfloat16", 2, 100, 16, 64, 64, 128, 0.0, True),
    ("ragged200", "bfloat16", 2, 200, 16, 64, 64, 128, 0.0, True),
    ("s_lt_chunk", "bfloat16", 2, 50, 16, 64, 64, 128, 0.0, True),
    ("chunk16", "bfloat16", 2, 256, 16, 64, 64, 16, 0.0, True),
    ("chunk32", "bfloat16", 2, 256, 16, 64, 64, 32, 0.0, True),
    ("chunk64", "bfloat16", 2, 256, 16, 64, 64, 64, 0.0, True),
    # the four shapes of tests/kernels/test_kernels.py:98-103, f32, contiguous
    ("jax_case1", "float32", 2, 64, 2, 8, 16, 16, 0.0, False),
    ("jax_case2", "float32", 1, 128, 4, 16, 8, 32, 0.0, False),
    ("jax_case3", "float32", 2, 96, 1, 8, 8, 32, 0.0, False),
    ("jax_case4", "float32", 1, 64, 2, 64, 64, 64, 0.0, False),
    ("smoke_f32", "float32", 4, 37, 16, 8, 8, 16, 0.0, True),
    ("batch1", "bfloat16", 1, 384, 112, 64, 64, 128, 0.0, True),
    ("strong_decay", "float32", 2, 256, 8, 64, 64, 128, 4.0, True),
    ("p128_n128", "float32", 1, 160, 4, 128, 128, 64, 0.0, True),
    # bf16 rows that cp.async cannot copy 16 bytes at a time: the FMA route
    ("odd_stride", "bfloat16", 2, 200, 16, 64, 64, 128, 0.0, "odd"),
]
# the bf16 cases whose shapes and strides the tensor-core route takes
SSD_TC_CASES = ("slice", "ragged100", "ragged200", "s_lt_chunk", "chunk16", "chunk32", "chunk64",
                "batch1")


def ssd_inputs(case, gen):
    """xh, dt, A, Bm, Cm on ``gen``'s device.  A differs by head.  With ``strided``,
    xh, Bm and Cm are views of one [B,S,H*P+2N] tensor, as the model's split
    of the conv output gives them ([B,S,H*P+2N+1] for "odd")."""
    import torch
    import torch.nn.functional as F

    _, dtype, B, S, H, P, N, _, shift, strided = case
    dt_, dev = getattr(torch, dtype), gen.device
    dt = F.softplus(torch.randn(B, S, H, generator=gen, device=dev) + shift)
    A = -torch.exp(torch.randn(H, generator=gen, device=dev))
    if strided:
        extra = int(strided == "odd")
        packed = torch.randn(B, S, H * P + 2 * N + extra, generator=gen, device=dev).to(dt_)
        xs, Bm, Cm, _ = torch.split(packed, [H * P, N, N, extra], dim=-1)
        xh = xs.reshape(B, S, H, P)
    else:
        xh = torch.randn(B, S, H, P, generator=gen, device=dev).to(dt_)
        Bm = torch.randn(B, S, N, generator=gen, device=dev).to(dt_)
        Cm = torch.randn(B, S, N, generator=gen, device=dev).to(dt_)
    return xh, dt, A, Bm, Cm


def ssd_bound_ms(case) -> tuple[float, str]:
    """Least time for the scan: xh read and y written, dt, A, B and C read once,
    at the HBM rate; or the least arithmetic at the inputs' peak: C B^T once per
    (batch, chunk), 2 Q^2 P (intra) + 4 Q P N (inter and state) per (batch,
    head, chunk); whichever is larger."""
    import torch

    _, dtype, B, S, H, P, N, chunk, _, _ = case
    esize = torch.finfo(getattr(torch, dtype)).bits // 8
    nbytes = esize * (2 * B * S * H * P + 2 * B * S * N) + 4 * (B * S * H + H)
    nc = -(-S // chunk)
    flops = B * nc * (2 * chunk * chunk * N + H * (2 * chunk * chunk * P + 4 * chunk * P * N))
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def kernel_tolerance(dtype: str, expected) -> dict:
    """bf16: rtol = atol = 2e-2 per element.  f32: rtol 2e-5, atol 2e-5 times
    the RMS of the reference (at least 1): both sides sum in f32 in other
    orders, and a sum's rounding grows with the size of its terms (the scan's
    RMS|y| is about 10 at the slice shape, a few units at the reference's test
    shapes; gmm's outputs are O(1) with w drawn at std 1/sqrt(D))."""
    if dtype == "bfloat16":
        return {"rtol": TOL[dtype], "atol": TOL[dtype]}
    rms = expected.float().square().mean().sqrt().item()
    return {"rtol": TOL[dtype], "atol": TOL[dtype] * max(1.0, rms)}


def check_mamba_kernel() -> dict:
    """mamba_scan against mamba_scan_ref at the slice shape and edge cases;
    prints each case's route and its shared memory, max|err|, RMS|ref| and
    margin (the largest |err| / (atol + rtol |ref|), at most 1 to pass)."""
    import torch

    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ref
    from repro_torch.models import ssm

    gen = torch.Generator("cuda").manual_seed(1)
    record = {}
    for case in [SSD_SLICE] + SSD_EDGE_CASES:
        name, dtype, B, S, H, P, N, chunk, shift, strided = case
        xh, dt, A, Bm, Cm = ssd_inputs(case, gen)
        path = ms.route(xh, Bm, Cm, chunk)
        want = "tensor_core" if name in SSD_TC_CASES else "fma"
        check(path == want, f"mamba_scan {name} takes the {path} route, want {want}")
        smem = ms.smem_bytes(ms.kernel_chunk(chunk, S, path), P, N, path)
        out = ms.mamba_scan(xh, dt, A, Bm, Cm, chunk=chunk)
        torch.cuda.synchronize()
        expected, _ = ref.mamba_scan_ref(xh, dt, A, Bm, Cm)
        check(out.dtype == xh.dtype and out.shape == xh.shape, f"{name}: bad output")
        check(bool(torch.isfinite(out.float()).all()), f"mamba_scan {name}: not finite")
        tol = kernel_tolerance(dtype, expected)
        diff = (out.float() - expected.float()).abs()
        err = diff.max().item()
        rms = expected.float().square().mean().sqrt().item()
        margin = (diff / (tol["atol"] + tol["rtol"] * expected.float().abs())).max().item()
        print(f"  mamba_scan {name:12s} {dtype:8s} B{B} S{S} H{H} P{P} N{N} chunk{chunk} "
              f"dt shift {shift} strided={strided}: route {path} ({smem} bytes of shared "
              f"memory), max|err| {err:.3e}, RMS|ref| {rms:.3e}, "
              f"max|ref| {expected.float().abs().max().item():.3e}, rtol {tol['rtol']}, "
              f"atol {tol['atol']:.3e}, margin {margin:.3f}")
        torch.testing.assert_close(out.float(), expected.float(), **tol,
                                   msg=lambda m, n=name: f"mamba_scan {n}: {m}")
        if case is SSD_SLICE:
            record = {"max_abs_err": err, "kernel_route": path}
            record["ms"] = time_ms(lambda: ms.mamba_scan(xh, dt, A, Bm, Cm, chunk=chunk))
            record["plain_ms"] = time_ms(lambda: ref.mamba_scan_ref(xh, dt, A, Bm, Cm),
                                         iters=5, warmup=1)
            # the comparison yardstick: the port's own eager chunked SSD, the
            # non-kernel route ("xla"); no single PyTorch call computes the scan
            chunked = ssm.ssd_chunked(xh, dt, A, Bm, Cm, chunk)
            torch.testing.assert_close(chunked.float(), expected.float(), **tol)
            record["ssd_chunked_ms"] = time_ms(lambda: ssm.ssd_chunked(xh, dt, A, Bm, Cm, chunk))
            record["bound_ms"], record["bound_by"] = ssd_bound_ms(case)
            print(f"  slice shape: kernel {record['ms']:.4f} ms, plain {record['plain_ms']:.4f} "
                  f"ms, eager ssd_chunked {record['ssd_chunked_ms']:.4f} ms, bound "
                  f"{record['bound_ms']:.4f} ms ({record['bound_by']})")
    # the wrapper refuses a chunk whose tiles do not fit in shared memory
    xh, dt, A, Bm, Cm = ssd_inputs(next(c for c in SSD_EDGE_CASES if c[0] == "p128_n128"), gen)
    try:
        ms.mamba_scan(xh, dt, A, Bm, Cm, chunk=128)
    except ValueError:
        print("  mamba_scan refuses chunk 128 at P = N = 128")
    else:
        raise RuntimeError("mamba_scan accepted chunk 128 at P = N = 128")
    return record


# name, dtype, E, C, D, F, Ew.  The timed cases: mixtral-8x7b's eval gate/up
# and down (8 x 512 tokens in 2 groups, C 640), its decode (8 tokens, C 8) and
# a qwen3-moe layer (4096 tokens in 2 groups, C 160).  The first is the slice
# shape of the kernels' JSON line.
GMM_SLICE = ("mixtral_eval_gate", "bfloat16", 16, 640, 4096, 14336, 8)
GMM_TIMED = [
    GMM_SLICE,
    ("mixtral_eval_down", "bfloat16", 16, 640, 14336, 4096, 8),
    ("mixtral_decode", "bfloat16", 8, 8, 4096, 14336, 8),
    ("qwen3_layer", "bfloat16", 256, 160, 4096, 1536, 128),
]
# the bf16 cases that take the TMA + wgmma route: every model shape, and the
# aligned cases whose ragged C and F exercise TMA's zero fill
GMM_TMA_CASES = ("mixtral_eval_gate", "mixtral_eval_down", "mixtral_decode", "qwen3_layer",
                 "serve_ragged", "c37_d96_f72", "e5_ew3", "mixtral_decode_split_gate",
                 "mixtral_decode_split_down")
GMM_EDGE_CASES = [
    ("mixtral_eval_gate_f32", "float32", 16, 640, 4096, 14336, 8),
    # a serving prefill batch of 8 x 501 tokens: one group, C 1256 (ragged)
    ("serve_ragged", "bfloat16", 8, 1256, 4096, 14336, 8),
    # ragged C, D and F (D % 8 != 0: the bf16 kernel's element-wise loads)
    ("c37_d100_f72", "bfloat16", 3, 37, 100, 72, 3),
    ("c37_d100_f72_f32", "float32", 3, 37, 100, 72, 3),
    # ragged C and F with 16-byte loads (D, F multiples of 8)
    ("c37_d96_f72", "bfloat16", 3, 37, 96, 72, 3),
    ("e6_ew3", "bfloat16", 6, 37, 100, 72, 3),
    ("e6_ew3_f32", "float32", 6, 37, 100, 72, 3),
    ("e5_ew3", "bfloat16", 5, 37, 96, 72, 3),
    ("e1", "bfloat16", 1, 37, 100, 72, 1),
    ("e1_f32", "float32", 1, 37, 100, 72, 1),
    # mixtral-8x7b decode_32k on (16, 16) with use_gmm: the one routing group
    # of 128 tokens (C 40) split over 16 data ranks (moe._experts_split),
    # gate and up on a rank's 256 of the embed dim and 896 hidden columns,
    # down back to its 256
    ("mixtral_decode_split_gate", "bfloat16", 8, 40, 256, 896, 8),
    ("mixtral_decode_split_down", "bfloat16", 8, 40, 896, 256, 8),
]


def gmm_bound_ms(case) -> tuple[float, str]:
    """Least time for the grouped matmul: x and w read once and the output
    written once at the HBM rate, or 2 E C D F operations at the dtype's
    peak, whichever is larger."""
    import torch

    _, dtype, E, C, D, F, Ew = case
    esize = torch.finfo(getattr(torch, dtype)).bits // 8
    nbytes = esize * (E * C * D + Ew * D * F + E * C * F)
    t_bytes, t_flops = nbytes / HBM_BYTES_PER_S, 2 * E * C * D * F / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def check_gmm_kernel() -> dict:
    """gmm against gmm_ref at the path's shapes and edge cases, x ~ N(0, 1) and
    w at std 1/sqrt(D), so outputs are O(1); prints each case's route,
    max|err|, RMS|ref| and margin.  Returns the timed cases' records by name."""
    import torch

    from repro_torch.kernels import moe_gmm as mg
    from repro_torch.kernels import ref

    gen = torch.Generator("cuda").manual_seed(2)
    records = {}
    for case in GMM_TIMED + GMM_EDGE_CASES:
        name, dtype, E, C, D, F, Ew = case
        dt = getattr(torch, dtype)
        x = torch.randn(E, C, D, generator=gen, device="cuda").to(dt)
        w = (torch.randn(Ew, D, F, generator=gen, device="cuda") * D ** -0.5).to(dt)
        path = mg.route(x, w)
        want = ("tma_wgmma" if name in GMM_TMA_CASES
                else "fma_f32" if dtype == "float32" else "wmma")
        check(path == want, f"gmm {name} takes the {path} route, want {want}")
        out = mg.gmm(x, w)
        torch.cuda.synchronize()
        expected = ref.gmm_ref(x, w)
        check(out.dtype == dt and out.shape == (E, C, F), f"gmm {name}: bad output")
        check(bool(torch.isfinite(out.float()).all()), f"gmm {name}: not finite")
        tol = kernel_tolerance(dtype, expected)
        diff = (out.float() - expected.float()).abs()
        err = diff.max().item()
        rms = expected.float().square().mean().sqrt().item()
        margin = (diff / (tol["atol"] + tol["rtol"] * expected.float().abs())).max().item()
        print(f"  gmm {name:21s} {dtype:8s} E{E} C{C} D{D} F{F} Ew{Ew}: route {path}, "
              f"max|err| {err:.3e}, "
              f"RMS|ref| {rms:.3e}, rtol {tol['rtol']}, atol {tol['atol']:.3e}, "
              f"margin {margin:.3f}")
        torch.testing.assert_close(out.float(), expected.float(), **tol,
                                   msg=lambda m, n=name: f"gmm {n}: {m}")
        del out, diff
        if case in GMM_TIMED:
            rec = {"max_abs_err": err, "kernel_route": path}
            rec["ms"] = time_ms(lambda: mg.gmm(x, w))
            rec["plain_ms"] = time_ms(lambda: ref.gmm_ref(x, w), iters=5, warmup=1)
            # the library yardstick: one batched matmul with w broadcast over
            # the E / Ew groups; the port never calls it
            xv = x.view(E // Ew, Ew, C, D)
            lib = torch.matmul(xv, w)
            torch.testing.assert_close(lib.reshape(E, C, F).float(), expected.float(), **tol)
            del lib
            rec["library_ms"] = time_ms(lambda: torch.matmul(xv, w))
            rec["bound_ms"], rec["bound_by"] = gmm_bound_ms(case)
            print(f"    kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, torch.matmul "
                  f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                  f"({rec['bound_by']}); kernel at {100 * rec['bound_ms'] / rec['ms']:.1f} % "
                  f"of its bound, {rec['ms'] / rec['library_ms']:.2f}x torch.matmul's time")
            records[name] = rec
        del x, w, expected
        torch.cuda.empty_cache()
    return records


# ---------------------------------------------------------------------------
# phase 4: serving
# ---------------------------------------------------------------------------


def _timed(fn, log: list):
    import torch

    def wrapper(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        log.append(time.perf_counter() - t0)
        return out

    return wrapper


# kernels whose device time a training step's profile sums, by a part of
# their names: cuBLAS's GEMMs, and the copies that cast weights, activations
# and gradients between f32 and bf16
KERNEL_GROUPS = {"cuBLAS GEMMs": ("nvjet", "gemm", "cutlass", "xmma"),
                 "casts and copies": ("copy_kernel",)}


def _kernel_time(trace: Path, top: int = 6, groups: dict | None = None) -> tuple[str, float]:
    """Device time by kernel from a chrome trace: the busy share of the traced
    window (union of kernel intervals over first start to last end), the
    largest kernels by total time, and the total of each of ``groups``; and
    the busy time in ms."""
    events = [e for e in json.loads(trace.read_text())["traceEvents"]
              if e.get("cat") == "kernel" and "dur" in e]
    if not events:
        return "no device kernels in the trace", 0.0
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, cur_start, cur_end = 0.0, *spans[0]
    for start, end in spans[1:]:
        if start > cur_end:
            busy += cur_end - cur_start
            cur_start = start
        cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    window = max(end for _, end in spans) - spans[0][0]
    by_name: dict[str, float] = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    total = sum(by_name.values())
    lines = [f"device busy {busy / 1e3:.3f} ms of a {window / 1e3:.3f} ms window "
             f"({100 * busy / window:.1f} %), {len(events)} kernels"]
    for name, dur in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"    {100 * dur / total:5.1f} %  {dur / 1e3:9.3f} ms  {name[:90]}")
    for group, parts in (groups or {}).items():
        dur = sum(d for name, d in by_name.items() if any(x in name for x in parts))
        lines.append(f"    {group}: {dur / 1e3:.3f} ms ({100 * dur / total:.1f} % of kernel time)")
    # the port's own kernels, wherever they rank
    for name, dur in by_name.items():
        if any(k in name for k in ("flash_attention", "mamba_scan", "gmm_")):
            n = sum(e["name"] == name for e in events)
            lines.append(f"    port kernel {name[:60]}: {dur / 1e3:.3f} ms in {n} launches "
                         f"({100 * dur / total:.1f} % of kernel time)")
    return "\n".join(lines), busy / 1e3


def _profile(name: str, fn, top: int = 6, groups: dict | None = None) -> float:
    """Traces ``fn`` with torch.profiler, prints where its device time goes
    and returns the device's busy ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    trace = ROOT / "build" / f"trace_{name.split()[0]}.json"
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    text, busy_ms = _kernel_time(trace, top, groups)
    print(f"  profile {name}: {text}")
    return busy_ms


def profile_serving(model, params, tokens, max_len: int, steps: int = 8) -> None:
    """Traces one prefill batch and ``steps`` decode steps with torch.profiler
    and prints where the device time goes in each."""
    import torch

    S = tokens.shape[1]
    with torch.inference_mode():
        _profile("prefill (1 batch)",
                 lambda: model.prefill(params, {"tokens": tokens}, max_len))
        _, cache = model.prefill(params, {"tokens": tokens}, max_len)
        _profile(f"decode ({steps} steps)", lambda: [
            model.decode_step(params, tokens[:, -1:], cache, S + i) for i in range(steps)])


def launch_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_gmm as mg

    return {"flash_attention": fa.flash_attention.launches,
            "mamba_scan": ms.mamba_scan.launches, "gmm": mg.gmm.launches}


def reset_launch_counts() -> None:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moe_gmm as mg

    fa.flash_attention.launches = 0
    fa.flash_attention.noncausal_launches = 0
    fa.flash_attention_fwd_lse.launches = 0
    fa.flash_attention_bwd.launches = 0
    ms.mamba_scan.launches = 0
    mg.gmm.launches = 0


def serve_requests(model, params, n_requests: int, max_new: int):
    """16 requests with prompts of 128-512 tokens through BatchAccumulator and
    ServeEngine at batch 8.  Prints tok/s, prefill ms per batch and decode ms
    per step; returns (batches, kernel launches during the run, prompts)."""
    import numpy as np
    import torch

    from repro_torch.serve.engine import BatchAccumulator, ServeEngine

    cfg = model.cfg
    prefill_s, decode_s = [], []
    model.prefill = _timed(model.prefill, prefill_s)
    model.decode_step = _timed(model.decode_step, decode_s)
    engine = ServeEngine(model, params, max_len=512 + max_new, device="cuda")
    accum = BatchAccumulator(engine, max_batch=8)
    rng = np.random.default_rng(0)
    lengths = rng.integers(128, 513, n_requests)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    for p in prompts:
        accum.submit(p)

    # one short request first, so the timed run does not carry the first
    # calls' set-up (cuBLAS handles, the kernel library's load)
    engine.generate(prompts[0][None, :128].astype(np.int32), max_new_tokens=2)
    prefill_s.clear()
    decode_s.clear()
    engine.stats = dict.fromkeys(engine.stats, 0)

    reset_launch_counts()
    t0 = time.perf_counter()
    results = accum.flush(max_new_tokens=max_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()

    batches = engine.stats["batches"]
    check(len(results) == n_requests, f"served {len(results)} of {n_requests}")
    for r in results:
        toks = np.asarray(r["tokens"])
        check(toks.shape == (max_new,), f"bad token shape {toks.shape}")
        check(((toks >= 0) & (toks < cfg.vocab_size)).all(), "token out of range")
    tokens = engine.stats["tokens_generated"]
    print(f"  served {len(results)} requests in {batches} batches (prompt lengths "
          f"{int(lengths.min())}-{int(lengths.max())}), {tokens} tokens in {wall:.3f} s: "
          f"{tokens / wall:.1f} tok/s; kernel launches {launches}")
    print(f"  prefill ms per batch: {[round(1e3 * s, 3) for s in prefill_s]}; decode ms "
          f"per token step (median of {len(decode_s)}): "
          f"{1e3 * float(np.median(decode_s)):.3f}")
    del model.prefill, model.decode_step
    return batches, launches, prompts


def first_batch(prompts):
    """The first 8 prompts, left-padded to the longest, on the card."""
    import numpy as np
    import torch

    width = max(len(p) for p in prompts[:8])
    batch = np.zeros((8, width), np.int64)
    for i, p in enumerate(prompts[:8]):
        batch[i, width - len(p):] = p
    return torch.as_tensor(batch, device="cuda")


def serve(n_requests: int = 16, max_new: int = 32) -> int:
    """Drives internlm2-1.8b's serving path; returns flash_attention's launches
    during it."""
    import torch

    from repro_torch import configs
    from repro_torch.models.model import Model

    cfg = configs.get("internlm2-1.8b").replace(attention_impl="flash")
    check(cfg.compute_dtype == "bfloat16", "expected bf16 compute")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    print(f"  internlm2-1.8b: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s")

    batches, counts, prompts = serve_requests(model, params, n_requests, max_new)
    launches = counts["flash_attention"]
    check(launches == cfg.n_layers * batches,
          f"flash_attention launched {launches} times, want "
          f"{cfg.n_layers} x {batches} prefill batches")

    tokens = first_batch(prompts)
    prefill_flash_vs_xla(cfg, params, tokens)
    profile_serving(Model(cfg), params, tokens, max_len=512 + max_new)
    return launches


def prefill_flash_vs_xla(cfg, params, tokens) -> None:
    """Prefill logits of ``tokens`` through the kernel ("flash") and through
    attend_xla, at full depth in f32 and bf16 and at the first layer in bf16:
    f32 at full depth within PREFILL_F32_TOL, bf16 at the first layer within
    PREFILL_SHALLOW_BF16_TOL (relative L2)."""
    import torch

    from repro_torch.models.model import Model

    width = tokens.shape[1]
    logits = {}
    runs = [(cfg.n_layers, "float32"), (cfg.n_layers, "bfloat16"), (SHALLOW_LAYERS, "bfloat16")]
    with torch.inference_mode():
        for n_layers, dtype in runs:
            for impl in ("xla", "flash"):
                run_cfg = cfg.replace(n_layers=n_layers, compute_dtype=dtype,
                                      attention_impl=impl)
                out, _ = Model(run_cfg).prefill(params, {"tokens": tokens}, width)
                logits[impl, n_layers, dtype] = out.float()
    for key, val in logits.items():
        check(bool(torch.isfinite(val).all()), f"prefill logits {key} not finite")

    def rel(key, ref_key):
        a, b = logits[key], logits[ref_key]
        return ((a - b).norm() / b.norm()).item()

    full = cfg.n_layers
    rel_f32 = rel(("flash", full, "float32"), ("xla", full, "float32"))
    rel_shallow = rel(("flash", SHALLOW_LAYERS, "bfloat16"), ("xla", SHALLOW_LAYERS, "bfloat16"))
    print(f"  prefill logits, flash vs xla (relative L2): f32 at {full} layers "
          f"{rel_f32:.3e} (tol {PREFILL_F32_TOL}); bf16 at {SHALLOW_LAYERS} layers "
          f"{rel_shallow:.3e} (tol {PREFILL_SHALLOW_BF16_TOL}); max|logit| "
          f"{logits['xla', full, 'float32'].abs().max().item():.3e}")
    print(f"  bf16 at {full} layers, not checked (relative L2): flash vs xla "
          f"{rel(('flash', full, 'bfloat16'), ('xla', full, 'bfloat16')):.3e}; from the f32 "
          f"xla run: flash {rel(('flash', full, 'bfloat16'), ('xla', full, 'float32')):.3e}, "
          f"xla {rel(('xla', full, 'bfloat16'), ('xla', full, 'float32')):.3e}")
    check(rel_f32 <= PREFILL_F32_TOL, f"flash f32 prefill differs from xla f32: {rel_f32}")
    check(rel_shallow <= PREFILL_SHALLOW_BF16_TOL,
          f"flash bf16 prefill at {SHALLOW_LAYERS} layers differs from xla bf16: {rel_shallow}")


# ---------------------------------------------------------------------------
# phases 5-7: zamba2-7b and mixtral-8x7b evaluation and serving
# ---------------------------------------------------------------------------


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm()).item()


def big_model(arch: str, **overrides):
    """``arch`` at full width on the card (with ``overrides``, such as a cut
    depth), f32 params redrawn from seed 0 by repro_torch.testing.redraw_params_,
    bf16 compute, attention_impl="flash"."""
    import torch

    from repro_torch import configs
    from repro_torch.models.model import Model
    from repro_torch.testing import redraw_params_

    cfg = configs.get(arch).replace(attention_impl="flash", **overrides)
    check(cfg.compute_dtype == "bfloat16" and cfg.param_dtype == "float32",
          "expected f32 params, bf16 compute")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0), device="cuda")
    redraw_params_(params, seed=0)
    torch.cuda.synchronize()
    print(f"  {arch}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.param_count() / 1e9:.3f} B params, init {time.perf_counter() - t0:.1f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB on the card")
    return model, params


@contextlib.contextmanager
def routing(record: list | None = None, replay: list | None = None):
    """Within the block, each MoE layer's ``top_k_dispatch`` result (dispatch,
    combine, aux) is appended to ``record``, or taken in order from ``replay``
    instead of being computed."""
    from repro_torch.models import moe

    real = moe.top_k_dispatch
    tape = iter(replay) if replay is not None else None

    def dispatch(logits, cfg, capacity):
        out = next(tape) if tape is not None else real(logits, cfg, capacity)
        if record is not None:
            record.append(out)
        return out

    moe.top_k_dispatch = dispatch
    try:
        yield
    finally:
        moe.top_k_dispatch = real


def rerouted_tokens(a: list, b: list) -> list[int]:
    """Per MoE layer, the tokens whose set of placed experts differs between
    two recordings of ``routing`` (a choice that flipped, or a token dropped
    at capacity in one and placed in the other)."""
    return [int((da.any(-1) != db.any(-1)).any(-1).sum()) for (da, _, _), (db, _, _) in zip(a, b)]


def cut_depth(cfg, n_layers: int):
    """``cfg`` at its first ``n_layers`` layers (an enc-dec model's encoder too)."""
    if cfg.family == "encdec":
        return cfg.replace(n_layers=n_layers, n_encoder_layers=n_layers)
    return cfg.replace(n_layers=n_layers)


def evaluate(model, params, per_batch: dict, shallow: int | None, shallow_tol: float | None,
             n_batches: int = 2, B: int = 8, S: int = 512, frames: int | None = None,
             profile: bool = True):
    """make_eval_step over ``n_batches`` batches of B x S tokens (labels shifted
    by one; with ``frames``, B x frames x d_model stub frame embeddings drawn
    from seed 0 beside them); each kernel must launch ``per_batch[name]`` times
    a batch.  The forward logits of the first batch through the kernels
    ("flash") are held against the plain routes ("xla", attention through
    attend_xla: the xla route's training kernels patched off): f32 at full
    depth, bf16 at the first ``shallow`` layers (``shallow`` None: a model with no
    kernel on its path, whose two routes are one, is not compared).  Returns
    (the launches, the first batch).

    An MoE layer's top-k routing is a step function of its input: a rounding
    difference upstream flips a near-tied choice, and the token then takes
    another expert, its logits moving by tens of percent.  For an MoE model
    the flash run is therefore held against xla on xla's routing (replayed
    through ``routing``), which isolates what the kernels change; the
    distances on each run's own routing and the tokens rerouted are printed."""
    from unittest import mock

    import numpy as np
    import torch

    from repro_torch.models import attention
    from repro_torch.models.model import Model
    from repro_torch.train.loop import make_eval_step

    cfg = model.cfg
    eval_step = make_eval_step(model)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (n_batches, B, S + 1))
    batches = [{"tokens": torch.as_tensor(t[:, :-1], device="cuda"),
                "labels": torch.as_tensor(t[:, 1:], device="cuda")} for t in tokens]
    if frames:
        gen = torch.Generator("cuda").manual_seed(0)
        for batch in batches:
            batch["frames"] = torch.randn(B, frames, cfg.d_model, generator=gen, device="cuda")
    eval_step(params, batches[0])  # set-up (cuBLAS handles, the kernel library's load)
    torch.cuda.synchronize()

    reset_launch_counts()
    times, losses = [], []
    for batch in batches:
        t0 = time.perf_counter()
        losses.append(eval_step(params, batch)["loss"].item())
        times.append(time.perf_counter() - t0)
    launches = launch_counts()
    shape = f"{B} x {S} tokens" + (f" and {frames} frames" if frames else "")
    print(f"  eval {n_batches} batches of {shape}: ms per batch "
          f"{[round(1e3 * t, 3) for t in times]}, loss {losses}; kernel launches {launches}")
    check(all(np.isfinite(losses)), f"eval loss not finite: {losses}")
    want = {name: n * n_batches for name, n in per_batch.items()}
    check(launches == want, f"eval launched {launches}, want {want}")
    if shallow is None:
        return launches, batches[0]

    logits = {}
    moe = cfg.moe is not None
    flash = "flash_pinned" if moe else "flash"  # the run held against xla
    with torch.inference_mode():
        for n_layers, dtype in ((cfg.n_layers, "float32"), (cfg.n_layers, "bfloat16"),
                                (shallow, "bfloat16")):
            run_cfg = cut_depth(cfg, n_layers).replace(compute_dtype=dtype)
            tapes = {"xla": [], "flash": []}
            runs = [("xla", "xla", tapes["xla"], None), ("flash", "flash", tapes["flash"], None)]
            if moe:
                runs.append(("flash_pinned", "flash", None, tapes["xla"]))
            for name, impl, record, replay in runs:
                # the plain side is attend_xla itself: unpatched, the xla route
                # sends this causal bf16 forward to the training kernels
                plain = (mock.patch.object(attention, "fused_causal", lambda *a, **k: False)
                         if impl == "xla" else contextlib.nullcontext())
                with routing(record, replay), plain:
                    out, _ = Model(run_cfg.replace(attention_impl=impl)).forward(
                        params, batches[0])
                check(bool(torch.isfinite(out).all()), f"{name} {dtype} logits not finite")
                logits[name, n_layers, dtype] = out.float()
                del out
            if moe:
                rerouted = rerouted_tokens(tapes["xla"], tapes["flash"])
                print(f"  {dtype} at {n_layers} layers: tokens (of {B * S}) whose experts "
                      f"differ between the xla and flash runs, by layer: {rerouted}; "
                      f"flash vs xla on their own routing (relative L2), not checked: "
                      f"{rel_l2(logits['flash', n_layers, dtype], logits['xla', n_layers, dtype]):.3e}")
            del tapes
    full = cfg.n_layers
    rel_f32 = rel_l2(logits[flash, full, "float32"], logits["xla", full, "float32"])
    rel_sh = rel_l2(logits[flash, shallow, "bfloat16"], logits["xla", shallow, "bfloat16"])
    on = " on xla's routing" if moe else ""
    print(f"  forward logits, flash vs xla{on} (relative L2): f32 at {full} layers "
          f"{rel_f32:.3e} (tol {EVAL_F32_TOL}); bf16 at the first {shallow} layers "
          f"{rel_sh:.3e} (tol {shallow_tol})")
    xla32 = logits["xla", full, "float32"]
    print(f"  bf16 at {full} layers, not checked (relative L2): flash vs xla{on} "
          f"{rel_l2(logits[flash, full, 'bfloat16'], logits['xla', full, 'bfloat16']):.3e}; "
          f"from the f32 xla run: flash "
          f"{rel_l2(logits['flash', full, 'bfloat16'], xla32):.3e}, xla "
          f"{rel_l2(logits['xla', full, 'bfloat16'], xla32):.3e}")
    check(rel_f32 <= EVAL_F32_TOL, f"flash f32 logits differ from xla f32: {rel_f32}")
    check(rel_sh <= shallow_tol,
          f"flash bf16 logits at the first {shallow} layers differ from xla bf16: {rel_sh}")
    del logits, xla32
    if profile:
        _profile("eval (1 batch)", lambda: eval_step(params, batches[0]))
    return launches, batches[0]


def serve_and_profile(model, params, per_batch: dict, n_requests: int = 16,
                      max_new: int = 32):
    """16 requests through serve_requests; each kernel must launch
    ``per_batch[name]`` times a prefill batch.  Profiles one prefill batch and
    8 decode steps; returns the prompts."""
    batches, launches, prompts = serve_requests(model, params, n_requests, max_new)
    want = {name: n * batches for name, n in per_batch.items()}
    check(launches == want, f"serving launched {launches}, want {want}")
    profile_serving(model, params, first_batch(prompts), max_len=512 + max_new)
    return prompts


def moe_layer_input(params, cfg, tokens):
    """Layer 0's MoE params and its real normed input for ``tokens``: the
    embedding, the attention residual and mlp_norm, as apply_block runs them."""
    import torch

    from repro_torch.models import attention as attn
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tfm

    p = tfm.layer_params(params["blocks"], 0)
    x = tfm.embed_tokens(params, cfg, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h = L.apply_norm(p["attn_norm"], x, cfg.norm_type, cfg.norm_eps)
    attn_out, _ = attn.apply_attention(p["attn"], cfg, h, positions, window=cfg.sliding_window)
    return p["moe"], L.apply_norm(p["mlp_norm"], x + attn_out, cfg.norm_type, cfg.norm_eps)


def check_gmm_route(cfg, params, inputs: dict) -> int:
    """apply_moe(use_gmm=True) against use_gmm=False on layer 0 for each token
    batch of ``inputs``, in f32 and bf16: gmm launches 3 times a call, the aux
    losses are equal (the dispatch is shared) and the outputs agree.  cuBLAS's
    reduced-precision bf16 reductions are off for the comparison, so the
    einsum route sums in f32 as the kernel does.  Returns gmm's launches."""
    import torch

    from repro_torch.models import moe

    reduced = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    reset_launch_counts()
    for name, tokens in inputs.items():
        T = tokens.numel()
        groups = moe.group_tokens(T)
        C = moe.capacity_for(T // groups, cfg)
        for dtype in ("float32", "bfloat16"):
            run_cfg = cfg.replace(compute_dtype=dtype)
            with torch.inference_mode():
                moe_params, h = moe_layer_input(params, run_cfg, tokens)
                before = launch_counts()["gmm"]
                out_k, aux_k = moe.apply_moe(moe_params, run_cfg, h, use_gmm=True)
                torch.cuda.synchronize()
                n = launch_counts()["gmm"] - before
                out_e, aux_e = moe.apply_moe(moe_params, run_cfg, h, use_gmm=False)
            check(n == 3, f"apply_moe(use_gmm=True) launched gmm {n} times, want 3")
            check(bool(torch.isfinite(out_k.float()).all()), f"gmm route {name} not finite")
            check(bool(torch.equal(aux_k, aux_e)), f"aux differs: {aux_k} vs {aux_e}")
            rel = rel_l2(out_k.float(), out_e.float())
            line = (f"  apply_moe {name} batch {tuple(tokens.shape)} ({groups} group(s), C {C}) "
                    f"{dtype}: gmm vs einsum relative L2 {rel:.3e}, aux {aux_k.item():.6f}")
            if dtype == "float32":
                tol = dict(rtol=GMM_ROUTE_F32_TOL, atol=GMM_ROUTE_F32_TOL)
                diff = (out_k - out_e).abs()
                margin = (diff / (GMM_ROUTE_F32_TOL * (1 + out_e.abs()))).max().item()
                print(f"{line}, max|err| {diff.max().item():.3e}, margin {margin:.3f} "
                      f"(rtol = atol = {GMM_ROUTE_F32_TOL})")
                torch.testing.assert_close(out_k, out_e, **tol)
            else:
                print(f"{line} (tol {GMM_ROUTE_BF16_TOL})")
                check(rel <= GMM_ROUTE_BF16_TOL, f"gmm bf16 route differs: {rel}")
            del out_k, out_e, h
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    return launch_counts()["gmm"]


def smoke_model_card_vs_cpu(arch: str, kernel: str | None) -> None:
    """An ``arch`` SMOKE model in f32 on the card against the same weights on
    the CPU: forward logits (``kernel`` against its plain version inside, once
    per layer, twice for an enc-dec model; None: a model with no kernel on
    its path, and none may launch), prefill logits and every cache leaf, and
    4 decode steps.  An enc-dec model also takes 24 frames, and its prompt
    stays inside its 32 decoder positions."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.testing import redraw_params_

    cfg = configs.get(arch, smoke=True).replace(compute_dtype="float32",
                                                attention_impl="flash")
    model = Model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0), device="cpu")
    redraw_params_(params, seed=0)
    gpu_params = L.map_tree(lambda t: t.cuda(), params)
    rng = np.random.default_rng(1)
    encdec = cfg.family == "encdec"
    n_prompt = 20 if encdec else 37
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, n_prompt + 4)))
    prompt, max_len = tokens[:, :n_prompt], n_prompt + 4
    extra = {"frames": torch.as_tensor(rng.standard_normal((4, 24, cfg.d_model)),
                                       dtype=torch.float32)} if encdec else {}
    cpu_batch = {"tokens": prompt, **extra}
    gpu_batch = {k: v.cuda() for k, v in cpu_batch.items()}
    per_forward = 0 if kernel is None else cfg.n_layers + cfg.n_encoder_layers
    tol = dict(rtol=SMOKE_TOL, atol=SMOKE_TOL)
    before = launch_counts()
    with torch.inference_mode():
        cpu_fwd, cpu_aux = model.forward(params, cpu_batch)
        gpu_fwd, gpu_aux = model.forward(gpu_params, gpu_batch)
        want = {**before, **({kernel: before[kernel] + per_forward} if kernel else {})}
        check(launch_counts() == want,
              f"SMOKE forward on the card launched {launch_counts()}, want {want}")
        torch.testing.assert_close(gpu_fwd.cpu(), cpu_fwd, **tol)
        torch.testing.assert_close(torch.as_tensor(gpu_aux).cpu(), torch.as_tensor(cpu_aux),
                                   **tol)
        cpu_logits, cpu_cache = model.prefill(params, cpu_batch, max_len)
        gpu_logits, gpu_cache = model.prefill(gpu_params, gpu_batch, max_len)
        torch.testing.assert_close(gpu_logits.cpu(), cpu_logits, **tol)
        gpu_leaves = dict(L.flatten_specs(gpu_cache))
        for path, leaf in L.flatten_specs(cpu_cache):
            if leaf is not None:
                torch.testing.assert_close(gpu_leaves[path], leaf, **tol,
                                           check_device=False)
        for pos in range(n_prompt, n_prompt + 4):
            new = tokens[:, pos:pos + 1]
            cpu_logits, cpu_cache = model.decode_step(params, new, cpu_cache, pos)
            gpu_logits, gpu_cache = model.decode_step(gpu_params, new.cuda(), gpu_cache, pos)
            torch.testing.assert_close(gpu_logits.cpu(), cpu_logits, **tol)
    print(f"  {arch} SMOKE, card vs CPU (f32): forward, prefill logits and caches, "
          f"4 decode steps agree within {SMOKE_TOL}")


# ---------------------------------------------------------------------------
# phases 8-9: whisper-medium and xlstm-1.3b
# ---------------------------------------------------------------------------

# whisper-medium's audio length (30 s of log-mel frames after the stub
# frontend) and its decoder's learned positions
WHISPER_FRAMES, WHISPER_TOKENS = 1500, 448
# the serving batches' prompt lengths: prompt + new tokens stay within 448
WHISPER_PROMPTS = (4, 64)


def whisper(max_new: int = 32) -> dict:
    """whisper-medium at full size (24 + 24 layers, d 1024, 16 heads of 64,
    f32 params redrawn from seed 0, bf16 compute, "flash"): make_eval_step on
    2 batches of 8 x (1500 frames, 448 tokens), flash launching 48 times a
    batch, 24 of them non-causal (the encoder); logits through flash held
    against xla (f32 at full depth, bf16 at the first encoder and decoder
    layer); then ServeEngine.generate(frames=) on 2 batches of 8 requests
    (prompts of 4 and 64 tokens, 32 new tokens), 48 flash launches a prefill
    batch.  Returns the launches of each run."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.loop import make_eval_step

    model, params = big_model("whisper-medium")
    cfg = model.cfg
    per_batch = cfg.n_layers + cfg.n_encoder_layers
    launches, batch = evaluate(model, params, {"flash_attention": per_batch, "mamba_scan": 0,
                                               "gmm": 0},
                               shallow=SHALLOW_LAYERS, shallow_tol=PREFILL_SHALLOW_BF16_TOL,
                               S=WHISPER_TOKENS, frames=WHISPER_FRAMES)
    # which of one batch's launches are the encoder's (non-causal)
    reset_launch_counts()
    make_eval_step(model)(params, batch)
    torch.cuda.synchronize()
    one = launch_counts()["flash_attention"]
    noncausal = fa.flash_attention.noncausal_launches
    print(f"  one more eval batch: flash launched {one} times, {noncausal} of them non-causal")
    check(one == per_batch and noncausal == cfg.n_encoder_layers,
          f"whisper eval batch: {one} flash launches, {noncausal} non-causal; want "
          f"{per_batch}, {cfg.n_encoder_layers}")
    out = {"eval": launches["flash_attention"], "eval_batch_noncausal": noncausal}

    prefill_s, decode_s = [], []
    model.prefill = _timed(model.prefill, prefill_s)
    model.decode_step = _timed(model.decode_step, decode_s)
    engine = ServeEngine(model, params, device="cuda")
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((8, WHISPER_FRAMES, cfg.d_model)).astype(np.float32)
    batches = [rng.integers(0, cfg.vocab_size, (8, n)).astype(np.int32) for n in WHISPER_PROMPTS]
    engine.generate(batches[0], max_new_tokens=2, frames=frames)  # set-up
    prefill_s.clear()
    decode_s.clear()
    engine.stats = dict.fromkeys(engine.stats, 0)
    reset_launch_counts()
    t0 = time.perf_counter()
    results = [engine.generate(b, max_new_tokens=max_new, frames=frames) for b in batches]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    serve_launches = launch_counts()
    noncausal = fa.flash_attention.noncausal_launches
    for r in results:
        toks = np.asarray(r["tokens"])
        check(toks.shape == (8, max_new), f"bad token shape {toks.shape}")
        check(((toks >= 0) & (toks < cfg.vocab_size)).all(), "token out of range")
    tokens = engine.stats["tokens_generated"]
    print(f"  served 2 batches of 8 requests (prompts of {WHISPER_PROMPTS} tokens, {WHISPER_FRAMES} "
          f"frames each), {tokens} tokens in {wall:.3f} s: {tokens / wall:.1f} tok/s; kernel "
          f"launches {serve_launches}, {noncausal} of flash's non-causal")
    print(f"  prefill ms per batch: {[round(1e3 * t, 3) for t in prefill_s]}; decode ms per "
          f"token step (median of {len(decode_s)}): {1e3 * float(np.median(decode_s)):.3f}")
    want = {"flash_attention": 2 * per_batch, "mamba_scan": 0, "gmm": 0}
    check(serve_launches == want, f"whisper serving launched {serve_launches}, want {want}")
    check(noncausal == 2 * cfg.n_encoder_layers, f"{noncausal} non-causal launches")
    out.update(serve=serve_launches["flash_attention"], serve_noncausal=noncausal)
    del model.prefill, model.decode_step
    with torch.inference_mode():
        tok = torch.as_tensor(batches[1], device="cuda")
        batch = {"tokens": tok, "frames": torch.as_tensor(frames, device="cuda")}
        _profile("whisper prefill (1 batch)", lambda: model.prefill(params, batch, None))
        _, cache = model.prefill(params, batch, None)
        _profile("whisper decode (8 steps)", lambda: [
            model.decode_step(params, tok[:, -1:], cache, tok.shape[1] + i) for i in range(8)])
    del model, params, engine, cache
    torch.cuda.empty_cache()
    return out


XLSTM_TRAIN_STEPS = 2


def xlstm() -> dict:
    """xlstm-1.3b at full size (48 layers: 42 mLSTM and 6 sLSTM, d 2048, f32
    params redrawn from seed 0, bf16 compute): make_eval_step on 2 batches of
    8 x 512 with no kernel launched, the sLSTM blocks' share of one batch's
    time (host clock around synchronised calls), 16 requests served through
    BatchAccumulator (prompts 128-512, 32 new tokens, batch 8), then
    XLSTM_TRAIN_STEPS steps of make_train_step (remat "full") with a finite
    loss and finite gradients in every leaf.  Returns the numbers."""
    import numpy as np
    import torch

    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import layers as L
    from repro_torch.models import xlstm as xlstm_mod
    from repro_torch.models.model import Model
    from repro_torch.train import loop
    from repro_torch.train import optimizer as opt

    none = {"flash_attention": 0, "mamba_scan": 0, "gmm": 0}
    model, params = big_model("xlstm-1.3b")
    cfg = model.cfg
    _, batch = evaluate(model, params, none, shallow=None, shallow_tol=None, profile=False)

    # where one eval batch's time goes: the sLSTM blocks (a 512-step loop each)
    # and the mLSTM blocks, each call timed to a synchronise
    block_s = {"slstm": [], "mlstm": []}
    real = {name: getattr(xlstm_mod, f"apply_{name}_block") for name in block_s}
    for name in block_s:
        setattr(xlstm_mod, f"apply_{name}_block", _timed(real[name], block_s[name]))
    try:
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.loss(params, batch).item()
            total = time.perf_counter() - t0
    finally:
        for name in block_s:
            setattr(xlstm_mod, f"apply_{name}_block", real[name])
    out = {"eval_ms": 1e3 * total,
           **{f"{name}_ms": 1e3 * sum(t) for name, t in block_s.items()}}
    print(f"  one eval batch timed by block: {out['eval_ms']:.3f} ms, sLSTM blocks "
          f"{out['slstm_ms']:.3f} ms ({100 * out['slstm_ms'] / out['eval_ms']:.1f} %, "
          f"{len(block_s['slstm'])} calls), mLSTM blocks {out['mlstm_ms']:.3f} ms "
          f"({100 * out['mlstm_ms'] / out['eval_ms']:.1f} %, {len(block_s['mlstm'])} calls)")

    serve_and_profile(model, params, none)

    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=XLSTM_TRAIN_STEPS)
    state = loop.TrainState(params, opt.init_adamw(params))
    bad_grads = []
    real_update = opt.adamw_update

    def update(p, grads, s, tc):
        bad_grads.extend("/".join(path) for path, g in L.flatten_specs(grads)
                         if not bool(torch.isfinite(g).all()))
        return real_update(p, grads, s, tc)

    step_fn = loop.make_train_step(Model(cfg.replace(remat_policy="full")), tcfg)
    data = _train_batches(cfg, XLSTM_TRAIN_STEPS, TRAIN_B, TRAIN_S)
    opt.adamw_update = update
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    try:
        for i, b in enumerate(data):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, b)
            losses.append(metrics["loss"].item())
            times.append(time.perf_counter() - t0)
            print(f"  train step {i + 1}: loss {losses[-1]:.6f}, grad norm "
                  f"{metrics['grad_norm'].item():.4f}, {1e3 * times[-1]:.3f} ms")
    finally:
        opt.adamw_update = real_update
    check(launch_counts() == none, f"xlstm training launched {launch_counts()}")
    check(all(np.isfinite(losses)), f"xlstm training loss not finite: {losses}")
    check(not bad_grads, f"non-finite gradients in {sorted(set(bad_grads))}")
    out.update(train_losses=losses, train_step_ms=[1e3 * t for t in times],
               train_peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"  {XLSTM_TRAIN_STEPS} steps of {TRAIN_B} x {TRAIN_S} (remat full): gradients "
          f"finite in every leaf, peak memory {out['train_peak_memory_gb']:.2f} GB")
    del state, params, model, data
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 9: phi3-mini-3.8b prefill, head_dim 96 through the attention kernel
# ---------------------------------------------------------------------------


def prefill_phi3(B: int = 8, S: int = 512) -> int:
    """phi3-mini-3.8b at full width and depth (32 layers, 32 heads of 96, f32
    params drawn from seed 0, bf16 compute, "flash"): one prefill batch of
    B x S launches flash_attention once a layer and no other kernel, and its
    logits are held against attend_xla at internlm2's limits.  Returns the
    launches of that batch."""
    import numpy as np
    import torch

    model, params = big_model("phi3-mini-3.8b")
    cfg = model.cfg
    check(cfg.resolved_head_dim == 96, f"phi3-mini head_dim {cfg.resolved_head_dim}, want 96")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)),
                             device="cuda")
    with torch.inference_mode():
        model.prefill(params, {"tokens": tokens}, S)  # set-up
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, {"tokens": tokens}, S)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launch_counts()
        check(bool(torch.isfinite(logits).all()), "phi3 prefill logits not finite")
    want = {"flash_attention": cfg.n_layers, "mamba_scan": 0, "gmm": 0}
    print(f"  prefill 1 batch of {B} x {S}: {1e3 * wall:.3f} ms, logits "
          f"{tuple(logits.shape)}; kernel launches {launches}")
    check(launches == want, f"phi3 prefill launched {launches}, want {want}")
    prefill_flash_vs_xla(cfg, params, tokens)
    with torch.inference_mode():
        _profile("phi3 prefill (1 batch)", lambda: model.prefill(params, {"tokens": tokens}, S))
    del model, params, logits
    torch.cuda.empty_cache()
    return launches["flash_attention"]


# ---------------------------------------------------------------------------
# phase 10: training internlm2-1.8b
# ---------------------------------------------------------------------------

# 8 x 512 SyntheticTokens batches under the training launcher's schedule
# (lr 1e-3, 2 warmup steps, then a cosine over the run's steps)
TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 512, 5
TRAIN_SCHEDULE = dict(learning_rate=1e-3, warmup_steps=2, total_steps=TRAIN_STEPS)
# microbatches=1 against microbatches=2 on one batch in f32: the same loss and
# gradients summed in another order; params after the step at atol 2 lr(step 0)
# + rtol 1e-4, since Adam turns the sign of a near-zero gradient into a whole
# +-lr step (tests/test_torch_train.py)
MICROBATCH_TOL = 1e-4
# the flow sub-phase runs at full width and 2 layers: at full depth a
# checkpoint of params, m and v is 12 B x 1.889 B = 22.7 GB to write and read
# back, at 2 layers 6.1 GB
FLOW_LAYERS = 2


def _train_batches(cfg, n: int, B: int, S: int) -> list:
    import torch

    from repro_torch.train.data import SyntheticTokens

    data = SyntheticTokens(cfg.vocab_size, B, S, seed=0)
    return [{k: torch.as_tensor(v, device="cuda") for k, v in data.batch_at(i).items()}
            for i in range(n)]


def train() -> dict:
    """make_train_step on full-width, full-depth internlm2-1.8b (1.889 B
    params; f32 params and AdamW state, bf16 compute, attention_impl="xla",
    remat "full", the config's own), weights drawn from seed 0 (std
    1/sqrt(d_in)), TRAIN_STEPS steps on TRAIN_B x TRAIN_S batches.  Checks a
    finite loss that falls from the first step to the last, that no kernel
    of the three launches (the reference's Pallas kernels have no backward)
    and that the xla route's attention runs the training pair: 2 forward
    launches a layer (forward and remat's recompute) and 1 backward a step.
    Prints each step, the median step time, tokens/s, model
    FLOP/s (8 N tokens a step with remat), peak memory, the optimizer's share,
    one step each under remat "none" and "dots", and a one-step profile.
    Returns the numbers."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import Model
    from repro_torch.testing import redraw_params_
    from repro_torch.train import loop
    from repro_torch.train import optimizer as opt

    cfg = configs.get("internlm2-1.8b")
    check(cfg.attention_impl == "xla" and cfg.remat_policy == "full"
          and cfg.param_dtype == "float32" and cfg.compute_dtype == "bfloat16",
          "expected xla attention, full remat, f32 params, bf16 compute")
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator("cuda").manual_seed(0), device="cuda")
    redraw_params_(params, seed=0)
    state = loop.TrainState(params, opt.init_adamw(params))
    torch.cuda.synchronize()
    n_params = cfg.param_count()
    print(f"  internlm2-1.8b: {cfg.n_layers} layers, d {cfg.d_model}, {n_params / 1e9:.3f} B "
          f"params, state (params, m, v) {torch.cuda.memory_allocated() / 1e9:.1f} GB, init "
          f"{time.perf_counter() - t0:.1f} s")
    tcfg = TrainConfig(**TRAIN_SCHEDULE)
    step_fn = loop.make_train_step(model, tcfg)
    batches = _train_batches(cfg, TRAIN_STEPS, TRAIN_B, TRAIN_S)

    update_s, times, losses, norms = [], [], [], []
    real_update = opt.adamw_update
    opt.adamw_update = _timed(real_update, update_s)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    try:
        for i, batch in enumerate(batches):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            losses.append(metrics["loss"].item())
            norms.append(metrics["grad_norm"].item())
            times.append(time.perf_counter() - t0)
            print(f"  step {i + 1}: loss {losses[-1]:.6f}, grad norm {norms[-1]:.4f}, lr "
                  f"{metrics['lr'].item():.3e}, {1e3 * times[-1]:.3f} ms (AdamW "
                  f"{1e3 * update_s[-1]:.3f} ms)")
    finally:
        opt.adamw_update = real_update
    launches = launch_counts()
    train_attention = {"fwd": fa.flash_attention_fwd_lse.launches,
                       "bwd": fa.flash_attention_bwd.launches}
    peak = torch.cuda.max_memory_allocated()
    check(launches == {"flash_attention": 0, "mamba_scan": 0, "gmm": 0},
          f"training launched {launches}; its path runs no kernel of the three")
    want = {"fwd": 2 * cfg.n_layers * TRAIN_STEPS, "bwd": cfg.n_layers * TRAIN_STEPS}
    check(train_attention == want, f"training's attention launched {train_attention}, want {want}")
    check(all(np.isfinite(losses + norms)), f"training not finite: {losses} {norms}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    tokens = TRAIN_B * TRAIN_S
    step_s = float(np.median(times))
    flops = 8 * n_params * tokens  # forward, backward and the remat forward
    out = {"arch": "internlm2-1.8b", "layers": cfg.n_layers, "params": n_params,
           "batch": [TRAIN_B, TRAIN_S], "losses": losses, "grad_norms": norms,
           "step_ms": [1e3 * t for t in times], "median_step_ms": 1e3 * step_s,
           "tokens_per_s": tokens / step_s, "model_flops_per_s": flops / step_s,
           "model_flops_share": flops / step_s / PEAK_FLOPS["bfloat16"], "peak_memory_gb": peak / 1e9,
           "adamw_ms": 1e3 * float(np.median(update_s)), "launches": launches,
           "train_attention_launches": train_attention}
    print(f"  median step {out['median_step_ms']:.3f} ms: {out['tokens_per_s']:.1f} tokens/s, "
          f"model FLOP/s (8 N tokens) {out['model_flops_per_s'] / 1e12:.1f} T = "
          f"{100 * out['model_flops_share']:.1f} % of the bf16 peak; AdamW (host clock, median) "
          f"{out['adamw_ms']:.3f} ms; peak memory {out['peak_memory_gb']:.2f} GB; kernel "
          f"launches {launches}")

    # what remat costs: one step each without it and saving the projections
    for policy in ("none", "dots"):
        other = loop.make_train_step(Model(cfg.replace(remat_policy=policy)), tcfg)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = other(state, batches[0])
        metrics["loss"].item()
        ms = 1e3 * (time.perf_counter() - t0)
        out[f"step_ms_remat_{policy}"] = ms
        out[f"peak_memory_gb_remat_{policy}"] = torch.cuda.max_memory_allocated() / 1e9
        print(f"  one step with remat {policy!r}: {ms:.3f} ms, peak memory "
              f"{out[f'peak_memory_gb_remat_{policy}']:.2f} GB")
    out["profiled_step_busy_ms"] = _profile("train step (1 step, remat full)",
                                            lambda: step_fn(state, batches[0]), top=10,
                                            groups=KERNEL_GROUPS)
    # the FLOPs of one real step, for phase 12 to hold its traced count
    # against.  The trace runs on a (1, 1) mesh, whose DTensors take
    # attend_xla, so this step takes it too: the same ops by the same formulas.
    from unittest import mock

    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import attention

    with FlopCounterMode(display=False) as counter, \
            mock.patch.object(attention, "fused_causal", lambda *a, **k: False):
        step_fn(state, batches[0])
    out["counted_step_flops"] = counter.get_total_flops()
    del state, params, batches
    torch.cuda.empty_cache()
    return out


def train_microbatches() -> dict:
    """One training step at full width and 2 layers in f32 from the same
    state and batch with microbatches=1 and microbatches=2: loss and grad
    norm within MICROBATCH_TOL, params within atol 2 lr(step 0) + rtol 1e-4."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model
    from repro_torch.testing import redraw_params_
    from repro_torch.train import loop
    from repro_torch.train import optimizer as opt

    cfg = configs.get("internlm2-1.8b").replace(n_layers=FLOW_LAYERS, compute_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator("cuda").manual_seed(0), device="cuda")
    redraw_params_(params, seed=0)
    batch = _train_batches(cfg, 1, TRAIN_B, TRAIN_S)[0]
    tcfg = TrainConfig(**TRAIN_SCHEDULE)
    results = {}
    for mb in (1, 2):
        p = L.map_tree(torch.clone, params)
        state, metrics = loop.make_train_step(model, dataclasses.replace(tcfg, microbatches=mb))(
            loop.TrainState(p, opt.init_adamw(p)), batch)
        results[mb] = (state.params, {k: v.item() for k, v in metrics.items()})
        del state
    (p1, m1), (p2, m2) = results[1], results[2]
    gaps = {k: abs(m2[k] - m1[k]) / abs(m1[k]) for k in ("loss", "grad_norm")}
    atol = 2 * m1["lr"]
    margin = max(((a - b).abs() / (atol + MICROBATCH_TOL * b.abs())).max().item()
                 for (_, a), (_, b) in zip(L.flatten_specs(p2), L.flatten_specs(p1)))
    print(f"  {FLOW_LAYERS} layers, f32, one step of {TRAIN_B} x {TRAIN_S}: microbatches 1 vs 2, "
          f"loss {m1['loss']:.6f} vs {m2['loss']:.6f} (rel {gaps['loss']:.2e}), grad norm "
          f"{m1['grad_norm']:.5f} vs {m2['grad_norm']:.5f} (rel {gaps['grad_norm']:.2e}), tol "
          f"{MICROBATCH_TOL}; params margin {margin:.3f} (atol 2 lr = {atol:.1e}, rtol "
          f"{MICROBATCH_TOL}, at most 1)")
    check(max(gaps.values()) <= MICROBATCH_TOL, f"microbatches differ: {gaps}")
    check(margin <= 1.0, f"params after microbatched step differ: margin {margin}")
    del results, params, p1, p2
    torch.cuda.empty_cache()
    return {"loss_rel": gaps["loss"], "grad_norm_rel": gaps["grad_norm"], "params_margin": margin}


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def train_flow() -> dict:
    """The paper's training flow on the card: FlowsService -> ap://compute ->
    TrainingFabric (internlm2-1.8b at full width and FLOW_LAYERS layers,
    params from the fabric's own Model.init on seed 0) through the port's
    training_flow_definition, one segment of 4 steps with a NodeFailure
    injected at its second step, restored from the seed checkpoint.  Prints the
    run's status, the restored step, each checkpoint's bytes and save and
    restore seconds, and the eval loss; no kernel of the three launches."""
    import math
    import shutil

    from repro_torch import configs
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.train import run_training_flow
    from repro_torch.train.fabric import TrainingFabric

    cfg = configs.get("internlm2-1.8b").replace(n_layers=FLOW_LAYERS)
    workdir = ROOT / "build" / "train_flow"
    shutil.rmtree(workdir, ignore_errors=True)
    fabric = TrainingFabric(cfg, TrainConfig(**TRAIN_SCHEDULE), batch=TRAIN_B, seq_len=TRAIN_S,
                            ckpt_dir=str(workdir / "ckpt"), device="cuda")
    save_s, restore_s = [], []
    fabric.save_checkpoint = _timed(fabric.save_checkpoint, save_s)
    fabric.restore_latest = _timed(fabric.restore_latest, restore_s)
    reset_launch_counts()
    run = run_training_flow(fabric, str(workdir), segments=1, steps_per_segment=4,
                            simulate_failure=True, label="chip-smoke")
    launches = launch_counts()
    check(run.status == "SUCCEEDED", f"training flow {run.status}: {run.error}")
    check("NodeFailure" in str(run.context.get("failure")), "no NodeFailure was caught")
    restored = run.context["restore"]["details"]["results"][0]["restored_step"]
    final = run.context["train"]["details"]["results"][0]
    eval_loss = run.context["eval"]["details"]["results"][0]["eval_loss"]
    check(restored == 0 and final["step"] == 4, f"restored {restored}, final {final}")
    check(math.isfinite(eval_loss) and math.isfinite(final["loss"]), f"eval loss {eval_loss}")
    check(launches == {"flash_attention": 0, "mamba_scan": 0, "gmm": 0},
          f"the training flow launched {launches}")
    ckpt_bytes = _dir_bytes(workdir / "ckpt" / "step_00000004")
    out = {"layers": FLOW_LAYERS, "params": cfg.param_count(), "status": run.status,
           "restored_step": restored, "final_step": final["step"], "eval_loss": eval_loss,
           "checkpoint_bytes": ckpt_bytes, "save_s": save_s, "restore_s": restore_s}
    print(f"  flow run {run.status}: {cfg.n_layers} layers ({out['params'] / 1e6:.1f} M params), "
          f"NodeFailure at step 1 caught, restored step {restored}, final step {final['step']} "
          f"(loss {final['loss']:.4f}), eval loss {eval_loss:.4f}; kernel launches {launches}")
    print(f"  checkpoint {ckpt_bytes / 1e9:.3f} GB: save s {[round(t, 3) for t in save_s]} "
          f"({ckpt_bytes / 1e9 / max(save_s):.2f} GB/s at the slower), restore s "
          f"{[round(t, 3) for t in restore_s]} ({ckpt_bytes / 1e9 / restore_s[0]:.2f} GB/s)")
    del fabric
    shutil.rmtree(workdir, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 11: shard (logical-axis sharding over DTensor, one card)
# ---------------------------------------------------------------------------

# sharded against unsharded on one card: a (1, 1) mesh runs the same local
# products, so the two differ at most in summation order (the f32 logits
# tolerance of the slices, relative)
SHARD_TOL = 1e-3
SHARD_STEPS = 2


def _shard_fabric(cfg, mesh, ckpt_dir):
    import torch

    from repro_torch.configs.base import TrainConfig
    from repro_torch.train.fabric import TrainingFabric

    return TrainingFabric(cfg, TrainConfig(**TRAIN_SCHEDULE), batch=TRAIN_B, seq_len=TRAIN_S,
                          ckpt_dir=str(ckpt_dir), device=torch.device("cuda", 0), mesh=mesh)


def shard_train(mesh) -> dict:
    """SHARD_STEPS steps of full-width, full-depth internlm2-1.8b (f32 params,
    bf16 compute, "xla", remat "full", as phase 10) on TRAIN_B x TRAIN_S
    batches through TrainingFabric, unsharded and then on ``mesh``, from the
    fabric's own init on the same seed and the same batches: losses within
    SHARD_TOL, each step's ms (DTensor's dispatch on record) and peak memory;
    no kernel launches."""
    import torch

    from repro_torch import configs

    cfg = configs.get("internlm2-1.8b")
    out = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        t0 = time.perf_counter()
        fabric = _shard_fabric(cfg, m, ROOT / "build" / "shard_train")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        records = []
        for _ in range(SHARD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = fabric.train_steps(1)
            records.append((rec["loss"], 1e3 * (time.perf_counter() - t0)))
        launches = launch_counts()
        placements = sorted({str(p.placements) for p in fabric.state.params["blocks"]["attn"]
                             ["wq"].values()} if m is not None else {"plain"})
        out[name] = {"losses": [r[0] for r in records], "step_ms": [r[1] for r in records],
                     "init_s": init_s, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                     "launches": launches, "wq_placements": placements}
        print(f"  {name}: losses {out[name]['losses']}, step ms "
              f"{[round(ms, 3) for ms in out[name]['step_ms']]}, init {init_s:.1f} s, peak "
              f"memory {out[name]['peak_memory_gb']:.2f} GB, launches {launches}, wq "
              f"placements {placements}")
        check(launches == {"flash_attention": 0, "mamba_scan": 0, "gmm": 0},
              f"{name} training launched {launches}")
        del fabric
        torch.cuda.empty_cache()
    a, b = out["sharded"]["losses"], out["unsharded"]["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    out["loss_rel"] = rel
    print(f"  sharded vs unsharded losses: relative {rel:.3e} (tol {SHARD_TOL}); step ms "
          f"{out['sharded']['step_ms'][-1]:.3f} vs {out['unsharded']['step_ms'][-1]:.3f} "
          f"(the last step)")
    check(rel <= SHARD_TOL, f"sharded losses {a} differ from unsharded {b}")
    return out


def shard_prefill(mesh, B: int = 8, S: int = 512) -> dict:
    """internlm2-1.8b prefill under "flash" at full size on ``mesh``: 24 flash
    launches a batch (per shard, through local_map), logits and caches within
    SHARD_TOL of the unsharded flash prefill."""
    import numpy as np
    import torch

    from repro_torch.models.model import param_axes, param_shapes
    from repro_torch.parallel import sharding as sh

    model, params = big_model("internlm2-1.8b")
    cfg = model.cfg
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S)),
                             device="cuda")
    with torch.inference_mode():
        model.prefill(params, {"tokens": tokens}, S)  # set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, want_cache = model.prefill(params, {"tokens": tokens}, S)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        dparams = sh.distribute_tree(params, sh.param_shardings(
            param_axes(cfg), mesh, sh.PARAM_RULES, param_shapes(cfg)))
        with sh.use_rules(sh.PARAM_RULES, sh.ACT_RULES, mesh):
            dtokens = sh.distribute_input(tokens, "batch", "seq")
            model.prefill(dparams, {"tokens": dtokens}, S)  # set-up
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            got, cache = model.prefill(dparams, {"tokens": dtokens}, S)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = launch_counts()
            got = got.full_tensor().float()
            rel_cache = rel_l2(cache["k"].full_tensor().float(), want_cache["k"].float())
    rel = rel_l2(got, want.float())
    print(f"  sharded flash prefill of {B} x {S}: {1e3 * wall:.3f} ms (unsharded "
          f"{1e3 * plain_wall:.3f} ms), launches {launches}; "
          f"logits vs unsharded (relative L2) {rel:.3e}, k cache {rel_cache:.3e} "
          f"(tol {SHARD_TOL})")
    want_launches = {"flash_attention": cfg.n_layers, "mamba_scan": 0, "gmm": 0}
    check(launches == want_launches, f"sharded prefill launched {launches}, "
          f"want {want_launches}")
    check(rel <= SHARD_TOL and rel_cache <= SHARD_TOL, f"sharded prefill differs: {rel} "
          f"{rel_cache}")
    del model, params, dparams, cache, want_cache
    torch.cuda.empty_cache()
    return {"ms": 1e3 * wall, "unsharded_ms": 1e3 * plain_wall,
            "launches": launches["flash_attention"], "logits_rel": rel,
            "cache_rel": rel_cache}


def shard_whisper_prefill(mesh, B: int = 8, prompt: int = 64) -> dict:
    """whisper-medium prefill under "flash" at full size on ``mesh``: 48 flash
    launches a batch, 24 of them non-causal (the encoder), per shard through
    local_map; logits and both caches (self and cross) within SHARD_TOL of
    the unsharded flash prefill (ROADMAP F7: the caches are placed on the
    mesh)."""
    import numpy as np
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.model import param_axes, param_shapes
    from repro_torch.parallel import sharding as sh

    t_part = time.perf_counter()
    model, params = big_model("whisper-medium")
    cfg = model.cfg
    rng = np.random.default_rng(4)
    frames = torch.as_tensor(rng.standard_normal((B, WHISPER_FRAMES, cfg.d_model)),
                             dtype=torch.float32, device="cuda")
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, prompt)), device="cuda")
    batch = {"frames": frames, "tokens": tokens}
    with torch.inference_mode():
        model.prefill(params, batch, None)  # set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want, want_cache = model.prefill(params, batch, None)
        torch.cuda.synchronize()
        plain_wall = time.perf_counter() - t0
        dparams = sh.distribute_tree(params, sh.param_shardings(
            param_axes(cfg), mesh, sh.PARAM_RULES, param_shapes(cfg)))
        with sh.use_rules(sh.PARAM_RULES, sh.ACT_RULES, mesh):
            dbatch = {"frames": sh.distribute_input(frames, "batch", "seq", "embed"),
                      "tokens": sh.distribute_input(tokens, "batch", "seq")}
            model.prefill(dparams, dbatch, None)  # set-up
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            got, cache = model.prefill(dparams, dbatch, None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches, noncausal = launch_counts(), fa.flash_attention.noncausal_launches
            got = got.full_tensor().float()
            rel_cache = {f"{part}_{kv}": rel_l2(cache[part][kv].full_tensor().float(),
                                                want_cache[part][kv].float())
                         for part in ("self", "cross_kv") for kv in ("k", "v")}
    rel = rel_l2(got, want.float())
    seconds = time.perf_counter() - t_part
    print(f"  sharded whisper flash prefill of {B} x ({WHISPER_FRAMES} frames, {prompt} tokens): "
          f"{1e3 * wall:.3f} ms (unsharded {1e3 * plain_wall:.3f} ms), launches {launches}, "
          f"{noncausal} non-causal; logits vs unsharded (relative L2) {rel:.3e}, caches "
          f"{rel_cache} (tol {SHARD_TOL}); part {seconds:.1f} s")
    n_layers = cfg.n_layers + cfg.n_encoder_layers
    want_launches = {"flash_attention": n_layers, "mamba_scan": 0, "gmm": 0}
    check(launches == want_launches and noncausal == cfg.n_encoder_layers,
          f"sharded whisper prefill launched {launches}, {noncausal} non-causal; want "
          f"{want_launches}, {cfg.n_encoder_layers}")
    check(rel <= SHARD_TOL and max(rel_cache.values()) <= SHARD_TOL,
          f"sharded whisper prefill differs: {rel} {rel_cache}")
    del model, params, dparams, cache, want_cache
    torch.cuda.empty_cache()
    return {"ms": 1e3 * wall, "unsharded_ms": 1e3 * plain_wall,
            "launches": launches["flash_attention"], "noncausal_launches": noncausal,
            "logits_rel": rel, "cache_rel": rel_cache, "seconds": seconds}


# one xLSTM super-block at full width: 7 mLSTM blocks and 1 sLSTM block
XLSTM_SHARD_LAYERS = 8


def shard_xlstm_train(mesh) -> dict:
    """SHARD_STEPS steps of xlstm-1.3b at full width and one super-block deep
    (XLSTM_SHARD_LAYERS layers; f32 params redrawn from seed 0, bf16 compute,
    the config's remat) on TRAIN_B x TRAIN_S batches through TrainingFabric,
    unsharded and then on ``mesh`` from the same weights (ROADMAP F6): losses
    within SHARD_TOL (and whether bit for bit), step ms, no kernel launched."""
    import torch

    from repro_torch import configs
    from repro_torch.models import layers as L
    from repro_torch.parallel import sharding as sh
    from repro_torch.testing import redraw_params_
    from repro_torch.train.loop import TrainState
    from repro_torch.train.optimizer import init_adamw

    t_part = time.perf_counter()
    cfg = configs.get("xlstm-1.3b").replace(n_layers=XLSTM_SHARD_LAYERS)
    out = {}
    weights = None
    for name, m in (("unsharded", None), ("sharded", mesh)):
        fabric = _shard_fabric(cfg, m, ROOT / "build" / "shard_xlstm")
        if weights is None:
            redraw_params_(fabric.state.params, seed=0)
            weights = L.map_tree(torch.clone, fabric.state.params)
        else:
            params = sh.distribute_tree(L.map_tree(torch.clone, weights),
                                        fabric._shardings()[0])
            fabric.state = TrainState(params, init_adamw(params))
        reset_launch_counts()
        records = []
        for _ in range(SHARD_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rec = fabric.train_steps(1)
            records.append((rec["loss"], 1e3 * (time.perf_counter() - t0)))
        launches = launch_counts()
        out[name] = {"losses": [r[0] for r in records], "step_ms": [r[1] for r in records]}
        print(f"  xlstm-1.3b ({cfg.n_layers} layers, d {cfg.d_model}) {name}: losses "
              f"{out[name]['losses']}, step ms {[round(ms, 3) for ms in out[name]['step_ms']]}")
        check(launches == {"flash_attention": 0, "mamba_scan": 0, "gmm": 0},
              f"xlstm {name} training launched {launches}")
        del fabric
        torch.cuda.empty_cache()
    del weights
    a, b = out["sharded"]["losses"], out["unsharded"]["losses"]
    rel = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    out.update(loss_rel=rel, bit_for_bit=a == b, seconds=time.perf_counter() - t_part)
    print(f"  xlstm sharded vs unsharded losses: relative {rel:.3e} (tol {SHARD_TOL}), "
          f"{'bit for bit' if a == b else 'not bit for bit'}; part {out['seconds']:.1f} s")
    check(all(x == x for x in a + b), f"xlstm losses not finite: {a} {b}")
    check(rel <= SHARD_TOL, f"xlstm sharded losses {a} differ from unsharded {b}")
    return out


def shard_smoke(mesh) -> dict:
    """SMOKE zamba2-7b eval under "flash" (the scan, per shard) and SMOKE
    mixtral-8x7b's apply_moe(use_gmm=True) on layer 0 (gmm, experts per
    shard), each on ``mesh`` against its unsharded run, f32, within
    SMOKE_TOL."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import moe
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import Model, param_axes, param_shapes
    from repro_torch.parallel import sharding as sh
    from repro_torch.testing import redraw_params_
    from repro_torch.train.loop import make_eval_step

    out = {}
    rng = np.random.default_rng(2)
    for arch in ("zamba2-7b", "mixtral-8x7b"):
        cfg = configs.get(arch, smoke=True).replace(compute_dtype="float32",
                                                    attention_impl="flash")
        model = Model(cfg)
        params = model.init(torch.Generator("cuda").manual_seed(0), device="cuda")
        redraw_params_(params, seed=0)
        dparams = sh.distribute_tree(params, sh.param_shardings(
            param_axes(cfg), mesh, sh.PARAM_RULES, param_shapes(cfg)))
        t = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 65)), device="cuda")
        batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        # no_grad, not inference_mode: the params are ordinary DTensors, and
        # some DTensor versions cannot view one under inference mode
        with torch.no_grad():
            if arch == "zamba2-7b":
                kernel, step = "mamba_scan", make_eval_step(model)
                want = step(params, batch)["loss"]
                reset_launch_counts()
                with sh.use_rules(sh.PARAM_RULES, sh.ACT_RULES, mesh):
                    got = step(dparams, batch)["loss"]
                n = launch_counts()[kernel]
                want_n = cfg.n_layers
            else:
                kernel = "gmm"
                p0 = tfm.layer_params(params["blocks"], 0)["moe"]
                x = torch.randn(4, 64, cfg.d_model, device="cuda",
                                generator=torch.Generator("cuda").manual_seed(3))
                want, want_aux = moe.apply_moe(p0, cfg, x, use_gmm=True)
                reset_launch_counts()
                with sh.use_rules(sh.PARAM_RULES, sh.ACT_RULES, mesh):
                    dp0 = tfm.layer_params(dparams["blocks"], 0)["moe"]
                    got, aux = moe.apply_moe(dp0, cfg, sh.distribute_input(
                        x, "batch", "seq", "embed"), use_gmm=True)
                    got, aux = got.full_tensor(), sh.full_tensor(aux)
                n = launch_counts()[kernel]
                want_n = 3
                check(bool(torch.allclose(aux, want_aux, rtol=SMOKE_TOL, atol=SMOKE_TOL)),
                      f"sharded aux {aux} vs {want_aux}")
        err = float((got - want).abs().max() / max(1.0, float(want.abs().max())))
        print(f"  {arch} SMOKE on the mesh ({kernel} per shard): {n} launches (want {want_n}), "
              f"max|err| vs unsharded {err:.3e} (tol {SMOKE_TOL})")
        check(n == want_n, f"{arch}: {kernel} launched {n} times on the mesh, want {want_n}")
        check(err <= SMOKE_TOL, f"{arch} sharded differs from unsharded: {err}")
        out[kernel] = {"launches": n, "max_err": err}
        del model, params, dparams
    torch.cuda.empty_cache()
    return out


def shard_flow(mesh) -> dict:
    """The elastic flow (repro_torch.launch.elastic) at full width and
    FLOW_LAYERS layers on ``mesh``: 2 steps, a checkpoint, a NodeFailure at
    step 3, reshard onto the 1-D ("data",) mesh (the placements change on
    restore), 2 more steps; the run must end SUCCEEDED."""
    import shutil

    from repro_torch import configs
    from repro_torch.launch.elastic import run_elastic_flow, summary
    from repro_torch.launch.mesh import make_mesh

    cfg = configs.get("internlm2-1.8b").replace(n_layers=FLOW_LAYERS)
    workdir = ROOT / "build" / "shard_flow"
    shutil.rmtree(workdir, ignore_errors=True)
    fabric = _shard_fabric(cfg, mesh, workdir / "ckpt")
    small = make_mesh((1,), ("data",))
    before = str(fabric.state.params["embed"]["table"].placements)
    t0 = time.perf_counter()
    run = run_elastic_flow(fabric, small, steps_per_segment=2, fail_at=3)
    wall = time.perf_counter() - t0
    rec = summary(run, fabric)
    after = str(fabric.state.params["embed"]["table"].placements)
    print(f"  elastic flow {rec['status']} in {wall:.1f} s: caught {rec['failure']!r}, "
          f"reshard {rec['reshard']}, final step {rec['final_step']}, embed placements "
          f"{before} -> {after}")
    check(rec["status"] == "SUCCEEDED", f"elastic flow {rec['status']}: {rec['error']}")
    check(rec["reshard"].get("new_mesh") == (1,) and rec["reshard"].get("restored_step") == 2
          and rec["final_step"] == 4 and before != after, f"elastic flow: {rec}")
    del fabric
    shutil.rmtree(workdir, ignore_errors=True)
    return {"status": rec["status"], "seconds": wall, "reshard": rec["reshard"],
            "final_step": rec["final_step"], "placements": [before, after]}


def shard() -> dict:
    """Phase 11: a world of one NCCL rank, a (1, 1) ("data", "model") mesh on
    the card, and the sharded paths on it (training, flash prefill,
    whisper's flash prefill, xLSTM training, the scan and gmm per shard, the
    elastic flow).  Returns their records."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_process_group, make_mesh

    init_process_group("cuda", 0, 1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"))
        out = {"train": shard_train(mesh)}
        out["prefill"] = shard_prefill(mesh)
        out["whisper_prefill"] = shard_whisper_prefill(mesh)
        out["xlstm_train"] = shard_xlstm_train(mesh)
        out.update(shard_smoke(mesh))
        out["flow"] = shard_flow(mesh)
    finally:
        dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# phase 12: the dry-run on the production meshes
# ---------------------------------------------------------------------------

# (arch, shape, mesh, cfg_override): a training cell on 256 ranks, an MoE
# prefill, the long-context decode whose cache shards its sequence over the
# 512-rank mesh's ("pod", "data"), a prefill traced through the flash
# kernel's custom op, xLSTM's training (its loops as single ops, ROADMAP F6;
# each of its 4 heads' value dims and sLSTM columns split over 4 of the 16
# model ranks, F9; its loops' backward from saved residuals, F13), whisper's
# prefill (its caches on the mesh, F7), mixtral's decode (its 128 tokens one
# routing group, whose expert work the data ranks split, F11) and xLSTM's
# decode (its value projection on a data rank's rows, F12; the mLSTM's
# value split with its state kept sliced in the cache, F14)
DRYRUN_CELLS = (
    ("internlm2-1.8b", "train_4k", "single", None),
    ("mixtral-8x7b", "prefill_32k", "single", None),
    ("zamba2-7b", "long_500k", "multi", None),
    ("internlm2-1.8b", "prefill_32k", "single", {"attention_impl": "flash"}),
    ("xlstm-1.3b", "train_4k", "single", None),
    ("whisper-medium", "prefill_32k", "single", None),
    ("mixtral-8x7b", "decode_32k", "single", None),
    ("xlstm-1.3b", "decode_32k", "single", None),
)
# FLOPs a card that a cell may not exceed: the work the port repeated on a
# mesh before F9, F11 and F12 (3.054e14, 2.570e11 and 4.998e10), with the
# reference's split, is a few times less
DRYRUN_FLOP_CEILINGS = {
    "xlstm-1.3b__train_4k__single": 1.5e14,
    "mixtral-8x7b__decode_32k__single": 1e11,
    "xlstm-1.3b__decode_32k__single": 1e10,
}
# wire bytes a card that a cell may not exceed: xlstm-1.3b's with each head
# whole on every model rank, as before F9 (train_4k) and F14 (decode_32k),
# which the splits may not raise.  Every xLSTM cell is also traced with the
# splits off (_heads_whole) and may not move more bytes than that trace.
DRYRUN_WIRE_CEILINGS = {
    "xlstm-1.3b__train_4k__single": 250951.2 * 2 ** 20,
    "xlstm-1.3b__decode_32k__single": 284.0 * 2 ** 20,
}
DRYRUN_FLASH_CELL = "internlm2-1.8b__prefill_32k__single__flash"
# phase 10's step traced on (1, 1) against FlopCounterMode around a real step
# on the card: the same ops by the same formulas, so equal up to float sums
DRYRUN_FLOPS_RTOL = 1e-9


def _dryrun_record(rec: dict, row: dict) -> dict:
    keep = ("compute_s", "memory_s", "collective_s", "dominant", "useful_ratio",
            "roofline_fraction", "collective_counts")
    return {"mesh_shape": rec["mesh_shape"], "lower_seconds": rec["lower_seconds"],
            "total_seconds": rec["total_seconds"], "ops": rec["hlo_instructions"],
            "flops": rec["cost"]["flops"], "bytes_accessed": rec["cost"]["bytes accessed"],
            "wire_bytes": rec["collectives"]["_total"]["wire_bytes_per_device"],
            "argument_bytes": rec["memory"]["argument_size_in_bytes"],
            "temp_bytes": rec["memory"]["temp_size_in_bytes"],
            "kernel_calls": rec["kernel_calls"], **{k: row[k] for k in keep}}


def _heads_whole(arch: str, shape: str, mesh: str) -> dict:
    """The cell traced with every split of xLSTM's work over a head's ranks
    off (``xlstm._head_split``: the mLSTM's value split in every step, the
    sLSTM's recurrence split; each head whole on every model rank, as
    before F9 and F14): its FLOPs, wire and temp bytes and count of
    collectives a card."""
    from unittest import mock

    from repro_torch.launch import dryrun as dr
    from repro_torch.models import xlstm

    with mock.patch.object(xlstm, "_head_split", lambda *a: None):
        rec = dr.run_cell(arch, shape, mesh, tag="heads_whole", device="cuda")
    check(rec["status"] == "ok", f"dry-run of {arch} x {shape} with heads whole failed:\n"
                                 f"{rec.get('traceback')}")
    return {"flops": rec["cost"]["flops"],
            "wire_bytes": rec["collectives"]["_total"]["wire_bytes_per_device"],
            "temp_bytes": rec["memory"]["temp_size_in_bytes"],
            "temp_at_peak": rec["memory"]["temp_at_peak"],
            "collectives": rec["collectives"]["_total"]["count"]}


def dryrun(training: dict) -> dict:
    """Phase 12: repro_torch.launch.dryrun.run_cell on each of DRYRUN_CELLS,
    a fake world of 256 or 512 ranks with the mesh on "cuda" (fake tensors:
    nothing is allocated, no kernel launches), each record's summary,
    roofline row and three costliest products printed; every cell must end ok, the flash cell with one
    flash node a layer, the cells of DRYRUN_FLOP_CEILINGS under theirs.  Then phase 10's step (internlm2-1.8b, 8 x 512, remat
    "full", its TrainConfig) traced on a (1, 1) world: its FLOPs must equal
    FlopCounterMode's around one real step of phase 10 on the card (within
    DRYRUN_FLOPS_RTOL), its compute term may not exceed phase 10's measured
    median step, and it is printed with the memory term beside that median
    and the profiled step's busy time."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import roofline

    reset_launch_counts()
    out = {}
    for arch, shape, mesh, override in DRYRUN_CELLS:
        tag = "flash" if override else ""
        rec = dr.run_cell(arch, shape, mesh, cfg_override=override, tag=tag, device="cuda")
        print(f"  {dr.summary(rec)}")
        check(rec["status"] == "ok", f"dry-run of {arch} x {shape} x {mesh} failed:\n"
                                     f"{rec.get('traceback')}")
        row = roofline.analyze(rec)
        print("  " + roofline.markdown_table([row]).splitlines()[-1])
        for op in rec["top_flops"][:3]:
            print(f"    {op['flops']:.4e} FLOPs in {op['count']} x {op['op']} {op['shapes']}")
        name = "__".join(filter(None, (arch, shape, mesh, tag)))
        out[name] = _dryrun_record(rec, row)
        if name in DRYRUN_FLOP_CEILINGS:
            print(f"    {rec['cost']['flops']:.4e} FLOPs a card, ceiling "
                  f"{DRYRUN_FLOP_CEILINGS[name]:.1e}")
            check(rec["cost"]["flops"] <= DRYRUN_FLOP_CEILINGS[name],
                  f"{name} traced {rec['cost']['flops']:.4e} FLOPs a card, over "
                  f"{DRYRUN_FLOP_CEILINGS[name]:.1e}")
        wire = rec["collectives"]["_total"]["wire_bytes_per_device"]
        if name in DRYRUN_WIRE_CEILINGS:
            print(f"    {wire / 2 ** 20:.1f} MiB on the wire a card, ceiling "
                  f"{DRYRUN_WIRE_CEILINGS[name] / 2 ** 20:.1f}")
            check(wire <= DRYRUN_WIRE_CEILINGS[name],
                  f"{name} moves {wire / 2 ** 20:.1f} MiB a card, over "
                  f"{DRYRUN_WIRE_CEILINGS[name] / 2 ** 20:.1f}")
        if arch == "xlstm-1.3b":
            out[name]["heads_whole"] = whole = _heads_whole(arch, shape, mesh)
            print(f"    with each head whole on its model ranks: {whole['flops']:.4e} FLOPs, "
                  f"{whole['wire_bytes'] / 2 ** 20:.1f} MiB on the wire, "
                  f"{whole['collectives']} collectives, temp "
                  f"{whole['temp_bytes'] / 2 ** 30:.2f} GiB a card (split: "
                  f"{rec['cost']['flops']:.4e} FLOPs, {wire / 2 ** 20:.1f} MiB, "
                  f"{rec['collectives']['_total']['count']} collectives, temp "
                  f"{rec['memory']['temp_size_in_bytes'] / 2 ** 30:.2f} GiB)")
            for what, at_peak in (("split", rec["memory"]["temp_at_peak"]),
                                  ("heads whole", whole["temp_at_peak"])):
                for e in at_peak[:4]:
                    print(f"      {what}, live at the temp peak: {e['bytes'] / 2 ** 30:.3f} GiB "
                          f"in {e['count']} x {e['op']} {e['shape']} {e['dtype']}")
            check(wire <= whole["wire_bytes"], f"{name}: the value split moves "
                  f"{wire / 2 ** 20:.1f} MiB a card, more than its heads whole "
                  f"({whole['wire_bytes'] / 2 ** 20:.1f})")
        if override:
            n_layers = configs.get(arch).n_layers
            check(rec["kernel_calls"].get("flash_attention") == n_layers,
                  f"the flash cell traced {rec['kernel_calls']}, not {n_layers} flash calls")

    shape = ShapeConfig("train_8x512", "train", TRAIN_S, TRAIN_B)
    rec = dr.run_cell("internlm2-1.8b", shape.name, "1x1", tcfg=TrainConfig(**TRAIN_SCHEDULE),
                      device="cuda", shape=shape, mesh_shape=(1, 1), tag="phase10")
    print(f"  {dr.summary(rec)}")
    check(rec["status"] == "ok", f"dry-run of phase 10's step failed:\n{rec.get('traceback')}")
    row = roofline.analyze(rec)
    median_s = training["median_step_ms"] / 1e3
    print(f"  phase 10's step traced on (1, 1): {rec['cost']['flops']:.4e} FLOPs, compute term "
          f"{1e3 * row['compute_s']:.3f} ms, memory term {1e3 * row['memory_s']:.3f} ms "
          f"(unfused upper bound); measured: median step {1e3 * median_s:.3f} ms, profiled "
          f"step busy {training['profiled_step_busy_ms']:.3f} ms; the traced FLOPs at the "
          f"median step are {100 * row['compute_s'] / median_s:.1f} % of the bf16 peak")
    check(row["compute_s"] <= median_s, f"the traced compute term {row['compute_s']:.4f} s "
                                        f"exceeds the measured median step {median_s:.4f} s")
    counted = training["counted_step_flops"]
    print(f"  FlopCounterMode around one real step of phase 10 on the card: {counted:.6e} "
          f"FLOPs; traced {rec['cost']['flops']:.6e}")
    check(abs(rec["cost"]["flops"] - counted) <= DRYRUN_FLOPS_RTOL * counted,
          f"the traced FLOPs {rec['cost']['flops']:.6e} differ from the {counted:.6e} counted "
          f"around a real step by more than {DRYRUN_FLOPS_RTOL}")
    out["phase10_step_1x1"] = {**_dryrun_record(rec, row),
                               "counted_step_flops": counted,
                               "median_step_ms": training["median_step_ms"],
                               "profiled_step_busy_ms": training["profiled_step_busy_ms"]}
    launches = launch_counts()
    check(launches == {"flash_attention": 0, "mamba_scan": 0, "gmm": 0},
          f"the dry-run launched {launches}; it traces fake tensors")
    return out


def gradient_guard() -> None:
    """A backward through any kernel route raises on the card, as on the CPU:
    Model.loss(...).backward() under attention_impl="flash" with params that
    require grad, and mamba_scan and gmm on CUDA inputs that require grad.
    Nothing is launched."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model

    cfg = configs.get("internlm2-1.8b", smoke=True).replace(attention_impl="flash")
    params = Model(cfg).init(torch.Generator("cuda").manual_seed(0), device="cuda")
    params = L.map_tree(lambda p: p.requires_grad_(), params)
    tokens = torch.ones((2, 16), dtype=torch.long, device="cuda")
    gen = torch.Generator("cuda").manual_seed(0)

    def rand(*shape, grad=False):
        return torch.randn(*shape, generator=gen, device="cuda").requires_grad_(grad)

    calls = {
        "Model.loss(flash).backward()": lambda: Model(cfg).loss(
            params, {"tokens": tokens, "labels": tokens}).backward(),
        "mamba_scan": lambda: ops.mamba_scan(rand(1, 64, 2, 16, grad=True), rand(1, 64, 2).abs(),
                                             -rand(2).abs(), rand(1, 64, 16), rand(1, 64, 16),
                                             chunk=32),
        "gmm": lambda: ops.gmm(rand(2, 16, 32), rand(2, 32, 16, grad=True)),
    }
    reset_launch_counts()
    for name, call in calls.items():
        try:
            call()
        except NotImplementedError as e:
            print(f"  {name} with inputs that require grad: NotImplementedError ({e})")
        else:
            raise RuntimeError(f"{name} ran a kernel route under autograd")
    check(launch_counts() == {"flash_attention": 0, "mamba_scan": 0, "gmm": 0},
          "a kernel launched under autograd")


# ---------------------------------------------------------------------------
# python3 chip_smoke.py --flash-ablation | --scan-ablation: a kernel with
# parts of its work switched off, by text substitution in a copy of its source
# ---------------------------------------------------------------------------

NO_GEMM = [
    ("  for (int kk = 0; kk < D / 16; ++kk)\n    ptx::wgmma_m64n64k16<0>(",
     "  for (int kk = 0; kk < 0; ++kk)\n    ptx::wgmma_m64n64k16<0>("),
    ("for (int kk = 0; kk < TC_BN / 16; ++kk) pv_wgmma<DV>(",
     "for (int kk = 0; kk < 0; ++kk) pv_wgmma<DV>("),
]
# the loop runs no time, but the compiler still sees its code
NO_SOFTMAX = [
    ("    // online softmax; entries 2i, 2i+1 of each fragment belong to row i\n"
     "#pragma unroll\n    for (int i = 0; i < 2; ++i) {",
     "    // online softmax; entries 2i, 2i+1 of each fragment belong to row i\n"
     "#pragma unroll\n    for (int i = 0; i < 2 * (softcap < 0.f); ++i) {"),
]
# only the first K/V tile is loaded and waited for; later tiles reuse stale data
NO_KV_LOADS = [
    ("    ptx::mbar_wait(&landed[stage], ((j_hi - j + stage) >> 1) & 1);",
     "    if (j == j_hi) ptx::mbar_wait(&landed[stage], ((j_hi - j + stage) >> 1) & 1);"),
    ("    if (j > j_lo && tid == 0) {", "    if (j < -1 && tid == 0) {"),
]
FLASH_ABLATIONS = {
    "full": [],
    "no_products": NO_GEMM,
    "no_softmax": NO_SOFTMAX,
    "no_kv_loads": NO_KV_LOADS,
    "loads_and_stores_only": NO_GEMM + NO_SOFTMAX + NO_KV_LOADS,
}
# the tensor-core scan: its inter term (C . h), its intra term (C B^T, the
# weights and W x) and its state update, each switched off; with all three
# off, the chunks' loads, the cumsum, the barriers and the stores remain
NO_INTER = [("      for (int kk = 0; kk < N / 16; ++kk) {\n        uint32_t a[4];\n"
             "        ptx::ldmatrix_x4(a, c_row + 16 * kk);\n#pragma unroll\n        for (int cb",
             "      for (int kk = 0; kk < N / 16 * (P < 0); ++kk) {\n        uint32_t a[4];\n"
             "        ptx::ldmatrix_x4(a, c_row + 16 * kk);\n#pragma unroll\n        for (int cb")]
NO_INTRA = [("      for (int j = 0; j <= r; ++j) {",
             "      for (int j = 0; j <= r * (P < 0) - 1; ++j) {")]
NO_STATE = [("n_tasks = c + 1 < n_chunks ? (P / 16) * n_blocks : 0", "n_tasks = 0")]
SCAN_ABLATIONS = {
    "full": [],
    "no_inter": NO_INTER,
    "no_intra": NO_INTRA,
    "no_state": NO_STATE,
    "loads_cumsum_stores": NO_INTER + NO_INTRA + NO_STATE,
}


def ablation(kernel: str) -> int:
    """Where a bf16 kernel's time goes: builds copies of its source with one
    part of its work switched off (FLASH_ABLATIONS for ``flash``,
    SCAN_ABLATIONS for ``scan``) into ``build/ablation/`` and times each one
    beside the full kernel, at the bf16 shapes of FLASH_TIMED with SDPA, or
    at SSD_SLICE with the eager ssd_chunked.  The switched-off copies compute
    wrong results: they exist only to be timed."""
    import ctypes

    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke.py: no src/repro_torch beside {__file__}")
    sys.path.insert(0, str(SRC))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.models import ssm

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")
    print(nvidia_smi())
    lib_name, table = (("flash_attention", FLASH_ABLATIONS) if kernel == "flash"
                       else ("mamba_scan", SCAN_ABLATIONS))
    source = (build.CSRC / f"{lib_name}.cu").read_text()
    out = build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, subs in table.items():
        text = source
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: the kernel source no longer has {old!r}")
            text = text.replace(old, new)
        (out / f"{lib_name}_{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             str(out / f"{lib_name}_{name}.so"), str(out / f"{lib_name}_{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        report = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{report}")
        libs[name] = ctypes.CDLL(str(out / f"{lib_name}_{name}.so"))

    gen = torch.Generator("cuda").manual_seed(0)
    runs = []  # (case name, the yardstick's line, the kernel call)
    if kernel == "flash":
        for case in FLASH_TIMED:
            name, dtype, B, S, T, H, K, D, causal, window, softcap = case
            if dtype != "bfloat16":
                continue
            q = torch.randn(B, S, H, D, generator=gen, device="cuda").bfloat16()
            k = torch.randn(B, T, K, D, generator=gen, device="cuda").bfloat16()
            v = torch.randn(B, T, K, D, generator=gen, device="cuda").bfloat16()
            kw = dict(causal=causal, window=window, logit_softcap=softcap)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True))
            bound, by = attention_bound_ms(case)
            runs.append((name, f"SDPA {sdpa:.4f} ms, bound {bound:.4f} ms ({by})",
                         lambda q=q, k=k, v=v, kw=kw: fa.flash_attention(q, k, v, **kw)))
    else:
        chunk = SSD_SLICE[7]
        xh, dt, A, Bm, Cm = ssd_inputs(SSD_SLICE, gen)
        eager = time_ms(lambda: ssm.ssd_chunked(xh, dt, A, Bm, Cm, chunk))
        bound, by = ssd_bound_ms(SSD_SLICE)
        runs.append((SSD_SLICE[0], f"eager ssd_chunked {eager:.4f} ms, bound {bound:.4f} ms ({by})",
                     lambda: ms.mamba_scan(xh, dt, A, Bm, Cm, chunk=chunk)))
    for name, yardstick, call in runs:
        print(f"{name}: {yardstick}")
        for variant, lib in libs.items():
            build._loaded[lib_name] = lib  # the wrapper launches this copy
            print(f"  {variant:22s} {time_ms(call, iters=50):.4f} ms")
    build._loaded.pop(lib_name, None)
    return 0


# ---------------------------------------------------------------------------


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke.py: no src/repro_torch beside {__file__}")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py: CUDA is not available")

    t_start = time.perf_counter()
    print("== device")
    card = nvidia_smi()
    print(card)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print("== build")
    from repro_torch.kernels import build

    t0 = time.perf_counter()
    reports = build.build("flash_attention", "mamba_scan", "moe_gmm")
    print(f"  built {[name for name, rep in reports.items() if rep]} in "
          f"{time.perf_counter() - t0:.1f} s")
    spilled = {}
    for name, report in reports.items():
        for entry, use in ptxas_usage(report).items():
            kernel = kernel_name(entry)
            print(f"  {name}: {kernel:34s} {use['registers']:3d} registers, {use['smem']:6d} "
                  f"bytes static shared memory, spills (stores, loads) {use['spills']} bytes")
            if kernel.startswith(NO_SPILL_ENTRIES) and use["spills"] != (0, 0):
                spilled[kernel] = use["spills"]
    check(not spilled, f"bf16 kernels spill (stores, loads bytes): {spilled}")

    print("== kernels vs plain versions")
    attn_records = check_attention_kernel()
    attn = attn_records[SLICE_CASE[0]]
    train_attn = check_train_attention_kernel()
    ssd = check_mamba_kernel()
    gmm_records = check_gmm_kernel()
    gmm = gmm_records[GMM_SLICE[0]]

    print("== serve internlm2-1.8b")
    fa_launches = serve()
    smoke_model_card_vs_cpu("internlm2-1.8b", "flash_attention")
    torch.cuda.empty_cache()  # the internlm2 weights are freed before zamba2's

    print("== evaluate zamba2-7b")
    model, params = big_model("zamba2-7b")
    launches, _ = evaluate(model, params, {"flash_attention": 0, "mamba_scan": model.cfg.n_layers,
                                           "gmm": 0},
                           shallow=model.cfg.zamba.shared_period, shallow_tol=SUPERBLOCK_BF16_TOL)
    ms_launches = launches["mamba_scan"]

    print("== serve zamba2-7b")
    # no kernel: prefill is ssd_chunked, decode the single-step recurrence, the
    # shared block attend_xla (head_dim 112)
    serve_and_profile(model, params, {"flash_attention": 0, "mamba_scan": 0, "gmm": 0})
    del model, params
    torch.cuda.empty_cache()
    smoke_model_card_vs_cpu("zamba2-7b", "mamba_scan")

    print(f"== mixtral-8x7b ({MIXTRAL_LAYERS} of 32 layers): evaluate")
    model, params = big_model("mixtral-8x7b", n_layers=MIXTRAL_LAYERS)
    flash_only = {"flash_attention": model.cfg.n_layers, "mamba_scan": 0, "gmm": 0}
    _, eval_batch = evaluate(model, params, flash_only, shallow=SHALLOW_LAYERS,
                             shallow_tol=PREFILL_SHALLOW_BF16_TOL)
    print("== mixtral-8x7b: serve")
    prompts = serve_and_profile(model, params, flash_only)
    print("== mixtral-8x7b: apply_moe through gmm")
    gmm_launches = check_gmm_route(model.cfg, params, {"eval": eval_batch["tokens"],
                                                       "serve": first_batch(prompts)})
    del model, params
    torch.cuda.empty_cache()
    smoke_model_card_vs_cpu("mixtral-8x7b", "flash_attention")

    print("== whisper-medium: evaluate and serve")
    whisper_launches = whisper()
    smoke_model_card_vs_cpu("whisper-medium", "flash_attention")

    print("== xlstm-1.3b: evaluate, serve and train")
    xlstm_record = xlstm()
    smoke_model_card_vs_cpu("xlstm-1.3b", None)

    print("== launcher")
    from repro_torch.launch.serve import main as serve_main

    for argv in ([], ["--arch", "zamba2-7b"], ["--arch", "mixtral-8x7b"],
                 ["--arch", "xlstm-1.3b"], ["--via-flows"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = serve_main(argv)
        print(out.getvalue(), end="")
        check(code == 0, f"launcher failed for {argv}")
        check("--via-flows" not in argv or ": SUCCEEDED" in out.getvalue(),
              "the serving flow did not succeed")

    print("== phi3-mini-3.8b: prefill (head_dim 96)")
    phi3_launches = prefill_phi3()

    print("== train internlm2-1.8b")
    training = train()
    training["microbatches"] = train_microbatches()
    print(f"== train internlm2-1.8b: the training flow ({FLOW_LAYERS} layers)")
    training["flow"] = train_flow()
    print("== train internlm2-1.8b: the training launcher (SMOKE)")
    from repro_torch.launch.train import main as train_main

    workdir = ROOT / "build" / "train_launcher"
    shutil.rmtree(workdir, ignore_errors=True)  # no checkpoint of an earlier run
    check(train_main(["--simulate-failure", "--workdir", str(workdir)]) == 0,
          "the training launcher failed")
    shutil.rmtree(workdir, ignore_errors=True)
    print("== gradient guard")
    gradient_guard()
    print("== shard: DTensor on a (1, 1) mesh (NCCL, one rank)")
    sharded = shard()
    print("== dryrun: fake worlds of 256 and 512 ranks, and phase 10's step on (1, 1)")
    dry = dryrun(training)
    print(f"== all phases passed in {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "flash_attention", "route": "cuda", "kernel_route": "tma_wgmma",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:118",
        "launches": fa_launches, "phi3_prefill_launches": phi3_launches,
        "whisper_launches": whisper_launches,
        "shard_prefill_launches": sharded["prefill"]["launches"],
        "shard_whisper_prefill_launches": sharded["whisper_prefill"]["launches"],
        "shard_whisper_prefill_noncausal": sharded["whisper_prefill"]["noncausal_launches"],
        "dryrun_traced_calls": dry[DRYRUN_FLASH_CELL]["kernel_calls"]["flash_attention"],
        "max_abs_err": attn["max_abs_err"],
        "ms": attn["ms"], "plain_ms": attn["plain_ms"],
        "bound_ms": attn["bound_ms"], "bound_by": attn["bound_by"],
        "library_ms": attn["library_ms"],
        # the same fields at mixtral's shape and at the slice shape in f32
        **{name: rec for name, rec in attn_records.items() if name != SLICE_CASE[0]},
    }, {
        "name": "flash_attention_train", "route": "cuda", "kernel_route": "tma_wgmma",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": None, "launches": training["train_attention_launches"], **train_attn,
    }, {
        "name": "mamba_scan", "route": "cuda", "kernel_route": ssd["kernel_route"],
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:82",
        "launches": ms_launches, "shard_launches": sharded["mamba_scan"]["launches"],
        "max_abs_err": ssd["max_abs_err"],
        "ms": ssd["ms"], "plain_ms": ssd["plain_ms"],
        "bound_ms": ssd["bound_ms"], "bound_by": ssd["bound_by"],
        "library_ms": None, "ssd_chunked_ms": ssd["ssd_chunked_ms"],
    }, {
        "name": "gmm", "route": "cuda", "kernel_route": gmm["kernel_route"],
        "source": "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:46",
        "launches": gmm_launches, "shard_launches": sharded["gmm"]["launches"],
        "max_abs_err": gmm["max_abs_err"],
        "ms": gmm["ms"], "plain_ms": gmm["plain_ms"],
        "bound_ms": gmm["bound_ms"], "bound_by": gmm["bound_by"],
        "library_ms": gmm["library_ms"],
        # the same fields at the other timed shapes
        **{name: rec for name, rec in gmm_records.items() if name != GMM_SLICE[0]},
    }]
    print(json.dumps({"xlstm": xlstm_record}))
    print(json.dumps({"train": training}))
    print(json.dumps({"shard": sharded}))
    print(json.dumps({"dryrun": dry}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    ablations = {"--flash-ablation": "flash", "--scan-ablation": "scan"}
    sys.exit(ablation(ablations[sys.argv[1]]) if sys.argv[1:] and sys.argv[1] in ablations
             else main())
