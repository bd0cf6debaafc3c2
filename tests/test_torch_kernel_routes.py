"""How the port's kernel wrappers pick a route, and what the bf16 scan's
tensor-core route rounds, on the CPU.

``moe_gmm.route`` and ``mamba_scan.route`` choose a kernel from dtypes,
shapes, strides and alignment alone; the tests hold them to the rule at small
shapes and at every case ``chip_smoke.py`` runs on the card (where it checks
the same routes again).  The tensor-core scan rounds three operands to bf16
that the FMA kernel keeps in f32; ``tc_scan_emulation`` repeats its arithmetic
in plain PyTorch (W, the h operand and x * w_state each split into bf16 hi +
lo, sums in f32, cum in f64) and is held against the JAX Pallas kernel in
interpret mode at the reference's bf16 tolerance.  Rounding one of the three
once instead of splitting it reads margins (|err| over the tolerance) of up
to 5.3 for W and 2.1 for each of the others at these sizes, so the kernel
splits all three; run this file as a script to print them.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke
from repro.kernels import ops as jax_ops
from repro.kernels.mamba_scan import mamba_scan as jax_mamba_scan
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import moe_gmm as mg

BF16 = torch.bfloat16
# the reference's bf16 tolerance (tests/kernels/test_kernels.py:20-21)
TOL = dict(rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# gmm
# ---------------------------------------------------------------------------


def _gmm_operands(dtype, D, F, x_offset=0, w_offset=0):
    """x [2,5,D] and w [2,D,F] whose data start x_offset / w_offset elements
    into their storage (an offset of 1 leaves a bf16 base off 16 bytes)."""
    x = torch.zeros(2 * 5 * D + x_offset, dtype=dtype)[x_offset:].view(2, 5, D)
    w = torch.zeros(2 * D * F + w_offset, dtype=dtype)[w_offset:].view(2, D, F)
    return x, w


@pytest.mark.parametrize("dtype, D, F, x_offset, w_offset, want", [
    (torch.float32, 96, 72, 0, 0, "fma_f32"),
    (torch.float32, 100, 72, 1, 0, "fma_f32"),
    (BF16, 96, 72, 0, 0, "tma_wgmma"),
    (BF16, 4096, 14336, 0, 0, "tma_wgmma"),
    (BF16, 8, 8, 8, 8, "tma_wgmma"),        # bases 16 bytes in
    (BF16, 100, 72, 0, 0, "wmma"),          # D % 8: rows not 16-byte multiples
    (BF16, 96, 76, 0, 0, "wmma"),           # F % 8
    (BF16, 96, 72, 1, 0, "wmma"),           # x's base off 16 bytes
    (BF16, 96, 72, 0, 4, "wmma"),           # w's base off 16 bytes
])
def test_gmm_route(dtype, D, F, x_offset, w_offset, want):
    x, w = _gmm_operands(dtype, D, F, x_offset, w_offset)
    assert mg.route(x, w) == want


@pytest.mark.parametrize("case", chip_smoke.GMM_TIMED + chip_smoke.GMM_EDGE_CASES,
                         ids=lambda c: c[0])
def test_gmm_route_of_the_chip_cases(case):
    """The routes chip_smoke.py requires on the card: TMA for every model
    shape and for the aligned cases with ragged C and F."""
    name, dtype, E, C, D, F, Ew = case
    dt = getattr(torch, dtype)
    x = torch.empty(E, C, D, dtype=dt, device="meta")
    w = torch.empty(Ew, D, F, dtype=dt, device="meta")
    want = ("tma_wgmma" if name in chip_smoke.GMM_TMA_CASES
            else "fma_f32" if dtype == "float32" else "wmma")
    assert mg.route(x, w) == want


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------


def _scan_operands(dtype, B, S, H, P, N, extra=0, offset=0):
    """xh, Bm, Cm as views of one packed [B,S,H*P+2N+extra] tensor whose data
    start ``offset`` elements into its storage, as the model splits them."""
    width = H * P + 2 * N + extra
    packed = torch.zeros(B * S * width + offset, dtype=dtype)[offset:].view(B, S, width)
    xs, Bm, Cm, _ = torch.split(packed, [H * P, N, N, extra], dim=-1)
    return xs.reshape(B, S, H, P), Bm, Cm


@pytest.mark.parametrize("dtype, P, N, chunk, extra, offset, want", [
    (BF16, 64, 64, 128, 0, 0, "tensor_core"),   # zamba2-7b
    (BF16, 64, 64, 16, 0, 0, "tensor_core"),
    (BF16, 32, 16, 64, 0, 0, "tensor_core"),
    (torch.float32, 64, 64, 128, 0, 0, "fma"),
    (BF16, 8, 8, 16, 0, 0, "fma"),              # zamba2 SMOKE: P, N off 16
    (BF16, 64, 64, 100, 0, 0, "fma"),           # chunk off 16
    (BF16, 64, 64, 128, 1, 0, "fma"),           # rows not 16-byte multiples
    (BF16, 64, 64, 128, 0, 8, "tensor_core"),   # base 16 bytes in
    (BF16, 64, 64, 128, 0, 1, "fma"),           # base off 16 bytes
    (BF16, 128, 128, 64, 0, 0, "fma"),          # the tensor-core tiles do not fit
])
def test_scan_route(dtype, P, N, chunk, extra, offset, want):
    xh, Bm, Cm = _scan_operands(dtype, 2, 160, 2, P, N, extra, offset)
    assert ms.route(xh, Bm, Cm, chunk) == want


@pytest.mark.parametrize("case", [chip_smoke.SSD_SLICE] + chip_smoke.SSD_EDGE_CASES,
                         ids=lambda c: c[0])
def test_scan_route_of_the_chip_cases(case):
    """The routes chip_smoke.py requires on the card, on the same layouts."""
    xh, _, _, Bm, Cm = chip_smoke.ssd_inputs(case, torch.Generator().manual_seed(0))
    want = "tensor_core" if case[0] in chip_smoke.SSD_TC_CASES else "fma"
    assert ms.route(xh, Bm, Cm, case[7]) == want


@pytest.mark.parametrize("chunk, S, path, want", [
    (128, 512, "tensor_core", 128),
    (128, 50, "tensor_core", 64),    # S rounded up to 16-row tiles
    (128, 100, "tensor_core", 112),
    (16, 100, "tensor_core", 16),
    (128, 50, "fma", 50),
    (128, 512, "fma", 128),
])
def test_scan_kernel_chunk(chunk, S, path, want):
    assert ms.kernel_chunk(chunk, S, path) == want


@pytest.mark.parametrize("chunk, P, N, path, want", [
    # two stages of bf16 x, B, C rows padded by 8 and dt; h in f32 and as bf16
    # hi + lo; cum in f64 and as f32 hi + lo; the state weights
    (128, 64, 64, "tensor_core", 2 * (2 * 128 * 72 + 4 * 128 * 72 + 4 * 128)
     + 8 * 64 * 72 + 20 * 128),
    (64, 128, 128, "tensor_core", 2 * (2 * 64 * 136 + 4 * 64 * 136 + 4 * 64)
     + 8 * 128 * 136 + 20 * 64),
    # x, B, C, h (rows padded by 1), a 16-row tile of W, dt and decay in f32,
    # cum in f64
    (128, 64, 64, "fma", 4 * (128 * 64 + 2 * 128 * 65 + 64 * 65 + 16 * 128 + 4 * 128)),
])
def test_scan_shared_memory_formula(chunk, P, N, path, want):
    assert ms.smem_bytes(chunk, P, N, path) == want


def test_scan_refuses_what_no_route_fits():
    """P = N = 128 at chunk 128 fits neither route (chip_smoke.py checks the
    wrapper's refusal on the card); at chunk 64 the FMA route takes it."""
    xh, Bm, Cm = _scan_operands(BF16, 1, 160, 1, 128, 128)
    assert ms.route(xh, Bm, Cm, 128) == "fma"
    assert ms.smem_bytes(128, 128, 128, "fma") > ms.SMEM_LIMIT
    assert ms.smem_bytes(64, 128, 128, "fma") <= ms.SMEM_LIMIT


# ---------------------------------------------------------------------------
# the tensor-core scan's rounding, against the JAX kernel
# ---------------------------------------------------------------------------


def _split(t: torch.Tensor, split: bool = True) -> torch.Tensor:
    """t as the kernel feeds it to a bf16 product: bf16(t) + bf16(t - bf16(t))
    (or, with ``split`` False, bf16(t) alone)."""
    hi = t.to(BF16).float()
    return hi + (t - hi).to(BF16).float() if split else hi


def tc_scan_emulation(xh, dt, A, Bm, Cm, chunk, split=("W", "h", "xw")):
    """The tensor-core scan's arithmetic in plain PyTorch: chunks of
    kernel_chunk rows (zero-filled past S), cum summed in f64 and its
    differences rounded to f32 before exp, the causal weight W, the carried
    h and x * w_state split into bf16 hi + lo where they meet a product (the
    names in ``split``; the others rounded to bf16 once), sums in f32, y
    rounded to bf16 once."""
    B, S, H, P = xh.shape
    Q = ms.kernel_chunk(chunk, S, "tensor_core")
    Sp = -(-S // Q) * Q

    def pad(t):
        return torch.nn.functional.pad(t.float(), [0, 0] * (t.dim() - 2) + [0, Sp - S])

    x, b, c, d = pad(xh), pad(Bm), pad(Cm), pad(dt)
    h = torch.zeros(B, H, P, Bm.shape[-1])
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool))[None, :, :, None]
    ys = []
    for c0 in range(0, Sp, Q):
        xc, bc, cc, dc = x[:, c0:c0 + Q], b[:, c0:c0 + Q], c[:, c0:c0 + Q], d[:, c0:c0 + Q]
        cum = torch.cumsum((dc * A).double(), dim=1)                   # [B,Q,H]
        diff = (cum[:, :, None] - cum[:, None, :]).float()             # [B,t,s,H]
        decay = torch.exp(torch.where(causal, diff, torch.zeros(())))
        W = torch.einsum("btn,bsn->bts", cc, bc)[..., None] * decay * dc[:, None]
        W = torch.where(causal, W, torch.zeros(()))
        inter = torch.einsum("btn,bhpn->bthp", cc, _split(h, "h" in split))
        y = torch.exp(cum.float())[..., None] * inter
        ys.append(y + torch.einsum("btsh,bshp->bthp", _split(W, "W" in split), xc))
        a_total = cum[:, -1]
        w_state = torch.exp((a_total[:, None] - cum).float()) * dc     # [B,Q,H]
        h = (torch.exp(a_total.float())[..., None, None] * h
             + torch.einsum("bshp,bsn->bhpn", _split(xc * w_state[..., None], "xw" in split), bc))
    return torch.cat(ys, dim=1)[:, :S].to(xh.dtype)


def _scan_inputs(B, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return xh, dt, A, Bm, Cm


# chip_smoke.py's bf16 edge cases (ragged S 100, 200 and 50; chunk 16, 32 and
# 64) at 4 heads, and zamba2-7b's scan at a reduced width (d_model 448: 14
# heads of P = N = 64, chunk 128, S 512)
EMULATED = [
    (2, 100, 4, 64, 64, 128),
    (2, 200, 4, 64, 64, 128),
    (2, 50, 4, 64, 64, 128),
    (2, 256, 4, 64, 64, 16),
    (2, 256, 4, 64, 64, 32),
    (2, 256, 4, 64, 64, 64),
    (1, 512, 14, 64, 64, 128),
]


def _emulated_and_jax(case):
    """The same seeded bf16 inputs as torch tensors and the JAX kernel's y."""
    B, S, H, P, N, chunk = case
    arrays = _scan_inputs(B, S, H, P, N, seed=S + chunk)
    jx = [jnp.asarray(a).astype(jnp.bfloat16) if i in (0, 3, 4) else jnp.asarray(a)
          for i, a in enumerate(arrays)]
    if S % min(chunk, S) == 0:
        expected = jax_mamba_scan(*jx, chunk=min(chunk, S), interpret=True)
    else:  # JAX's kernel needs S to tile by the chunk; its wrapper halves it
        expected = jax_ops.mamba_scan(*jx, chunk=chunk)
    tx = [torch.from_numpy(a).to(BF16) if i in (0, 3, 4) else torch.from_numpy(a)
          for i, a in enumerate(arrays)]
    return tx, np.asarray(expected.astype(jnp.float32))


@pytest.mark.parametrize("case", EMULATED, ids=lambda c: "-".join(map(str, c)))
def test_tensor_core_scan_rounding_matches_jax(case):
    tx, expected = _emulated_and_jax(case)
    out = tc_scan_emulation(*tx, case[-1])
    assert out.dtype == BF16 and out.shape == tx[0].shape
    np.testing.assert_allclose(out.float().numpy(), expected, **TOL)


if __name__ == "__main__":
    # the margins behind the kernel's hi + lo splits: the largest
    # |err| / (atol + rtol |ref|) against the JAX kernel with every operand
    # split, and with one of them rounded to bf16 once
    # (PYTHONPATH=src:. JAX_PLATFORMS=cpu python tests/test_torch_kernel_routes.py)
    for case in EMULATED:
        tx, expected = _emulated_and_jax(case)
        margins = []
        for once in ("", "W", "h", "xw"):
            split = tuple(name for name in ("W", "h", "xw") if name != once)
            out = tc_scan_emulation(*tx, case[-1], split=split).float().numpy()
            err = np.abs(out - expected) / (TOL["atol"] + TOL["rtol"] * np.abs(expected))
            margins.append(f"{once + ' rounded once' if once else 'all split'} {err.max():.3f}")
        print(f"B, S, H, P, N, chunk {case}: margin " + ", ".join(margins))
