"""The port's serving slice against the JAX package, at SMOKE sizes in f32.

Weights come from the JAX package's own init through the bridge; token
inputs are seeded numpy.  Logits are compared at rtol = atol = 1e-4 rather
than the kernels' 2e-5: the logits sit at the end of a stack of layers whose
f32 sums the two frameworks order differently (2 layers here, 24 at full
size), and each layer adds its own rounding.  Token arrays must be identical.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# the port's tests need torch beside jax; without it they are not collected
torch = pytest.importorskip("torch")

from repro import configs as jax_configs
from repro.models import transformer as jax_tfm
from repro.models.model import Model as JaxModel
from repro.serve.engine import BatchAccumulator as JaxAccumulator
from repro.serve.engine import ServeEngine as JaxEngine
from repro_torch import bridge, configs
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch.serve import serve_via_flows
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.model import PORTED_FAMILIES, Model
from repro_torch.serve.engine import BatchAccumulator, ServeEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["internlm2-1.8b", "phi3-mini-3.8b", "command-r-35b", "starcoder2-15b"]
B, S = 2, 12


def _cfgs(arch, **kw):
    kw = dict(compute_dtype="float32", attention_impl="flash", **kw)
    return (jax_configs.get(arch, smoke=True).replace(**kw),
            configs.get(arch, smoke=True).replace(**kw))


def _params(jcfg, tcfg):
    jparams, _ = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jparams, bridge.params_from_jax(tree, tcfg, device="cpu")


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("arch", ARCHS + ["internvl2-2b"])
def test_forward_lm_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _params(jcfg, tcfg)
    tokens = _tokens(tcfg, (B, S))
    pixels = None
    if tcfg.family == "vlm":
        pixels = np.random.default_rng(2).standard_normal(
            (B, tcfg.n_image_tokens, tcfg.d_model)).astype(np.float32)
    jlogits, _ = jax_tfm.forward_lm(jparams, jcfg, jnp.asarray(tokens),
                                    None if pixels is None else jnp.asarray(pixels))
    tlogits, aux = tfm.forward_lm(tparams, tcfg, torch.from_numpy(tokens).long(),
                                  None if pixels is None else torch.from_numpy(pixels))
    assert tlogits.shape == (B, S, tcfg.vocab_size) and float(aux) == 0.0
    _close(tlogits, jlogits)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_lm_matches_jax(arch):
    """Prefill through the flash route against the reference's masked cache
    attention: the last logits and the whole [L,B,max_len,K,D] cache."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _params(jcfg, tcfg)
    tokens, max_len = _tokens(tcfg, (B, S)), S + 6
    jlogits, jcache = jax_tfm.prefill_lm(jparams, jcfg, jnp.asarray(tokens), max_len)
    tlogits, tcache = tfm.prefill_lm(tparams, tcfg, torch.from_numpy(tokens).long(),
                                     max_len)
    assert tlogits.shape == (B, 1, tcfg.vocab_size)
    _close(tlogits, jlogits)
    for name in ("k", "v"):
        assert tcache[name].shape == jcache[name].shape
        _close(tcache[name], jcache[name])


def test_decode_lm_matches_jax_for_8_steps():
    jcfg, tcfg = _cfgs("internlm2-1.8b")
    jparams, tparams = _params(jcfg, tcfg)
    tokens = _tokens(tcfg, (B, 5 + 8))
    max_len = tokens.shape[1]
    jlogits, jcache = jax_tfm.prefill_lm(jparams, jcfg, jnp.asarray(tokens[:, :5]), max_len)
    tlogits, tcache = tfm.prefill_lm(tparams, tcfg, torch.from_numpy(tokens[:, :5]).long(),
                                     max_len)
    for pos in range(5, 13):
        new = tokens[:, pos:pos + 1]
        jlogits, jcache = jax_tfm.decode_lm(jparams, jcfg, jnp.asarray(new), jcache,
                                            jnp.asarray(pos, jnp.int32))
        tlogits, tcache = tfm.decode_lm(tparams, tcfg, torch.from_numpy(new).long(),
                                        tcache, pos)
        _close(tlogits, jlogits)
    _close(tcache["k"], jcache["k"])


def _serve(engine_cls, accum_cls, model, params, prompts, eos, **kw):
    engine = engine_cls(model, params, max_len=24, eos_token=eos, **kw)
    accum = accum_cls(engine, max_batch=3)
    for p in prompts:
        accum.submit(p)
    return accum.flush(max_new_tokens=8), engine.stats


def test_serve_engine_tokens_identical_to_jax():
    """Greedy serving of ragged, left-padded prompts, with and without EOS."""
    jcfg, tcfg = _cfgs("internlm2-1.8b")
    jparams, tparams = _params(jcfg, tcfg)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, tcfg.vocab_size, n) for n in (5, 9, 3, 12, 7)]
    jax_side = (JaxEngine, JaxAccumulator, JaxModel(jcfg), jparams, prompts)
    port_side = (ServeEngine, BatchAccumulator, Model(tcfg), tparams, prompts)

    ref, _ = _serve(*port_side, None, device="cpu")
    eos = int(ref[0]["tokens"][2])  # ends request 0 after 3 tokens
    for eos_token in (None, eos):
        jout, jstats = _serve(*jax_side, eos_token)
        tout, tstats = _serve(*port_side, eos_token, device="cpu")
        assert tstats == jstats
        assert len(tout) == len(jout) == len(prompts)
        for t, j in zip(tout, jout):
            assert t["prompt_len"] == j["prompt_len"]
            np.testing.assert_array_equal(t["tokens"], j["tokens"])
    assert (tout[0]["tokens"][3:] == eos).all() and len(tout[0]["tokens"]) == 8


def test_sampled_decoding_is_seeded():
    _, tcfg = _cfgs("internlm2-1.8b")
    params = Model(tcfg).init(torch.Generator("cpu").manual_seed(0), device="cpu")
    prompts = [np.arange(1, 6)] * 2
    runs = [_serve(ServeEngine, BatchAccumulator, Model(tcfg), params, prompts, None,
                   greedy=False, seed=seed, device="cpu")[0] for seed in (7, 7, 8)]
    tokens = [np.stack([r["tokens"] for r in run]) for run in runs]
    assert np.array_equal(tokens[0], tokens[1])
    assert not np.array_equal(tokens[0], tokens[2])
    assert ((tokens[0] >= 0) & (tokens[0] < tcfg.vocab_size)).all()


# ---------------------------------------------------------------------------
# Guards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,n_leaves", [("internlm2-1.8b", 12), ("mixtral-8x7b", 13),
                                           ("qwen3-moe-235b-a22b", 13)])
def test_bridge_round_trips_bitwise(arch, n_leaves):
    """Dense: 9 of 12 leaves stacked under ``blocks``.  MoE: the MLP's three
    weights give way to the router [L,D,E] and experts [L,E,D,F]/[L,E,F,D]."""
    jcfg, tcfg = _cfgs(arch)
    jparams, tparams = _params(jcfg, tcfg)
    back = bridge.params_to_jax(tparams, tcfg)
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    bleaves = jax.tree_util.tree_leaves_with_path(back)
    assert len(jleaves) == len(bleaves) == n_leaves
    assert tparams["blocks"]["attn"]["wq"]["w"].shape[0] == tcfg.n_layers
    if tcfg.moe is not None:
        E, D, F = tcfg.moe.n_experts, tcfg.d_model, tcfg.moe.d_ff
        assert tparams["blocks"]["moe"]["router"]["w"].shape == (tcfg.n_layers, D, E)
        assert tparams["blocks"]["moe"]["experts"]["down"].shape == (tcfg.n_layers, E, F, D)
    for (jp, j), (bp, b) in zip(jleaves, bleaves):
        assert jp == bp and b.dtype == j.dtype
        np.testing.assert_array_equal(b, np.asarray(j))


@pytest.mark.parametrize("fault", ["missing_leaf", "extra_leaf", "bad_shape"])
def test_bridge_rejects_mismatched_trees(fault):
    jcfg, tcfg = _cfgs("internlm2-1.8b")
    tree = jax.tree_util.tree_map(np.asarray, JaxModel(jcfg).init(jax.random.PRNGKey(0))[0])
    if fault == "missing_leaf":
        del tree["lm_head"]
    elif fault == "extra_leaf":
        tree["blocks"]["attn"]["wq"]["b"] = np.zeros((2, 64), np.float32)
    else:
        tree["blocks"]["mlp"]["up"]["w"] = tree["blocks"]["mlp"]["up"]["w"][:, :, :-1]
    with pytest.raises(ValueError):
        bridge.params_from_jax(tree, tcfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS + ["internvl2-2b", "zamba2-7b", "mixtral-8x7b",
                                  "qwen3-moe-235b-a22b", "xlstm-1.3b", "whisper-medium"])
def test_model_init_matches_jax_tree(arch):
    jcfg, tcfg = _cfgs(arch)
    jparams, _ = JaxModel(jcfg).init(jax.random.PRNGKey(0))
    tparams = Model(tcfg).init(torch.Generator("cpu").manual_seed(0), device="cpu")
    jleaves = jax.tree_util.tree_leaves_with_path(jparams)
    tleaves = jax.tree_util.tree_leaves_with_path(tparams)
    assert [p for p, _ in jleaves] == [p for p, _ in tleaves]
    for (_, j), (_, t) in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape and str(t.dtype) == f"torch.{j.dtype}"


def test_unported_family_raises():
    """Every family of the reference is ported; a family it does not have
    still raises."""
    assert set(PORTED_FAMILIES) == {"dense", "vlm", "moe", "hybrid", "ssm", "encdec"}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(configs.get("xlstm-1.3b", smoke=True).replace(family="rnn"))


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_every_config_builds_forwards_prefills_and_decodes(arch):
    """Model(cfg) for every config of the registry, at SMOKE size on the CPU:
    init, forward, prefill and two decode steps, all finite and of the
    reference's shapes.  Latent attention (moonlight) runs on the xla route,
    since the flash route refuses it, and has no KV cache yet: its prefill
    raises."""
    cfg = configs.get(arch, smoke=True)
    tcfg = cfg.replace(compute_dtype="float32",
                       attention_impl="xla" if cfg.kv_lora_rank else "flash")
    model = Model(tcfg)
    params = model.init(torch.Generator("cpu").manual_seed(0), device="cpu")
    batch = {"tokens": torch.from_numpy(_tokens(tcfg, (B, S))).long()}
    if tcfg.family == "vlm":
        batch["pixel_embeds"] = torch.zeros((B, tcfg.n_image_tokens, tcfg.d_model))
    if tcfg.family == "encdec":
        batch["frames"] = torch.ones((B, 16, tcfg.d_model))
    logits, _ = model.forward(params, batch)
    assert logits.shape == (B, S, tcfg.vocab_size) and bool(torch.isfinite(logits).all())
    if tcfg.kv_lora_rank:
        with pytest.raises(NotImplementedError, match="no KV cache"):
            model.prefill(params, batch, S + 2)
        return
    logits, cache = model.prefill(params, batch, S + 2)
    for pos in (S, S + 1):
        assert logits.shape == (B, 1, tcfg.vocab_size) and bool(torch.isfinite(logits).all())
        logits, cache = model.decode_step(params, logits.argmax(-1), cache, pos)


@pytest.mark.parametrize("arch", configs.REFERENCE_ARCH_IDS)
def test_count_params_analytic_equals_the_references(arch):
    """The full configs' analytic parameter counts, exactly the reference's
    (xlstm-1.3b 1.756 B and whisper-medium 0.759 B among them)."""
    from repro.models.model import count_params_analytic as jax_count

    from repro_torch.models.model import count_params_analytic

    assert count_params_analytic(configs.get(arch)) == jax_count(jax_configs.get(arch))


@pytest.mark.parametrize("argv", [["--via-flows"], ["--arch", "xlstm-1.3b"],
                                  ["--arch", "xlstm-1.3b", "--via-flows"]])
def test_serve_launcher_runs_to_the_end(argv, capsys):
    """``python -m repro_torch.launch.serve --device cpu`` with the reference's
    ``--via-flows`` and for xlstm-1.3b: all 16 requests served, and through
    flows the run SUCCEEDED."""
    assert serve_launcher.main([*argv, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served [16] requests" in out if "--via-flows" in argv else "served 16 requests" in out
    assert "'requests': 16" in out and "'tokens_generated': 256" in out
    if "--via-flows" in argv:
        assert ": SUCCEEDED" in out


def test_serving_flow_succeeds_and_serves_every_request():
    """serve_via_flows: the flow's one Compute action flushes the accumulator;
    the run SUCCEEDED and its result counts every request, each served."""
    _, tcfg = _cfgs("internlm2-1.8b")
    params = Model(tcfg).init(torch.Generator("cpu").manual_seed(0), device="cpu")
    engine = ServeEngine(Model(tcfg), params, max_len=24, device="cpu")
    accum = BatchAccumulator(engine, max_batch=3)
    for p in [np.arange(1, n + 1) for n in (5, 9, 3, 12, 7)]:
        accum.submit(p)
    run = serve_via_flows(accum, 4)
    assert run.status == "SUCCEEDED"
    assert run.context["served"]["details"]["results"] == [[5]]
    assert engine.stats["requests"] == 5 and engine.stats["tokens_generated"] == 20
    assert not accum._pending


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")  # decided at run time, not collection
    cfg = configs.get("internlm2-1.8b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(Model(cfg), params={})
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg).init(torch.Generator("cpu").manual_seed(0))


def test_flash_route_runs_on_prefill_only(monkeypatch):
    """Prefill sends each layer's attention to the kernel entry point, decode
    keeps attend_xla; on CPU tensors the entry point counts no launch."""
    calls = []
    real = attn.kernel_ops.flash_attention

    def spy(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(attn.kernel_ops, "flash_attention", spy)
    _, tcfg = _cfgs("internlm2-1.8b")
    params = Model(tcfg).init(torch.Generator("cpu").manual_seed(0), device="cpu")
    before = fa_kernel.flash_attention.launches
    _, cache = tfm.prefill_lm(params, tcfg, torch.ones((1, 4), dtype=torch.long), 8)
    assert calls == [(1, 4, tcfg.n_heads, tcfg.resolved_head_dim)] * tcfg.n_layers
    tfm.decode_lm(params, tcfg, torch.ones((1, 1), dtype=torch.long), cache, 4)
    assert len(calls) == tcfg.n_layers
    assert fa_kernel.flash_attention.launches == before


def _imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.append(node.args[0].value)
    return names


def test_port_imports_no_jax_and_nothing_of_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    # the training slice's modules and the control plane's copy among them
    names = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"src/repro_torch/{m}.py" for m in (
        "train/optimizer", "train/loop", "train/data", "train/checkpoint", "train/fabric",
        "parallel/compression", "launch/train", "core/flows_service", "core/engine",
        "core/process_backend", "core/providers/compute", "models/xlstm",
        "models/encdec")} <= names
    bad = [(f.relative_to(ROOT).as_posix(), name) for f in files for name in _imports(f)
           if name.split(".")[0] in ("jax", "jaxlib", "repro") or name == "repro"]
    assert not bad
