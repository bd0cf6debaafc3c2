"""The port's logical-axis sharding against the JAX package, in one process.

``repro_torch.parallel.sharding``'s rule engine (``ShardingRules.spec``,
``assign_spec``, ``logical_spec``, the legacy ``_prune_spec_for_shape``) is
held to ``repro.parallel.sharding`` exactly: every case of
``tests/launch/test_sharding_rules.py`` restated, and a hypothesis
differential over random logical axes, shapes and mesh sizes.  The models'
logical axes (``param_axes``, the cache-axes functions) equal the
reference's for every architecture, and each full config's per-leaf specs
equal the reference's ``logical_spec(axes, eff, shape, mesh)`` at three mesh
sizes, with mesh stand-ins so that no device and no process group is needed.
The int8 error-feedback compression is bit-equal on ``q``.  The multi-rank
numerics are in ``tests/test_torch_distributed.py``.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

from repro import configs as jax_configs  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import model as jax_model  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.models import xlstm as jax_xlstm  # noqa: E402
from repro.parallel import compression as jax_comp  # noqa: E402
from repro.parallel import sharding as jax_sh  # noqa: E402
from repro.testing import hypothesis_shim  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.models import attention, model, ssm, xlstm  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.parallel import compression as comp  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    ACT_RULES,
    PARAM_RULES,
    ShardingRules,
    assign_spec,
)

given, settings, st = hypothesis_shim()

SIZES = {"data": 16, "model": 16}
SIZES_POD = {"pod": 2, "data": 16, "model": 16}
MESHES = [{"data": 2, "model": 2}, SIZES, SIZES_POD]


def _torch_mesh(sizes: dict):
    """The port's stand-in: what ``mesh_axis_sizes`` and ``placements`` read."""
    return SimpleNamespace(mesh_dim_names=tuple(sizes), shape=tuple(sizes.values()))


def _jax_mesh(sizes: dict):
    """The reference's stand-in (as ``tests/launch/test_specs_dryrun.py``)."""
    return SimpleNamespace(axis_names=tuple(sizes), devices=np.empty(tuple(sizes.values())))


# --- tests/launch/test_sharding_rules.py, restated -------------------------


def test_basic_assignment():
    assert assign_spec(("embed", "mlp"), (4096, 14336), PARAM_RULES, SIZES) == ("data", "model")


def test_pod_axes_compose():
    spec = assign_spec(("embed", "mlp"), (4096, 14336), PARAM_RULES, SIZES_POD)
    assert spec == (("pod", "data"), "model")


def test_non_divisible_axis_released_for_later_dim():
    """The mixtral bug: experts=8 cannot take model=16; mlp must get it."""
    spec = assign_spec(("experts", "embed", "mlp"), (8, 4096, 14336), PARAM_RULES, SIZES)
    assert spec == (None, "data", "model")


def test_divisible_experts_keep_ep():
    spec = assign_spec(("experts", "embed", "mlp"), (128, 4096, 1536), PARAM_RULES, SIZES)
    assert spec == ("model", "data")  # EP wins; mlp axis taken


def test_partial_tuple_assignment():
    """batch=8 < pod*data=32: take only the axes that divide."""
    rules = ShardingRules({"batch": ("pod", "data")})
    assert assign_spec(("batch", "seq"), (8, 128), rules, SIZES_POD) == ("pod",)


def test_absent_mesh_axis_skipped():
    assert assign_spec(("embed", "mlp"), (64, 256), PARAM_RULES, {"model": 16}) == (None, "model")


def test_indivisible_everything_replicates():
    assert assign_spec(("embed", "mlp"), (10, 18), PARAM_RULES, SIZES) == ()


def test_act_rules_batch_heads():
    spec = assign_spec(("batch", "seq", "heads", "head_dim"), (256, 4096, 32, 128),
                       ACT_RULES, SIZES)
    assert spec == ("data", None, "model")


def test_small_kv_heads_replicate_but_release_axis():
    axes = ("batch", "kv_seq", "kv_heads", "head_dim")
    assert assign_spec(axes, (128, 32768, 8, 128), ACT_RULES, SIZES) == ("data",)
    rules = ACT_RULES.merged({"kv_seq": "model"})
    assert assign_spec(axes, (128, 32768, 8, 128), rules, SIZES) == ("data", "model")


# --- the rule engine against the reference ----------------------------------


def test_rule_tables_are_the_references():
    assert dict(PARAM_RULES.rules) == dict(jax_sh.PARAM_RULES.rules)
    assert dict(ACT_RULES.rules) == dict(jax_sh.ACT_RULES.rules)


@pytest.mark.parametrize("axes", [
    ("embed", "mlp"), ("batch", "seq", "embed"), ("experts", "embed", "mlp"),
    ("embed", "embed"), ("layers", "vocab", "embed"), (None, "qkv"), ("rank",), (),
])
def test_rules_spec_matches_reference(axes):
    for rules, ref in ((PARAM_RULES, jax_sh.PARAM_RULES), (ACT_RULES, jax_sh.ACT_RULES)):
        assert rules.spec(axes) == tuple(ref.spec(axes))


_NAMES = st.sampled_from(sorted(set(PARAM_RULES.rules) | set(ACT_RULES.rules)) + [None])


@settings(max_examples=300, deadline=None)
@given(
    axes=st.lists(_NAMES, min_size=0, max_size=5),
    dims=st.lists(st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 64, 96, 128]),
                  min_size=5, max_size=5),
    sizes=st.fixed_dictionaries({
        "pod": st.sampled_from([None, 1, 2, 3]),
        "data": st.sampled_from([None, 1, 2, 4, 8, 16]),
        "model": st.sampled_from([None, 1, 2, 3, 4, 16]),
    }),
    acts=st.booleans(),
    override=st.sampled_from([None, {"kv_seq": "model"}, {"mlp": ("data", "model")},
                              {"embed": ("model", "pod")}]),
)
def test_assign_spec_matches_reference_hypothesis(axes, dims, sizes, acts, override):
    """assign_spec and ShardingRules.spec agree with the reference on random
    logical axes, shapes, mesh sizes and rule overrides."""
    sizes = {k: v for k, v in sizes.items() if v is not None}
    shape = tuple(dims[:len(axes)])
    axes = tuple(axes)
    rules, ref = (ACT_RULES, jax_sh.ACT_RULES) if acts else (PARAM_RULES, jax_sh.PARAM_RULES)
    if override:
        rules, ref = rules.merged(override), ref.merged(override)
    assert assign_spec(axes, shape, rules, sizes) == tuple(
        jax_sh.assign_spec(axes, shape, ref, sizes))
    assert rules.spec(axes) == tuple(ref.spec(axes))


@pytest.mark.parametrize("spec,shape", [
    (("data", "model"), (32, 48)), ((("pod", "data"), None, "model"), (64, 7, 6)),
    (("model",), (10,)), ((None, ("data", "model")), (3, 64)), ((), (5, 5)),
])
def test_prune_spec_for_shape_matches_reference(spec, shape):
    with sh.use_rules(PARAM_RULES, ACT_RULES, _torch_mesh(SIZES_POD)):
        got = sh._prune_spec_for_shape(spec, shape)
    with jax_sh.use_rules(jax_sh.PARAM_RULES, jax_sh.ACT_RULES, _jax_mesh(SIZES_POD)):
        want = jax_sh._prune_spec_for_shape(P(*spec), shape)
    assert got == tuple(want)
    assert sh._prune_spec_for_shape(spec, shape) == spec  # no active mesh


def test_logical_spec_without_shape_is_the_rules_spec():
    axes = ("batch", "seq", "heads", "head_dim")
    assert sh.logical_spec(axes, ACT_RULES) == ACT_RULES.spec(axes)
    assert sh.logical_spec(axes, ACT_RULES, (32, 4, 3, 2), _torch_mesh(SIZES)) == ("data",)


def test_shard_is_a_no_op_on_plain_tensors_and_without_rules():
    x = torch.zeros(4, 8)
    assert sh.shard(x, "batch", "embed") is x
    with sh.use_rules(PARAM_RULES, ACT_RULES):
        assert sh.shard(x, "batch", "embed") is x
        assert sh.distribute_input(x, "batch", "seq") is x  # no mesh
        with pytest.raises(ValueError):
            sh.shard(x, "batch")
    assert sh.active_rules() == (None, None)


# --- placements --------------------------------------------------------------


@pytest.mark.parametrize("spec,names,want", [
    ((), ("data", "model"), (Replicate(), Replicate())),
    (("data", "model"), ("data", "model"), (Shard(0), Shard(1))),
    ((None, "data"), ("data", "model"), (Shard(1), Replicate())),
    ((("pod", "data"), None, "model"), ("pod", "data", "model"), (Shard(0), Shard(0), Shard(2))),
    ((("data", "pod"),), ("pod", "data", "model"), (Shard(0), Shard(0), Replicate())),
    ((None, None, "model"), ("data",), None),
])
def test_spec_to_placements(spec, names, want):
    """A tuple target puts Shard(d) on each of its mesh dims, every other mesh
    dim is Replicate; a target absent from the mesh raises."""
    mesh = SimpleNamespace(mesh_dim_names=names)
    if want is None:
        with pytest.raises(ValueError):
            sh.placements(spec, mesh)
    else:
        assert sh.placements(spec, mesh) == want


@pytest.mark.parametrize("shape,want", [
    ((1, 64, 8), (Replicate(), Shard(1))),
    ((2, 64, 8), (Shard(0), Shard(1))),
    ((1, 1, 8), (Replicate(), Replicate())),
])
def test_placements_leave_a_dim_of_size_one_replicated(shape, want):
    """Given the tensor's shape, a dim of size 1 (which the spec can only
    give mesh axes of size 1) stays Replicate: DTensor refuses to view a
    sharded dim of size 1 away (ROADMAP F10).  The spec is not changed."""
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"))
    assert sh.placements(("data", "model"), mesh, shape) == want
    assert sh.placements(("data", "model"), mesh) == (Shard(0), Shard(1))


def test_placements_refuse_a_mesh_axis_twice():
    with pytest.raises(ValueError):
        sh.placements(("data", "data"), SimpleNamespace(mesh_dim_names=("data",)))


def test_local_rank_along_nests_left_to_right():
    mesh = SimpleNamespace(get_coordinate=lambda: (1, 0, 1), size=lambda i: (2, 4, 2)[i])
    assert sh.local_rank_along(mesh, (Shard(0), Replicate(), Shard(0)), 0) == (3, 4)
    assert sh.local_rank_along(mesh, (Shard(0), Shard(1), Replicate()), 1) == (0, 4)


# --- models: axes, shapes, per-leaf specs ------------------------------------


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_param_axes_match_reference(arch, smoke):
    cfg, jcfg = configs.get(arch, smoke=smoke), jax_configs.get(arch, smoke=smoke)
    assert model.param_axes(cfg) == jax_model.param_axes(jcfg)
    assert model.param_shapes(cfg) == jax_model.param_shapes(jcfg)


def _jax_effective(rules, mesh_axes):
    """The reference's ``effective`` (inside ``param_shardings``)."""
    out = {}
    for k, v in rules.rules.items():
        if v is None:
            out[k] = None
        else:
            targets = v if isinstance(v, tuple) else (v,)
            kept = tuple(t for t in targets if t in mesh_axes)
            out[k] = kept if len(kept) > 1 else (kept[0] if kept else None)
    return jax_sh.ShardingRules(out)


@pytest.mark.parametrize("sizes", MESHES, ids=["2x2", "16x16", "2x16x16"])
@pytest.mark.parametrize("arch", jax_configs.ARCH_IDS)
def test_param_specs_match_reference(arch, sizes):
    """Each leaf of a full config resolves to the reference's spec, and the
    port's Sharding pairs carry the placements of those specs."""
    cfg = configs.get(arch)
    axes, shapes = model.param_axes(cfg), model.param_shapes(cfg)
    mesh = _torch_mesh(sizes)
    specs = sh.param_specs(axes, mesh, PARAM_RULES, param_shapes=shapes)
    shardings = sh.param_shardings(axes, mesh, PARAM_RULES, param_shapes=shapes)
    eff = _jax_effective(jax_sh.PARAM_RULES, set(sizes))
    jmesh = _jax_mesh(sizes)
    n = 0
    for (path, ax), (_, shape), (_, spec), (_, sharding) in zip(
            L.flatten_specs(axes), L.flatten_specs(shapes), L.flatten_specs(specs),
            L.flatten_specs(shardings)):
        want = tuple(jax_sh.logical_spec(ax, eff, shape, jmesh))
        assert spec == want, (path, ax, shape)
        assert sharding.mesh is mesh and sharding.placements == sh.placements(want, mesh)
        n += 1
    assert n == len(list(L.flatten_specs(axes)))


def test_param_specs_without_shapes_use_the_rules_spec():
    cfg = configs.get("mixtral-8x7b")
    mesh = _torch_mesh({"data": 4, "model": 4})
    eff = _jax_effective(jax_sh.PARAM_RULES, {"data", "model"})
    for (_, ax), (_, spec) in zip(L.flatten_specs(model.param_axes(cfg)),
                                  L.flatten_specs(sh.param_specs(model.param_axes(cfg), mesh))):
        assert spec == tuple(eff.spec(ax))


def test_cache_axes_match_reference():
    assert attention.kv_cache_axes() == jax_attention.kv_cache_axes()
    assert ssm.mamba_cache_axes() == jax_ssm.mamba_cache_axes()
    assert xlstm.mlstm_cache_axes() == jax_xlstm.mlstm_cache_axes()
    assert xlstm.slstm_state_axes() == jax_xlstm.slstm_state_axes()


# --- int8 + error feedback ---------------------------------------------------


@pytest.mark.parametrize("shape,scale", [((64,), 1.0), ((33, 17), 0.01), ((8, 4, 5), 300.0)])
def test_compress_int8_matches_reference(shape, scale):
    """q bit-equal (both round half to even), scale and the new error equal."""
    rng = np.random.default_rng(len(shape))
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    # values that land on .5 steps exercise the tie rule
    x.flat[:4] = np.array([0.5, -0.5, 1.5, 2.5], np.float32) * float(np.abs(x).max()) / 127
    e = (rng.normal(size=shape) * scale * 1e-3).astype(np.float32)
    q, s, err = comp.compress_int8(torch.from_numpy(x), torch.from_numpy(e))
    jq, js, jerr = jax_comp.compress_int8(jnp.asarray(x), jnp.asarray(e))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(comp.decompress_int8(q, s).numpy(),
                               np.asarray(jax_comp.decompress_int8(jq, js)), rtol=1e-6)


def test_compress_tree_int8_matches_reference():
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(5, 3)).astype(np.float32),
            "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    ttree = L.map_tree(torch.from_numpy, tree)
    payload, errs = comp.compress_tree_int8(ttree, comp.init_error_feedback(ttree))
    jpayload, jerrs = jax_comp.compress_tree_int8(
        {k: v for k, v in tree.items()},
        {"a": jnp.zeros((5, 3)), "b": {"c": jnp.zeros((7,))}})
    np.testing.assert_array_equal(payload["b"]["c"][0].numpy(), np.asarray(jpayload["b"]["c"][0]))
    np.testing.assert_array_equal(payload["a"][0].numpy(), np.asarray(jpayload["a"][0]))
    np.testing.assert_allclose(errs["a"].numpy(), np.asarray(jerrs["a"]), rtol=1e-6, atol=1e-7)
    out = comp.decompress_tree_int8(payload)
    jout = jax_comp.decompress_tree_int8(jpayload)
    np.testing.assert_allclose(out["b"]["c"].numpy(), np.asarray(jout["b"]["c"]), rtol=1e-6)


def test_grad_compression_int8_error_feedback():
    """``tests/train/test_optimizer.py``'s property on the port: one shot is
    within scale/2, and over 50 rounds the error buffer carries exactly the
    deficit, so compression noise does not accumulate."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
    q, scale, _ = comp.compress_int8(x, torch.zeros_like(x))
    assert float(torch.max(torch.abs(comp.decompress_int8(q, scale) - x))) <= float(scale) / 2 + 1e-6
    total_in = torch.zeros_like(x)
    total_out = torch.zeros_like(x)
    err = torch.zeros_like(x)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32)) * 0.01
        total_in = total_in + g
        q, scale, err = comp.compress_int8(g, err)
        total_out = total_out + comp.decompress_int8(q, scale)
    assert float(torch.max(torch.abs((total_in - total_out) - (-err)))) < 1e-3


# --- launch/mesh.py ----------------------------------------------------------


def test_mesh_helpers_without_a_process_group():
    from repro_torch.launch import mesh as mesh_mod

    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh_mod.make_mesh((1, 1), ("data", "model"), "cpu")
    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"world of {n} ranks"):
            mesh_mod.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    assert mesh_mod.mesh_chip_count(_torch_mesh(SIZES_POD)) == 512
    # the H100's published peaks, the same numbers chip_smoke.py uses
    assert (mesh_mod.PEAK_FLOPS_BF16, mesh_mod.HBM_BANDWIDTH) == (989e12, 3.35e12)
