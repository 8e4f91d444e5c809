"""The port's logical axes and placements against the reference's, on the CPU.

For all ten full configs: ``Model.abstract_init()`` (shapes, per-leaf dtypes,
logical axes) leaf for leaf against the reference's, and the placements of
``repro_torch.sharding.logical_to_sharding`` on the production meshes
(``(16, 16)`` and ``(2, 16, 16)``, fsdp on and off) against the reference's
``logical_to_sharding`` on a ``jax.sharding.AbstractMesh`` of the same shape;
then ``batch_shardings`` / ``state_shardings`` for every family.  The port's
meshes live on the fake process group (``repro_torch.launch.mesh``), which
this file starts and ends itself.
"""

import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

import repro.configs as jconfigs
import repro_torch.configs as tconfigs
from repro.launch import specs as jspecs
from repro.models import Model as JModel
from repro.sharding import default_rules as jdefault_rules
from repro.sharding import logical_to_sharding as jlogical_to_sharding
from repro_torch.launch import specs
from repro_torch.launch.mesh import DRYRUN_MESHES, make_production_mesh
from repro_torch.models import Model, transformer
from repro_torch.sharding import (
    Sharding, ShardingRules, batch_specs, check_divisibility, default_rules, logical_to_sharding,
)

torch.set_num_threads(1)

ARCHS = tconfigs.ARCH_IDS
MESHES = ("16x16", "2x16x16")


@pytest.fixture(scope="module")
def meshes():
    """``get(name)``: the port's mesh and the reference's abstract mesh of
    that name (the fake group is replaced when the size changes)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache.clear()
            shape, names = DRYRUN_MESHES[name]
            cache[name] = (make_production_mesh(multi_pod=name == "2x16x16"),
                           AbstractMesh(shape, names))
        return cache[name]

    yield get
    if dist.is_initialized():
        dist.destroy_process_group()


def _flat(tree, prefix=""):
    """``name -> leaf`` with dotted names; tuples of axis names are leaves."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
        return out
    return {prefix[:-1]: tree}


def _spec(entries, ndim):
    entries = tuple(entries) + (None,) * (ndim - len(entries))
    return tuple(tuple(e) if isinstance(e, (list, tuple)) and len(e) > 1
                 else (e[0] if isinstance(e, (list, tuple)) else e) for e in entries)


_REF_INIT = {}


def _reference_init(arch):
    if arch not in _REF_INIT:
        params, axes = JModel(jconfigs.get_config(arch)).abstract_init()
        _REF_INIT[arch] = (_flat(params), _flat(axes))
    return _REF_INIT[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_init_matches_reference(arch):
    """Axes, shapes and dtypes of every parameter, leaf for leaf, and no
    storage allocated."""
    cfg = tconfigs.get_config(arch)
    params, axes = Model(cfg, device="meta").abstract_init()
    jparams, jaxes = _reference_init(arch)
    assert list(params) == list(axes)
    assert sorted(params) == sorted(jparams) == sorted(jaxes)
    for name, p in params.items():
        assert p.device.type == "meta", name
        assert tuple(p.shape) == tuple(jparams[name].shape), name
        assert str(p.dtype).replace("torch.", "") == str(jparams[name].dtype), name
        assert axes[name] == jaxes[name], name
    assert sum(p.numel() for p in params.values()) >= tconfigs.param_count(cfg)


def test_kv_cache_axes_match_reference():
    from repro.models import transformer as jtransformer

    assert transformer.kv_cache_axes() == jtransformer.kv_cache_axes()


@pytest.mark.parametrize("mesh_name,arch,fsdp",
                         [(m, a, f) for m in MESHES for a in ARCHS for f in (False, True)])
def test_placements_match_reference(meshes, mesh_name, arch, fsdp):
    """The spec of every parameter equals the reference's, and its DTensor
    placements say the same thing: ``Shard(d)`` on each mesh dim that shards
    tensor dim ``d``."""
    mesh, jmesh = meshes(mesh_name)
    cfg = tconfigs.get_config(arch)
    n_experts = cfg.moe.n_experts if cfg.moe else 0
    params, axes = Model(cfg, device="meta").abstract_init()
    got = logical_to_sharding(axes, mesh, default_rules(mesh, n_experts=n_experts, fsdp=fsdp),
                              like=params)
    jparams, jaxes = _reference_init(arch)
    want = _flat(jlogical_to_sharding(_unflat(jaxes), jmesh,
                                      jdefault_rules(jmesh, n_experts=n_experts, fsdp=fsdp),
                                      like=_unflat(jparams)))
    assert sorted(got) == sorted(want)
    names = mesh.mesh_dim_names
    for name, s in got.items():
        ndim = params[name].dim()
        assert _spec(s.spec, ndim) == _spec(want[name].spec, ndim), (name, s.spec, want[name].spec)
        for j, placement in enumerate(s.placements):
            d = s.tensor_dim(names[j])
            assert placement == (Replicate() if d is None else Shard(d)), (name, j)
        s.local_shape(params[name].shape)   # every kept shard divides


def _unflat(flat):
    tree = {}
    for name, leaf in flat.items():
        node = tree
        *parents, last = name.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def test_expert_parallel_and_the_divisibility_fallback(meshes):
    """llama4's 16 experts take EP on the 16-wide model axis; qwen2_moe's 60
    replicate and put ``ff_expert`` on ``model``; whisper's vocab 51,866 and
    mamba2's 50,280 do not divide 16 and replicate."""
    mesh, _ = meshes("16x16")

    def spec(arch, name):
        cfg = tconfigs.get_config(arch)
        params, axes = Model(cfg, device="meta").abstract_init()
        rules = default_rules(mesh, n_experts=cfg.moe.n_experts if cfg.moe else 0)
        return logical_to_sharding(axes, mesh, rules, like=params)[name].spec

    assert spec("llama4_scout_17b_a16e", "layers.we_gate") == (None, "model", None, None)
    assert spec("qwen2_moe_a2_7b", "layers.we_gate") == (None, None, None, "model")
    assert spec("whisper_large_v3", "embed") == (None, None)
    assert spec("mamba2_370m", "embed") == (None, None)
    assert spec("stablelm_3b", "embed") == ("model", None)


def test_batch_over_two_mesh_axes_is_two_shards_of_one_dim(meshes):
    """``batch`` -> ``("pod", "data")``: ``Shard(0)`` on the pod and the data
    dims, which DTensor orders pod first (the reference's order); the local
    block is 1/32 of the rows."""
    mesh, jmesh = meshes("2x16x16")
    rules = default_rules(mesh)
    assert rules.get("batch") == ("pod", "data")
    s = batch_specs(mesh, {"tokens": (256, 4096)}, rules)["tokens"]
    assert s.placements == (Shard(0), Shard(0), Replicate())
    assert s.local_shape((256, 4096)) == (8, 4096)
    assert s.local_slices((256, 4096)) == (slice(0, 8), slice(0, 4096))   # rank 0
    with pytest.raises(ValueError, match="mesh order"):
        Sharding(mesh, (("data", "pod"),))
    from repro.sharding import check_divisibility as jcheck_divisibility

    assert check_divisibility(tconfigs.get_config("stablelm_3b"), mesh, 256) == []
    for arch, batch in (("qwen2_7b", 100), ("stablelm_3b", 100), ("llama4_scout_17b_a16e", 256)):
        got = check_divisibility(tconfigs.get_config(arch), mesh, batch)
        assert got and got == jcheck_divisibility(jconfigs.get_config(arch), jmesh, batch)
    assert ShardingRules((("heads", "model"),)).spec(("heads", None)) == ("model", None)


def _state_cases():
    return [(m, a, c) for m in MESHES for a in ARCHS for c in ("decode_32k", "long_500k")]


@pytest.mark.parametrize("mesh_name,arch,shape", _state_cases())
def test_state_and_batch_shardings_match_reference(meshes, mesh_name, arch, shape):
    """``specs.batch_shardings`` / ``state_shardings`` of every family's decode
    cells (the sequence-sharded KV branch where the KV heads do not divide
    the model axis, the batch-of-1 branch) against the reference's."""
    mesh, jmesh = meshes(mesh_name)
    cfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    cell = next(c for c in tconfigs.shape_cells(arch) if c.name == shape)
    jcell = next(c for c in jconfigs.shape_cells(arch) if c.name == shape)
    tok, state = specs.decode_inputs(cfg, cell)
    jtok, jstate = jspecs.decode_inputs(jcfg, jcell)
    B = cell.global_batch
    got = specs.state_shardings(cfg, mesh, state, B)
    want = jspecs.state_shardings(jcfg, jmesh, jstate, B)
    assert set(got) == set(want)
    for key, s in got.items():
        pairs = zip(s, want[key]) if isinstance(s, tuple) else [(s, want[key])]
        leaves = state[key] if isinstance(state[key], tuple) else (state[key],)
        for (a, b), leaf in zip(pairs, leaves):
            assert _spec(a.spec, leaf.dim()) == _spec(b.spec, leaf.dim()), (key, a.spec, b.spec)
    bt, jbt = specs.batch_shardings(mesh, tok, B), jspecs.batch_shardings(jmesh, jtok, B)
    assert _spec(bt["tokens"].spec, 2) == _spec(jbt["tokens"].spec, 2)
    if cfg.n_kv_heads and cfg.n_kv_heads % 16 and "kv" in got:
        assert got["kv"][0].spec[2] is not None   # the cache sequence takes the model axis
