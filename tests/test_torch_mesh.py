"""The port's sharding rules (``infinisst_tpu_torch/parallel/mesh.py``)
against the JAX package's (``infinisst_tpu/parallel/mesh.py``), with no
process group:

- the spec trees, for the dryrun and flagship configs, ``zero`` on and
  off, each JAX ``PartitionSpec`` read as a tuple;
- ``sanitize_spec`` on every leaf shape of the dryrun and flagship trees
  and on the shapes of ``tests/test_parallel.py``, over meshes (8, 1),
  (4, 2), (2, 4), (1, 8) and (2, 2) (JAX's on conftest's 8 virtual CPU
  devices, the port's as a ``{axis: size}`` mapping);
- ``check_tensor_parallel`` and the layouts ``shard_params`` reads;
- every rank's leaves from ``shard_params`` with ``zero`` (FSDP) have the
  shard shapes of JAX's ``sanitize_specs`` at (2, 1), (2, 2) and (8, 1),
  the port's mesh a mapping with the rank given (on the meta device).
"""

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from infinisst_tpu.core.presets import dryrun_config as jdryrun
from infinisst_tpu.core.presets import flagship_config as jflagship
from infinisst_tpu.parallel import mesh as jmesh
from infinisst_tpu_torch.core.presets import dryrun_config, flagship_config
from infinisst_tpu_torch.parallel import mesh as pmesh
from infinisst_tpu_torch.train.main import random_params
from infinisst_tpu_torch.train.step import tree_leaves
from tools_memplan import abstract_params

MESHES = [(8, 1), (4, 2), (2, 4), (1, 8), (2, 2)]
CONFIGS = {"dryrun": (jdryrun, dryrun_config),
           "flagship": (jflagship, flagship_config)}
# tests/test_parallel.py's shapes and specs
EXTRA = [((128263, 4096), ("data", "model")),
         ((4096, 128263), ("data", "model")),
         ((4096, 14336), ("data", "model")),
         ((3, 5), ("data", None))]


def _jflat(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))


def _pflat(tree):
    if isinstance(tree, pmesh.P):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _pflat(tree[k])]
    return [x for v in tree for x in _pflat(v)]


def _t(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_spec_trees_match_jax(name, zero):
    jcfg, pcfg = CONFIGS[name][0](), CONFIGS[name][1]()
    want = _jflat(jmesh.model_param_specs(jcfg, zero=zero))
    got = _pflat(pmesh.model_param_specs(pcfg, zero=zero))
    assert [_t(s) for s in got] == [_t(s) for s in want]
    assert all(isinstance(s, pmesh.P) for s in got)


def _jax_mesh(d, m):
    return jmesh.make_mesh(data=d, model=m)


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sanitize_spec_matches_jax(name, mesh):
    jcfg = CONFIGS[name][0]()
    jm = _jax_mesh(*mesh)
    sizes = {"data": mesh[0], "model": mesh[1]}
    shapes = [tuple(x.shape) for x in
              jax.tree.leaves(abstract_params(jcfg, jnp.bfloat16))]
    for zero in (False, True):
        specs = _jflat(jmesh.model_param_specs(jcfg, zero=zero))
        pspecs = _pflat(pmesh.model_param_specs(CONFIGS[name][1](),
                                                zero=zero))
        assert len(shapes) == len(specs) == len(pspecs)
        for shape, js, ps in zip(shapes, specs, pspecs):
            want = jmesh.sanitize_spec(shape, js, jm)
            got = pmesh.sanitize_spec(shape, ps, sizes)
            assert _t(got) == _t(want), (shape, js, got, want)
    for shape, spec in EXTRA:
        want = jmesh.sanitize_spec(shape, JP(*spec), jm)
        got = pmesh.sanitize_spec(shape, pmesh.P(*spec), sizes)
        assert _t(got) == _t(want), (shape, spec, got, want)


def test_port_params_have_jax_shapes():
    """The port's dryrun tree has the JAX tree's leaves, shapes and order
    (the spec trees above are matched to it by structure)."""
    got = [tuple(x.shape) for x in
           tree_leaves(random_params(dryrun_config(), "cpu", torch.float32))]
    want = [tuple(x.shape) for x in
            jax.tree.leaves(abstract_params(jdryrun(), jnp.float32))]
    assert got == want


def _meta(tree):
    """A JAX abstract tree as meta-device tensors (shapes only)."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta(v) for v in tree]
    return torch.empty(tuple(tree.shape), device="meta")


def test_layouts_and_tensor_parallel_check():
    cfg = flagship_config()
    lay = pmesh.layouts(_meta(abstract_params(jflagship(), jnp.bfloat16)),
                        pmesh.model_param_specs(cfg, zero=True),
                        {"data": 4, "model": 2})
    ll = lay["llama"]
    wq, wo = ll["layers"]["wq"], ll["layers"]["wo"]
    assert wq.model_dim == 2 and wq.data_dim == 1
    assert wo.model_dim == 1 and wo.data_dim == 2
    assert ll["embed"].model_dim == 1 and ll["embed"].data_dim == 1
    # the odd vocabulary: lm_head's 'model' joins 'data' on D
    assert ll["lm_head"].spec == (("data", "model"), None)
    assert ll["lm_head"].model_dim == 0 and ll["lm_head"].data_dim == 0
    pmesh.check_tensor_parallel(cfg, 8)
    with pytest.raises(ValueError, match="inside a head"):
        pmesh.check_tensor_parallel(cfg, 3)
    with pytest.raises(ValueError, match="num_kv_heads"):
        pmesh.check_tensor_parallel(cfg, 16)


def test_make_mesh_needs_a_process_group():
    with pytest.raises(ValueError, match="world size 4; it has 0"):
        pmesh.make_mesh(2, 2, device="cpu")


SHARD_MESHES = [(2, 1), (2, 2), (8, 1)]


@pytest.mark.parametrize("mesh", SHARD_MESHES,
                         ids=[f"{d}x{m}" for d, m in SHARD_MESHES])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_rank_shards_are_jax_shard_shapes(name, mesh):
    """``shard_params`` with the ``zero`` spec tree (FSDP), at every
    (data, model) rank, against the shard shape JAX's ``NamedSharding``
    gives each leaf of its sanitised spec tree."""
    from infinisst_tpu_torch.parallel import collectives as par

    jcfg, pcfg = CONFIGS[name][0](), CONFIGS[name][1]()
    d, m = mesh
    shapes = abstract_params(jcfg, jnp.bfloat16)
    jm = _jax_mesh(d, m)
    jspecs = _jflat(jmesh.sanitize_specs(
        shapes, jmesh.model_param_specs(jcfg, zero=True), jm))
    want = [NamedSharding(jm, s).shard_shape(tuple(x.shape))
            for s, x in zip(jspecs, jax.tree.leaves(shapes))]
    sizes = {"data": d, "model": m}
    for rd in range(d):
        for rm in range(m):
            local, lay = pmesh.shard_params(
                _meta(shapes), sizes, pmesh.model_param_specs(pcfg, True),
                ranks={"data": rd, "model": rm})
            leaves = tree_leaves(local)
            assert [tuple(t.shape) for t in leaves] == want, (rd, rm)
            # a leaf split over 'data' is marked for the forwards' gathers
            for t, lt in zip(leaves, pmesh.layout_leaves(lay)):
                assert par.data_dim(t) == lt.data_dim


def test_sanitize_specs_matches_jax_tree():
    """The tree form over the flagship's shapes at (4, 2), ZeRO on."""
    jcfg, pcfg = jflagship(), flagship_config()
    shapes = abstract_params(jcfg, jnp.bfloat16)
    want = _jflat(jmesh.sanitize_specs(
        shapes, jmesh.model_param_specs(jcfg, zero=True), _jax_mesh(4, 2)))
    got = _pflat(pmesh.sanitize_specs(
        _meta(shapes), pmesh.model_param_specs(pcfg, zero=True),
        {"data": 4, "model": 2}))
    assert [_t(s) for s in got] == [_t(s) for s in want]
