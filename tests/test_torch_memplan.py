"""``infinisst_tpu_torch.tools.memplan`` (the port of ``tools_memplan.py``)
on the dryrun and flagship presets, with no process group: the bytes a
row reckons per rank are the sums of the shard shapes at mapping meshes,
every heavy leaf keeps a mesh axis (JAX's
``test_planner_lowers_with_sharded_heavy_leaves`` pin), and the plan
covers every mesh of the world size.  ``tests/test_torch_parallel.py``
holds the reckoned parameter bytes to what a rank holds under gloo."""

import pytest
import torch

from infinisst_tpu_torch.core.config import StreamConfig
from infinisst_tpu_torch.core.presets import dryrun_config, flagship_config
from infinisst_tpu_torch.parallel import mesh as pmesh
from infinisst_tpu_torch.tools import memplan
from infinisst_tpu_torch.train import step as tstep

MESHES = [(4, 2), (2, 1), (8, 1), (1, 4), (2, 2)]


def _bytes(t):
    return t.numel() * t.element_size()


@pytest.mark.parametrize("mesh", MESHES, ids=[f"{d}x{m}" for d, m in MESHES])
@pytest.mark.parametrize("stage", [2, 1])
def test_reckoned_bytes_are_the_shard_shapes(mesh, stage):
    cfg = dryrun_config()
    d, m = mesh
    row = memplan.reckon(cfg, d, m, stage, dtype=torch.float32)
    whole = memplan.meta_params(cfg, torch.float32)
    lay = pmesh.layouts(whole, pmesh.model_param_specs(cfg, zero=d > 1),
                        {"data": d, "model": m})
    mask = tstep.tree_leaves(tstep.trainable_mask(
        whole, memplan._freeze(stage)))
    p = g = 0
    for t, lt, trained in zip(tstep.tree_leaves(whole),
                              pmesh.layout_leaves(lay), mask):
        shape = list(t.shape)
        for axis, dim in (("data", lt.data_dim), ("model", lt.model_dim)):
            if dim is not None:
                shape[dim] //= {"data": d, "model": m}[axis]
        n = int(torch.Size(shape).numel()) * t.element_size()
        p += n
        g += n if trained else 0
    assert row["param_bytes_per_rank"] == p
    assert row["grad_bytes_per_rank"] == g
    assert row["opt_bytes_per_rank"] == 2 * g
    assert row["state_bytes_per_rank"] == p + 3 * g
    assert row["zero"] == (d > 1) and row["mesh"] == f"dp{d}xtp{m}"
    # FSDP: a rank holds less than the whole on any mesh of two ranks
    assert p < sum(_bytes(t) for t in tstep.tree_leaves(whole))


@pytest.mark.parametrize("mesh", [(4, 2), (8, 1), (2, 4), (2, 2)])
def test_heavy_leaves_keep_a_mesh_axis(mesh):
    for cfg in (dryrun_config(), flagship_config()):
        row = memplan.reckon(cfg, *mesh, stage=2)
        assert set(row["heavy_leaf_specs"]) == {
            "llama.lm_head", "llama.embed", "llama.layers.w_up",
            "llama.layers.wq"}
        for name, spec in row["heavy_leaf_specs"].items():
            assert "data" in spec or "model" in spec, (name, spec)


def test_plan_rows_cover_every_mesh():
    out = memplan.plan(dryrun_config(), 4, pool_per_rank=2, beam=2)
    for key, stage in (("meshes", 2), ("stage1_meshes", 1)):
        assert [r["mesh"] for r in out[key]] == ["dp4xtp1", "dp2xtp2",
                                                 "dp1xtp4"]
        assert all(r["stage"] == stage for r in out[key])
        assert all(r["fits_budget"] is None for r in out[key])
    srow, = out["serve_pools"]
    assert srow["pool_size"] == 8 and srow["rows_per_rank"] == 2
    cfg = dryrun_config()
    one = memplan.reckon_serve(cfg, 1, 2, 2, StreamConfig())
    # the split pool: the same rows' state a rank, float leaves split
    assert one["pool_state_bytes_per_rank"] == \
        srow["pool_state_bytes_per_rank"]
    assert srow["param_bytes_per_rank"] < one["param_bytes_per_rank"]
    assert memplan.meshes_of(4) == [(4, 1), (2, 2), (1, 4)]


def test_measure_serve_runs_the_given_config(monkeypatch):
    """The serving row measured on the dryrun preset on the CPU, in a
    world-1 gloo group: the pool ticks on the dryrun's parameters (the
    flagship's 8B draw is what the row measured whatever ``cfg`` it was
    given)."""
    import torch.distributed as dist

    from infinisst_tpu_torch.serve import engine as E
    from tests.torch_mesh_workers import free_port

    cfg = dryrun_config()
    seen = []
    orig = E.ServingEngine.__init__

    def init(self, params, *args, **kw):
        seen.append(tuple(params["llama"]["embed"].shape))
        orig(self, params, *args, **kw)

    monkeypatch.setattr(E.ServingEngine, "__init__", init)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        got = memplan.measure_serve(cfg, 1, 1, 2, StreamConfig(),
                                    torch.device("cpu"))
    finally:
        dist.destroy_process_group()
    assert seen == [(cfg.llama.vocab_size, cfg.llama.hidden_size)]
    assert got["peak_bytes"] is None and got["tick_s"] > 0
