"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's accounting.

* Every smoke-config cell of the grid walks ``ok`` (or is ``skipped``
  where the reference skips it) on both production meshes, with the
  reference's report keys (``trace_s`` for ``lower_compile_s``).
* ``total_params`` and ``active_params`` equal the reference's, for the
  smoke and the full configs.
* The per-device argument bytes equal what the reference's
  ``param_shardings``, ``state_shardings`` and ``batch_shardings`` give on
  the same abstract mesh (each leaf's ``shard_shape``).
* The walk at two depths (and two microbatch counts), extended linearly,
  equals the walk of the whole config: FLOPs, bytes, dot FLOPs and ops
  exactly.
* The CLI exits 1 on a ``FAILED`` cell, and the grid runs in worker
  processes as in one.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import pytest

from repro.configs import ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_smoke_config as ref_smoke
from repro.configs import input_specs as ref_input_specs
from repro.distributed import sharding as rsh
from repro.models import lm as ref_lm
from repro_torch.configs import SHAPES, ShapeSpec, get_config, \
    get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.train.optimizer import OptimizerConfig

MESHES = ((False, (16, 16), ("data", "model")),
          (True, (2, 16, 16), ("pod", "data", "model")))
KEYS = {"arch", "shape", "mesh", "chips", "status", "trace_s", "memory",
        "fits_hbm", "hbm_gib_per_chip", "roofline", "active_params",
        "total_params"}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_smoke_cells_walk_on_both_meshes(arch):
    cfg = get_smoke_config(arch)
    for multi, _, _ in MESHES:
        for shape in sorted(SHAPES):
            rep = dryrun.lower_cell(arch, shape, multi, config=cfg)
            assert rep["status"] in ("ok", "skipped"), rep
            if rep["status"] == "skipped":
                assert shape == "long_500k"
                continue
            assert KEYS <= set(rep)
            assert rep["collectives_modelled"] == "port mesh code only"
            rl = rep["roofline"]
            assert rl["global_flops"] > 0 and rl["global_bytes"] > 0
            assert rl["dominant"] in ("compute", "memory", "collective")
            assert math.isfinite(rl["step_time_s"])
            assert rep["total_params"] == ref_smoke(arch).param_count()
            assert rep["active_params"] == ref_smoke(arch).param_count(
                active_only=True)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_counts_equal_the_reference(arch):
    from repro.configs import get_config as ref_config
    for ref, port in ((ref_config(arch), get_config(arch)),
                      (ref_smoke(arch), get_smoke_config(arch))):
        assert port.param_count() == ref.param_count()
        assert port.param_count(active_only=True) == \
            ref.param_count(active_only=True)


def _ref_bytes(tree, shardings):
    leaves = jax.tree_util.tree_leaves(tree)
    shards = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    return sum(math.prod(s.shard_shape(tuple(l.shape)))
               * jnp.dtype(l.dtype).itemsize
               for l, s in zip(leaves, shards) if l.shape)


@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-moe-3b-a800m",
                                  "recurrentgemma-9b", "whisper-base"])
def test_argument_bytes_equal_the_reference_shardings(arch):
    """The decode cell: parameters, the token and the decode state."""
    rcfg, pcfg = ref_smoke(arch), get_smoke_config(arch)
    shape = REF_SHAPES["decode_32k"]
    params = jax.eval_shape(lambda k: ref_lm.init_params(
        rcfg, k, dtype=jnp.bfloat16), jax.random.PRNGKey(0))
    state = jax.eval_shape(lambda: ref_lm.init_decode_state(
        rcfg, shape.global_batch, shape.seq_len, dtype=jnp.bfloat16))
    batch = ref_input_specs(rcfg, shape, dtype=jnp.bfloat16)
    for multi, mshape, names in MESHES:
        mesh = rsh.abstract_mesh(mshape, names)
        with rsh.use_mesh_rules(None):
            want = (_ref_bytes(params, rsh.param_shardings(params, mesh))
                    + _ref_bytes(state, rsh.state_shardings(state, mesh))
                    + _ref_bytes(batch, rsh.batch_shardings(batch, mesh)))
        rep = dryrun.lower_cell(arch, "decode_32k", multi, config=pcfg)
        assert rep["memory"]["argument_size_in_bytes"] == want


def _counts(c):
    return (c.flops, c.bytes, c.dot_flops, c.ops)


@pytest.mark.parametrize("arch,layers,micro", [
    ("qwen3-4b", 5, 4), ("recurrentgemma-9b", 11, 4),
    ("granite-moe-3b-a800m", 4, 5)])
def test_extended_walk_equals_the_whole_walk(arch, layers, micro):
    cfg = dataclasses.replace(get_smoke_config(arch), n_layers=layers,
                              train_microbatches=micro)
    shape = ShapeSpec("train_small", 32, 2 * micro, "train")
    ocfg = OptimizerConfig()
    mesh = dryrun.production_mesh(False)
    with dryrun.use_mesh_rules(mesh):
        cost, walked = dryrun.walk_cell(cfg, shape, ocfg)
        whole = dryrun._walk_step(cfg, shape, ocfg, micro)
    assert walked["groups"] == [1, 2] and walked["microbatches"] == [2, 3]
    assert _counts(cost) == _counts(whole)
    decode = ShapeSpec("decode_small", 64, 4, "decode")
    with dryrun.use_mesh_rules(mesh):
        cost, _ = dryrun.walk_cell(cfg, decode)
        whole = dryrun._walk_step(cfg, decode, None, 1)
    assert _counts(cost) == _counts(whole)


def test_two_level_remat_keeps_its_structure_in_the_walk():
    """qwen2-72b remats 8 groups at a time; the walked depths are 8 and
    16, and a config whose chunk does not divide its groups walks 1 and
    2 ungrouped."""
    cfg = get_config("qwen2-72b")
    assert dryrun._groups_walked(cfg) == (8, 16)
    odd = dataclasses.replace(cfg, n_layers=81)
    assert dryrun._groups_walked(odd) == (1, 2)
    assert dryrun._groups_walked(get_smoke_config("qwen3-4b")) == (2, 2)


def test_cli_exits_1_on_a_failed_cell(monkeypatch, capsys):
    def boom(*a, **kw):
        raise RuntimeError("planted")
    monkeypatch.setattr(dryrun, "lower_cell", boom)
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k"])
    assert e.value.code == 1
    out = capsys.readouterr().out
    assert "FAILED RuntimeError: planted" in out
    assert "1 cells: 0 ok, 0 skipped, 1 FAILED" in out


def test_cli_grid_in_worker_processes(capsys, tmp_path):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "whisper-base", "--shape", "long_500k",
                     "--mesh", "both", "--out",
                     str(tmp_path)])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "2 cells: 0 ok, 2 skipped, 0 FAILED" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "whisper-base_long_500k_multi.json",
        "whisper-base_long_500k_single.json"]
