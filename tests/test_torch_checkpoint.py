"""Checkpoint and restore (``repro_torch.ft.checkpoint``), mirroring
``tests/test_checkpoint.py``: atomic commit, latest-step discovery, GC,
refused shapes and leaves, and bit-identical training resume through
``launch.train.run``; then what the port adds: bf16 and integer leaves bit
for bit, a sparse weight's pattern checked on load, reshard-on-load
(``shardings=``) bit for bit and the reference's elastic restart onto
other meshes, a mesh of several devices refused, and the on-disk format
read across by the reference's ``load`` (and the reference's by the
port's)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ft import checkpoint as ref_ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.core.csr import BlockCSR
from repro_torch.distributed import sharding as sh
from repro_torch.ft import checkpoint as ckpt
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import run
from repro_torch.train.optimizer import OptState, named_leaves


def test_roundtrip_and_latest(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.int32)}}
    ckpt.save(str(tmp_path), 3, tree)
    ckpt.save(str(tmp_path), 7, tree)
    assert ckpt.latest_step(str(tmp_path)) == 7
    step, restored = ckpt.load(str(tmp_path), tree)
    assert step == 7
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.int32
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])
    step, _ = ckpt.load(str(tmp_path), tree, step=3)
    assert step == 3


def test_tmp_dirs_never_visible(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros((2,))})
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    assert sorted(os.listdir(tmp_path / "step_00000001")) == [
        "manifest.json", "shard_00000.npz"]


def test_garbage_collect(tmp_path):
    tree = {"a": torch.zeros((2,))}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, tree)
    os.makedirs(tmp_path / "step_00000006.tmp")
    ckpt.garbage_collect(str(tmp_path), keep=2)
    assert sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path)) == [4, 5]


def test_shape_mismatch_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros((2, 2))})
    with pytest.raises(ValueError):
        ckpt.load(str(tmp_path), {"a": torch.zeros((3, 3))})


def test_missing_leaf_rejected(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros((2,))})
    with pytest.raises(KeyError):
        ckpt.load(str(tmp_path), {"zz": torch.zeros((2,))})
    with pytest.raises(FileNotFoundError):
        ckpt.load(str(tmp_path / "none"), {"a": torch.zeros((2,))})


def _assert_trees_equal(a, b):
    la, lb = dict(named_leaves(a)), dict(named_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        assert torch.equal(la[k], lb[k]), k


@pytest.mark.timeout(120)
@pytest.mark.parametrize("sparse_mlp", [False, True])
def test_resume_is_deterministic(tmp_path, sparse_mlp, capsys):
    """Train 4 steps; against train 2 with a checkpoint, then resume and
    train to 4: identical parameters and optimizer state, bit for bit
    (the data regenerates each step's batch)."""
    import dataclasses
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"),
                              sparse_mlp=sparse_mlp)
    kw = dict(seq_len=16, global_batch=2, micro_batches=1, device="cpu")
    straight = run(cfg, steps=4, **kw)
    d = str(tmp_path)
    first = run(cfg, steps=2, ckpt_dir=d, **kw)
    assert ckpt.latest_step(d) == 2
    resumed = run(cfg, steps=4, ckpt_dir=d, **kw)
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "checkpointed → " in out
    assert [r["step"] for r in first.history] == [0, 1]
    assert [r["step"] for r in resumed.history] == [2, 3]
    assert [r["loss"] for r in resumed.history] == \
        [r["loss"] for r in straight.history[2:]]
    _assert_trees_equal(resumed.params, straight.params)
    _assert_trees_equal(resumed.opt._asdict(), straight.opt._asdict())
    assert torch.equal(resumed.opt.step, straight.opt.step)
    assert resumed.opt.step.shape == () and int(resumed.opt.step) == 4
    assert ckpt.latest_step(d) == 4


def test_bf16_tree_bit_for_bit(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((5, 7), generator=g).to(torch.bfloat16),
            "odd": torch.tensor([float("inf"), -0.0, float("nan"), 1e-40,
                                 3.0e38]).to(torch.bfloat16)}
    ckpt.save(str(tmp_path), 1, tree)
    _, restored = ckpt.load(str(tmp_path), tree)
    for k, t in tree.items():
        assert restored[k].dtype == torch.bfloat16
        assert torch.equal(restored[k].view(torch.int16),
                           t.view(torch.int16)), k
    import json
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        dtypes = {e["name"]: e["dtype"] for e in json.load(f)["leaves"]}
    assert dtypes == {"w": "bfloat16", "odd": "bfloat16"}
    # like's dtype decides: a bf16 checkpoint restored into f32
    _, up = ckpt.load(str(tmp_path), {"w": torch.zeros((5, 7)),
                                      "odd": torch.zeros((5,))})
    assert up["w"].dtype == torch.float32
    assert torch.equal(up["w"], tree["w"].float())


def test_opt_state_step_is_saved(tmp_path):
    state = OptState(step=torch.tensor(17, dtype=torch.int32),
                     m={"a/b": torch.ones((3,), dtype=torch.bfloat16)},
                     v={"a/b": torch.full((3,), 0.5)},
                     error={"a/b": torch.zeros(())})
    ckpt.save(str(tmp_path), 5, {"opt": state})
    like = OptState(step=torch.zeros((), dtype=torch.int32),
                    m={"a/b": torch.zeros((3,), dtype=torch.bfloat16)},
                    v={"a/b": torch.zeros((3,))},
                    error={"a/b": torch.ones(())})
    _, restored = ckpt.load(str(tmp_path), {"opt": like})
    got = restored["opt"]
    assert isinstance(got, OptState)
    assert got.step.dtype == torch.int32 and int(got.step) == 17
    assert got.step.shape == () and got.error["a/b"].shape == ()
    assert torch.equal(got.m["a/b"], state.m["a/b"])
    assert torch.equal(got.v["a/b"], state.v["a/b"])
    assert float(got.error["a/b"]) == 0.0


def _bsr(mask, seed):
    g = torch.Generator().manual_seed(seed)
    dense = torch.randn((16, 16), generator=g) * torch.from_numpy(
        np.kron(mask, np.ones((8, 8))).astype(np.float32))
    return BlockCSR.from_dense(dense, (8, 8), device="cpu")


def test_block_csr_pattern_is_saved_and_checked(tmp_path):
    a = _bsr(np.array([[1, 0], [1, 1]]), 0)
    ckpt.save(str(tmp_path), 1, {"mlp": [a]})
    same = _bsr(np.array([[1, 0], [1, 1]]), 1)
    _, restored = ckpt.load(str(tmp_path), {"mlp": [same]})
    got = restored["mlp"][0]
    assert torch.equal(got.blocks, a.blocks)
    for f in ("block_col", "block_row", "row_ptr"):
        np.testing.assert_array_equal(getattr(got, f), getattr(a, f))
    other = _bsr(np.array([[0, 1], [1, 1]]), 0)     # same nnzb, moved
    assert other.blocks.shape == a.blocks.shape
    with pytest.raises(ValueError, match="pattern"):
        ckpt.load(str(tmp_path), {"mlp": [other]})


def test_shardings_raise(tmp_path):
    """Reshard-on-load onto a mesh whose coordinates name several devices
    raises (a leaf's per-device slices are not ported: queue A item 10);
    onto an abstract mesh (no devices) too."""
    tree = {"w": torch.zeros((4, 4))}
    ckpt.save(str(tmp_path), 2, tree)
    several = sh.Mesh([["cpu", "meta"], ["cpu", "cpu"]], ("data", "model"))
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        ckpt.load(str(tmp_path), tree,
                  shardings=sh.param_shardings(tree, several))
    with pytest.raises(ValueError, match="abstract mesh"):
        ckpt.load(str(tmp_path), tree, shardings=sh.param_shardings(
            tree, sh.abstract_mesh((2, 2), ("data", "model"))))
    with pytest.raises(KeyError, match="shardings"):
        ckpt.load(str(tmp_path), tree, shardings={})


def test_reshard_on_load_is_bit_for_bit(tmp_path):
    """Every kind of leaf (f32, bf16, int, a sparse weight's payload and
    pattern, an OptState) loads onto the sharding's mesh device with the
    saved bits; ``meta`` stands for a device other than ``like``'s."""
    g = torch.Generator().manual_seed(3)
    tree = {"w": torch.randn((6, 4), generator=g),
            "h": torch.randn((5,), generator=g).to(torch.bfloat16),
            "n": torch.arange(7, dtype=torch.int32),
            "mlp": [_bsr(np.array([[1, 0], [1, 1]]), 2)],
            "opt": OptState(step=torch.tensor(3, dtype=torch.int32),
                            m={"w": torch.randn((6, 4), generator=g)},
                            v={"w": torch.rand((6, 4), generator=g)},
                            error={"w": torch.zeros(())})}
    ckpt.save(str(tmp_path), 9, tree)
    mesh = make_debug_mesh((2, 2), device="cpu")
    step, got = ckpt.load(str(tmp_path), tree,
                          shardings=sh.param_shardings(tree, mesh))
    assert step == 9
    _assert_trees_equal(got, tree)
    assert torch.equal(got["n"], tree["n"])
    assert torch.equal(got["opt"].step, tree["opt"].step)
    for f in ("block_col", "block_row", "row_ptr"):
        np.testing.assert_array_equal(getattr(got["mlp"][0], f),
                                      getattr(tree["mlp"][0], f))
    meta = make_debug_mesh((2, 2), device="meta")
    _, placed = ckpt.load(str(tmp_path), tree,
                          shardings=sh.param_shardings(tree, meta))
    assert placed["w"].device.type == "meta"
    assert placed["mlp"][0].blocks.device.type == "meta"
    assert placed["opt"].m["w"].device.type == "meta"


@pytest.mark.timeout(120)
def test_elastic_restart_onto_other_meshes(tmp_path):
    """The reference's elastic scenario (``tests/test_elastic.py``) on the
    port: 4 steps under a (4, 2) mesh against 2 steps, a checkpoint,
    reshard-on-load onto (2, 2) and (8, 1) CPU meshes and 2 more steps.
    One process, one device: the continued run equals the uninterrupted
    one bit for bit (the reference holds it within rtol 2e-3 across its
    devices' reduction orders)."""
    from repro_torch.data import DataConfig, synth_batch
    from repro_torch.models import lm
    from repro_torch.train import (OptimizerConfig, init_opt_state,
                                   make_train_step)
    cfg = get_smoke_config("qwen3-4b")
    ocfg = OptimizerConfig(peak_lr=1e-3, warmup_steps=1, total_steps=10)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=8)
    step_fn = make_train_step(cfg, ocfg, micro_batches=1)

    def fresh():
        params = lm.unstack_layers(lm.init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"))
        return params, init_opt_state(ocfg, params)

    def run_steps(mesh, params, opt, steps, start):
        with sh.use_mesh_rules(mesh):
            for s in range(start, start + steps):
                params, opt, _ = step_fn(params, opt, synth_batch(dcfg, s))
        return params, opt

    mesh_a = make_debug_mesh((4, 2), device="cpu")
    ref, _ = run_steps(mesh_a, *fresh(), 4, 0)
    p2, o2 = run_steps(mesh_a, *fresh(), 2, 0)
    ckpt.save(str(tmp_path), 2, {"params": p2, "opt": o2})
    for shape in ((2, 2), (8, 1)):
        mesh_b = make_debug_mesh(shape, device="cpu")
        params, opt = fresh()
        like = {"params": params, "opt": opt}
        shardings = {"params": sh.param_shardings(params, mesh_b),
                     "opt": sh.param_shardings(opt, mesh_b)}
        _, restored = ckpt.load(str(tmp_path), like, shardings=shardings)
        p4, _ = run_steps(mesh_b, restored["params"], restored["opt"], 2, 2)
        _assert_trees_equal(p4, ref)


def test_reference_reads_the_port_format(tmp_path):
    """A flat f32 dict saved by the port is read back by the reference's
    ``repro.ft.checkpoint.load``, and the reference's by the port's."""
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": torch.linspace(-1, 1, 5)}
    ckpt.save(str(tmp_path / "port"), 4, tree)
    like = {k: jnp.zeros(tuple(v.shape), jnp.float32)
            for k, v in tree.items()}
    step, got = ref_ckpt.load(str(tmp_path / "port"), like)
    assert step == 4
    for k, v in tree.items():
        np.testing.assert_array_equal(np.asarray(got[k]), v.numpy())
    ref_ckpt.save(str(tmp_path / "ref"), 9, {k: jnp.asarray(v.numpy())
                                             for k, v in tree.items()})
    step, back = ckpt.load(str(tmp_path / "ref"), tree)
    assert step == 9
    for k, v in tree.items():
        assert torch.equal(back[k], v)
