"""Checkpoint and restore (``repro_torch.ft.checkpoint``), mirroring
``tests/test_checkpoint.py``: atomic commit, latest-step discovery, GC,
refused shapes and leaves, and bit-identical training resume through
``launch.train.run``; then what the port adds: bf16 and integer leaves bit
for bit, a sparse weight's pattern checked on load, reshard-on-load
(``shardings=``) bit for bit and the reference's elastic restart onto
other meshes, the on-disk format read across by the reference's ``load``
(and the reference's by the port's); and a tree whose MoE expert leaves
are placed over a mesh's ``model`` peers (``sharding.device_put_params``):
saved as its whole tree, loaded into a placed tree or onto a mesh of
several devices as ``device_put_params`` places it, and a placed
training run resumed bit for bit (the CPU mesh's entries standing for
several devices).  A tree placed for the pipeline
(``pipeline.place_stages``, each stage's layer groups on its device)
likewise: its whole tree's checkpoint, loaded back onto the devices its
``like`` names, and placed after the load onto another stage count."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ft import checkpoint as ref_ckpt
from repro_torch.configs import get_smoke_config
from repro_torch.core.csr import BlockCSR
from repro_torch.distributed import pipeline
from repro_torch.distributed import sharding as sh
from repro_torch.ft import checkpoint as ckpt
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.launch.train import run
from repro_torch.models import lm
from repro_torch.train.optimizer import OptState, named_leaves, parts


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
    """Equal leaves, bit for bit, on the same devices (a placed leaf's
    slices against the other's, slice by slice)."""
    la, lb = dict(named_leaves(a)), dict(named_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        pa, pb = parts(la[k]), parts(lb[k])
        assert type(la[k]) is type(lb[k]) and len(pa) == len(pb), k
        for x, y in zip(pa, pb):
            assert x.dtype == y.dtype and x.device == y.device, k
            assert torch.equal(x, y), k


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


def test_shardings_over_several_devices_place_each_peers_slice(tmp_path):
    """Reshard-on-load onto a mesh whose coordinates name several devices
    (``meta`` stands for a device other than the CPU) places what
    ``device_put_params`` places: an expert leaf cut into the ``model``
    peers' slices, each on ``mesh.device_at(model=pe)`` (the CPU's with
    the saved bits of its range), every other leaf whole on the mesh's
    first device.  An abstract mesh (no devices) and shardings that lack
    a leaf raise."""
    g = torch.Generator().manual_seed(4)
    tree = {"w": torch.randn((4, 4), generator=g),
            "moe": {"experts_gate": torch.randn((4, 4, 2), generator=g)}}
    ckpt.save(str(tmp_path), 2, tree)
    several = sh.Mesh([["cpu", "meta"], ["cpu", "cpu"]], ("data", "model"))
    _, got = ckpt.load(str(tmp_path), tree,
                       shardings=sh.param_shardings(tree, several))
    assert got["w"].device.type == "cpu" and torch.equal(got["w"], tree["w"])
    cut = got["moe"]["experts_gate"]
    assert isinstance(cut, sh.PeerSlices)
    assert (cut.axis, cut.shape) == (0, (4, 4, 2))
    for pe, part in enumerate(cut.parts):
        assert part.device == several.device_at(model=pe)
        assert part.shape == (2, 4, 2)
    assert torch.equal(cut.parts[0], tree["moe"]["experts_gate"][:2])
    assert cut.parts[1].device.type == "meta"
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


def _placed_tree(mesh, seed=5, down=torch.bfloat16):
    """A tree of two per-layer MoE layers (``experts_down`` in ``down``),
    an embedding and an optimizer state over it, placed on ``mesh`` by
    ``device_put_params``, beside the whole tree."""
    g = torch.Generator().manual_seed(seed)
    layers = [{"moe": {"router": torch.randn((6, 8), generator=g),
                       "experts_gate": torch.randn((8, 6, 3), generator=g),
                       "experts_down": torch.randn((8, 3, 6), generator=g)
                       .to(down)}} for _ in range(2)]
    params = {"embed_tokens": torch.randn((10, 6), generator=g),
              "groups": {"b0": layers}}
    opt = OptState(step=torch.tensor(3, dtype=torch.int32),
                   m={k: torch.randn(t.shape, generator=g)
                      for k, t in named_leaves(params)},
                   v={k: torch.rand(t.shape, generator=g)
                      for k, t in named_leaves(params)},
                   error={k: torch.zeros(()) for k, _ in
                          named_leaves(params)})
    whole = {"params": params, "opt": opt}
    return whole, sh.device_put_params(whole, mesh)


def test_placed_tree_saves_its_whole_trees_checkpoint(tmp_path):
    """A placed tree's checkpoint (parameters and an optimizer state whose
    moments are cut alike) has its whole tree's manifest and arrays."""
    whole, placed = _placed_tree(make_debug_mesh((1, 4), device="cpu"))
    moe = placed["params"]["groups"]["b0"][1]["moe"]
    assert isinstance(moe["experts_down"], sh.PeerSlices)
    assert isinstance(placed["opt"].m["groups/b0/0/moe/experts_gate"],
                      sh.PeerSlices)
    ckpt.save(str(tmp_path / "placed"), 3, placed)
    ckpt.save(str(tmp_path / "whole"), 3, whole)
    import json
    dirs = [tmp_path / name / "step_00000003" for name in ("placed", "whole")]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    assert manifests[0] == manifests[1]
    arrays = [np.load(d / "shard_00000.npz") for d in dirs]
    assert sorted(arrays[0].files) == sorted(arrays[1].files)
    for f in arrays[1].files:
        assert arrays[0][f].dtype == arrays[1][f].dtype
        np.testing.assert_array_equal(arrays[0][f], arrays[1][f])


def test_placed_loads_equal_device_put_params(tmp_path, monkeypatch):
    """Loaded into a placed ``like``, and with ``shardings`` over a mesh
    of several devices, a checkpoint comes back as ``device_put_params``
    of the loaded whole tree, bit for bit (a mesh of ``meta`` entries:
    each slice on ``mesh.device_at(model=pe)``)."""
    mesh = make_debug_mesh((1, 4), device="cpu")
    whole, _ = _placed_tree(mesh)
    ckpt.save(str(tmp_path), 7, whole)
    _, other = _placed_tree(mesh, seed=6)          # other values, same tree
    _, got = ckpt.load(str(tmp_path), other)
    _assert_trees_equal(got, sh.device_put_params(whole, mesh))
    assert torch.equal(got["opt"].step, whole["opt"].step)
    like, _ = _placed_tree(mesh, seed=6)
    several = sh.Mesh([["cpu", "cpu", "cpu", "cpu"]], ("data", "model"))
    shardings = {"params": sh.param_shardings(like["params"], several),
                 "opt": sh.param_shardings(like["opt"], several)}
    with monkeypatch.context() as m:     # four entries as four devices
        m.setattr(ckpt, "mesh_devices", lambda mesh: list(mesh.devices.flat))
        _, got = ckpt.load(str(tmp_path), like, shardings=shardings)
    _assert_trees_equal(got, sh.device_put_params(whole, several))
    meta = sh.Mesh([["cpu", "meta", "meta", "meta"]], ("data", "model"))
    _, got = ckpt.load(str(tmp_path), like, shardings={
        "params": sh.param_shardings(like["params"], meta),
        "opt": sh.param_shardings(like["opt"], meta)})
    want = sh.device_put_params(whole, meta)
    for (k, a), (_, b) in zip(sh.leaves_with_path(got),
                              sh.leaves_with_path(want)):
        assert type(a) is type(b), k
        for pe, (x, y) in enumerate(zip(parts(a), parts(b))):
            assert x.device == y.device, k
            if isinstance(a, sh.PeerSlices):
                assert x.device == meta.device_at(model=pe)
            if x.device.type == "cpu":
                assert torch.equal(x, y), k


def test_stage_placed_tree_saves_loads_and_places_again(tmp_path,
                                                       monkeypatch):
    """qwen2-72b's smoke config at 8 layers (bf16, sparse MLP) placed by
    ``place_stages`` over four pods: saved, it has its whole tree's
    manifest and arrays; loaded into a placed ``like`` of other values,
    every leaf comes back on the device that ``like`` names, bit for bit
    (a ``meta`` pod shows the groups on another device); after the load,
    ``place_stages`` puts it onto 2 stages, whose pipeline gives the 4
    stages' output bit for bit (the CPU entries standing for several
    devices)."""
    import dataclasses
    import json
    cfg = dataclasses.replace(get_smoke_config("qwen2-72b"), n_layers=8,
                              sparse_mlp=True, sparse_block=(8, 8))

    def layers(seed):
        return lm.unstack_layers(lm.init_params(
            cfg, torch.Generator().manual_seed(seed), torch.bfloat16,
            device="cpu"))["groups"]["b0"]
    pods = lambda devs: sh.Mesh(devs, ("pod",))
    whole = layers(0)
    placed = pipeline.place_stages(whole, pods(["cpu"] * 4))
    ckpt.save(str(tmp_path / "placed"), 5, placed)
    ckpt.save(str(tmp_path / "whole"), 5, whole)
    dirs = [tmp_path / name / "step_00000005" for name in ("placed", "whole")]
    manifests = [json.loads((d / "manifest.json").read_text()) for d in dirs]
    assert manifests[0] == manifests[1]
    arrays = [np.load(d / "shard_00000.npz") for d in dirs]
    assert sorted(arrays[0].files) == sorted(arrays[1].files)
    for f in arrays[1].files:
        np.testing.assert_array_equal(arrays[0][f], arrays[1][f])

    _, got = ckpt.load(str(tmp_path / "placed"),
                       pipeline.place_stages(layers(1), pods(["cpu"] * 4)))
    _assert_trees_equal(got, whole)
    like = pipeline.place_stages(layers(1), pods(["cpu"] * 3 + ["meta"]))
    _, got = ckpt.load(str(tmp_path / "placed"), like)
    for g, (a, b) in enumerate(zip(got, whole)):
        for (k, x), (_, y) in zip(named_leaves(a), named_leaves(b)):
            assert x.device.type == ("meta" if g >= 6 else "cpu"), (g, k)
            assert x.dtype == y.dtype
            if g < 6:
                assert torch.equal(x, y), (g, k)

    _, got = ckpt.load(str(tmp_path / "placed"), layers(1))
    two = pipeline.place_stages(got, pods(["cpu", "meta"]))
    assert [g for g, layer in enumerate(two)
            if layer["attn"]["wq"].device.type == "meta"] == [4, 5, 6, 7]
    plan = lm.sparse_mlp_plan(whole)
    fn = lambda stage, h: lm.apply_layers(stage, cfg, h, mlp_plan=plan)
    x = torch.randn((4, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(2)).to(
                        torch.bfloat16)
    monkeypatch.setattr(sh, "several", lambda mesh: True)
    y2 = pipeline.pipeline_apply(fn, pods(["cpu"] * 2), 4, pipeline
                                 .place_stages(got, pods(["cpu"] * 2)), x)
    y4 = pipeline.pipeline_apply(fn, pods(["cpu"] * 4), 4, placed, x)
    assert torch.equal(y2, y4)


def test_reference_reads_a_placed_checkpoint(tmp_path):
    """The reference's ``load`` reads a placed f32 tree's checkpoint
    (parameters and moments): each expert leaf whole, with the whole
    tree's bits."""
    trees = _placed_tree(make_debug_mesh((1, 4), device="cpu"),
                         down=torch.float32)
    whole, placed = ({"params": t["params"], "m": t["opt"].m,
                      "v": t["opt"].v} for t in trees)
    ckpt.save(str(tmp_path), 5, placed)
    like = sh.map_with_path(lambda path, t: jnp.zeros(tuple(t.shape),
                                                      jnp.asarray(
                                                          t.numpy()).dtype),
                            whole)
    step, got = ref_ckpt.load(str(tmp_path), like)
    assert step == 5
    flat = dict(sh.leaves_with_path(got))
    for path, t in sh.leaves_with_path(whole):
        np.testing.assert_array_equal(np.asarray(flat[path]), t.numpy())


@pytest.mark.timeout(120)
def test_placed_run_resumes_bit_for_bit(tmp_path, monkeypatch, capsys):
    """granite-moe-3b's smoke config on the expert-parallel path through
    ``launch.train.run`` under a (1, 4) mesh counted as four devices (the
    launcher places the tree; the MoE layer takes its several-device
    path): 2 steps, a checkpoint, a resume and 2 more equal 4 straight
    steps bit for bit, parameters and optimizer state, slice by slice."""
    import dataclasses
    monkeypatch.setattr(launch_train, "mesh_devices",
                        lambda mesh: list(mesh.devices.flat))
    monkeypatch.setattr(sh, "several", lambda mesh: True)
    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              moe_impl="ep_a2a", moe_capacity_factor=1.25)
    kw = dict(seq_len=16, global_batch=2, micro_batches=1, device="cpu")
    d = str(tmp_path)
    with sh.use_mesh(make_debug_mesh((1, 4), device="cpu")):
        straight = run(cfg, steps=4, **kw)
        run(cfg, steps=2, ckpt_dir=d, **kw)
        resumed = run(cfg, steps=4, ckpt_dir=d, **kw)
    assert "resumed from step 2" in capsys.readouterr().out
    moe = resumed.params["groups"]["b0"][0]["moe"]
    assert isinstance(moe["experts_up"], sh.PeerSlices)
    assert [r["step"] for r in resumed.history] == [2, 3]
    assert [r["loss"] for r in resumed.history] == \
        [r["loss"] for r in straight.history[2:]]
    _assert_trees_equal(resumed.params, straight.params)
    _assert_trees_equal(resumed.opt._asdict(), straight.opt._asdict())
    assert torch.equal(resumed.opt.step, straight.opt.step)


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
