"""Port parity: GPipe ``pipeline_apply`` (``repro_torch.distributed
.pipeline``) against the reference's.

The reference's own test (``tests/test_pipeline.py``) runs its pipeline
under 4 forced host devices; its forward works there, while ``jax.grad``
through it fails under this jax (a mesh-size error), so that test is one
of the known failures.  Here the reference's forward runs in that
subprocess on inputs drawn from a numpy seed and handed over in an npz,
and the gradients are held against ``jax.grad`` of the reference's
sequential ``stage_fn``, with the reference test's tolerances (forward
rtol = atol = 1e-5; gradients rtol 1e-4, atol 1e-5).  The port runs on a
CPU mesh of the same shape (``make_debug_mesh((4,), ("pod",),
device="cpu")``).

A qwen3-4b smoke model with its sparse MLP is then pipelined against the
port's own sequential blocks (``lm.apply_layers``): output and every
gradient within 1e-5·max + 1e-6.

Across devices: ``place_stages`` cuts the per-layer list as the
reference's ``NamedSharding(mesh, P("pod"))`` cuts the stacked leaves
(its ``devices_indices_map``, from the same subprocess); a mesh with one
``"meta"`` coordinate shows which groups move and that the others are
kept as they are.  On a mesh of several devices ``pipeline_apply`` takes
only a placed tree: an unplaced or stacked one raises ``ValueError``.  A
CPU mesh of four ``"cpu"`` entries stands for four devices where
``sharding.several`` is patched: the placed tree then runs the
several-device path, bit for bit as the whole tree on the one-device
path, and the qwen2-72b smoke config (bf16 parameters, sparse MLP at
(8, 8), 8 layers) pipelined there on its placed tree is held against
``lm.apply_layers`` over all its layers, microbatch by microbatch, bit
for bit.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.pipeline import (pipeline_apply, place_stages,
                                              stage_group_count)
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm
from repro_torch.train.optimizer import named_leaves

G, B, D, PODS, MICRO = 8, 8, 16, 4, 4

SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.pipeline import pipeline_apply
    inp = np.load(sys.argv[1])
    ws, x = jnp.asarray(inp["ws"]), jnp.asarray(inp["x"])

    def stage_fn(stage_ws, x):
        def body(h, w):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, x, stage_ws)
        return h

    mesh = jax.make_mesh((4,), ("pod",))
    out = pipeline_apply(stage_fn, mesh, n_microbatches=4,
                         params_stacked=ws, x=x)
    np.save(sys.argv[2], np.asarray(out))
    # the stacked leaves' rows each pod coordinate holds under the
    # sharding the reference's pipeline takes them in
    cut = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(
        "pod")).devices_indices_map(ws.shape)
    rows = [cut[d][0] for d in mesh.devices.reshape(-1)]
    np.save(sys.argv[3], np.array([[r.start or 0, ws.shape[0]
                                    if r.stop is None else r.stop]
                                   for r in rows]))
    print("reference forward done")
""")


def _inputs():
    rng = np.random.default_rng(0)
    ws = (rng.standard_normal((G, D, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((B, D)).astype(np.float32)
    return ws, x


def _stage_fn(stage_ws, x):
    for w in stage_ws:
        x = torch.tanh(x @ w)
    return x


def _ref_stage_fn(stage_ws, x):
    def body(h, w):
        return jnp.tanh(h @ w), None
    h, _ = jax.lax.scan(body, x, stage_ws)
    return h


def pod_mesh(n=PODS):
    return make_debug_mesh((n,), ("pod",), device="cpu")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's pipelined forward and its pod cut of the stacked
    ``ws``, ``(P, 2)`` row ranges in mesh order."""
    tmp = tmp_path_factory.mktemp("gpipe")
    ws, x = _inputs()
    np.savez(tmp / "inputs.npz", ws=ws, x=x)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp / "inputs.npz"),
         str(tmp / "out.npy"), str(tmp / "cut.npy")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stderr[-3000:], proc.stdout[-500:])
    assert "reference forward done" in proc.stdout
    return {"forward": np.load(tmp / "out.npy"),
            "cut": np.load(tmp / "cut.npy")}


def test_gpipe_forward_matches_the_reference(reference):
    ws, x = _inputs()
    out = pipeline_apply(_stage_fn, pod_mesh(), MICRO, torch.from_numpy(ws),
                         torch.from_numpy(x))
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), reference["forward"], rtol=1e-5,
                               atol=1e-5)
    # and the sequential stages, as the reference test holds it
    np.testing.assert_allclose(
        out.numpy(), np.asarray(_ref_stage_fn(jnp.asarray(ws),
                                              jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def test_gpipe_gradients_match_the_reference_sequential_grad():
    ws, x = _inputs()
    want = jax.grad(lambda w: (_ref_stage_fn(w, jnp.asarray(x)) ** 2).sum())(
        jnp.asarray(ws))
    wt = torch.from_numpy(ws).requires_grad_(True)
    (pipeline_apply(_stage_fn, pod_mesh(), MICRO, wt,
                    torch.from_numpy(x)) ** 2).sum().backward()
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)


def test_gpipe_runs_each_stage_on_each_microbatch_once_in_order():
    """``P·M`` stage calls (no bubble computed), microbatch t through
    stage p at tick t + p, each stage with its own groups."""
    calls = []

    def stage_fn(stage_ws, x):
        calls.append((int(stage_ws[0, 0, 0]), int(x[0, 0])))
        return x + 1
    ws = torch.arange(G, dtype=torch.float32)[:, None, None].expand(G, 2, 2)
    x = torch.arange(MICRO, dtype=torch.float32).repeat_interleave(2)[
        :, None].expand(2 * MICRO, 3).contiguous()
    out = pipeline_apply(stage_fn, pod_mesh(), MICRO, ws, x)
    assert torch.equal(out, x + PODS)
    per = G // PODS
    want = []
    for t in range(MICRO + PODS - 1):
        for p in reversed(range(PODS)):
            if 0 <= t - p < MICRO:
                want.append((p * per, t - p + p))   # mb t-p, + p stages
    assert calls == want


def test_stage_group_count_raises():
    assert stage_group_count(8, 4) == 2
    with pytest.raises(ValueError, match="not divisible"):
        stage_group_count(6, 4)
    ws, x = _inputs()
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply(_stage_fn, pod_mesh(3), 4, torch.from_numpy(ws),
                       torch.from_numpy(x))
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(_stage_fn, pod_mesh(), 3, torch.from_numpy(ws),
                       torch.from_numpy(x))


def _one_meta(p):
    """A ``("pod",)`` mesh of ``"cpu"`` entries but ``"meta"`` at pod
    ``p``: several devices, and the groups that move show on ``meta``."""
    return sh.Mesh(["meta" if q == p else "cpu" for q in range(PODS)],
                   ("pod",))


def test_place_stages_cuts_as_the_reference_named_sharding(reference):
    """Group ``g`` goes to the device of pod ``g // (G / P)``, the rows
    the reference's ``NamedSharding(mesh, P("pod"))`` gives that pod;
    a group already on its stage's device is kept as it is, and a moved
    one is a leaf of its own that keeps ``requires_grad``."""
    ws, _ = _inputs()
    layers = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    for p, (lo, hi) in enumerate(reference["cut"]):
        placed = place_stages(layers, _one_meta(p))
        assert [g for g, t in enumerate(placed)
                if t.device.type == "meta"] == list(range(lo, hi))
        for g, t in enumerate(placed):
            assert t.requires_grad and t.is_leaf
            assert (t is layers[g]) == (t.device.type == "cpu")
    # dicts of per-layer lists, and a BlockCSR's one host pattern
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), n_layers=8,
                              sparse_mlp=True, sparse_block=(8, 8))
    tree = lm.unstack_layers(lm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))["groups"]
    placed = place_stages(tree, _one_meta(3))
    for g, (a, b) in enumerate(zip(tree["b0"], placed["b0"])):
        wa, wb = a["mlp"]["w_down"], b["mlp"]["w_down"]
        assert wb.block_col is wa.block_col and wb.row_ptr is wa.row_ptr
        assert wb.blocks.device.type == ("meta" if g >= 6 else "cpu")
        assert (b["attn"]["wq"] is a["attn"]["wq"]) == (g < 6)


def test_pipeline_on_a_mesh_of_several_devices_raises(monkeypatch):
    """On a mesh of several devices an unplaced tree (groups off their
    stage's device) or a stacked one raises ``ValueError`` naming
    ``place_stages``; nothing is copied for it."""
    ws, x = _inputs()
    layers = list(torch.from_numpy(ws))
    mesh = sh.Mesh(["cpu", "meta", "cpu", "cpu"], ("pod",))
    with pytest.raises(ValueError, match="group 2 .*place_stages"):
        pipeline_apply(_stage_fn, mesh, MICRO, layers, torch.from_numpy(x))
    for tree in (torch.from_numpy(ws), {"w": torch.from_numpy(ws)}):
        with pytest.raises(ValueError, match="stacked .*"):
            pipeline_apply(_stage_fn, mesh, MICRO, tree,
                           torch.from_numpy(x))
        with pytest.raises(ValueError, match="place_stages"):
            place_stages(tree, mesh)
    # the four CPU entries standing for four devices: the stacked tree
    # raises there too, the one-device path takes it
    monkeypatch.setattr(sh, "several", lambda mesh: True)
    with pytest.raises(ValueError, match="place_stages"):
        pipeline_apply(_stage_fn, pod_mesh(), MICRO, torch.from_numpy(ws),
                       torch.from_numpy(x))


def test_placed_tree_on_several_devices_matches_the_whole_tree(
        monkeypatch):
    """A tree placed by ``place_stages`` runs the several-device path
    (``sharding.several`` patched: the four CPU entries stand for four
    devices) and gives the whole tree's output and gradients on the
    one-device path bit for bit."""
    ws, x = _inputs()

    def run(tree, leaves):
        xg = torch.from_numpy(x).requires_grad_(True)
        y = pipeline_apply(_stage_fn, pod_mesh(), MICRO, tree, xg)
        (y ** 2).sum().backward()
        return y.detach(), xg.grad, [t.grad for t in leaves]
    whole = torch.from_numpy(ws).requires_grad_(True)
    y0, dx0, (g0,) = run(whole, [whole])
    layers = [torch.from_numpy(w.copy()).requires_grad_(True) for w in ws]
    with monkeypatch.context() as m:
        m.setattr(sh, "several", lambda mesh: True)
        placed = place_stages(layers, pod_mesh())
        y1, dx1, g1 = run(placed, placed)
    assert torch.equal(y1, y0) and torch.equal(dx1, dx0)
    assert torch.equal(torch.stack(g1), g0)


def test_the_ring_counts_its_bytes():
    """Each hop is a ``collective-permute`` of one microbatch's
    activation, forward and backward; the outputs come back once."""
    ws, x = _inputs()
    wt = torch.from_numpy(ws).requires_grad_(True)
    before = sh.collectives_moved()
    y = pipeline_apply(_stage_fn, pod_mesh(), MICRO, wt, torch.from_numpy(x))
    mid = sh.collectives_moved()
    y.sum().backward()
    after = sh.collectives_moved()
    hop = (B // MICRO) * D * 4
    hops = MICRO * (PODS - 1)
    assert mid["collective-permute"] - before["collective-permute"] == \
        hops * hop
    assert after["collective-permute"] - mid["collective-permute"] == \
        hops * hop
    assert mid["all-reduce"] - before["all-reduce"] == B * D * 4


def _close(got, want, what):
    tol = 1e-5 * float(want.abs().max()) + 1e-6
    err = float((got - want).abs().max())
    assert err <= tol, f"{what}: {err} > {tol}"


def test_qwen3_smoke_pipelined_matches_sequential_blocks():
    """The sparse-MLP qwen3-4b smoke at 8 layers, 4 stages of 2, 4
    microbatches: output and every gradient against ``apply_layers`` over
    all layers in order."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), n_layers=8,
                              sparse_mlp=True, sparse_block=(8, 8))
    params = lm.unstack_layers(lm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    layers = params["groups"]["b0"]
    plan = lm.sparse_mlp_plan(params)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((4, 16, cfg.d_model)).astype(
        np.float32))
    r = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))

    def stage_fn(stage_layers, h):
        return lm.apply_layers(stage_layers, cfg, h, mlp_plan=plan)

    def grads(fn):
        leaves = [t for _, t in named_leaves(layers)]
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        xg = x.clone().requires_grad_(True)
        y = fn(xg)
        (y * r).sum().backward()
        return y.detach(), [t.grad.clone() for t in leaves], xg.grad

    y_seq, g_seq, dx_seq = grads(lambda h: stage_fn(layers, h))
    y_pipe, g_pipe, dx_pipe = grads(
        lambda h: pipeline_apply(stage_fn, pod_mesh(), 4, layers, h))
    _close(y_pipe, y_seq, "output")
    _close(dx_pipe, dx_seq, "dx")
    assert len(g_pipe) == len(g_seq)
    for i, (a, b) in enumerate(zip(g_pipe, g_seq)):
        _close(a, b, f"grad {i}")


def test_qwen2_72b_smoke_bf16_pipelined_on_a_placed_tree(monkeypatch):
    """qwen2-72b's smoke config (QKV biases drawn non-zero) with bf16
    parameters and its sparse MLP at (8, 8), cut to 8 layers, 4 stages
    of 2, 4 microbatches, on a tree placed by ``place_stages`` over four
    CPU entries standing for four devices: output, dx and every gradient
    of ``sum(y·R)`` against ``apply_layers`` over all layers in order,
    microbatch by microbatch (so that the bf16 gradients sum the same
    per-microbatch terms), bit for bit."""
    cfg = dataclasses.replace(get_smoke_config("qwen2-72b"), n_layers=8,
                              sparse_mlp=True, sparse_block=(8, 8))
    gen = torch.Generator().manual_seed(0)
    layers = lm.unstack_layers(lm.init_params(
        cfg, gen, torch.bfloat16, device="cpu"))["groups"]["b0"]
    for layer in layers:
        for k in ("bq", "bk", "bv"):
            layer["attn"][k] = 0.1 * torch.randn(
                layer["attn"][k].shape, generator=gen).to(torch.bfloat16)
    plan = lm.sparse_mlp_plan(layers)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 16, cfg.d_model)).astype(
        np.float32)).to(torch.bfloat16)
    r = torch.from_numpy(rng.standard_normal(x.shape).astype(
        np.float32)).to(torch.bfloat16)

    def stage_fn(stage_layers, h):
        return lm.apply_layers(stage_layers, cfg, h, mlp_plan=plan)

    def grads(tree, fn):
        leaves = [t for _, t in named_leaves(tree)]
        for t in leaves:
            t.requires_grad_(True)
            t.grad = None
        xg = x.clone().requires_grad_(True)
        y = fn(tree, xg)
        (y.float() * r.float()).sum().backward()
        return y.detach(), [t.grad.clone() for t in leaves], xg.grad

    y_seq, g_seq, dx_seq = grads(layers, lambda tree, h: torch.cat(
        [stage_fn(tree, mb) for mb in h.chunk(4)]))
    monkeypatch.setattr(sh, "several", lambda mesh: True)
    placed = place_stages(layers, pod_mesh())
    y_pipe, g_pipe, dx_pipe = grads(
        placed, lambda tree, h: pipeline_apply(stage_fn, pod_mesh(), 4,
                                               tree, h))
    assert y_pipe.dtype == torch.bfloat16
    assert torch.equal(y_pipe, y_seq)
    assert torch.equal(dx_pipe, dx_seq)
    assert len(g_pipe) == len(g_seq) == 8 * len(list(named_leaves(layers[0])))
    for i, (a, b) in enumerate(zip(g_pipe, g_seq)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b), f"grad {i}"
