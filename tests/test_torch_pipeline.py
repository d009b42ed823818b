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
from repro_torch.distributed.pipeline import pipeline_apply, stage_group_count
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
def reference_forward(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gpipe")
    ws, x = _inputs()
    np.savez(tmp / "inputs.npz", ws=ws, x=x)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp / "inputs.npz"),
         str(tmp / "out.npy")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stderr[-3000:], proc.stdout[-500:])
    assert "reference forward done" in proc.stdout
    return np.load(tmp / "out.npy")


def test_gpipe_forward_matches_the_reference(reference_forward):
    ws, x = _inputs()
    out = pipeline_apply(_stage_fn, pod_mesh(), MICRO, torch.from_numpy(ws),
                         torch.from_numpy(x))
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), reference_forward, rtol=1e-5,
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


def test_pipeline_on_a_mesh_of_several_devices_raises():
    ws, x = _inputs()
    mesh = sh.Mesh(["cpu", "meta", "cpu", "cpu"], ("pod",))
    with pytest.raises(NotImplementedError, match="queue A item 10"):
        pipeline_apply(_stage_fn, mesh, MICRO, torch.from_numpy(ws),
                       torch.from_numpy(x))


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
