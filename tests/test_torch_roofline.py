"""Port parity: ``repro_torch.roofline`` (``analysis``, ``jaxpr_cost``)
against ``repro.roofline``.

* The HLO text functions are the reference's: ``collective_bytes`` (and its
  top-n view) equal on the compiled text of a program with every
  collective kind inside a scan, made by the reference's jax on 4 forced
  host devices in a subprocess.
* ``model_flops`` and every field of ``Roofline.summary`` equal for every
  applicable arch × shape (the same inputs on both sides).
* The aten walker against the reference's jaxpr walker on dense smoke
  decode steps: the dot FLOPs are equal (the same products); the total
  FLOPs between 0.95× and 1.0× the reference's and the bytes between
  0.45× and 1.0×.  Other ops are one FLOP an output element on both
  sides, but the reference's layer scan carries the stacked cache: each
  layer's slice is read by a ``dynamic_slice`` (one FLOP and 2 bytes-worth
  an element) and written back by a ``dynamic_update_slice`` (2× its
  bytes), where the port's layers read views (free) and write one token
  in place; and a softmax is one aten op where jax has five primitives.
* The walk on ``meta`` counts what the walk on the CPU counts (the same op
  stream), kernels included: a kernel call is charged as the reference's
  counterpart, its plain version's ops not at all.
* The ``meta`` repairs the walk needs: ``init_params(device="meta")``
  with the CPU init's shapes and dtypes, and granite's ``loss_fn``
  backward on ``meta``.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS, SHAPES as REF_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke
from repro.configs import shape_applicable as ref_applicable
from repro.models import lm as ref_lm
from repro.roofline import analysis as ref_analysis
from repro.roofline import jaxpr_cost as ref_jc
from repro_torch.configs import SHAPES, get_config, get_smoke_config
from repro_torch.data import DataConfig, synth_batch
from repro_torch.kernels.moe_gemm import moe_gemm as b8_gemm
from repro_torch.models import lm
from repro_torch.regions import region
from repro_torch.roofline import analysis
from repro_torch.roofline import jaxpr_cost as jc
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state
from repro_torch.train.train_step import make_train_step

HLO_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    mesh = jax.make_mesh((4,), ("x",))

    def inner(a):
        def body(c, _):
            c = jax.lax.ppermute(c, "x", [(i, (i + 1) % 4) for i in range(4)])
            return c * 2.0, None
        a, _ = jax.lax.scan(body, a, None, length=3)
        s = jax.lax.psum(a, "x")
        g = jax.lax.all_gather(a, "x")
        t = jax.lax.all_to_all(a.reshape(4, -1), "x", 0, 0)
        r = jax.lax.psum_scatter(a.reshape(4, -1), "x", tiled=True)
        return s + g.sum(0) + t.reshape(a.shape) + r.sum()

    f = jax.jit(shard_map(inner, mesh=mesh, in_specs=P("x"),
                          out_specs=P("x"), check_rep=False))
    text = f.lower(jnp.ones((64, 8), jnp.float32)).compile().as_text()
    open(sys.argv[1], "w").write(text)
    print("hlo written")
""")


@pytest.fixture(scope="module")
def hlo_text(tmp_path_factory):
    out = tmp_path_factory.mktemp("hlo") / "module.txt"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.run([sys.executable, "-c", HLO_SCRIPT, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return out.read_text()


def test_collective_bytes_equal_the_reference(hlo_text):
    want = ref_analysis.collective_bytes(hlo_text)
    got = analysis.collective_bytes(hlo_text)
    assert got == want
    # the program has every kind but reduce-scatter's own op (XLA may
    # lower it either way) and the scan's permutes are multiplied
    assert want["collective-permute"] > 0 and want["all-reduce"] > 0
    assert analysis.collective_bytes(hlo_text, top_n=5) == \
        ref_analysis.collective_bytes(hlo_text, top_n=5)
    comps = analysis._split_computations(hlo_text)
    assert comps == ref_analysis._split_computations(hlo_text)
    assert analysis._computation_multiplicities(comps) == \
        ref_analysis._computation_multiplicities(comps)
    for dtype, dims in (("bf16", "16,4096"), ("f32", ""), ("pred", "3"),
                        ("token", "")):
        assert analysis._shape_bytes(dtype, dims) == \
            ref_analysis._shape_bytes(dtype, dims)


CELLS = [(a, s) for a in sorted(ARCHS) for s in sorted(REF_SHAPES)
         if ref_applicable(ref_config(a), REF_SHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_and_roofline_fields_equal(arch, shape, monkeypatch):
    """The same formulas: with the reference's hardware constants (a TPU
    v5e's) in the port's module, every field of the summary is equal."""
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(analysis, name, getattr(ref_analysis, name))
    rc, pc = ref_config(arch), get_config(arch)
    active = rc.param_count(active_only=True)
    assert pc.param_count(active_only=True) == active
    assert pc.param_count() == rc.param_count()
    want = ref_analysis.model_flops(rc, REF_SHAPES[shape], active)
    assert analysis.model_flops(pc, SHAPES[shape], active) == want
    flops, nbytes = 3.1e18 + len(arch), 7.7e14 * len(shape)
    coll = {"all-to-all": 1.5e9, "collective-permute": 2.5e8,
            "all-gather": 0.0, "all-reduce": 4e7, "reduce-scatter": 0.0}
    r = ref_analysis.Roofline(flops=flops, bytes_accessed=nbytes,
                              coll_bytes=coll, chips=256)
    p = analysis.Roofline(flops=flops, bytes_accessed=nbytes,
                          coll_bytes=dict(coll), chips=256)
    assert p.summary(model_flops_global=want) == \
        r.summary(model_flops_global=want)


def test_constants_are_the_cards():
    """NVIDIA H100 80GB HBM3, 700 W: dense bf16, HBM3, NVLink one way."""
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.ICI_BW) == (
        989e12, 3.35e12, 450e9)


def test_analyze_charges_the_walks_collectives_per_device():
    cost = jc.Cost(2e15, 3e12)
    cost.collectives = {"all-to-all": 256e9, "collective-permute": 512e6}
    rl = analysis.analyze(cost, 256)
    assert rl.coll_bytes["all-to-all"] == 1e9
    assert rl.coll_bytes["collective-permute"] == 2e6
    assert rl.collective_s == (1e9 + 2e6) / analysis.ICI_BW
    assert rl.compute_s == 2e15 / (256 * analysis.PEAK_FLOPS)
    assert rl.memory_s == 3e12 / (256 * analysis.HBM_BW)


def _ref_cost(fn, *args):
    """The reference walker's FLOPs, bytes and dot FLOPs (the walk again
    with dot FLOPs zeroed, subtracted: its scans multiply them)."""
    c = ref_jc.jaxpr_cost(fn, *args)
    orig = ref_jc._dot_flops
    ref_jc._dot_flops = lambda eqn: 0
    try:
        c0 = ref_jc.jaxpr_cost(fn, *args)
    finally:
        ref_jc._dot_flops = orig
    return c.flops, c.bytes, c.flops - c0.flops


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2-7b", "internvl2-1b",
                                  "granite-moe-3b-a800m"])
def test_decode_step_walk_against_the_reference(arch):
    b, s = 4, 64
    rc, pc = ref_smoke(arch), get_smoke_config(arch)
    rp = jax.eval_shape(lambda k: ref_lm.init_params(rc, k),
                        jax.random.PRNGKey(0))
    rs = jax.eval_shape(lambda: ref_lm.init_decode_state(rc, b, s))
    tok = jax.ShapeDtypeStruct((b, 1), jnp.int32)
    rf, rb, rd = _ref_cost(lambda p, st, t: ref_lm.decode_step(p, rc, st, t),
                           rp, rs, tok)
    pp = lm.init_params(pc, None, device="meta")
    ps = lm.init_decode_state(pc, b, s, device="meta")
    pt = torch.empty((b, 1), dtype=torch.int32, device="meta")
    cost = jc.jaxpr_cost(lambda: lm.decode_step(pp, pc, ps, pt))
    assert cost.dot_flops == rd
    assert 0.95 <= cost.flops / rf <= 1.0
    assert 0.45 <= cost.bytes / rb <= 1.0


def _counts(c):
    return (c.flops, c.bytes, c.dot_flops, c.ops)


def test_meta_walk_equals_the_cpu_walk():
    """qwen3-4b smoke with a sparse MLP (B3 in the decode step; B4 and B2
    in the train step, through their plain versions on the CPU): the same
    counts on ``meta`` and on the CPU."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), sparse_mlp=True,
                              sparse_block=(8, 8), train_microbatches=2)
    cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    meta = lm.init_params(cfg, None, device="meta")
    for params, dev in ((cpu, "cpu"), (meta, "meta")):
        assert params["groups"]["b0"]["mlp"]["w_down"].blocks.device.type \
            == dev
    batch = synth_batch(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4, seed=0), 0)
    ocfg = OptimizerConfig()
    counts = {}
    for params, dev in ((cpu, "cpu"), (meta, "meta")):
        p = lm.unstack_layers(params)
        plan = lm.sparse_mlp_plan(p)
        step = make_train_step(cfg, ocfg, mlp_plan=plan)
        b = {k: v.to(dev) for k, v in batch.items()}
        train = jc.jaxpr_cost(step, p, init_opt_state(ocfg, p), b)
        state = lm.init_decode_state(cfg, 4, 32, device=dev)
        tok = batch["tokens"][:, :1].to(dev)
        decode = jc.jaxpr_cost(lambda: lm.decode_step(params, cfg, state,
                                                      tok))
        counts[dev] = (_counts(train), _counts(decode))
    assert counts["cpu"] == counts["meta"]


def test_meta_walk_peak_equals_the_cpu_walks():
    """The dense qwen3-4b smoke's train step (4 microbatches) and decode
    step through ``dryrun.step_call``: on ``meta`` and on the CPU the same
    counts and the same peak of live bytes (an operand's storage, as an
    ``_unsafe_view`` result shares, is not a temporary)."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"),
                              train_microbatches=4)
    ocfg = dryrun.optimizer_config(cfg)
    for shape in (ShapeSpec("t", 32, 4, "train"),
                  ShapeSpec("d", 64, 4, "decode")):
        meta = jc.jaxpr_cost(dryrun.step_call(cfg, shape, ocfg, 4))
        cpu = jc.jaxpr_cost(dryrun.step_call(
            cfg, shape, ocfg, 4, device="cpu",
            generator=torch.Generator().manual_seed(0)))
        assert _counts(meta) == _counts(cpu)
        assert meta.peak_bytes == cpu.peak_bytes > 0


def test_kernel_calls_are_charged_as_the_reference_counterparts():
    """B8 forward and backward on ``meta`` and on the CPU: each call the
    reference einsum's ``dot_general`` (2·T·K·N FLOPs, operand and result
    bytes), none of the plain version's ops."""
    e, bt, d, f = 4, 8, 16, 24
    for dev in ("cpu", "meta"):
        x = torch.ones((e * bt, d), device=dev, requires_grad=True)
        w = torch.ones((e, d, f), device=dev, requires_grad=True)
        eot = torch.arange(e, dtype=torch.int32, device=dev)
        fwd = jc.jaxpr_cost(lambda: b8_gemm(x, eot, w, bt=bt))
        assert fwd.ops == 1 and fwd.dot_flops == 2 * e * bt * d * f
        assert fwd.bytes == 4 * (x.numel() + w.numel() + e * bt * f)
        both = jc.jaxpr_cost(lambda: b8_gemm(x, eot, w, bt=bt).sum()
                             .backward())
        # forward, the sum, dx and dW (and the ones of the sum's backward)
        assert both.dot_flops == 3 * 2 * e * bt * d * f


def test_views_are_free_and_fused_regions_charge_their_boundary():
    x = torch.ones((8, 16), device="meta")
    c = jc.jaxpr_cost(lambda: x.view(16, 8).t().reshape(8, 16))
    assert (c.flops, c.bytes) == (0, 0)

    def ssd_scan(a):                # a stand-in under a region's name
        return (a.sum(-1) * 2).exp()
    inner = jc.jaxpr_cost(lambda: (x.sum(-1) * 2).exp())
    fused = jc.jaxpr_cost(lambda: region(ssd_scan)(x))
    with pytest.raises(KeyError, match="no charge"):
        jc.jaxpr_cost(lambda: region(lambda a: a)(x))
    assert region(ssd_scan)(x).shape == (8,)      # outside a walk: the call
    assert fused.flops == inner.flops
    assert fused.bytes == 8 * 16 * 4 + 8 * 4


def test_every_kernel_region_has_a_charge():
    """Each ``region`` of ``repro_torch.kernels`` is one of the walker's
    ``KERNEL_CHARGES``, and each charge names a region there."""
    import importlib
    found = set()
    for mod in ("block_attn", "maple_sddmm", "maple_spgemm", "maple_spmm",
                "maple_spmspm", "moe_gemm"):
        m = importlib.import_module(f"repro_torch.kernels.{mod}")
        for name, fn in vars(m).items():
            if getattr(fn, "is_region", False) and \
                    fn.__module__ == m.__name__:
                found.add(f"{mod}.{fn.__name__}")
    assert found == set(jc.KERNEL_CHARGES)


def test_a_walk_charges_its_own_thread_and_its_backward_only():
    """A kernel called on another thread while a walk runs is not charged
    to it; the backward that the walk's thread starts is, wherever
    autograd runs it."""
    import threading
    e, bt, d, f = 4, 8, 16, 24
    x = torch.ones((e * bt, d), device="meta", requires_grad=True)
    w = torch.ones((e, d, f), device="meta", requires_grad=True)
    eot = torch.arange(e, dtype=torch.int32, device="meta")
    inside, other_done = threading.Event(), threading.Event()

    def other():
        inside.wait()
        b8_gemm(x.detach(), eot, w.detach(), bt=bt)
        other_done.set()

    def walked():
        inside.set()
        other_done.wait()
        b8_gemm(x, eot, w, bt=bt).sum().backward()
    t = threading.Thread(target=other)
    t.start()
    c = jc.jaxpr_cost(walked)
    t.join()
    assert c.dot_flops == 3 * 2 * e * bt * d * f


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_init_has_the_cpu_shapes_and_dtypes(arch):
    cfg = get_smoke_config(arch)
    for dtype in (torch.float32, torch.bfloat16):
        meta = lm.init_params(cfg, None, dtype, device="meta")
        cpu = lm.init_params(cfg, torch.Generator().manual_seed(0), dtype,
                             device="cpu")
        got = [(p, t.shape, t.dtype, t.device.type)
               for p, t in _leaves(meta)]
        want = [(p, t.shape, t.dtype, "meta") for p, t in _leaves(cpu)]
        assert got == want


def _leaves(tree, prefix=""):
    from repro_torch.distributed.sharding import leaves_with_path
    return [(path, leaf) for path, leaf in leaves_with_path(tree)
            if isinstance(leaf, torch.Tensor)]


def test_init_params_without_a_generator_off_meta_raises():
    with pytest.raises(ValueError, match="generator"):
        lm.init_params(get_smoke_config("qwen3-4b"), None, device="cpu")


def test_granite_loss_backward_runs_on_meta():
    cfg = get_smoke_config("granite-moe-3b-a800m")
    params = lm.unstack_layers(lm.init_params(cfg, None, device="meta"))
    leaves = [t for _, t in _leaves(params)]
    for t in leaves:
        t.requires_grad_(True)
    batch = {k: torch.empty((2, 16), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    loss, _ = lm.loss_fn(params, cfg, batch)
    loss.backward()
    for t in leaves:
        assert t.grad is not None and t.grad.shape == t.shape
        assert t.grad.device.type == "meta"
