"""Port parity: the logical-axis sharding rules of
``repro_torch.distributed.sharding`` against ``repro.distributed.sharding``.

Every leaf of every reference config's parameters (the reference's
``jax.eval_shape(init_params)`` against the port's
``init_params(device="meta")``, bf16) gets the same PartitionSpec, equal as
tuples, on abstract meshes (16, 16) and (2, 16, 16), under all three rule
sets; so does every leaf of every decode state.  Leaf paths are printed as
the reference's ``jax.tree_util`` paths, so the two are compared as dicts
from path to (shape, spec).  Then the reference's own ``test_sharding.py``
cases on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS
from repro.configs import get_config as ref_config
from repro.distributed import sharding as rsh
from repro.models import lm as ref_lm
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm

MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
RULES = (("default", None, None),
         ("infer", rsh.INFERENCE_RULES, sh.INFERENCE_RULES),
         ("sp", rsh.PREFILL_SP_RULES, sh.PREFILL_SP_RULES))


def _ref_specs(tree, spec_fn, style, mesh, rules):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    with rsh.use_mesh_rules(None, rules):
        for path, leaf in flat:
            if style == "str":
                name = "/".join(str(k) for k in path)
            else:
                name = "/".join(str(getattr(k, "key", k)) for k in path)
            shape = tuple(np.shape(leaf))
            out[name] = (shape, tuple(spec_fn(name, shape, mesh)))
    return out


def _port_specs(tree, spec_fn, style, mesh, rules):
    with sh.use_mesh_rules(None, rules):
        return {name: (shape, tuple(spec_fn(name, shape, mesh)))
                for name, shape in sh.tree_paths(tree, style)}


def _check_all(ref_tree, port_tree, kind):
    ref_fn = rsh.spec_for_param if kind == "param" else rsh.spec_for_state
    port_fn = sh.spec_for_param if kind == "param" else sh.spec_for_state
    style = "str" if kind == "param" else "key"
    for shape, names in MESHES:
        rm, pm = rsh.abstract_mesh(shape, names), sh.abstract_mesh(shape,
                                                                   names)
        for tag, rrules, prules in RULES:
            want = _ref_specs(ref_tree, ref_fn, style, rm, rrules)
            got = _port_specs(port_tree, port_fn, style, pm, prules)
            assert got == want, (shape, tag, set(got) ^ set(want))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference(arch):
    rcfg = ref_config(arch)
    ref = jax.eval_shape(lambda k: ref_lm.init_params(rcfg, k,
                                                      dtype=jnp.bfloat16),
                         jax.random.PRNGKey(0))
    port = lm.init_params(get_config(arch), None, torch.bfloat16,
                          device="meta")
    _check_all(ref, port, "param")


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_specs_equal_the_reference(arch):
    rcfg = ref_config(arch)
    ref = jax.eval_shape(lambda: ref_lm.init_decode_state(
        rcfg, 128, 4096, dtype=jnp.bfloat16))
    port = lm.init_decode_state(get_config(arch), 128, 4096,
                                torch.bfloat16, device="meta")
    _check_all(ref, port, "state")


def test_sparse_weight_paths_equal_the_reference():
    """A BlockCSR flattens into its four arrays on both sides, printed
    ``[<flat index 0>]`` to ``[<flat index 3>]`` (``str(k)``) and ``0`` to
    ``3`` (the bare key); a sparse MLP's ``w_down`` gets the reference's
    specs for its payload (``(L, nnzb, bm, bk)``, replicated)."""
    from repro.core.csr import BlockCSR as RefBSR
    from repro_torch.core.csr import BlockCSR
    a = np.zeros((2, 3, 8, 8), np.float32)
    cols, rows = np.array([0, 1, 1], np.int32), np.array([0, 0, 1], np.int32)
    rptr = np.array([0, 2, 3], np.int32)
    ref = {"mlp": {"w_down": RefBSR(jnp.asarray(a), jnp.asarray(cols),
                                    jnp.asarray(rows), jnp.asarray(rptr),
                                    (16, 16), (8, 8))}}
    port = {"mlp": {"w_down": BlockCSR(torch.from_numpy(a), cols, rows, rptr,
                                       (16, 16), (8, 8))}}
    flat, _ = jax.tree_util.tree_flatten_with_path(ref)
    assert [p for p, _ in sh.tree_paths(port, "str")] == \
        ["/".join(str(k) for k in path) for path, _ in flat]
    assert [p for p, _ in sh.tree_paths(port, "key")] == \
        ["/".join(str(getattr(k, "key", k)) for k in path)
         for path, _ in flat]
    m = mesh16()
    for (path, leaf), (ppath, shape) in zip(flat,
                                            sh.tree_paths(port, "str")):
        assert tuple(sh.spec_for_param(ppath, shape, m)) == tuple(
            rsh.spec_for_param(ppath, tuple(leaf.shape), m))


def test_param_shardings_tree_follows_the_params():
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), sparse_mlp=True,
                              sparse_block=(8, 8))
    params = lm.init_params(cfg, None, device="meta")
    mesh = sh.abstract_mesh((16, 16), ("data", "model"))
    tree = sh.param_shardings(params, mesh)
    assert set(tree["groups"]["b0"]["mlp"]["w_down"]) == {
        "blocks", "block_col", "block_row", "row_ptr"}
    ns = tree["embed_tokens"]
    assert isinstance(ns, sh.NamedSharding) and ns.mesh is mesh
    assert ns.spec == sh.spec_for_param("['embed_tokens']",
                                        tuple(params["embed_tokens"].shape),
                                        mesh)
    assert "['groups']/['b0']/['attn']/['wq']" not in \
        sh.describe_param_shardings(params, mesh)
    assert "groups/b0/attn/wq" in sh.describe_param_shardings(params, mesh)


def test_batch_shardings_match_the_reference():
    batch = {"tokens": (256, 4096), "labels": (256, 4096),
             "enc_frames": (256, 1536, 512)}
    for shape, names in MESHES:
        rm, pm = rsh.abstract_mesh(shape, names), sh.abstract_mesh(shape,
                                                                   names)
        want = rsh.batch_shardings(
            {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in batch.items()},
            rm)
        got = sh.batch_shardings(
            {k: torch.empty(v, device="meta") for k, v in batch.items()}, pm)
        for k in batch:
            assert tuple(got[k].spec) == tuple(want[k].spec)


# ---- the reference's tests/test_sharding.py cases, on the port ----------

def mesh16():
    return sh.abstract_mesh((16, 16), ("data", "model"))


def test_divisibility_fallback():
    m = mesh16()
    assert sh.logical_spec(("embed", "heads", None), (3584, 28, 128), m) \
        == sh.P("data", None, None)
    assert sh.logical_spec(("embed", "heads", None), (4096, 32, 128), m) \
        == sh.P("data", "model", None)


def test_axis_used_once():
    assert sh.logical_spec(("heads", "mlp"), (32, 1024), mesh16()) \
        == sh.P("model", None)


def test_param_patterns():
    m = mesh16()
    assert sh.spec_for_param("groups/b0/attn/wq", (2, 4096, 32, 128), m) \
        == sh.P(None, "data", "model", None)
    assert sh.spec_for_param("embed_tokens", (151936, 4096), m) \
        == sh.P("model", "data")
    assert sh.spec_for_param("groups/b0/moe/experts_gate",
                             (2, 128, 4096, 1536), m) \
        == sh.P(None, "model", "data", None)
    assert sh.spec_for_param("groups/b0/norm1/scale", (4096,), m) == sh.P()
    assert sh.spec_for_param("error/anything", (), m) == sh.P()


def test_state_patterns():
    m = mesh16()
    assert sh.spec_for_state("groups/b0/k", (2, 128, 32768, 8, 128), m) \
        == sh.P(None, "data", "model", None, None)
    assert sh.spec_for_state("groups/b0/state", (2, 128, 80, 64, 128), m) \
        == sh.P(None, "data", "model", None, None)
    assert sh.spec_for_state("pos", (), m) == sh.P()


def test_shard_noop_outside_context():
    x = torch.ones((4, 4))
    assert sh.shard(x, ("batch", None)) is x


def test_shard_under_a_mesh_returns_x():
    """The reference's ``test_shard_applies_constraint`` (a known failure
    under this jax): under a bound mesh the hint keeps the value."""
    x = torch.ones((4, 4))
    with sh.use_mesh_rules(make_debug_mesh((1, 1), device="cpu")):
        assert sh.shard(x, ("batch", None)) is x


def test_rank_mismatch_raises():
    with sh.use_mesh_rules(make_debug_mesh((1, 1), device="cpu")):
        with pytest.raises(ValueError):
            sh.shard(torch.ones((4, 4)), ("batch",))


def test_rules_bind_and_restore():
    mesh = make_debug_mesh((1, 1), device="cpu")
    assert sh.active_mesh() is None
    with sh.use_mesh_rules(mesh, sh.PREFILL_SP_RULES):
        assert sh.active_mesh() is mesh
        assert sh._ctx.rules["seq"] == ("model",)
        with sh.use_mesh(None):
            assert sh._ctx.rules == sh.DEFAULT_RULES
        assert sh._ctx.rules["seq"] == ("model",)
    assert sh.active_mesh() is None and sh._ctx.rules == sh.DEFAULT_RULES


def test_recompute_context_rebinds_the_rules():
    """A remat recompute on another thread sees the forward's mesh and
    rules (autograd's thread has its own binding)."""
    import threading
    mesh = make_debug_mesh((1, 1), device="cpu")
    with sh.use_mesh_rules(mesh, sh.INFERENCE_RULES):
        _, rebound = sh.recompute_context()
    seen = {}

    def run():
        with rebound:
            seen["mesh"], seen["rules"] = sh.active_mesh(), sh._ctx.rules
        seen["after"] = sh.active_mesh()
    t = threading.Thread(target=run)
    t.start()
    t.join()
    assert seen["mesh"] is mesh and seen["rules"] == sh.INFERENCE_RULES
    assert seen["after"] is None


def test_rule_sets_equal_the_reference():
    assert dict(sh.DEFAULT_RULES) == dict(rsh.DEFAULT_RULES)
    assert dict(sh.INFERENCE_RULES) == dict(rsh.INFERENCE_RULES)
    assert dict(sh.PREFILL_SP_RULES) == dict(rsh.PREFILL_SP_RULES)
