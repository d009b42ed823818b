"""Port parity: the expert-parallel MoE path (``moe_layer_ep``) against the
reference's on a multi-device mesh.

One module-scoped subprocess runs the reference's ``moe_layer`` with
``impl="ep_a2a"`` under ``use_mesh_rules`` on 8 forced host devices (as
``tests/test_moe_ep.py`` does), jitted, on inputs and weights drawn here
from numpy seeds and handed over in an npz; it writes each case's output
and the gradients of ``sum(y²)``.  The port runs the same program on a CPU
mesh of the same shape (``make_debug_mesh(..., device="cpu")``), with
whole expert leaves and with the tree placed by
``sharding.device_put_params`` (each peer's slices, the serving and
training path of a mesh of several cards, where the CPU mesh's entries
stand for several devices through ``sharding.several``); the subprocess also
writes the reference's cut of each expert leaf
(``NamedSharding.devices_indices_map``).

Tolerances: y within 1e-5 (the two sum in different orders); dx and the
expert-weight and router gradients within 1e-4·max + 1e-6, of two
losses: ``sum(y²)`` and ``sum(y·R)`` for a fixed random R.

Two behaviours of the reference are pinned rather than copied:

* a dropped slot's ``.set(-1)`` lands on cell ``(0, cap_send - 1)`` of the
  expert-id send buffer; under ``jit`` on the CPU the last write wins, so
  when peer 0 is full the kept slot there loses its expert.  The port
  never writes a dropped slot there (``test_ep_dropped_slot_never_erases``);
* where a peer drops slots at the second level, the model peers' copies
  of the output differ; the reference's output is peer 0's, and its
  shard_map transpose hands every copy the cotangent over the peer count,
  the cotangent each device computed from its own copy.  The port returns
  peer 0's copy and hands every copy peer 0's cotangent over the peer
  count: its own gradient equals the reference's where the loss is linear
  in y (``sum(y·R)``), and the reference's ``sum(y²)`` gradient is held
  against the copies' (``_ep_forward``) each with its own cotangent.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import lm as ref_lm
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import lm
from repro_torch.models import moe as M
from repro_torch.train.optimizer import named_leaves

KEYS = ("router", "experts_gate", "experts_up", "experts_down")
D, F, K = 64, 32, 2
# name: (mesh shape, axes, experts, capacity factor, batch, router column
# skewed, its skew); the skewed expert lives on peer 1 unless the case is
# about peer 0 being full
CASES = {
    "mesh24_cf8": ((2, 4), ("data", "model"), 8, 8.0, 4, 0, 0.0),
    "mesh14_cf8": ((1, 4), ("data", "model"), 8, 8.0, 4, 0, 0.0),
    "mesh222_cf8": ((2, 2, 2), ("pod", "data", "model"), 8, 8.0, 2, 0, 0.0),
    "mesh24_cf125_drops": ((2, 4), ("data", "model"), 16, 1.25, 4, 5, 2.0),
    "mesh14_cf125_drops": ((1, 4), ("data", "model"), 16, 1.25, 4, 5, 2.0),
    "mesh24_replicated": ((2, 4), ("data", "model"), 8, 1.25, 3, 3, 1.0),
    "peer0_full": ((1, 4), ("data", "model"), 8, 1.25, 4, 0, 2.5),
}
MATCHED = [c for c in CASES if c != "peer0_full"]
# the serving meshes of device_put_params: (data, model) = (1, 4), (2, 4)
PLACED = [c for c in MATCHED if CASES[c][1] == ("data", "model")]
# expert leaves cut by the reference's param sharding: (mesh, path, shape)
STACKED = "['groups']/['b0']/['moe']/['{}']"
PER_LAYER = "['groups']/['b0']/[1]/['moe']/['{}']"
CUTS = [((1, 4), STACKED, (3, 8, 64, 32), "experts_gate"),
        ((2, 4), STACKED, (3, 8, 32, 64), "experts_down"),
        ((2, 4), PER_LAYER, (8, 64, 32), "experts_up")]
# the cases whose placed gradients are held against the reference's cut
# of each expert leaf (the layer's own tree: the leaf's path is its key)
GRADIENT = ["mesh14_cf8", "mesh14_cf125_drops"]
EXPERTS = ("experts_gate", "experts_up", "experts_down")


def _leaf_dims(name, leaf):
    e = CASES[name][2]
    return (e, F, D) if leaf == "experts_down" else (e, D, F)


GRAD_CUTS = {(name, leaf): len(CUTS) + i for i, (name, leaf) in enumerate(
    (n, leaf) for n in GRADIENT for leaf in EXPERTS)}
ALL_CUTS = CUTS + [(CASES[name][0], "['{}']", _leaf_dims(name, leaf), leaf)
                   for name, leaf in GRAD_CUTS]

SCRIPT = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.sharding import use_mesh_rules
    from repro.models import moe as M
    from jax.sharding import NamedSharding
    from repro.distributed.sharding import spec_for_param
    spec = json.load(open(sys.argv[1]))
    inp = np.load(sys.argv[2])
    out = {}
    for i, c in enumerate(spec.pop("__cuts__")):
        mesh = jax.make_mesh(tuple(c["shape"]), ("data", "model"))
        leaf = tuple(c["leaf"])
        where = NamedSharding(mesh, spec_for_param(
            c["path"], leaf, mesh)).devices_indices_map(leaf)
        rows = []
        for coord in np.ndindex(mesh.devices.shape):
            for dim, sl in enumerate(where[mesh.devices[coord]]):
                rows.append([*coord, dim, *sl.indices(leaf[dim])[:2]])
        out[f"cut{i}"] = np.asarray(rows)
    for name, c in spec.items():
        cfg = M.MoEConfig(**c["fields"])
        mesh = jax.make_mesh(tuple(c["shape"]), tuple(c["axes"]))
        p = {k: jnp.asarray(inp[name + "/" + k]) for k in c["keys"]}
        x = jnp.asarray(inp[name + "/x"])
        r = jnp.asarray(inp[name + "/r"])
        losses = {"": lambda p, x: (M.moe_layer(p, cfg, x) ** 2).sum(),
                  "lin_": lambda p, x: (M.moe_layer(p, cfg, x) * r).sum()}
        with use_mesh_rules(mesh):
            assert M._ep_applicable(cfg), name
            y = jax.jit(lambda p, x: M.moe_layer(p, cfg, x))(p, x)
            out[name + "/y"] = np.asarray(y)
            for tag, loss in losses.items():
                gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(p, x)
                out[name + "/" + tag + "dx"] = np.asarray(gx)
                for k in c["keys"]:
                    out[name + "/" + tag + "d" + k] = np.asarray(gp[k])
    np.savez(sys.argv[3], **out)
    print("reference EP done")
""")


def _fields(name):
    _, _, e, cf, _, _, _ = CASES[name]
    return dict(d_model=D, n_experts=e, n_experts_padded=e, top_k=K,
                d_expert=F, capacity_factor=cf, impl="ep_a2a")


def _inputs(name):
    shape, _, e, _, b, col, skew = CASES[name]
    rng = np.random.default_rng(len(name) * 7 + e)
    w = {"router": rng.standard_normal((D, e)).astype(np.float32) / 8,
         "experts_gate": rng.standard_normal((e, D, F)).astype(
             np.float32) / 8,
         "experts_up": rng.standard_normal((e, D, F)).astype(np.float32) / 8,
         "experts_down": rng.standard_normal((e, F, D)).astype(
             np.float32) / 6}
    w["router"][:, col] += skew
    return w, rng.standard_normal((b, 16, D)).astype(np.float32)


def _cotangent(name):
    """The fixed R of the loss ``sum(y·R)``, drawn apart from the inputs."""
    _, x = _inputs(name)
    return np.random.default_rng(len(name) + 1000).standard_normal(
        x.shape).astype(np.float32)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    spec, arrays = {}, {}
    for name, (shape, axes, *_rest) in CASES.items():
        spec[name] = {"fields": _fields(name), "shape": shape, "axes": axes,
                      "keys": KEYS}
        w, x = _inputs(name)
        arrays.update({f"{name}/{k}": v for k, v in w.items()})
        arrays[f"{name}/x"] = x
        arrays[f"{name}/r"] = _cotangent(name)
    spec["__cuts__"] = [{"shape": shape, "path": path.format(leaf),
                         "leaf": dims}
                        for shape, path, dims, leaf in ALL_CUTS]
    (tmp / "spec.json").write_text(json.dumps(spec))
    np.savez(tmp / "inputs.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp / "spec.json"),
         str(tmp / "inputs.npz"), str(tmp / "out.npz")],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, (proc.stderr[-3000:], proc.stdout[-500:])
    assert "reference EP done" in proc.stdout
    return dict(np.load(tmp / "out.npz"))


def _port(name, fn=None):
    """The port on ``name``'s inputs under its CPU mesh: (y, grads of
    sum(y²) by key and ``"x"``, drops).  ``fn`` maps (p, cfg, x) to the
    loss (default: ``moe_layer``'s sum of squares)."""
    shape, axes, *_ = CASES[name]
    cfg = M.MoEConfig(**_fields(name))
    w, x = _inputs(name)
    p = {k: torch.from_numpy(v).requires_grad_(True) for k, v in w.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    with sh.use_mesh(make_debug_mesh(shape, axes, device="cpu")):
        y = M.moe_layer(p, cfg, xt)
        loss = (y ** 2).sum() if fn is None else fn(p, cfg, xt)
        drops = M.ep_dropped_slots(p, cfg, xt.detach())
    loss.backward()
    grads = {k: t.grad.numpy() for k, t in p.items()}
    grads["x"] = xt.grad.numpy()
    return y.detach().numpy(), grads, drops


def _grads_close(got, reference, name, tag=""):
    for key in ("x",) + KEYS:
        want = reference[f"{name}/{tag}d{key}"]
        err = float(np.abs(got[key] - want).max())
        limit = 1e-4 * float(np.abs(want).max()) + 1e-6
        assert err <= limit, f"{name} {tag}d{key}: {err} > {limit}"


def _own_cotangents(p, cfg, x):
    """``sum(y²)`` as the reference's devices take it: each model peer's
    copy squared, the copies averaged."""
    copies = M._ep_forward(p, cfg, x)
    return sum((c ** 2).sum() for c in copies) / len(copies)


def _grads_match(reference, name, grads, drops):
    """The port's gradients of both losses against the reference's:
    ``moe_layer``'s own for ``sum(y·R)``; for ``sum(y²)`` its own where no
    peer drops at the second level, else the copies' with their own
    cotangents."""
    r = torch.from_numpy(_cotangent(name))
    _, lin, _ = _port(name, fn=lambda p, cfg, x: (M.moe_layer(p, cfg, x)
                                                  * r).sum())
    _grads_close(lin, reference, name, "lin_")
    if drops["second_level"]:
        _, grads, _ = _port(name, fn=_own_cotangents)
    _grads_close(grads, reference, name)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", MATCHED)
def test_ep_matches_reference(reference, name):
    y, grads, drops = _port(name)
    err = float(np.abs(y - reference[f"{name}/y"]).max())
    assert err <= 1e-5, f"{name} y: {err}"
    if "drops" in name:
        assert drops["first_level"] > 0 and drops["second_level"] > 0
    _grads_match(reference, name, grads, drops)


def test_ep_sizes_follow_the_reference_greedy_pick():
    cfg = M.MoEConfig(**_fields("mesh24_cf125_drops"))
    mesh = make_debug_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    for b, axes, div in ((4, ("pod", "data"), 4), (2, ("data",), 2),
                         (6, ("data",), 2), (3, (), 1)):
        z = M.ep_sizes(mesh, cfg, b, 16)
        assert (z["batch_axes"], z["batch_div"]) == (axes, div)
        t_loc = b // div * 16
        cap_send = max(8, -(-int(t_loc * K * 1.25 / 2) // 8) * 8)
        assert (z["t_loc"], z["cap_send"]) == (t_loc, cap_send)
        assert z["cap_exp"] == max(8, -(-int(2 * cap_send * 1.25 / 8)
                                        // 8) * 8)
    z = M.ep_sizes(make_debug_mesh((1, 4), device="cpu"), cfg, 4, 16)
    assert (z["batch_axes"], z["t_loc"], z["cap_send"], z["cap_exp"],
            z["e_loc"]) == (("data",), 64, 40, 56, 4)


def test_ep_returns_peer_0s_copy_and_hands_each_copy_the_cotangent():
    """With second-level drops the peers' copies differ: the output is
    peer 0's copy bit for bit, and the gradient hands every copy the
    output's cotangent over the peer count (the reference's transpose);
    held within 1e-6·max + 1e-9 of that sum taken by hand, whose
    gradients accumulate in another order."""
    name = "mesh14_cf125_drops"
    y, grads, drops = _port(name)
    assert drops["second_level"] > 0
    ct = torch.from_numpy(2 * y)                  # d sum(y²) / dy

    def by_hand(p, cfg, x):
        copies = M._ep_forward(p, cfg, x)
        assert torch.equal(copies[0].detach(), torch.from_numpy(y))
        assert not torch.equal(copies[0], copies[-1])  # later copies lost
        return sum((c * ct).sum() for c in copies) / len(copies)
    _, want, _ = _port(name, fn=by_hand)
    for key, g in grads.items():
        limit = 1e-6 * float(np.abs(want[key]).max()) + 1e-9
        assert float(np.abs(g - want[key]).max()) <= limit, key
    with sh.use_mesh(make_debug_mesh((1, 4), device="cpu")):
        w, x = _inputs(name)
        p = {k: torch.from_numpy(v) for k, v in w.items()}
        cfg = M.MoEConfig(**_fields(name))
        assert len(M._ep_forward(p, cfg, torch.from_numpy(x))) == 1


@pytest.mark.timeout(300)
def test_ep_dropped_slot_never_erases_a_kept_one(reference, monkeypatch):
    """Peer 0 full and slots dropped: the reference's ``.set(-1)`` of the
    dropped slots lands on the kept slot at ``(0, cap_send - 1)``, whose
    token then loses that expert; the port keeps it.  With that one write
    put back, the port equals the reference on every token."""
    name = "peer0_full"
    cfg = M.MoEConfig(**_fields(name))
    w, x = _inputs(name)
    mesh = make_debug_mesh((1, 4), device="cpu")
    z = M.ep_sizes(mesh, cfg, *x.shape[:2])
    cap_send = z["cap_send"]
    xt = torch.from_numpy(x).reshape(-1, D)
    r = M._ep_route(torch.from_numpy(w["router"]), cfg, xt, 4, z["e_loc"],
                    cap_send)
    _, eid_send = M._ep_send(xt, r, 4, cap_send)
    assert not bool(r["keep"].all())                  # slots are dropped
    held = r["keep"] & (r["slot"] == cap_send - 1)    # the kept slot there
    assert int(held.sum()) == 1
    assert int(eid_send[0, cap_send - 1]) == int(r["eid"][held])
    token = int(held.nonzero()) // K                  # flat order: token-major

    y, _, _ = _port(name)
    y_ref = reference[f"{name}/y"].reshape(-1, D)
    diff = np.abs(y.reshape(-1, D) - y_ref).max(axis=1)
    assert diff[token] > 1e-3
    assert np.delete(diff, token).max() <= 1e-5

    send = M._ep_send

    def reference_write(xt, r, msize, cap_send):
        xs, es = send(xt, r, msize, cap_send)
        if not bool(r["keep"].all()):
            es = es.clone()
            es[0, cap_send - 1] = -1
        return xs, es
    monkeypatch.setattr(M, "_ep_send", reference_write)
    y, grads, drops = _port(name)
    assert float(np.abs(y - reference[f"{name}/y"]).max()) <= 1e-5
    _grads_match(reference, name, grads, drops)


@pytest.mark.parametrize("why", ["no_mesh", "no_model_axis",
                                 "indivisible_experts",
                                 "indivisible_d_model", "return_aux"])
def test_ep_falls_back_to_the_sort_path(why):
    fields = _fields("mesh24_cf125_drops")
    mesh = make_debug_mesh((2, 4), device="cpu")
    if why == "no_mesh":
        mesh = None
    elif why == "no_model_axis":
        mesh = make_debug_mesh((2, 4), ("data", "shard"), device="cpu")
    elif why == "indivisible_experts":
        fields.update(n_experts=12, n_experts_padded=12)
        mesh = make_debug_mesh((1, 8), device="cpu")
    elif why == "indivisible_d_model":
        mesh = make_debug_mesh((3, 2), device="cpu")
    cfg = M.MoEConfig(**fields)
    sort = dataclasses.replace(cfg, impl="gspmd")
    p = M.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 8, D)).astype(np.float32))
    with sh.use_mesh(mesh):
        assert M._ep_applicable(cfg) == (why == "return_aux")
        if why == "return_aux":
            got, aux = M.moe_layer(p, cfg, x, return_aux=True)
            want, aux_want = M.moe_layer(p, sort, x, return_aux=True)
            assert torch.equal(aux, aux_want)
        else:
            got, want = M.moe_layer(p, cfg, x), M.moe_layer(p, sort, x)
    assert torch.equal(got, want)


def test_ep_mesh_of_another_device_type_raises():
    cfg = M.MoEConfig(**_fields("mesh14_cf8"))
    p = M.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros((2, 8, D))
    with sh.use_mesh(make_debug_mesh((1, 4), device="cuda")), \
            pytest.raises(ValueError, match="devices of the operands' type"):
        M.moe_layer(p, cfg, x)


@pytest.fixture(scope="module")
def granite_ep():
    """The granite-moe-3b smoke config with ``moe_impl="ep_a2a"``,
    weights from the reference carried across with the converter."""
    cfg_ref = ref_smoke_config("granite-moe-3b-a800m")
    cfg = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              moe_impl="ep_a2a", moe_capacity_factor=8.0)
    params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_map(np.asarray, params_ref)
    return cfg_ref, cfg, params_ref, params_from_numpy(flat, cfg,
                                                       device="cpu")


def test_ep_model_prefill_matches_the_reference(granite_ep):
    """At capacity 8 neither path drops a slot: the whole smoke model
    under a (1, 4) CPU mesh on the EP path gives the reference's
    sort-path logits."""
    cfg_ref, cfg, params_ref, params = granite_ep
    tok = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))
    want, _ = ref_lm.prefill(params_ref, cfg_ref,
                             {"tokens": jax.numpy.asarray(tok)})
    calls = []
    ep = M.moe_layer_ep

    def counted(*a):
        calls.append(1)
        return ep(*a)
    M.moe_layer_ep = counted
    try:
        with sh.use_mesh(make_debug_mesh((1, 4), device="cpu")):
            got, _ = lm.prefill(params, cfg, {"tokens": torch.from_numpy(tok)})
    finally:
        M.moe_layer_ep = ep
    assert len(calls) == cfg.n_layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_ep_trains_like_the_sort_path(granite_ep):
    """The loss and every gradient of one batch on the EP path (under a
    (2, 4) CPU mesh) against the sort path, with no slot dropped: within
    1e-4·max + 1e-6."""
    _, cfg, _, params = granite_ep
    tok = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 9))
    batch = {"tokens": torch.from_numpy(tok[:, :8]),
             "labels": torch.from_numpy(tok[:, 1:])}
    out = {}
    for impl, mesh in (("gspmd", None),
                       ("ep_a2a", make_debug_mesh((2, 4), device="cpu"))):
        per = lm.unstack_layers(params)
        leaves = dict(named_leaves(per))
        for t in leaves.values():
            t.requires_grad_(True)
        with sh.use_mesh(mesh):        # remat recomputes in the backward
            loss, _ = lm.loss_fn(per, dataclasses.replace(cfg, moe_impl=impl),
                                 batch)
            loss.backward()
        out[impl] = (float(loss.detach()),
                     {k: t.grad for k, t in leaves.items()})
    assert abs(out["ep_a2a"][0] - out["gspmd"][0]) <= 1e-5 * out["gspmd"][0]
    for k, want in out["gspmd"][1].items():
        got = out["ep_a2a"][1][k]
        err = float((got - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-6, k


def test_ep_remat_recompute_runs_under_the_forwards_mesh(granite_ep):
    """The mesh is bound per thread, and on CUDA autograd runs the
    backward (and so remat's recompute) on a thread of its own: a
    backward on another thread, outside the mesh, recomputes on the EP
    path as the forward did and gives the same gradients."""
    _, cfg, _, params = granite_ep
    tok = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 9))
    batch = {"tokens": torch.from_numpy(tok[:, :8]),
             "labels": torch.from_numpy(tok[:, 1:])}
    grads = []
    for thread in (False, True):
        per = lm.unstack_layers(params)
        leaves = dict(named_leaves(per))
        for t in leaves.values():
            t.requires_grad_(True)
        with sh.use_mesh(make_debug_mesh((1, 4), device="cpu")):
            loss, _ = lm.loss_fn(per, cfg, batch)
            if not thread:
                loss.backward()
        if thread:
            errors = []

            def backward():
                try:
                    loss.backward()
                except Exception as e:          # reported below
                    errors.append(e)
            worker = threading.Thread(target=backward)
            worker.start()
            worker.join()
            assert not errors, errors
        grads.append({k: t.grad for k, t in leaves.items()})
    for k, g in grads[0].items():
        assert torch.equal(grads[1][k], g), k


def test_received_is_the_all_to_all_transpose():
    """R_p[s] = S_s[p] where every source sends the same buffer S (the
    peers of a batch shard route its tokens alike), peer major."""
    send = torch.arange(24.0).view(4, 3, 2)
    got = M._received(send, 4).view(4, 4, 3, 2)
    for pe in range(4):
        for src in range(4):
            assert torch.equal(got[pe, src], send[pe])
    ids = torch.arange(12, dtype=torch.int32).view(4, 3)
    assert torch.equal(M._received(ids, 4).view(4, 4, 3),
                       ids.unsqueeze(1).expand(4, 4, 3))


def test_ep_mesh_of_several_devices_raises(monkeypatch):
    """A mesh whose entries are not all x's device (a mesh of several
    cards) takes expert weights placed on their peers' devices: whole
    leaves raise, naming the placement function; here the CPU's entries
    stand for other devices."""
    monkeypatch.setattr(sh, "several", lambda mesh: True)
    cfg = M.MoEConfig(**_fields("mesh14_cf8"))
    p = M.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.zeros((2, 8, D))
    with sh.use_mesh(make_debug_mesh((1, 4), device="cpu")), \
            pytest.raises(ValueError, match="device_put_params"):
        M.moe_layer(p, cfg, x)


def _placed(name, mesh):
    """``name``'s weights placed on ``mesh`` by ``device_put_params``
    beside the whole ones, its config and its input."""
    cfg = M.MoEConfig(**_fields(name))
    w, x = _inputs(name)
    whole = {k: torch.from_numpy(v) for k, v in w.items()}
    return whole, sh.device_put_params(whole, mesh), cfg, \
        torch.from_numpy(x)


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", PLACED)
def test_placed_tree_matches_reference(reference, name):
    """The tree placed by ``device_put_params`` on a CPU (1, 4) or (2, 4)
    mesh runs each peer's products on its slices: within 1e-5 of the
    reference's ``moe_layer_ep``, and the whole tree's bits."""
    shape, axes, *_ = CASES[name]
    mesh = make_debug_mesh(shape, axes, device="cpu")
    whole, placed, cfg, x = _placed(name, mesh)
    with sh.use_mesh(mesh):
        got = M.moe_layer(placed, cfg, x)
        want = M.moe_layer(whole, cfg, x)
    err = float(np.abs(got.numpy() - reference[f"{name}/y"]).max())
    assert err <= 1e-5, f"{name} y: {err}"
    assert torch.equal(got, want)


@pytest.fixture(scope="module")
def cut_tree():
    """The leaves of ``CUTS`` in one parameter tree (a stacked group and a
    per-layer list, as ``lm`` holds them), drawn from a seed, with a
    norm leaf that is not cut."""
    rng = np.random.default_rng(9)
    draw = lambda dims: torch.from_numpy(  # noqa: E731
        rng.standard_normal(dims).astype(np.float32))
    stacked = {"moe": {leaf: draw(dims) for _, path, dims, leaf in CUTS
                       if path == STACKED}, "norm1": {"scale": draw((3, D))}}
    layers = [{"moe": {leaf: draw(dims) for _, path, dims, leaf in CUTS
                       if path == PER_LAYER}} for _ in range(2)]
    return {"groups": {"b0": stacked}, "per_layer": layers}


@pytest.mark.timeout(300)
@pytest.mark.parametrize("i", range(len(CUTS)))
def test_placement_cuts_each_peer_the_references_slice(reference, cut_tree,
                                                       i):
    """``device_put_params``: every model peer's slice of an expert leaf
    is the block of experts the reference's sharding gives that peer
    (at every ``data`` coordinate), its own tensor, equal to the whole
    leaf's bits; leaves that are not cut stay whole."""
    shape, path, dims, leaf = CUTS[i]
    tree = ({"groups": cut_tree["groups"]} if path == STACKED
            else {"groups": {"b0": cut_tree["per_layer"]}})
    mesh = make_debug_mesh(shape, device="cpu")
    placed = dict(sh.leaves_with_path(sh.device_put_params(tree, mesh)))
    whole = dict(sh.leaves_with_path(tree))
    by_name = {sh.path_str(k, "str"): k for k in placed}
    key = by_name[path.format(leaf)]
    got = placed[key]
    assert isinstance(got, sh.PeerSlices) and got.shape == dims
    e_loc = dims[got.axis] // shape[1]
    cut = reference[f"cut{i}"]                    # data, model, dim, lo, hi
    for pe, part in enumerate(got.parts):
        lo = pe * e_loc
        rows = cut[(cut[:, 1] == pe) & (cut[:, 2] == got.axis)]
        assert len(rows) == shape[0]
        assert (rows[:, 3:] == [lo, lo + e_loc]).all(), rows
        assert torch.equal(part, whole[key].narrow(got.axis, lo, e_loc))
        assert part.data_ptr() != whole[key].data_ptr()
    assert torch.equal(got.whole(), whole[key])
    for k, t in placed.items():
        if not isinstance(t, sh.PeerSlices):
            assert t is whole[k]


def test_placed_tree_serves_like_the_whole_tree(granite_ep):
    """granite's smoke model on the EP path under a (1, 4) CPU mesh: the
    placed tree's prefill and decode logits and its greedy tokens equal
    the whole tree's bit for bit (a stacked leaf's layer is a
    ``PeerSlices`` of every peer's layer)."""
    from repro_torch.serve import SamplingConfig, generate
    _, cfg, _, params = granite_ep
    mesh = make_debug_mesh((1, 4), device="cpu")
    placed = sh.device_put_params(params, mesh)
    assert isinstance(placed["groups"]["b0"]["moe"]["experts_up"],
                      sh.PeerSlices)
    tok = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 7)))
    out = []
    with sh.use_mesh(mesh), torch.no_grad():
        for tree in (params, placed):
            logits, state = lm.prefill(tree, cfg, {"tokens": tok},
                                       max_seq=12)
            step, _ = lm.decode_step(tree, cfg, state, tok[:, :1])
            tokens, _ = generate(tree, cfg, {"tokens": tok},
                                 SamplingConfig(max_new_tokens=4))
            out.append((logits, step, tokens))
    for got, want in zip(*out):
        assert torch.equal(got, want)


def _reference_range(reference, i, pe, axis):
    """The ``[lo, hi)`` of ``axis`` that the reference's sharding of cut
    ``i`` gives ``model`` peer ``pe`` (the same at every ``data``
    coordinate)."""
    cut = reference[f"cut{i}"]                    # data, model, dim, lo, hi
    rows = cut[(cut[:, 1] == pe) & (cut[:, 2] == axis)]
    assert len(np.unique(rows[:, 3:], axis=0)) == 1, rows
    return int(rows[0, 3]), int(rows[0, 4])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("name", GRADIENT)
def test_ep_gradient_on_several_devices(reference, name, monkeypatch):
    """Training across cards: placed weights take a gradient on a mesh of
    several devices (the CPU mesh's entries stand for four devices
    through ``sharding.several``; each slice still on its peer's entry).
    Each slice's ``.grad`` of ``sum(y·R)`` is the reference's gradient
    cut at that peer's range (``devices_indices_map``), and dx and the
    router's gradient the reference's, within 1e-4·max + 1e-6."""
    mesh = make_debug_mesh((1, 4), device="cpu")
    _, placed, cfg, x = _placed(name, mesh)
    leaves = [placed["router"].requires_grad_(True), x.requires_grad_(True)]
    for key in EXPERTS:
        for part in placed[key].parts:
            leaves.append(part.requires_grad_(True))
    seen = []

    def several(mesh):
        seen.append(mesh)
        return True
    monkeypatch.setattr(sh, "several", several)
    r = torch.from_numpy(_cotangent(name))
    with sh.use_mesh(mesh):
        y = M.moe_layer(placed, cfg, x)
    assert seen
    (y * r).sum().backward()
    for key in EXPERTS:
        want = reference[f"{name}/lin_d{key}"]
        limit = 1e-4 * float(np.abs(want).max()) + 1e-6
        i = GRAD_CUTS[name, key]
        for pe, part in enumerate(placed[key].parts):
            assert part.grad is not None and part.grad.device == part.device
            lo, hi = _reference_range(reference, i, pe, placed[key].axis)
            assert part.shape[0] == hi - lo
            err = float(np.abs(part.grad.numpy() - want[lo:hi]).max())
            assert err <= limit, f"{name} d{key} peer {pe}: {err} > {limit}"
    for key, got in (("router", placed["router"].grad), ("x", x.grad)):
        want = reference[f"{name}/lin_d{key}"]
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()) + 1e-6, key


def test_ep_several_devices_with_data_above_1_raises(monkeypatch):
    """A mesh of several devices with a ``data`` axis of 2 raises,
    naming ROADMAP item 10.3 (the CPU's entries stand for other
    devices)."""
    mesh = make_debug_mesh((2, 4), device="cpu")
    _, placed, cfg, x = _placed("mesh24_cf8", mesh)
    monkeypatch.setattr(sh, "several", lambda mesh: True)
    with sh.use_mesh(mesh), \
            pytest.raises(NotImplementedError, match="queue A item 10"):
        M.moe_layer(placed, cfg, x)


@pytest.mark.parametrize("where", ["no_mesh", "another_mesh"])
def test_placed_weights_outside_their_mesh_raise(where):
    """Placed expert weights run only on the EP path of a mesh of their
    placement: with no mesh bound (the sort path) or under a mesh of
    another ``model`` size they raise ``ValueError``."""
    _, placed, cfg, x = _placed(
        "mesh14_cf8", make_debug_mesh((1, 4), device="cpu"))
    mesh = None if where == "no_mesh" else make_debug_mesh((1, 2),
                                                           device="cpu")
    with sh.use_mesh(mesh), pytest.raises(ValueError, match="placed"):
        M.moe_layer(placed, cfg, x)


def test_serving_steps_capture_only_on_one_card():
    """``engine.captured``: a decode step is captured on a card under no
    mesh or a mesh whose entries are all one card, and runs eagerly on a
    mesh of several cards (and on the CPU); ``mesh_devices`` counts
    ``"cuda"`` and ``"cuda:i"`` entries by the device they name."""
    from repro_torch.serve.engine import captured
    card = torch.device("cuda", 0)
    one = sh.Mesh([["cuda:0"] * 4], ("data", "model"))
    four = sh.Mesh([[f"cuda:{i}" for i in range(4)]], ("data", "model"))
    assert len(sh.mesh_devices(one)) == 1
    assert len(sh.mesh_devices(four)) == 4
    assert len(sh.mesh_devices(sh.Mesh([["cuda"] * 4],
                                       ("data", "model")))) == 1
    assert captured(card)
    for mesh, want in ((one, True), (four, False)):
        with sh.use_mesh(mesh):
            assert captured(card) is want
            assert not captured(torch.device("cpu"))
