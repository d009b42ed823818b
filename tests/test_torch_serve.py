"""Port parity: the serving slice of ``repro_torch`` against ``repro``.

The qwen3-4b smoke config with a block-sparse MLP (8×8 blocks) is
initialised by the reference, carried across with ``repro_torch.convert``
and run by both packages on the CPU.  Logits agree within 1e-4 (the
repo's f32 tolerance: the two sum in different orders); greedy tokens are
equal.  Sampled decoding cannot match ``jax.random``; it is held on
determinism within the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.csr import BlockCSR as RefBlockCSR
from repro.models import lm as ref_lm
from repro.models.layers import init_sparse_linear as ref_init_sparse_linear
from repro.serve import engine as ref_engine
from repro_torch.configs import get_smoke_config
from repro_torch.convert import block_csr_from_numpy, params_from_numpy
from repro_torch.kernels import (maple_spmm_compact, maple_spmm_naive,
                                 maple_spmm_planned)
from repro_torch.models import lm
from repro_torch.serve import (SamplingConfig, SparseLogitHead,
                               complete_static, generate)

TOL = dict(rtol=1e-4, atol=1e-4)


def flatten_ref(tree):
    """The reference pytree as nested dicts of numpy (BlockCSR → dict)."""
    if isinstance(tree, RefBlockCSR):
        return {"blocks": np.asarray(tree.blocks),
                "block_col": np.asarray(tree.block_col),
                "block_row": np.asarray(tree.block_row),
                "row_ptr": np.asarray(tree.row_ptr),
                "shape": tree.shape, "block_shape": tree.block_shape}
    if isinstance(tree, dict):
        return {k: flatten_ref(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def models():
    sparse = dict(sparse_mlp=True, sparse_block=(8, 8))
    cfg_ref = dataclasses.replace(ref_smoke_config("qwen3-4b"), **sparse)
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), **sparse)
    params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(0))
    params = params_from_numpy(flatten_ref(params_ref), cfg, device="cpu")
    w_ref = ref_init_sparse_linear(jax.random.PRNGKey(7), cfg.d_model,
                                   cfg.vocab_padded, block_shape=(8, 8),
                                   block_density=0.5)
    head_ref = ref_engine.SparseLogitHead.build(w_ref)
    head = SparseLogitHead.build(block_csr_from_numpy(flatten_ref(w_ref),
                                                      device="cpu"))
    return cfg_ref, cfg, params_ref, params, head_ref, head


def _prompts(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


def test_converted_params_keep_the_stacked_layout(models):
    cfg_ref, cfg, params_ref, params, _, _ = models
    w = params["groups"]["b0"]["mlp"]["w_down"]
    assert w.blocks.shape[0] == cfg.n_layers and w.stacked
    ref_w = params_ref["groups"]["b0"]["mlp"]["w_down"]
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(
            w.layer(i).to_dense().numpy(),
            np.asarray(jax.tree_util.tree_map(lambda a: a[i],
                                              ref_w).to_dense()))
    assert params["groups"]["b0"]["attn"]["wq"].shape == \
        params_ref["groups"]["b0"]["attn"]["wq"].shape


def test_prefill_and_teacher_forced_decode_match_reference(models):
    cfg_ref, cfg, params_ref, params, _, _ = models
    prompts = _prompts(0, 2, 9, cfg.vocab_size)
    max_seq = 9 + 4
    ref_logits, ref_state = ref_engine.jitted_prefill(cfg_ref, max_seq)(
        params_ref, batch={"tokens": jnp.asarray(prompts, jnp.int32)})
    logits, state = lm.prefill(params, cfg,
                               {"tokens": torch.from_numpy(prompts)},
                               max_seq=max_seq)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    step_ref = ref_engine.jitted_decode_step(cfg_ref)
    forced = _prompts(1, 2, 4, cfg.vocab_size)
    for t in range(4):
        tok = forced[:, t:t + 1]
        ref_logits, ref_state = step_ref(params_ref, state=ref_state,
                                         tokens=jnp.asarray(tok, jnp.int32))
        logits, state = lm.decode_step(params, cfg, state,
                                       torch.from_numpy(tok))
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                                   err_msg=f"decode step {t}", **TOL)
    assert state["pos"] == int(ref_state["pos"]) == max_seq


def test_generate_greedy_tokens_match_reference(models):
    cfg_ref, cfg, params_ref, params, _, _ = models
    prompts = _prompts(2, 3, 8, cfg.vocab_size)
    sampling = SamplingConfig(max_new_tokens=6)
    ref_tokens, ref_ent = ref_engine.generate(
        params_ref, cfg_ref, {"tokens": jnp.asarray(prompts, jnp.int32)},
        ref_engine.SamplingConfig(max_new_tokens=6))
    calls = maple_spmm_naive.launches
    tokens, ent = generate(params, cfg, {"tokens": torch.from_numpy(prompts)},
                           sampling)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))
    np.testing.assert_allclose(ent, ref_ent, **TOL)
    assert maple_spmm_naive.launches == calls     # CPU: plain versions only


@pytest.mark.parametrize("use_head", [False, True])
def test_complete_static_greedy_tokens_match_reference(models, use_head):
    cfg_ref, cfg, params_ref, params, head_ref, head = models
    prompt = _prompts(3, 1, 7, cfg.vocab_size)[0]
    ref_new, ref_reason, _ = ref_engine.complete_static(
        params_ref, cfg_ref, prompt, 5,
        sampling=ref_engine.SamplingConfig(), key=jax.random.PRNGKey(0),
        head=head_ref if use_head else None)
    new, reason, _ = complete_static(params, cfg, prompt, 5,
                                     sampling=SamplingConfig(),
                                     head=head if use_head else None)
    assert new == ref_new and reason == ref_reason == "length"


@pytest.fixture(scope="module")
def dense_models():
    cfg_ref, cfg = ref_smoke_config("qwen3-4b"), get_smoke_config("qwen3-4b")
    params_ref = ref_lm.init_params(cfg_ref, jax.random.PRNGKey(0))
    return cfg_ref, cfg, params_ref, params_from_numpy(
        flatten_ref(params_ref), cfg, device="cpu")


@pytest.mark.parametrize("where", ["sampling", "keyword"])
def test_complete_static_ends_at_its_eos_keyword_like_the_reference(
        dense_models, where):
    """The request ends at the ``eos_id`` keyword; ``sampling.eos_id`` is
    not read (qwen3-4b smoke, prompt seed 3, whose first greedy token is
    489)."""
    cfg_ref, cfg, params_ref, params = dense_models
    prompt = _prompts(3, 1, 7, cfg.vocab_size)[0]
    if where == "sampling":
        ref_kw = dict(sampling=ref_engine.SamplingConfig(eos_id=489))
        kw = dict(sampling=SamplingConfig(eos_id=489))
    else:
        ref_kw = dict(sampling=ref_engine.SamplingConfig(), eos_id=489)
        kw = dict(sampling=SamplingConfig(), eos_id=489)
    ref_new, ref_reason, _ = ref_engine.complete_static(
        params_ref, cfg_ref, prompt, 5, key=jax.random.PRNGKey(0), **ref_kw)
    new, reason, _ = complete_static(params, cfg, prompt, 5, **kw)
    assert (new, reason) == (ref_new, ref_reason)
    if where == "sampling":
        assert len(new) == 5 and reason == "length"
    else:
        assert (new, reason) == ([489], "eos")


def test_generate_takes_max_seq_like_the_reference(models):
    cfg_ref, cfg, params_ref, params, _, _ = models
    prompts = _prompts(4, 2, 6, cfg.vocab_size)
    ref_tokens, _ = ref_engine.generate(
        params_ref, cfg_ref, {"tokens": jnp.asarray(prompts, jnp.int32)},
        ref_engine.SamplingConfig(max_new_tokens=4), max_seq=16)
    tokens, _ = generate(params, cfg, {"tokens": torch.from_numpy(prompts)},
                         SamplingConfig(max_new_tokens=4), max_seq=16)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(ref_tokens))


def test_prefill_cache_dtype_and_remat_match_reference(models):
    """The KV cache takes ``cache_dtype``; decode over a bf16 cache gives
    the reference's logits (both round the same f32 K/V once)."""
    cfg_ref, cfg, params_ref, params, _, _ = models
    prompts = _prompts(5, 2, 7, cfg.vocab_size)
    ref_logits, ref_state = ref_lm.prefill(
        params_ref, cfg_ref, {"tokens": jnp.asarray(prompts, jnp.int32)},
        max_seq=9, cache_dtype=jnp.bfloat16, remat=False)
    logits, state = lm.prefill(params, cfg, {"tokens": torch.from_numpy(
        prompts)}, max_seq=9, cache_dtype=torch.bfloat16, remat=False)
    assert state["groups"]["b0"]["k"].dtype == torch.bfloat16
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)
    tok = _prompts(6, 2, 1, cfg.vocab_size)
    ref_logits, _ = ref_lm.decode_step(params_ref, cfg_ref, ref_state,
                                       jnp.asarray(tok, jnp.int32))
    logits, _ = lm.decode_step(params, cfg, state, torch.from_numpy(tok))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), **TOL)


def test_sparse_head_logits_match_reference(models):
    _, cfg, _, _, head_ref, head = models
    hidden = np.random.default_rng(4).standard_normal(
        (2, 3, cfg.d_model)).astype(np.float32)
    np.testing.assert_allclose(head(torch.from_numpy(hidden)).numpy(),
                               np.asarray(head_ref(jnp.asarray(hidden))),
                               **TOL)
    assert head.plan.fused == head_ref.plan.fused
    assert head.predicted_cycles == head_ref.predicted_cycles


def test_sampled_decoding_is_deterministic_per_generator_seed(models):
    _, cfg, _, params, _, head = models
    prompts = torch.from_numpy(_prompts(5, 2, 6, cfg.vocab_size))
    sampling = SamplingConfig(temperature=0.8, top_k=20, max_new_tokens=5)
    runs = [generate(params, cfg, {"tokens": prompts}, sampling,
                     torch.Generator().manual_seed(11))[0]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    other = generate(params, cfg, {"tokens": prompts}, sampling,
                     torch.Generator().manual_seed(12))[0]
    assert other.shape == runs[0].shape
    singles = [complete_static(params, cfg, prompts[0].numpy(), 4,
                               sampling=sampling, head=head,
                               generator=torch.Generator().manual_seed(3))[0]
               for _ in range(2)]
    assert singles[0] == singles[1]


def test_entry_points_refuse_a_missing_cuda_device(models):
    _, cfg, _, _, _, _ = models
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="cuda"):
        lm.init_decode_state(cfg, 1, 4)


def test_planned_head_launch_counter_stays_zero_on_cpu(models):
    """The default head's plan carries the rmw layout, so a call goes
    through ``maple_spmm_planned``: on the CPU it runs the plain version
    and neither planned kernel counts a launch."""
    _, cfg, _, _, _, head = models
    assert head.plan.fused == "rmw"
    before = (maple_spmm_compact.launches, maple_spmm_planned.launches)
    head(torch.zeros((1, 1, cfg.d_model)))
    assert (maple_spmm_compact.launches,
            maple_spmm_planned.launches) == before


def test_serve_cli_runs_on_cpu_and_refuses_checkpoints(capsys, tmp_path):
    """The serving CLI on random weights, then with ``--ckpt-dir`` on a
    training checkpoint: the trainer's parameters are served (its
    per-layer layout loaded, then stacked) and give ``generate``'s greedy
    tokens on them; another model's checkpoint is refused."""
    from repro_torch.launch.serve import main
    from repro_torch.launch.train import main as train_main
    args = ["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
            "--batch", "2", "--prompt-len", "5", "--max-new", "3"]
    tokens = main(args)
    assert tokens.shape == (2, 3) and "on cpu" in capsys.readouterr().out
    run = train_main(["--arch", "qwen3-4b", "--smoke", "--device", "cpu",
                      "--steps", "2", "--ckpt-dir", str(tmp_path)])
    served = main([*args, "--ckpt-dir", str(tmp_path)])
    cfg = run.cfg
    gen = torch.Generator().manual_seed(0)
    lm.init_params(cfg, gen, device="cpu")       # the CLI's draws, in order
    prompts = torch.randint(0, cfg.vocab_size, (2, 5), generator=gen)
    with torch.no_grad():
        want, _ = generate(lm.stack_layers(run.params), cfg,
                           {"tokens": prompts},
                           SamplingConfig(max_new_tokens=3), gen)
    assert torch.equal(served, want) and not torch.equal(served, tokens)
    with pytest.raises(KeyError, match="missing leaf"):
        main(["--arch", "qwen2-7b", "--smoke", "--device", "cpu",
              "--ckpt-dir", str(tmp_path)])


def test_unported_families_and_converter_misuse_raise():
    cfg = get_smoke_config("qwen3-4b")
    with pytest.raises(NotImplementedError, match="not ported"):
        lm.init_params(dataclasses.replace(cfg, family="ssm"),
                       torch.Generator(), device="cpu")
    w = {"blocks": np.zeros((2, 3, 8, 8), np.float32),
         "block_col": np.array([[0, 1, -1], [1, 0, -1]], np.int32),
         "block_row": np.array([[0, 1, 1], [0, 1, 1]], np.int32),
         "row_ptr": np.array([[0, 1, 2], [0, 1, 2]], np.int32),
         "shape": (16, 16), "block_shape": (8, 8)}
    with pytest.raises(ValueError, match="disagree"):
        block_csr_from_numpy(w, device="cpu")
    w["block_col"] = np.array([[0, 1, -1], [0, 1, -1]], np.int32)
    stacked = block_csr_from_numpy(w, device="cpu")
    assert stacked.stacked and stacked.block_col.tolist() == [0, 1, -1]
    with pytest.raises(ValueError, match="lm_head"):
        params_from_numpy({"embed_tokens": np.zeros((4, 2)), "groups": {},
                           "final_norm": {}}, cfg, device="cpu")


def test_port_init_serves_finite_logits():
    cfg = dataclasses.replace(get_smoke_config("qwen3-4b"), sparse_mlp=True,
                              sparse_block=(8, 8))
    params = lm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    w = params["groups"]["b0"]["mlp"]["w_down"]
    assert w.blocks.shape[:1] == (cfg.n_layers,)
    assert (np.diff(w.row_ptr) > 0).all()     # no dead output channel
    w.layer(0).check_pad_contract()
    prompts = torch.from_numpy(_prompts(6, 2, 5, cfg.vocab_size))
    logits, state = lm.prefill(params, cfg, {"tokens": prompts}, max_seq=8)
    assert logits.shape == (2, 1, cfg.vocab_padded)
    assert torch.isfinite(logits).all() and state["pos"] == 5
