"""Port parity of two of the reference's examples on the CPU:
``repro_torch.examples.quickstart`` against ``examples/quickstart.py`` and
``repro_torch.examples.accelerator_sim`` against
``examples/accelerator_sim.py``.

* Layer A's text equals the reference's line for line.
* Layer B draws the same numpy operands, moves the same blocks and is
  within 1e-4 of the dense product.
* Layer C from the reference's ``PRNGKey(0)`` weights, carried across:
  each loss within 1e-4 relative of the reference's jitted steps, the
  greedy tokens equal.
* ``accelerator_sim`` at scale 0.02 with ``--events --spgemm`` prints the
  reference's text line for line, apart from the ``max|dC|=`` field (a
  float error: at most 1e-5 on both).  Both run in this process, so the
  Table-I clones (``sparsity.generate`` seeds with ``hash()``) are the
  same matrices.
* Every example's ``main`` defaults to the card and raises without one.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke_config
from repro.data import DataConfig as RefDataConfig
from repro.data import synth_batch as ref_synth_batch
from repro.models import lm as ref_lm
from repro.serve import SamplingConfig as RefSamplingConfig
from repro.serve import generate as ref_generate
from repro.train import OptimizerConfig as RefOptimizerConfig
from repro.train import init_opt_state as ref_init_opt_state
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_numpy
from repro_torch.examples import (accelerator_sim, quickstart, serve_lm,
                                  train_lm)
from test_torch_train import flatten_ref

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SIM_ARGV = ["--scale", "0.02", "--events", "--spgemm"]
DC = re.compile(r"max\|dC\|=(\S+)")


def printed(lines):
    """``say``'s lines as the printed text's lines (a line may begin with
    a blank one)."""
    return "\n".join(lines).splitlines()


def reference_example(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(f"reference_{name}",
                                                  EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_layer_a_text_equals_the_reference(capsys):
    reference_example("quickstart").layer_a()
    want = capsys.readouterr().out
    got = quickstart.layer_a("cpu")
    assert capsys.readouterr().out == want
    assert printed(got["lines"]) == want.splitlines()
    assert len(got["lines"]) == 4


def test_layer_b_moves_the_reference_blocks(capsys):
    reference_example("quickstart").layer_b()
    want = capsys.readouterr().out.splitlines()
    got = quickstart.layer_b("cpu")
    lines = printed(got["lines"])
    assert capsys.readouterr().out.splitlines() == lines
    strip = lambda line: line.split(", max|err|")[0]
    assert [strip(x) for x in lines[2:]] == [strip(x) for x in want[2:]]
    assert len(lines) == len(want) == 3
    assert got["blocks"] == 5
    assert got["err"] <= 1e-4
    assert tuple(got["out"].shape) == (256, 128)


def test_layer_c_follows_the_reference_jitted_steps():
    """The reference's layer C (``jax.jit(make_train_step(...))``, 3
    steps, then ``generate``) on its ``PRNGKey(0)`` weights, and the
    port's on the same weights."""
    cfg = ref_smoke_config("qwen3-4b")
    params = ref_lm.init_params(cfg, jax.random.PRNGKey(0))
    got = quickstart.layer_c("cpu", params=params_from_numpy(
        flatten_ref(params), get_smoke_config("qwen3-4b"), device="cpu"))
    ocfg = RefOptimizerConfig(peak_lr=3e-3, warmup_steps=1, total_steps=10)
    opt = ref_init_opt_state(ocfg, params)
    dcfg = RefDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                         global_batch=4)
    step = jax.jit(ref_make_train_step(cfg, ocfg, micro_batches=2))
    losses = []
    for s in range(3):
        params, opt, m = step(params, opt, ref_synth_batch(dcfg, s))
        losses.append(float(m["loss"]))
    toks, _ = ref_generate(params, cfg,
                           {"tokens": jnp.ones((1, 8), jnp.int32)},
                           RefSamplingConfig(max_new_tokens=8))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    assert got["tokens"] == np.asarray(toks)[0].tolist()
    assert got["step_fn"].__name__ == "train_step"       # eager on the CPU


def test_accelerator_sim_prints_the_reference_text(capsys, monkeypatch):
    monkeypatch.setattr("sys.argv", ["accelerator_sim.py", *SIM_ARGV])
    reference_example("accelerator_sim").main()
    want = capsys.readouterr().out.splitlines()
    got = accelerator_sim.main([*SIM_ARGV, "--device", "cpu"])
    lines = printed(got["lines"])
    assert capsys.readouterr().out.splitlines() == lines
    assert len(lines) == len(want)
    errors = []
    for g, w in zip(lines, want):
        assert DC.sub("", g) == DC.sub("", w)
        errors += [float(m) for line in (g, w) for m in DC.findall(line)]
    assert len(errors) == 6 and max(errors) <= 1e-5
    assert [r["kind"] for r in got["sweep"]] == ["uniform", "power_law",
                                                 "banded"]
    assert sorted(got["matrices"]) == ["fb", "sc", "wg"]


@pytest.mark.parametrize("module", [quickstart, accelerator_sim, serve_lm,
                                    train_lm],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_the_default_device_is_the_card(module, monkeypatch):
    """No flag means ``cuda``: without a card the example raises before it
    computes anything (never a silent CPU run)."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        module.main([])
