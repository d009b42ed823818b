"""Port parity of the paper-tables entry point
(``repro_torch.launch.paper_tables``) against the reference bench
(``benchmarks/paper_tables.py``) on the CPU: the printed text (CSV
header and rows, the two ``MEAN_*`` lines, the assumption lines) equal
line for line, and every row's numbers equal.  Both run in this process,
so the Table-I clones (``sparsity.generate`` seeds with ``hash()``) are
the same matrices.
"""

import importlib.util
from pathlib import Path

import pytest

from repro_torch.launch import paper_tables

BENCH = Path(__file__).resolve().parents[1] / "benchmarks/paper_tables.py"


def _bench():
    spec = importlib.util.spec_from_file_location("paper_tables_bench",
                                                  BENCH)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_printed_tables_equal_the_reference_line_for_line(capsys):
    want_rows = _bench().run(scale=0.05)
    want = capsys.readouterr().out
    rows = paper_tables.run(scale=0.05, device="cpu")
    got = capsys.readouterr().out
    assert got.splitlines() == want.splitlines()
    assert len(got.splitlines()) == 2 + 14 + 2 + 3 + 4
    assert [r["matrix"] for r in rows] == [r["matrix"] for r in want_rows]
    for r, w in zip(rows, want_rows):
        for key in ("n", "nnz", "P", "nnz_C"):
            assert r[key] == w[key], (r["matrix"], key)
        for fam in ("matraptor", "extensor"):
            for name in ("energy_benefit_pct", "onchip_energy_benefit_pct",
                         "speedup_pct", "area_ratio"):
                assert getattr(r[fam], name) == getattr(w[fam], name)
        assert r["generate_s"] >= 0 and r["analyze_s"] >= 0
    assert paper_tables.PAPER == _bench().PAPER
    mr = paper_tables.means(rows, "matraptor")
    assert f"MEAN_MR,,,,,{mr[0]:.1f},{mr[1]:.1f},{mr[2]:.1f},{mr[3]:.1f}" \
        in got


def test_entry_point_runs_on_the_cpu(capsys):
    rows = paper_tables.main(["--scale", "0.01", "--seed", "3",
                              "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("# paper_tables: Fig.8/Fig.9 reproduction "
                          "(Table-I clones @ scale=0.01)")
    assert len(rows) == 14 and "MEAN_EX,,,,," in out
    want_rows = _bench().run(scale=0.01, seed=3, csv=False)
    assert [r["P"] for r in rows] == [r["P"] for r in want_rows]


def test_default_device_is_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        paper_tables.run(scale=0.01, csv=False)
