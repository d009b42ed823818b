"""Port parity of the paper's accelerator model: ``core/maple.py``'s
statistics and event counters, ``core/energy.py`` and
``core/dataflows.py`` against ``repro`` on the CPU.

All of it is host numpy over CSR metadata with the reference's
arithmetic in the reference's order, so every field, event count, cycle
count, energy and area is held exactly (``np.array_equal`` / ``==``).
The Table-I clones are generated by both packages in this process
(``sparsity.generate`` seeds with ``hash()``, equal within a process)
and checked equal first.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import dataflows as RD
from repro.core import energy as RE
from repro.core import maple as RM
from repro.core import sparsity as RS
from repro.core.csr import CSR as RefCSR
from repro_torch.convert import csr_from_numpy
from repro_torch.core import dataflows as D
from repro_torch.core import energy as E
from repro_torch.core import maple as M
from repro_torch.core import sparsity as S

CLONE_SCALES = {ab: (0.02 if RS.TABLE_I[ab].n > 500_000 else 0.05)
                for ab in RS.TABLE_I}
STAT_FIELDS = [f.name for f in dataclasses.fields(M.SpGEMMStats)]


def _port_csr(ref):
    return csr_from_numpy(np.asarray(ref.value), np.asarray(ref.col_id),
                          np.asarray(ref.row_ptr), ref.shape, device="cpu")


@pytest.fixture(scope="module")
def clones():
    """Every Table-I clone from both packages (scale 0.02 for the three
    largest, 0.05 for the rest)."""
    out = {}
    for ab, spec in RS.TABLE_I.items():
        ref = RS.generate(spec, scale=CLONE_SCALES[ab], seed=0)
        port = S.generate(S.TABLE_I[ab], scale=CLONE_SCALES[ab], seed=0,
                          device="cpu")
        out[ab] = (ref, port)
    return out


def _golden(kind, m=40, k=32, n=24, seed=0):
    rng = np.random.default_rng(seed)
    am = RS.element_pattern_mask(kind, rng, m, k)
    bm = RS.element_pattern_mask(kind, rng, k, n)
    ad = (am * rng.standard_normal(am.shape)).astype(np.float32)
    bd = (bm * rng.standard_normal(bm.shape)).astype(np.float32)
    return ad, bd


def assert_stats_equal(got, want):
    for name in STAT_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and np.array_equal(g, w), name
        else:
            assert type(g) is type(w) and g == w, name
    assert got.avg_b_row_len == want.avg_b_row_len
    assert got.compaction == want.compaction


def test_clones_are_the_references(clones):
    for ab, (ref, port) in clones.items():
        assert port.shape == ref.shape, ab
        assert np.array_equal(port.row_ptr, np.asarray(ref.row_ptr)), ab
        assert np.array_equal(port.col_id, np.asarray(ref.col_id)), ab
        assert np.array_equal(port.value.numpy(), np.asarray(ref.value)), ab


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("ab", list(RS.TABLE_I))
def test_analyze_spgemm_on_table_i_clones(clones, ab, exact):
    ref, port = clones[ab]
    assert_stats_equal(M.analyze_spgemm(port, exact_output=exact),
                       RM.analyze_spgemm(ref, exact_output=exact))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("kind", ["uniform", "power_law", "banded"])
def test_analyze_spgemm_on_golden_patterns_with_b_not_a(kind, exact):
    ad, bd = _golden(kind)
    ra, rb = RefCSR.from_dense(ad, nnz_max=int((ad != 0).sum()) + 7), \
        RefCSR.from_dense(bd)
    assert_stats_equal(M.analyze_spgemm(_port_csr(ra), _port_csr(rb),
                                        exact_output=exact),
                       RM.analyze_spgemm(ra, rb, exact_output=exact))
    sq, _ = _golden(kind, m=32, k=32, seed=1)         # B = A (b=None)
    rsq = RefCSR.from_dense(sq)
    assert_stats_equal(M.analyze_spgemm(_port_csr(rsq), exact_output=exact),
                       RM.analyze_spgemm(rsq, exact_output=exact))


@pytest.mark.parametrize("exact", [True, False])
def test_analyze_spgemm_on_an_empty_matrix(exact):
    ra = RefCSR.from_dense(np.zeros((6, 6), np.float32), nnz_max=4)
    got = M.analyze_spgemm(_port_csr(ra), exact_output=exact)
    assert got.partial_products == 0 and got.nnz_c == 0
    assert got.avg_b_row_len == 0.0 and got.compaction == 0.0
    assert_stats_equal(got, RM.analyze_spgemm(ra, exact_output=exact))
    for cfg in D.ALL_CONFIGS:
        r, w = D.simulate(cfg(), got), RD.simulate(
            getattr(RD, cfg.__name__)(), RM.analyze_spgemm(ra))
        assert list(r.events.items()) == list(w.events.items())
        assert r.events["mac"] == 0.0
        assert r.cycles == w.cycles and r.bottleneck == w.bottleneck


# --------------------------------------------------------------------------
# event counters and energy / area
# --------------------------------------------------------------------------

def test_event_counts_behave_as_the_reference():
    assert M.EVENT_KINDS == RM.EVENT_KINDS
    got = M.EventCounts(mac=3, l2_access=2.5)
    want = RM.EventCounts(mac=3, l2_access=2.5)
    assert list(got.items()) == list(want.items())
    assert all(type(v) is float for v in got.values())
    other = dict(mac=1.25, merge_op=4, pe_transfer=0.5)
    assert list((got + M.EventCounts(**other)).items()) == \
        list((want + RM.EventCounts(**other)).items())
    assert list(got.scaled(0.3).items()) == list(want.scaled(0.3).items())
    with pytest.raises(KeyError):
        M.EventCounts(dram=1)
    with pytest.raises(KeyError):
        RM.EventCounts(dram=1)


def test_energy_and_area_constants_are_equal():
    assert E.ENERGY_PER_EVENT == RE.ENERGY_PER_EVENT
    assert list(E.ENERGY_PER_EVENT) == list(RE.ENERGY_PER_EVENT)
    for name in ("MAC_MM2", "ADDER_MM2", "CTRL_MM2", "SRAM_FIXED_MM2",
                 "SRAM_MM2_PER_KB", "SORT_QUEUE_FACTOR", "RF_MM2_PER_KB"):
        assert getattr(E, name) == getattr(RE, name), name
    for kb in (-1.0, 0.0, 0.5, 1.0, 4.5, 18.0, 53.0):
        assert E.sram_mm2(kb) == RE.sram_mm2(kb)
        assert E.sorting_queue_mm2(kb) == RE.sorting_queue_mm2(kb)
        assert E.regfile_mm2(kb) == RE.regfile_mm2(kb)
    pe, ref_pe = E.PEArea("x", 0.125, 0.03), RE.PEArea("x", 0.125, 0.03)
    assert pe.total_mm2 == ref_pe.total_mm2
    assert E.pe_array_area(pe, 128) == RE.pe_array_area(ref_pe, 128)
    ev = dict(mac=7.0, merge_op=3.0, cd_op=11.0, l0_access=1e6,
              l1_access=3.3e5, l2_access=1.7e4)
    assert E.energy_of(M.EventCounts(**ev)) == \
        RE.energy_of(RM.EventCounts(**ev))
    assert E.energy_breakdown(M.EventCounts(**ev)) == \
        RE.energy_breakdown(RM.EventCounts(**ev))


def test_matraptor_merge_passes_equal_reference(clones):
    for ab in ("wg", "of", "fb"):
        ref, port = clones[ab]
        got_st, want_st = M.analyze_spgemm(port), RM.analyze_spgemm(ref)
        for q in (0, 1, 2, 12, 64):
            got = M.matraptor_merge_passes(got_st, q)
            want = RM.matraptor_merge_passes(want_st, q)
            assert got.dtype == want.dtype and np.array_equal(got, want)


# --------------------------------------------------------------------------
# the four §IV configurations, simulate and compare
# --------------------------------------------------------------------------

def test_configs_equal_reference():
    assert [f.__name__ for f in D.ALL_CONFIGS] == \
        [f.__name__ for f in RD.ALL_CONFIGS]
    for mk, ref_mk in zip(D.ALL_CONFIGS, RD.ALL_CONFIGS):
        got, want = mk(), ref_mk()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.total_macs == want.total_macs
        area, ref_area = D._area_of(got), RD._area_of(want)
        assert (area.name, area.buffers_mm2, area.logic_mm2) == \
            (ref_area.name, ref_area.buffers_mm2, ref_area.logic_mm2)
    assert D.WORD_BYTES == RD.WORD_BYTES


def _assert_sim_equal(got, want):
    assert dataclasses.asdict(got.config) == dataclasses.asdict(want.config)
    assert list(got.events.items()) == list(want.events.items())
    assert got.cycles == want.cycles
    assert got.energy == want.energy
    assert (got.pe_area.name, got.pe_area.buffers_mm2,
            got.pe_area.logic_mm2) == (want.pe_area.name,
                                       want.pe_area.buffers_mm2,
                                       want.pe_area.logic_mm2)
    assert got.array_area_mm2 == want.array_area_mm2
    assert got.bottleneck == want.bottleneck


@pytest.mark.parametrize("ab", ["wg", "pg", "of", "cg", "p3", "fb"])
def test_simulate_four_configs_equals_reference(clones, ab):
    ref, port = clones[ab]
    got_st, want_st = M.analyze_spgemm(port), RM.analyze_spgemm(ref)
    for mk, ref_mk in zip(D.ALL_CONFIGS, RD.ALL_CONFIGS):
        _assert_sim_equal(D.simulate(mk(), got_st),
                          RD.simulate(ref_mk(), want_st))


@pytest.mark.parametrize("family", ["matraptor", "extensor"])
@pytest.mark.parametrize("ab", list(RS.TABLE_I))
def test_compare_equals_reference(clones, ab, family):
    ref, port = clones[ab]
    got = D.compare(family, M.analyze_spgemm(port))
    want = RD.compare(family, RM.analyze_spgemm(ref))
    for name in ("family", "energy_benefit_pct", "onchip_energy_benefit_pct",
                 "speedup_pct", "area_ratio"):
        assert getattr(got, name) == getattr(want, name), name
    _assert_sim_equal(got.baseline, want.baseline)
    _assert_sim_equal(got.maple, want.maple)
    assert D._onchip_energy(got.maple) == RD._onchip_energy(want.maple)


def test_compare_refuses_an_unknown_family(clones):
    st = M.analyze_spgemm(clones["pg"][1])
    with pytest.raises(ValueError, match="tpu"):
        D.compare("tpu", st)
