"""Port parity for the two-phase SpGEMM path: the containers and sorted-CSR
utilities, the Table-I generators, the symbolic phase (``plan_spgemm``)
exactly equal to the reference's, and the numeric kernels' wrappers (on
the CPU, so through their plain versions) against the reference's Pallas
kernels in interpret mode at rtol = atol = 1e-5 (f32; only the order of
summation may differ).

Operands are made in numpy from a seed and carried into both packages
(``convert.csr_from_numpy``).  ``sparsity.generate`` seeds its rng with
``hash(spec.abbrev)``, which Python salts per process, so the two
packages agree only within one process, as here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import csr as ref_csr
from repro.core import formats as ref_formats
from repro.core import sparsity as ref_sparsity
from repro.core.csr import CSR as RefCSR
from repro.core.maple import analyze_spgemm as ref_analyze
from repro.kernels import maple_spgemm as ref_maple_spgemm
from repro.kernels import ops as ref_ops
from repro.kernels.maple_sddmm import maple_sddmm_csr_pallas
from repro.kernels.maple_spgemm import maple_spgemm_pallas
from repro.kernels.maple_spmspm import maple_spmspm_pallas
from repro.kernels.schedule import plan_spgemm as ref_plan_spgemm
from repro_torch.convert import csr_from_numpy
from repro_torch.core import csr, formats, sparsity
from repro_torch.core.csr import CSR, BlockCSR
from repro_torch.core.maple import analyze_spgemm
from repro_torch.kernels import (ExecutionPlan, SpgemmPlan, csr_to_ell,
                                 maple_spgemm, maple_spmspm, plan_spgemm)
from repro_torch.kernels.maple_sddmm import maple_sddmm_csr
from repro_torch.kernels.maple_spgemm import (maple_spgemm_numeric,
                                              maple_spgemm_numeric_plain)
from repro_torch.kernels.maple_spmspm import maple_spmspm_ell
from repro_torch.kernels.ops import _spgemm_compaction_maps
from repro_torch.kernels.schedule import SPGEMM_ROW_WINDOW

TOL = dict(rtol=1e-5, atol=1e-5)
KINDS = ("uniform", "power_law", "banded")
PLAN_ARRAYS = ("order", "step_row", "step_col", "written", "out_row_ptr",
               "out_cols", "row_upper", "scatter_pos", "a_gather", "a_live",
               "b_gather", "b_live", "lane_work")
PLAN_SCALARS = ("la", "lb", "lc", "chunk", "n_rows", "n_real_steps",
                "shape_a", "shape_b", "nnz_c", "n_lanes", "steps",
                "utilization")
STATS_SCALARS = ("n_rows", "n_cols", "nnz_a", "nnz_b", "partial_products",
                 "nnz_c")
STATS_ARRAYS = ("a_row_len", "b_row_len", "row_partials", "row_fibers",
                "b_row_refs")


def port(ref: RefCSR) -> CSR:
    return csr_from_numpy(np.asarray(ref.value), np.asarray(ref.col_id),
                          np.asarray(ref.row_ptr), ref.shape, device="cpu")


def pair(d, pad=0):
    """The same padded CSR in both packages."""
    ref = RefCSR.from_dense(d, nnz_max=max(int((d != 0).sum()), 1) + pad)
    return ref, port(ref)


def rand_dense(rng, m, n, density=None, mask=None):
    if mask is None:
        mask = rng.random((m, n)) < density
    return (mask * rng.standard_normal(mask.shape)).astype(np.float32)


def golden(kind, seed=0, shape=(24, 20, 28)):
    """A and B from the reference's element-pattern goldens (the masks
    the benchmarks share), with pads past nnz."""
    rng = np.random.default_rng(seed)
    m, k, n = shape
    ad = rand_dense(rng, m, k,
                    mask=ref_sparsity.element_pattern_mask(kind, rng, m, k))
    bd = rand_dense(rng, k, n,
                    mask=ref_sparsity.element_pattern_mask(kind, rng, k, n))
    return ad, bd, pair(ad, pad=3), pair(bd, pad=2)


def assert_plans_equal(got, want):
    for f in PLAN_ARRAYS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    for f in PLAN_SCALARS:
        assert getattr(got, f) == getattr(want, f), f
    for f in STATS_SCALARS:
        assert getattr(got.stats, f) == getattr(want.stats, f), f
    for f in STATS_ARRAYS:
        assert np.array_equal(getattr(got.stats, f),
                              getattr(want.stats, f)), f
    assert got.predicted_cycles() == want.predicted_cycles()


# --------------------------------------------------------------------------
# symbolic phase: every plan array and scalar exactly the reference's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("balance", ["work", "fibers", "none"])
@pytest.mark.parametrize("n_lanes", [1, 3, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_plan_spgemm_equals_reference(kind, n_lanes, balance):
    _, _, (ra, a), (rb, b) = golden(kind, seed=KINDS.index(kind))
    got = plan_spgemm(a, b, n_lanes=n_lanes, balance=balance)
    assert isinstance(got, SpgemmPlan) and isinstance(got, ExecutionPlan)
    assert_plans_equal(got, ref_plan_spgemm(ra, rb, n_lanes=n_lanes,
                                            balance=balance))


def test_plan_spgemm_of_blocked_operands_equals_reference():
    rng = np.random.default_rng(4)
    d = rng.standard_normal((16, 24)).astype(np.float32)
    d[:8, 8:] = 0.0
    d[3, 1] = 0.0                         # explicit zero inside a live block
    ra = ref_csr.BlockCSR.from_dense(d, (8, 8), n_blocks_max=6)
    a = BlockCSR.from_dense(d, (8, 8), n_blocks_max=6, device="cpu")
    rb, b = pair(rand_dense(rng, 24, 10, 0.3), pad=1)
    want_e = ref_formats.as_element_csr(ra)
    got_e = formats.as_element_csr(a)
    assert np.array_equal(got_e.col_id, np.asarray(want_e.col_id))
    assert np.array_equal(got_e.row_ptr, np.asarray(want_e.row_ptr))
    assert np.array_equal(got_e.value.numpy(), np.asarray(want_e.value))
    assert_plans_equal(plan_spgemm(a, b, n_lanes=3),
                       ref_plan_spgemm(ra, rb, n_lanes=3))
    with pytest.raises(TypeError, match="not a blocked sparse format"):
        formats.as_element_csr(np.zeros((2, 2)))


@pytest.mark.parametrize("exact", [True, False])
def test_analyze_spgemm_b_none_is_a_times_a(exact):
    _, _, (ra, a), _ = golden("power_law", seed=5)
    got = analyze_spgemm(a, exact_output=exact)
    want = ref_analyze(ra, exact_output=exact)
    for f in STATS_SCALARS:
        assert getattr(got, f) == getattr(want, f), f
    for f in STATS_ARRAYS:
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


# --------------------------------------------------------------------------
# sorted-CSR utilities and containers
# --------------------------------------------------------------------------

def test_merge_by_column_equals_reference():
    cols = [3, 1, 3, -1, 0, 1, 7, 3]
    vals = np.asarray([1.0, 2.0, 4.0, 9.0, 8.0, 0.5, -1.0, 0.25], np.float32)
    for args in ((cols, vals), (cols,)):
        got, want = csr.merge_by_column(*args), ref_csr.merge_by_column(*args)
        assert np.array_equal(got[0], want[0]) and got[0].dtype == np.int32
        assert (got[1] is None) == (want[1] is None)
        if got[1] is not None:
            assert np.array_equal(got[1], want[1])


def test_grow_nnz_max_equals_reference():
    for args in ((0,), (9,), (129,), (5, 64), (100, 64), (3, 0)):
        assert csr.grow_nnz_max(*args) == ref_csr.grow_nnz_max(*args)
    assert csr.grow_nnz_max(1000, floor=3) == \
        ref_csr.grow_nnz_max(1000, floor=3)
    for bad in (dict(required=-1), dict(required=4, floor=0)):
        with pytest.raises(ValueError):
            csr.grow_nnz_max(**bad)


@pytest.mark.parametrize("kind", KINDS)
def test_spgemm_row_upper_bounds_equals_reference(kind):
    _, _, (ra, a), (rb, b) = golden(kind, seed=6)
    got = csr.spgemm_row_upper_bounds(a, b)
    want = ref_csr.spgemm_row_upper_bounds(ra, rb)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_ell_slots_equal_reference():
    for rptr in ([0, 2, 2, 5], [0, 0], [0, 1, 4, 4, 9]):
        for width in (None, 6):
            want = ref_formats.ell_slots(np.asarray(rptr), width)
            for got in (formats.ell_slots(np.asarray(rptr), width),
                        csr.ell_slots(np.asarray(rptr), width)):
                assert all(np.array_equal(g, w) and g.dtype == w.dtype
                           for g, w in zip(got, want))
    with pytest.raises(ValueError, match="longest row"):
        formats.ell_slots(np.asarray([0, 2, 2, 5]), width=2)


def test_csr_to_ell_equals_reference_and_guards_truncation():
    rng = np.random.default_rng(7)
    d = rand_dense(rng, 9, 11, 0.4)
    d[2] = 0.0
    ra, a = pair(d, pad=4)
    for kw in (dict(), dict(max_row_len=12), dict(max_row_len=2,
                                                  truncate=True)):
        want_v, want_c = ref_formats.csr_to_ell(ra, **kw)
        for fn in (formats.csr_to_ell, csr_to_ell):
            got_v, got_c = fn(a, **kw)
            assert np.array_equal(got_v.numpy(), np.asarray(want_v))
            assert np.array_equal(got_c.numpy(), np.asarray(want_c))
            assert got_c.dtype == torch.int32
    with pytest.raises(ValueError, match="truncate"):
        formats.csr_to_ell(a, max_row_len=2)


@pytest.mark.parametrize("pad,cap", [(0, None), (3, None), (2, 40)])
def test_csr_transpose_equals_reference(pad, cap):
    rng = np.random.default_rng(8)
    d = rand_dense(rng, 8, 13, 0.35)
    d[:, 4] = 0.0
    ra, a = pair(d, pad=pad)
    got = csr.csr_transpose(a, nnz_max=cap)
    want = ref_csr.csr_transpose(ra, nnz_max=cap)
    assert got.shape == want.shape == (13, 8)
    assert np.array_equal(got.col_id, np.asarray(want.col_id))
    assert np.array_equal(got.row_ptr, np.asarray(want.row_ptr))
    assert np.array_equal(got.value.numpy(), np.asarray(want.value))
    np.testing.assert_array_equal(got.to_dense().numpy(), d.T)
    got.check_pad_contract()
    with pytest.raises(ValueError, match="nnz_max"):
        csr.csr_transpose(a, nnz_max=1)


def test_csr_container_equals_reference():
    rng = np.random.default_rng(9)
    d = rand_dense(rng, 7, 6, 0.4)
    d[5:] = 0.0                                  # trailing empty rows
    ra = RefCSR.from_dense(d, nnz_max=30)
    a = CSR.from_dense(d, nnz_max=30, device="cpu")
    assert np.array_equal(a.col_id, np.asarray(ra.col_id))
    assert np.array_equal(a.row_ptr, np.asarray(ra.row_ptr))
    assert np.array_equal(a.value.numpy(), np.asarray(ra.value))
    assert (a.nnz, a.nnz_max, a.n_rows, a.n_cols) == \
        (int(ra.nnz), ra.nnz_max, ra.n_rows, ra.n_cols)
    assert np.array_equal(a.row_lengths(), np.asarray(ra.row_lengths()))
    assert np.array_equal(a.row_ids(), np.asarray(ra.row_ids()))
    np.testing.assert_array_equal(a.to_dense().numpy(),
                                  np.asarray(ra.to_dense()))
    assert a.check_pad_contract() is a
    with pytest.raises(ValueError, match="nnz_max"):
        CSR.from_dense(d, nnz_max=2, device="cpu")
    for bad, match in ((dataclasses.replace(a, value=a.value + 1.0),
                        "pad values"),
                       (dataclasses.replace(a, col_id=np.where(
                           np.arange(30) == 29, 0, a.col_id).astype(
                               np.int32)), "pad col_id"),
                       (dataclasses.replace(a, row_ptr=a.row_ptr[::-1]
                                            .copy()), "monotone")):
        with pytest.raises(ValueError, match=match):
            bad.check_pad_contract()


# --------------------------------------------------------------------------
# the Table-I generators (in-process parity)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("abbrev", ["cg", "wv", "f3"])
def test_generate_equals_reference_in_process(abbrev):
    spec = sparsity.TABLE_I[abbrev]
    assert dataclasses.astuple(spec) == \
        dataclasses.astuple(ref_sparsity.TABLE_I[abbrev])
    got = sparsity.generate(spec, scale=0.01, seed=3, device="cpu")
    want = ref_sparsity.generate(ref_sparsity.TABLE_I[abbrev], scale=0.01,
                                 seed=3)
    assert got.shape == want.shape
    assert np.array_equal(got.col_id, np.asarray(want.col_id))
    assert np.array_equal(got.row_ptr, np.asarray(want.row_ptr))
    assert np.array_equal(got.value.numpy(), np.asarray(want.value))


def test_pattern_masks_and_clones_equal_reference():
    for kind in KINDS:
        for fn in ("element_pattern_mask", "block_pattern_mask"):
            got = getattr(sparsity, fn)(kind, np.random.default_rng(1), 9, 7)
            want = getattr(ref_sparsity, fn)(kind, np.random.default_rng(1),
                                             9, 7)
            assert np.array_equal(got, want), (fn, kind)
    got = sparsity.table_i_clones(scale=0.0005, device="cpu")
    want = ref_sparsity.table_i_clones(scale=0.0005)
    assert set(got) == set(want) == set(sparsity.TABLE_I)
    for k in got:
        assert np.array_equal(got[k].row_ptr, np.asarray(want[k].row_ptr))
    with pytest.raises(ValueError):
        sparsity.element_pattern_mask("zipf", np.random.default_rng(0), 2, 2)


# --------------------------------------------------------------------------
# the numeric kernels' wrappers against the reference's Pallas kernels
# --------------------------------------------------------------------------

def ell_operands(plan, ra, rb):
    """The reference kernels' ELL operands for a reference plan."""
    a_vals = jnp.where(jnp.asarray(plan.a_live),
                       ra.value[jnp.asarray(plan.a_gather)], 0)
    b_ell = jnp.where(jnp.asarray(plan.b_live),
                      rb.value[jnp.asarray(plan.b_gather)], 0)
    return a_vals, b_ell


@pytest.mark.parametrize("kind", KINDS)
def test_numeric_phase_equals_pallas_kernel(kind):
    """B5's wrapper writes C's padded-CSR values directly; the reference
    kernel's ELL rows, compacted with its own maps, must agree."""
    _, _, (ra, a), (rb, b) = golden(kind, seed=10)
    rp, plan = ref_plan_spgemm(ra, rb, n_lanes=3), plan_spgemm(a, b,
                                                               n_lanes=3)
    cap = plan.nnz_c + 5
    a_vals, b_ell = ell_operands(rp, ra, rb)
    ell = maple_spgemm_pallas(
        a_vals.reshape(-1, 1), b_ell, jnp.asarray(rp.scatter_pos),
        jnp.asarray(rp.order), jnp.asarray(rp.step_row),
        jnp.asarray(rp.step_col), m=ra.shape[0], lc=rp.lc, interpret=True)
    rows, offs = ref_ops._spgemm_compaction_maps(rp, cap)
    got_rows, got_offs = _spgemm_compaction_maps(plan, cap)
    assert np.array_equal(got_rows, rows) and np.array_equal(got_offs, offs)
    want = np.where(np.arange(cap) < plan.nnz_c,
                    np.asarray(ell)[rows, offs], 0)
    got = maple_spgemm_numeric(a.value, b.value, plan, cap=cap)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, maple_spgemm_numeric_plain(a.value, b.value,
                                                       plan, cap=cap))


@pytest.mark.parametrize("kind", KINDS)
def test_csr_sddmm_equals_pallas_kernel(kind):
    """B6's wrapper writes dA in A's value layout; the reference kernel's
    per-ELL-slot output, mapped through ``a_gather``, must agree."""
    _, _, (ra, a), (rb, b) = golden(kind, seed=11)
    _csr_sddmm_against_pallas(ra, a, rb, b)


@pytest.mark.parametrize("b_density", [0.1, 0.3, 0.6])
def test_csr_sddmm_equals_pallas_kernel_on_long_b_rows(b_density):
    """The card tests' B6 operands: B rows longer than a lane group's
    three steps (24 terms) and than a warp, and empty A rows."""
    rng = np.random.default_rng(7)
    am = rng.random((30, 40)) < 0.3
    am[::7] = False                                  # empty A rows
    bm = rng.random((40, 120)) < b_density
    bm[3] = True                                     # a 120-entry B row
    (ra, a), (rb, b) = (pair(rand_dense(rng, *x.shape, mask=x), pad=2)
                        for x in (am, bm))
    assert plan_spgemm(a, b, n_lanes=3).lb > 32
    _csr_sddmm_against_pallas(ra, a, rb, b)


def _csr_sddmm_against_pallas(ra, a, rb, b):
    rp, plan = ref_plan_spgemm(ra, rb, n_lanes=3), plan_spgemm(a, b,
                                                               n_lanes=3)
    m, cap = ra.shape[0], plan.nnz_c
    dc = np.random.default_rng(12).standard_normal(cap).astype(np.float32)
    rows, offs = ref_ops._spgemm_compaction_maps(rp, cap)
    dc_ell = np.zeros((m + 1, rp.lc), np.float32)
    dc_ell[rows, offs] = dc
    _, b_ell = ell_operands(rp, ra, rb)
    ell_da = maple_sddmm_csr_pallas(
        jnp.asarray(dc_ell), b_ell, jnp.asarray(rp.scatter_pos),
        jnp.asarray(rp.order), jnp.asarray(rp.step_row),
        jnp.asarray(rp.step_col), n_slots=m * rp.la, interpret=True)
    live = np.nonzero(rp.a_live)[0]
    want = np.zeros(ra.nnz_max, np.float32)
    want[rp.a_gather[live]] = np.asarray(ell_da)[live, 0]
    got = maple_sddmm_csr(torch.from_numpy(dc), b.value, plan,
                          n_slots=a.nnz_max)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_element_walk_equals_pallas_kernel(kind):
    ad, bd, (ra, a), _ = golden(kind, seed=13)
    values, col_ids = ref_formats.csr_to_ell(ra)
    want = maple_spmspm_pallas(values, col_ids, jnp.asarray(bd),
                               interpret=True)
    got_v, got_c = formats.csr_to_ell(a)
    got = maple_spmspm_ell(got_v, got_c, torch.from_numpy(bd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), ad @ bd, rtol=1e-4, atol=1e-4)


# --------------------------------------------------------------------------
# maple_spgemm / maple_spmspm values against the reference
# --------------------------------------------------------------------------

def ref_values(ra, rb, plan, **kw):
    """The reference's C values, jitted over a prebuilt plan (as its own
    tests run it)."""
    f = jax.jit(lambda av, bv: ref_maple_spgemm(
        RefCSR(av, ra.col_id, ra.row_ptr, ra.shape),
        RefCSR(bv, rb.col_id, rb.row_ptr, rb.shape), plan=plan, **kw).value)
    return np.asarray(f(ra.value, rb.value))


def check_padded_csr_contract(c: CSR):
    nnz = c.nnz
    assert (c.col_id[nnz:] == -1).all() and (c.col_id[:nnz] >= 0).all()
    assert not c.value[nnz:].any()
    for i in range(c.shape[0]):
        seg = c.col_id[c.row_ptr[i]:c.row_ptr[i + 1]]
        assert (np.diff(seg) > 0).all()
    c.check_pad_contract()


@pytest.mark.parametrize("schedule,balance", [
    ("balanced", "work"), ("row_atomic", "fibers"), ("naive", "none")])
@pytest.mark.parametrize("kind", KINDS)
def test_maple_spgemm_values_equal_reference(kind, schedule, balance):
    ad, bd, (ra, a), (rb, b) = golden(kind, seed=14)
    c = maple_spgemm(a, b, schedule=schedule, n_lanes=3)
    want = ref_values(ra, rb, ref_plan_spgemm(ra, rb, n_lanes=3,
                                              balance=balance))
    assert isinstance(c, CSR) and c.shape == (ra.shape[0], rb.shape[1])
    assert c.nnz_max == want.shape[0]
    np.testing.assert_allclose(c.value.numpy(), want, **TOL)
    np.testing.assert_allclose(c.to_dense().numpy(), ad @ bd, rtol=1e-4,
                               atol=1e-4)
    check_padded_csr_contract(c)


def test_maple_spmspm_equals_reference():
    ad, bd, (ra, a), (rb, b) = golden("uniform", seed=15, shape=(10, 8, 9))
    for ref_b, b_ in ((rb, b), (jnp.asarray(bd), torch.from_numpy(bd))):
        want = np.asarray(ref_ops.maple_spmspm(ra, ref_b))
        got = maple_spmspm(a, b_)
        assert got.shape == (10, 9)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    with pytest.raises(ValueError, match="contraction"):
        maple_spmspm(a, torch.zeros((3, 9)))


# --------------------------------------------------------------------------
# contracts and raises (the reference's)
# --------------------------------------------------------------------------

def test_spgemm_nnz_at_capacity_and_nnz_max_raise():
    ad, _, (ra, a), _ = golden("uniform", seed=16, shape=(10, 10, 10))
    plan = plan_spgemm(a, a, n_lanes=2)
    c = maple_spgemm(a, a, nnz_max=plan.nnz_c)
    assert c.nnz_max == plan.nnz_c
    np.testing.assert_allclose(c.value.numpy(), ref_values(
        ra, ra, ref_plan_spgemm(ra, ra, n_lanes=2), nnz_max=plan.nnz_c),
        **TOL)
    np.testing.assert_allclose(c.to_dense().numpy(), ad @ ad, rtol=1e-4,
                               atol=1e-4)
    with pytest.raises(ValueError, match="nnz_max"):
        maple_spgemm(a, a, nnz_max=plan.nnz_c - 1)


@pytest.mark.parametrize("case", ["zero_a", "zero_b", "zero_k", "zero_m",
                                  "zero_n"])
def test_spgemm_degenerate_and_zero_dimension_operands(case):
    rng = np.random.default_rng(17)
    shapes = {"zero_a": ((6, 5), (5, 7)), "zero_b": ((5, 4), (4, 6)),
              "zero_k": ((4, 0), (0, 5)), "zero_m": ((0, 5), (5, 4)),
              "zero_n": ((5, 4), (4, 0))}[case]
    ad = rand_dense(rng, *shapes[0], 0.0 if case == "zero_a" else 0.5)
    bd = rand_dense(rng, *shapes[1], 0.0 if case == "zero_b" else 0.5)
    (ra, a), (rb, b) = pair(ad), pair(bd)
    av = a.value.clone().requires_grad_()
    before = maple_spgemm_numeric.launches
    c = maple_spgemm(dataclasses.replace(a, value=av), b)
    want = ref_maple_spgemm(ra, rb)
    assert c.shape == want.shape == (shapes[0][0], shapes[1][1])
    assert c.nnz == 0 and (c.col_id == -1).all()
    assert c.nnz_max == want.nnz_max and not c.value.any()
    c.value.sum().backward()
    assert not av.grad.any()
    assert maple_spgemm_numeric.launches == before


def test_spgemm_raises_like_the_reference():
    rng = np.random.default_rng(23)
    _, a = pair(rand_dense(rng, 6, 5, 0.4))
    _, b = pair(rand_dense(rng, 5, 6, 0.4))
    zeros = lambda m, n: CSR.from_dense(np.zeros((m, n), np.float32),
                                        device="cpu")
    with pytest.raises(ValueError, match="contraction"):
        maple_spgemm(a, zeros(7, 3))
    with pytest.raises(ValueError, match="unknown schedule"):
        maple_spgemm(a, b, schedule="fastest")
    with pytest.raises(TypeError, match="CSR"):
        maple_spgemm(a, np.zeros((5, 6), np.float32))
    with pytest.raises(ValueError, match="plan is for"):
        maple_spgemm(a, b, plan=plan_spgemm(b, a))
    dense_d = rng.standard_normal((6, 5)).astype(np.float32)
    thin_d = np.zeros((6, 5), np.float32)
    thin_d[np.arange(5), np.arange(5)] = 1.0
    dense_plan = plan_spgemm(CSR.from_dense(dense_d, device="cpu"), b)
    with pytest.raises(ValueError, match="capacity"):
        maple_spgemm(CSR.from_dense(thin_d, device="cpu"), b,
                     plan=dense_plan)
    full_b = CSR.from_dense(np.ones((5, 6), np.float32), device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        maple_spgemm(a, CSR.from_dense(thin_d.T[:, :6].copy(), device="cpu"),
                     plan=plan_spgemm(a, full_b))
    with pytest.raises(ValueError, match="balance"):
        plan_spgemm(a, b, balance="speed")
    with pytest.raises(ValueError, match="n_lanes"):
        plan_spgemm(a, b, n_lanes=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        plan_spgemm(a, a)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        maple_spgemm(dataclasses.replace(a, value=a.value.double()),
                     dataclasses.replace(b, value=b.value.double()))


def test_spgemm_plan_reuse_with_new_values():
    ad, _, (ra, a), _ = golden("banded", seed=19, shape=(8, 8, 8))
    plan = plan_spgemm(a, a, n_lanes=2)
    a2 = dataclasses.replace(a, value=a.value * 2)
    np.testing.assert_allclose(maple_spgemm(a2, a2, plan=plan).to_dense()
                               .numpy(), 4 * (ad @ ad), rtol=1e-4, atol=1e-4)
    dev = plan.on_device(torch.device("cpu"))
    assert plan.on_device(torch.device("cpu")) is dev
    assert dev["pos"].numel() == plan.stats.partial_products


# --------------------------------------------------------------------------
# the device plan's derived arrays against a derivation by hand
# --------------------------------------------------------------------------

def derived_by_hand(plan):
    """``row_meta``, ``row_base``, ``slot_b``, ``t_cpos``, ``fiber_meta``
    and ``fiber_base`` from the host plan alone (``scatter_pos``,
    ``a_gather``, ``order`` / ``step_col``, ``b_live``, ``out_row_ptr``),
    with loops: slot s = a_gather[e] of live ELL slot e consumes the B row
    its lane step names; a row's partials follow its slots' B rows; a
    fiber lists the slots of one B row in row order, each with one partial
    per entry of that row; the records list each window of 32 rows by
    slot count or fiber length, longest first."""
    m, k, la = plan.shape_a[0], plan.shape_b[0], plan.la
    b_len = plan.b_live.sum(axis=1)
    b_start = np.concatenate([[0], np.cumsum(b_len)])
    col_of = {int(e): int(c) for e, c in zip(plan.order.ravel(),
                                            plan.step_col.ravel()) if c >= 0}
    live = [e for e in range(m * la) if plan.a_live[e]]
    slot_b = np.zeros((len(live), 2), np.int32)
    for e in live:
        slot_b[plan.a_gather[e]] = (b_start[col_of[e]], b_len[col_of[e]])
    meta, base, first = [], [], 0
    for i in range(m):
        mine = [e for e in live if e // la == i]
        parts = sum(int(b_len[col_of[e]]) for e in mine)
        meta.append((plan.a_gather[mine[0]] if mine else len(
            [e for e in live if e // la < i]), len(mine),
            plan.out_row_ptr[i + 1] - plan.out_row_ptr[i], parts))
        base.append((plan.out_row_ptr[i], first))
        first += parts
    w = SPGEMM_ROW_WINDOW
    order = sorted(range(m), key=lambda i: (i // w, -meta[i][1], i))
    fmeta, fbase, t_cpos = [], [], []
    for kk in range(k):
        fiber = sorted((e for e in live if col_of[e] == kk),
                       key=lambda e: e // la)
        fmeta.append((b_start[kk], b_len[kk],
                      len([e for e in live if col_of[e] < kk]), len(fiber)))
        fbase.append(len(t_cpos))
        for e in fiber:
            for u in range(b_len[kk]):
                assert plan.scatter_pos[e, u] >= 0
                t_cpos.append(plan.out_row_ptr[e // la]
                              + plan.scatter_pos[e, u])
    fibers = sorted(range(k), key=lambda kk: (kk // w, -fmeta[kk][3], kk))
    return {"row_meta": np.asarray([meta[i] for i in order],
                                   np.int32).reshape(-1, 4),
            "row_base": np.asarray([base[i] for i in order],
                                   np.int64).reshape(-1, 2),
            "slot_b": slot_b, "t_cpos": np.asarray(t_cpos, np.int32),
            "fiber_meta": np.asarray([fmeta[kk] for kk in fibers],
                                     np.int32).reshape(-1, 4),
            "fiber_base": np.asarray([fbase[kk] for kk in fibers],
                                     np.int64)}


@pytest.mark.parametrize("case", ["uniform", "power_law", "banded",
                                  "empty_rows", "all_zero_a", "wide"])
def test_device_plan_derived_arrays_equal_a_derivation_by_hand(case):
    rng = np.random.default_rng(31)
    if case in KINDS:
        _, _, (_, a), (_, b) = golden(case, seed=32)
    else:
        am, bm = {"empty_rows": (rng.random((70, 40)) < 0.2,
                                 rng.random((40, 22)) < 0.3),
                  "all_zero_a": (np.zeros((9, 7), bool),
                                 rng.random((7, 8)) < 0.5),
                  "wide": (rng.random((6, 80)) < 0.9,
                           rng.random((80, 90)) < 0.9)}[case]
        if case == "empty_rows":
            am[::3] = False                   # empty A rows and output rows
            bm[2] = False                     # an empty B row some slots take
            am[:, 5] = False                  # a B row no slot consumes
        _, a = pair(rand_dense(rng, *am.shape, mask=am), pad=2)
        _, b = pair(rand_dense(rng, *bm.shape, mask=bm), pad=1)
    plan = plan_spgemm(a, b, n_lanes=3)
    if case == "wide":
        assert plan.lb > 32 and plan.la > 32
    dev = plan.on_device(torch.device("cpu"))
    for name, want in derived_by_hand(plan).items():
        got = (plan.fiber_positions(torch.device("cpu")) if name == "t_cpos"
               else dev[name])
        assert got.dtype == torch.from_numpy(want).dtype, name
        assert torch.equal(got, torch.from_numpy(want)), name
    assert plan.fiber_positions(torch.device("cpu")).numel() \
        == plan.stats.partial_products


def test_fiber_positions_are_built_on_demand_and_refuse_past_32_bits():
    """``t_cpos`` is not part of the shared device plan: it is built on
    dB's first call and cached.  Only it holds C slots in 32 bits, so only
    it refuses a C of more than 2^31 - 1 values."""
    rng = np.random.default_rng(33)
    _, a = pair(rand_dense(rng, 20, 20, mask=rng.random((20, 20)) < 0.3))
    plan = plan_spgemm(a, a)
    cpu = torch.device("cpu")
    assert "t_cpos" not in plan.on_device(cpu)
    assert plan.fiber_positions(cpu) is plan.fiber_positions(cpu)
    ptr = plan.out_row_ptr.copy()
    ptr[-1] = 2 ** 31
    big = dataclasses.replace(plan, out_row_ptr=ptr, _on_device={},
                              _patterns={}, _t_cpos={})
    big.on_device(cpu)
    with pytest.raises(ValueError, match="32-bit"):
        big.fiber_positions(cpu)
