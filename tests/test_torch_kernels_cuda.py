"""The Hopper kernels (SpMM forward in the naive, compact and rmw
layouts, block SDDMM and the maple_spmm backward; the SpGEMM numeric phase, its CSR SDDMM and dB, and the element
walk with a dense B; the MoE grouped GEMM, its dx and dW, and
block-sparse local attention) against their plain versions, on the
card.

These tests need an NVIDIA GPU and the CUDA toolkit (``nvcc``); without a
card they skip.  They import nothing of JAX, so they run on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.csr import BlockCSR
from repro_torch.core.sparsity import SPGEMM_SPLIT_CASES, spgemm_split_masks
from repro_torch.kernels import (maple_spmm, maple_spmm_compact,
                                 maple_spmm_naive, maple_spmm_planned,
                                 plan_spmm)
from repro_torch.kernels.maple_spmm import (maple_spmm_compact_plain,
                                            maple_spmm_naive_plain,
                                            maple_spmm_planned_plain)
from repro_torch.kernels.ops import _meta_on, _scatter_merge_f32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _operands(cuda, seed, gm, gk, block, density, dtype, extra_pad=2):
    rng = np.random.default_rng(seed)
    bm, bk = block
    mask = rng.random((gm, gk)) < density
    mask[1::3] = False                            # empty block-rows
    d = rng.standard_normal((gm * bm, gk * bk)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, bm, 0), bk, 1)
    a = BlockCSR.from_dense(d, block, n_blocks_max=int(mask.sum()) + 1
                            + extra_pad, device=cuda)
    return dataclasses.replace(a, blocks=a.blocks.to(dtype)), rng


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    scale = float(want.abs().max())
    limit = 1e-5 * scale + 1e-6 if dtype == torch.float32 else 1e-2 * scale
    assert float((got - want).abs().max()) <= limit


def _close_attn(got, want, dtype):
    """B9: ``_close``, and in bf16 each run of max(hd, 64) consecutive
    output values (one query row of one head at hd >= 64) within 2^-7 of
    the run's norm: P's one rounding to bf16 leaves about 2e-3, and one
    key too many or too few in a row of 2048 moves it about 1.3e-2."""
    _close(got, want, dtype)
    if dtype == torch.float32:
        return
    n = max(want.shape[-1], 64)
    d = (got.float() - want.float()).flatten()
    w = want.float().flatten()
    pad = -d.numel() % n
    d = torch.nn.functional.pad(d, (0, pad)).view(-1, n).norm(dim=1)
    w = torch.nn.functional.pad(w, (0, pad)).view(-1, n).norm(dim=1)
    assert bool((d <= 2.0 ** -7 * w).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block,bn,n", [((8, 8), 16, 21), ((64, 64), 128, 1),
                                        ((64, 64), 128, 128),
                                        ((16, 32), 64, 70)])
def test_naive_kernel_matches_plain(cuda, dtype, block, bn, n):
    a, rng = _operands(cuda, 0, 7, 6, block, 0.5, dtype)
    b3 = torch.from_numpy(rng.standard_normal((3, a.shape[1], n))
                          .astype(np.float32)).to(cuda, dtype)
    meta = _meta_on(a, cuda)
    args = (a.blocks, meta["row_ptr"], meta["block_col"], b3)
    before = maple_spmm_naive.launches
    got = maple_spmm_naive(*args, bn=bn)
    torch.cuda.synchronize()
    assert maple_spmm_naive.launches == before + 1
    _close(got, maple_spmm_naive_plain(*args), dtype)
    empty = np.repeat(np.diff(a.row_ptr) == 0, block[0])
    assert (got[:, torch.from_numpy(empty).to(cuda)] == 0).all()


def _naive_twice(a, b3, **kw):
    """B3 twice on the same inputs: bit-identical, one launch each."""
    meta = _meta_on(a, b3.device)
    args = (a.blocks, meta["row_ptr"], meta["block_col"], b3)
    before = maple_spmm_naive.launches
    got = [maple_spmm_naive(*args, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert maple_spmm_naive.launches == before + 2
    assert torch.equal(got[0], got[1])
    return got[0], args


def _one_run_a_row(a, cuda):
    """A run table with one run per non-empty block-row, its steps the
    row's slots in construction order: B4's arguments beside B3's."""
    ptr = np.asarray(a.row_ptr)
    nnzb = int(ptr[-1])
    rows = [i for i in range(len(ptr) - 1) if ptr[i + 1] > ptr[i]]
    order = torch.arange(max(nnzb, 1), dtype=torch.int32)[None]
    step_col = torch.from_numpy(np.asarray(a.block_col)[:max(nnzb, 1)]
                                .astype(np.int32))[None]
    if nnzb == 0:
        step_col[:] = -1
    runs = torch.tensor([(0, ptr[i], ptr[i + 1], i) for i in rows],
                        dtype=torch.int32).reshape(-1, 4)
    per_row = np.zeros(len(ptr), np.int32)
    per_row[1:] = np.cumsum(np.diff(ptr) > 0)
    return [t.to(cuda) for t in (order, step_col, runs,
                                 torch.from_numpy(per_row))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,n", [(4, 1), (3, 1), (2, 2), (4, 8), (4, 64),
                                 (4, 112), (4, 128)])
def test_naive_kernel_routes_rerun_bit_identical(cuda, dtype, g, n):
    """B3 at 64 × 64 blocks on each route: batches folded into the skinny
    tile (f32, N <= 4) or wgmma's n8 tile (bf16, N <= 8; G 3 leaves columns
    idle), and g kept in the grid (FFMA, wgmma n64 / n128, ragged N 112)."""
    from repro_torch.kernels.maple_spmm import naive_route
    a, rng = _operands(cuda, 5, 6, 10, (64, 64), 0.5, dtype)
    b3 = torch.from_numpy(rng.standard_normal((g, a.shape[1], n))
                          .astype(np.float32)).to(cuda, dtype)
    route = naive_route(dtype, g, 6, n, a.shape[1], 64, 64, 128,
                        n_slots=a.block_col.shape[0], sms=132)
    narrow = n <= (8 if dtype == torch.bfloat16 else 4)
    assert (route["fold"] > 0) == narrow
    got, args = _naive_twice(a, b3)
    _close(got, maple_spmm_naive_plain(*args), dtype)
    empty = np.repeat(np.diff(a.row_ptr) == 0, 64)
    assert (got[:, torch.from_numpy(empty).to(cuda)] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,n", [(4, 1), (3, 4), (2, 17), (4, 112)])
def test_naive_kernel_on_rows_over_the_ring_and_one_slot_rows(cuda, dtype,
                                                              g, n):
    """A 24-block and a 20-block row (segments longer than the ring), a
    one-slot row and empty rows."""
    a, rng = _split_operands(cuda, dtype)
    b3 = torch.from_numpy(rng.standard_normal((g, a.shape[1], n))
                          .astype(np.float32)).to(cuda, dtype)
    got, args = _naive_twice(a, b3)
    _close(got, maple_spmm_naive_plain(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_naive_kernel_on_an_all_pad_matrix(cuda, dtype):
    a, rng = _operands(cuda, 13, 5, 4, (64, 64), 0.0, dtype, extra_pad=3)
    assert int(a.row_ptr[-1]) == 0
    for g, n in ((4, 1), (2, 40)):
        b3 = torch.ones((g, a.shape[1], n), device=cuda, dtype=dtype)
        got, _ = _naive_twice(a, b3)
        assert got.shape == (g, a.shape[0], n) and not got.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block,g,n", [((64, 64), 4, 1), ((64, 64), 3, 2),
                                       ((64, 64), 4, 112), ((8, 8), 3, 21),
                                       ((64, 64), 2, 8), ((128, 16), 4, 1),
                                       ((8, 8), 4, 1)])
def test_naive_kernel_equals_planned_on_one_run_a_row(cuda, dtype, block, g,
                                                      n):
    """B3 sums a row as B4 sums a run: on a run table of one run per
    non-empty row, B4's f32 result cast to B's dtype is B3's, bit for bit,
    whether B3 folds the batches or keeps them in the grid."""
    a, rng = _operands(cuda, 6, 7, 9, block, 0.5, dtype)
    b3 = torch.from_numpy(rng.standard_normal((g, a.shape[1], n))
                          .astype(np.float32)).to(cuda, dtype)
    got, _ = _naive_twice(a, b3, bn=16 if block == (8, 8) else 128)
    order, step_col, runs, ptr = _one_run_a_row(a, cuda)
    want = maple_spmm_planned(a.blocks, order, step_col, runs, ptr, b3,
                              bn=16 if block == (8, 8) else 128)
    torch.cuda.synchronize()
    assert torch.equal(got, want.to(dtype))


def test_naive_route_matches_the_library(cuda):
    """The wrapper's route (tile, fold, batch groups, B's copy) is the one
    the C launcher plans."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.maple_spmm import (_COPIES, naive_route,
                                                walk_tile)
    lib = _build.library("maple_spmm")
    kinds = {"wgmma": (0, 1, 2), "skinny": (3,), "ffma": (4, 5, 6, 7, 8, 9,
                                                          10)}
    out = (ctypes.c_int * 6)()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for bm, bk in ((8, 8), (64, 64), (16, 32), (128, 16)):
            for g in (1, 3, 4, 9):
                for n in (1, 2, 3, 4, 5, 8, 17, 21, 112, 128):
                    for aligned in (True, False):
                        k = 40 * bk + (bk if n % 2 else 0)
                        try:
                            r = naive_route(dtype, g, 40, n, k, bm, bk, 128,
                                            n_slots=400, sms=132,
                                            aligned=aligned)
                        except ValueError:     # no tile fits: both refuse
                            tile = walk_tile(dtype, n, bm, bk, 128, runs=40,
                                             g=g, sms=132)
                            assert lib.maple_spmm_naive_layout(
                                code, g, n, k, bm, bk, tile, int(aligned),
                                out) != 0
                            continue
                        err = lib.maple_spmm_naive_layout(
                            code, g, n, k, bm, bk, r["bn"], int(aligned),
                            out)
                        assert err == 0
                        assert out[0] in kinds[r["consumer"]] or (
                            out[0] == 11 and r["split"])
                        assert (out[0] == 11) == r["split"]
                        assert list(out[1:5]) == [r["tile"], r["n_tiles"],
                                                  r["fold"], r["groups"]]
                        assert _COPIES[out[5]] == r["copy"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lanes,chunk,whole", [(8, 1, False), (8, None, True),
                                               (3, 2, False)])
def test_compact_kernel_and_merge_match_plain(cuda, dtype, lanes, chunk,
                                              whole):
    a, rng = _operands(cuda, 1, 9, 8, (8, 8), 0.5, dtype)
    plan = plan_spmm(a, n_lanes=lanes, chunk=chunk, row_atomic=whole)
    b3 = torch.from_numpy(rng.standard_normal((2, a.shape[1], 37))
                          .astype(np.float32)).to(cuda, dtype)
    dev = plan.on_device(cuda)
    n_slots = plan.n_lanes * plan.r_max
    args = (a.blocks, dev["order"], dev["step_col"], dev["runs"], b3)
    tiles = maple_spmm_compact(*args, n_slots=n_slots, bn=16)
    want = maple_spmm_compact_plain(*args, n_slots=n_slots)
    live = torch.from_numpy(plan.slot_row.reshape(-1) >= 0).to(cuda)
    view = lambda t: t.view(2, n_slots, 8, 37)[:, live]
    _close(view(tiles), view(want), dtype)
    merged = [_scatter_merge_f32(tiles.view(2, n_slots, 8, 37), dev["merge"],
                                 gm=plan.n_block_rows) for _ in range(2)]
    assert torch.equal(merged[0], merged[1])
    _close(merged[0], _scatter_merge_f32(want.view(2, n_slots, 8, 37),
                                         dev["merge"], gm=plan.n_block_rows),
           dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lanes,chunk,whole,block,bn,n", [
    (8, 1, False, (8, 8), 16, 37), (8, None, True, (8, 8), 16, 1),
    (3, 2, False, (8, 8), 16, 21), (1, None, False, (8, 8), 16, 16),
    (8, 2, False, (64, 64), 128, 256), (8, None, False, (16, 32), 64, 70)])
def test_planned_kernel_matches_plain_and_compact_merge(cuda, dtype, lanes,
                                                        chunk, whole, block,
                                                        bn, n):
    """B4 against its plain version, bit-identical on rerun, and equal bit
    for bit to B1 + the slot merge on the same plan (idle lanes, split
    rows, empty rows, G > 1, ragged N)."""
    a, rng = _operands(cuda, 11, 9, 8, block, 0.5, dtype)
    plan = plan_spmm(a, n_lanes=lanes, chunk=chunk, row_atomic=whole)
    b3 = torch.from_numpy(rng.standard_normal((2, a.shape[1], n))
                          .astype(np.float32)).to(cuda, dtype)
    dev = plan.on_device(cuda)
    args = (a.blocks, dev["order"], dev["step_col"], dev["row_runs"],
            dev["row_run_ptr"], b3)
    before = maple_spmm_planned.launches
    got = [maple_spmm_planned(*args, bn=bn) for _ in range(2)]
    torch.cuda.synchronize()
    assert maple_spmm_planned.launches == before + 2
    assert torch.equal(got[0], got[1])
    _close(got[0], maple_spmm_planned_plain(*args), dtype)
    n_slots = plan.n_lanes * plan.r_max
    tiles = maple_spmm_compact(a.blocks, dev["order"], dev["step_col"],
                               dev["runs"], b3, n_slots=n_slots, bn=bn)
    merged = _scatter_merge_f32(tiles.view(2, n_slots, block[0], n),
                                dev["merge"], gm=plan.n_block_rows)
    assert torch.equal(got[0], merged)
    empty = np.repeat(np.diff(a.row_ptr) == 0, block[0])
    assert (got[0][:, torch.from_numpy(empty).to(cuda)] == 0).all()


def _split_operands(cuda, dtype):
    """64 × 64 blocks: a 24-block row, a 20-block row, a one-block row,
    empty rows."""
    rng = np.random.default_rng(31)
    mask = np.zeros((6, 24), bool)
    mask[0] = True
    mask[3, 2:22] = True
    mask[5, 7] = True
    d = rng.standard_normal((6 * 64, 24 * 64)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, 64, 0), 64, 1)
    a = BlockCSR.from_dense(d, (64, 64), device=cuda)
    return dataclasses.replace(a, blocks=a.blocks.to(dtype)), rng


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 4, 17, 256])
@pytest.mark.parametrize("lanes,chunk,whole", [(16, 1, False),
                                               (1, None, True)])
def test_run_walk_on_rows_over_a_cluster_and_runs_over_the_ring(
        cuda, dtype, n, lanes, chunk, whole):
    """B4 on rows split into more runs than a cluster has blocks, and on
    runs longer than the ring: bit-identical on rerun, equal to B1 +
    merge bit for bit, within tolerance of the plain version."""
    from repro_torch.kernels.maple_spmm import SEGMENTS
    a, rng = _split_operands(cuda, dtype)
    plan = plan_spmm(a, n_lanes=lanes, chunk=chunk, row_atomic=whole)
    if lanes > 1:
        assert np.diff(plan.row_run_ptr).max() > SEGMENTS
    else:
        assert (plan.runs[:, 2] - plan.runs[:, 1]).max() > 4 * SEGMENTS
    b3 = torch.from_numpy(rng.standard_normal((2, a.shape[1], n))
                          .astype(np.float32)).to(cuda, dtype)
    dev = plan.on_device(cuda)
    args = (a.blocks, dev["order"], dev["step_col"], dev["row_runs"],
            dev["row_run_ptr"], b3)
    got = [maple_spmm_planned(*args) for _ in range(2)]
    n_slots = plan.n_lanes * plan.r_max
    tiles = maple_spmm_compact(a.blocks, dev["order"], dev["step_col"],
                               dev["runs"], b3, n_slots=n_slots)
    merged = _scatter_merge_f32(tiles.view(2, n_slots, 64, n), dev["merge"],
                                gm=plan.n_block_rows)
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], merged)
    _close(got[0], maple_spmm_planned_plain(*args), dtype)


def test_run_layout_matches_the_library(cuda):
    """The wrapper sizes B4's scratch from ``run_layout``; the launcher
    plans from its own C code: the two agree."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.maple_spmm import _tile_n, run_layout
    lib = _build.library("maple_spmm")
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for bm, bk in ((8, 8), (64, 64), (16, 32)):
            for n in (1, 4, 5, 8, 17, 21, 70, 256):
                for bn in (16, 64, 128, 256):
                    nt, fr = ctypes.c_int(), ctypes.c_int()
                    err = lib.maple_spmm_run_layout(
                        code, n, 64 * bk, bm, bk, _tile_n(bn, n),
                        ctypes.byref(nt), ctypes.byref(fr))
                    lay = run_layout(dtype, n, bm, bk, bn)
                    assert err == 0
                    assert (nt.value, fr.value) == (lay["n_tiles"],
                                                    lay["frag"])


def test_planned_kernel_on_an_all_empty_matrix(cuda):
    a, rng = _operands(cuda, 12, 5, 4, (8, 8), 0.0, torch.float32)
    plan = plan_spmm(a, n_lanes=4)
    assert plan.row_runs.shape[0] == 0
    dev = plan.on_device(cuda)
    b3 = torch.ones((1, a.shape[1], 9), device=cuda)
    out = maple_spmm_planned(a.blocks, dev["order"], dev["step_col"],
                             dev["row_runs"], dev["row_run_ptr"], b3, bn=16)
    torch.cuda.synchronize()
    assert out.shape == (1, a.shape[0], 9) and not out.any()


@pytest.mark.parametrize("fused", ["rmw", "compact"])
def test_maple_spmm_on_the_card_matches_the_cpu(cuda, fused):
    a, rng = _operands(cuda, 2, 10, 6, (8, 8), 0.4, torch.float32)
    a_cpu = dataclasses.replace(a, blocks=a.blocks.cpu(), device_meta={})
    b = rng.standard_normal((2, a.shape[1], 19)).astype(np.float32)
    for kw in (dict(schedule="naive"), dict(n_lanes=8, chunk=1),
               dict(n_lanes=3, row_atomic=True)):
        if kw.get("schedule") != "naive":
            kw = dict(plan=plan_spmm(a_cpu, fused=fused, **kw))
        got = maple_spmm(a, torch.from_numpy(b).to(cuda), bn=16, **kw)
        want = maple_spmm(a_cpu, torch.from_numpy(b), bn=16, **kw)
        _close(got.cpu(), want, torch.float32)


def test_wrappers_refuse_bad_tiles_on_the_card(cuda):
    a, _ = _operands(cuda, 3, 4, 4, (8, 8), 0.5, torch.float32)
    meta = _meta_on(a, cuda)
    b3 = torch.zeros((1, 32, 4), device=cuda)
    with pytest.raises(ValueError, match="power-of-two"):
        maple_spmm_naive(a.blocks, meta["row_ptr"], meta["block_col"], b3,
                         bn=48)
    with pytest.raises(ValueError, match="is on"):
        maple_spmm_naive(a.blocks, meta["row_ptr"].cpu(), meta["block_col"],
                         b3)


# --------------------------------------------------------------------------
# the block SDDMM (B2) and the maple_spmm backward
# --------------------------------------------------------------------------

# (block, bn, G, N, density, block grid, slots a CTA (0: the launcher's
# choice), slots shuffled out of row order)
SDDMM_CASES = [
    ((8, 8), 16, 3, 21, 0.5, (6, 5), 0, False),
    ((8, 8), 16, 1, 1, 0.5, (6, 5), 0, False),
    ((64, 64), 128, 1, 256, 0.3, (6, 5), 0, False),
    ((16, 32), 64, 2, 70, 0.4, (6, 5), 0, False),
    ((8, 8), 16, 2, 40, 0.0, (6, 5), 0, False),         # all pad
    # rows longer than a chunk, chunks that span rows: the dC panel kept
    # from slot to slot and reloaded at each new row
    ((64, 64), 128, 1, 256, 0.7, (6, 20), 8, False),
    ((16, 32), 64, 1, 256, 0.7, (6, 20), 8, False),
    # rows of N·size bytes that TMA cannot take: the producer's own loads
    ((64, 64), 128, 1, 4, 0.7, (6, 20), 8, False),      # the head's N
    ((64, 64), 128, 1, 37, 0.7, (6, 20), 8, False),
    ((8, 8), 16, 1, 21, 0.7, (6, 20), 8, False),
    ((64, 64), 128, 1, 1, 0.7, (6, 20), 8, False),
    # G = 3 at N = 256: the panel streamed beside B in every stage
    ((64, 64), 128, 3, 256, 0.5, (4, 6), 8, False),
    # (4, 8) blocks: a thread's rows 4 apart, one swizzle key a row
    ((4, 8), 16, 2, 40, 0.6, (12, 10), 8, False),
    # slots out of row order: a new panel at almost every slot
    ((64, 64), 128, 1, 256, 0.7, (6, 20), 8, True),
    ((16, 32), 64, 2, 21, 0.7, (6, 20), 3, True),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block,bn,g,n,density,grid,chunk,shuffle",
                         SDDMM_CASES)
def test_sddmm_kernel_matches_plain(cuda, monkeypatch, dtype, block, bn, g,
                                    n, density, grid, chunk, shuffle):
    from repro_torch.kernels import maple_sddmm_bsr
    from repro_torch.kernels import maple_sddmm as module
    from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr_plain
    monkeypatch.setattr(module, "CHUNK", chunk)
    a, rng = _operands(cuda, 4, *grid, block, density, dtype)
    bm, bk = block
    dc = torch.from_numpy(rng.standard_normal((g, a.shape[0], n))
                          .astype(np.float32)).to(cuda, dtype)
    b3 = torch.from_numpy(rng.standard_normal((g, a.shape[1], n))
                          .astype(np.float32)).to(cuda, dtype)
    order = (rng.permutation(a.n_blocks_max) if shuffle
             else np.arange(a.n_blocks_max))
    br = torch.from_numpy(a.block_row[order]).to(cuda)
    bc = torch.from_numpy(a.block_col[order]).to(cuda)
    before = maple_sddmm_bsr.launches
    got = [maple_sddmm_bsr(dc, b3, br, bc, bm=bm, bk=bk, bn=bn)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert maple_sddmm_bsr.launches == before + 2
    assert torch.equal(got[0], got[1])            # no atomics: same bits
    _close(got[0], maple_sddmm_bsr_plain(dc, b3, br, bc, bm=bm, bk=bk),
           dtype)
    assert (got[0][bc < 0] == 0).all()


def test_maple_spmm_backward_on_the_card_matches_the_cpu(cuda):
    from repro_torch.kernels import (maple_sddmm_bsr, plan_spmm_vjp)
    a, rng = _operands(cuda, 5, 10, 6, (8, 8), 0.4, torch.float32)
    b = rng.standard_normal((2, a.shape[1], 19)).astype(np.float32)
    cot = rng.standard_normal((2, a.shape[0], 19)).astype(np.float32)
    grads = {}
    for dev in ("cpu", cuda):
        blocks = a.blocks.detach().to(dev).clone().requires_grad_()
        bt = torch.from_numpy(b).to(dev).requires_grad_()
        w = dataclasses.replace(a, blocks=blocks, device_meta={})
        before = (maple_spmm_planned.launches, maple_spmm_compact.launches,
                  maple_sddmm_bsr.launches)
        out = maple_spmm(w, bt, bn=16, plan=plan_spmm_vjp(w, n_lanes=4))
        (out * torch.from_numpy(cot).to(dev)).sum().backward()
        if dev == cuda:
            torch.cuda.synchronize()
            # forward and dB on the rmw kernel (the default plans' layout),
            # dA on the SDDMM
            assert (maple_spmm_planned.launches - before[0],
                    maple_spmm_compact.launches - before[1],
                    maple_sddmm_bsr.launches - before[2]) == (2, 0, 1)
        grads[str(dev)] = (blocks.grad.cpu(), bt.grad.cpu())
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind,shards,cols,device_chunk", [
    ("uniform", 3, 1, None), ("power_law", 4, 2, None),
    ("banded", 2, 1, None), ("power_law", 4, 1, 2),
    ("empty_rows", 8, 1, None)])
def test_partitioned_maple_spmm_on_the_card_matches_plain(
        cuda, dtype, kind, shards, cols, device_chunk):
    """Partitioned forward, dA and dB (B1 and B2 per shard, the
    row-offset merge) on the card against the same plan on the CPU (the
    plain versions) over the golden patterns; ``empty_rows`` at 8 shards
    leaves shards that own no row, ``device_chunk=2`` splits rows over
    shards.  One shard equals the single-device compact layout bit for
    bit."""
    from repro_torch.core.sparsity import block_pattern_mask
    from repro_torch.kernels import (maple_sddmm_bsr,
                                     plan_partitioned_spmm_vjp,
                                     plan_spmm_vjp)
    rng = np.random.default_rng(7)
    gm, gk = 9, 8
    if kind == "empty_rows":
        mask = rng.random((gm, gk)) < 0.5
        mask[::2] = False
    else:
        mask = block_pattern_mask(kind, rng, gm, gk)
    d = rng.standard_normal((gm * 8, gk * 8)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, 8, 0), 8, 1)
    a = BlockCSR.from_dense(d, (8, 8), n_blocks_max=int(mask.sum()) + 3,
                            device="cpu")
    plan = plan_partitioned_spmm_vjp(a, n_shards=shards, n_col_shards=cols,
                                     n_lanes=3, device_chunk=device_chunk)
    if kind == "empty_rows":
        assert any(not s.written.any() for s in plan.fwd.shards)
    if device_chunk:
        assert plan.fwd.split_rows
    b = rng.standard_normal((2, a.shape[1], 21)).astype(np.float32)
    cot = rng.standard_normal((2, a.shape[0], 21)).astype(np.float32)

    def run(dev, train):
        blocks = a.blocks.to(dev, dtype).clone().requires_grad_()
        bt = torch.from_numpy(b).to(dev, dtype).requires_grad_()
        w = dataclasses.replace(a, blocks=blocks, device_meta={})
        out = maple_spmm(w, bt, bn=16, plan=train)
        (out.float() * torch.from_numpy(cot).to(dev)).sum().backward()
        return [t.detach().float().cpu() for t in (out, blocks.grad,
                                                   bt.grad)]

    before = (maple_spmm_compact.launches, maple_sddmm_bsr.launches)
    got = run(cuda, plan)
    torch.cuda.synchronize()
    # B1 per shard that owns a run and per panel, forward and dB; B2 per
    # shard and panel
    runs = sum(p.runs.shape[0] > 0 for side in (plan.fwd, plan.bwd)
               for p in side.shards)
    assert maple_spmm_compact.launches - before[0] == cols * runs
    assert maple_sddmm_bsr.launches - before[1] == shards * cols
    want = run("cpu", plan)
    for g, w in zip(got, want):
        _close(g, w, dtype)
    assert torch.equal(run(cuda, plan)[0], got[0])        # rerun: same bits
    if dtype == torch.float32:
        one = plan_partitioned_spmm_vjp(a, n_shards=1, n_lanes=3)
        single = plan_spmm_vjp(a, n_lanes=3, fused="compact")
        for g, w in zip(run(cuda, one), run(cuda, single)):
            assert torch.equal(g, w)


def test_partitioned_mesh_on_the_card(cuda):
    """A bound mesh of ``"cuda"`` entries (another device name than the
    payload's ``cuda:0``) sends every shard down the mesh branch on the
    one card: each shard's own blocks, kept once per payload version; the
    same bits as the stacked loop, forward, dA and dB.  A mesh of CPU
    devices around card tensors raises."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import plan_partitioned_spmm_vjp
    rng = np.random.default_rng(11)
    mask = rng.random((9, 8)) < 0.4
    d = rng.standard_normal((72, 64)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, 8, 0), 8, 1)
    a = BlockCSR.from_dense(d, (8, 8), n_blocks_max=int(mask.sum()) + 3,
                            device=cuda)
    plan = plan_partitioned_spmm_vjp(a, n_shards=2, n_col_shards=2,
                                     n_lanes=3)
    blocks = a.blocks.clone().requires_grad_()
    w = dataclasses.replace(a, blocks=blocks, device_meta={})
    bt = torch.from_numpy(rng.standard_normal((2, 64, 21)).astype(
        np.float32)).to(cuda).requires_grad_()
    cot = torch.from_numpy(rng.standard_normal((2, 72, 21)).astype(
        np.float32)).to(cuda)

    def grads():
        blocks.grad = bt.grad = None
        out = maple_spmm(w, bt, bn=16, plan=plan)
        (out * cot).sum().backward()
        return [out.detach(), blocks.grad, bt.grad]

    with sh.use_mesh(sh.Mesh([["cuda"] * 2] * 2,
                             (sh.PARTITION_AXIS, sh.COL_AXIS))):
        on_mesh = grads()
        kept = plan.fwd.on_device(torch.device("cuda"))["shards"][0]
        assert kept["payload"][blocks][0] == blocks._version
        with sh.local_partition_execution():
            loop = grads()
    for g, want in zip(on_mesh, loop):
        assert torch.equal(g, want)
    with sh.use_mesh(sh.Mesh(["cpu"] * 2, (sh.PARTITION_AXIS,))), \
            pytest.raises(ValueError, match="devices of the operands' type"):
        maple_spmm(w, bt, bn=16, plan=plan_partitioned_spmm_vjp(
            a, n_shards=2, n_lanes=3))


# --------------------------------------------------------------------------
# the SpGEMM kernels (B5, B6, dB) and the element walk (B7)
# --------------------------------------------------------------------------

def _element_csr(cuda, mask, rng, dtype, pad=2):
    from repro_torch.core.csr import CSR
    d = (mask * rng.standard_normal(mask.shape)).astype(np.float32)
    c = CSR.from_dense(d, nnz_max=max(int(mask.sum()), 1) + pad, device=cuda)
    return dataclasses.replace(c, value=c.value.to(dtype))


def _spgemm_operands(cuda, kind, dtype, seed=0, shape=(40, 36, 44)):
    from repro_torch.core.sparsity import element_pattern_mask
    from repro_torch.kernels import plan_spgemm
    rng = np.random.default_rng(seed)
    m, k, n = shape
    if kind == "wide":                  # rows and panels wider than a warp
        am, bm = rng.random((m, k)) < 0.9, rng.random((k, n)) < 0.9
    else:
        am = element_pattern_mask(kind, rng, m, k)
        bm = element_pattern_mask(kind, rng, k, n)
        am[1::5] = False                # empty rows
    a = _element_csr(cuda, am, rng, dtype)
    b = _element_csr(cuda, bm, rng, dtype)
    return a, b, plan_spgemm(a, b, n_lanes=3), rng


SPGEMM_KINDS = ["uniform", "power_law", "banded", "wide"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", SPGEMM_KINDS)
def test_spgemm_numeric_kernel_matches_plain(cuda, kind, dtype):
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_numeric,
                                                  maple_spgemm_numeric_plain)
    shape = (6, 80, 90) if kind == "wide" else (40, 36, 44)
    a, b, plan, _ = _spgemm_operands(cuda, kind, dtype, shape=shape)
    cap = plan.nnz_c + 7
    before = maple_spgemm_numeric.launches
    got = [maple_spgemm_numeric(a.value, b.value, plan, cap=cap)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert maple_spgemm_numeric.launches == before + 2
    assert torch.equal(got[0], got[1])            # no atomics: same bits
    want = maple_spgemm_numeric_plain(a.value, b.value, plan, cap=cap)
    _close(got[0], want, dtype)
    assert not got[0][plan.nnz_c:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", SPGEMM_KINDS)
def test_csr_sddmm_and_db_kernels_match_plain(cuda, kind, dtype):
    from repro_torch.kernels.maple_sddmm import (maple_sddmm_csr,
                                                 maple_sddmm_csr_plain)
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                                  maple_spgemm_db_plain)
    shape = (6, 80, 90) if kind == "wide" else (40, 36, 44)
    a, b, plan, rng = _spgemm_operands(cuda, kind, dtype, seed=1,
                                       shape=shape)
    dc = torch.from_numpy(rng.standard_normal(plan.nnz_c + 3).astype(
        np.float32)).to(cuda, dtype)
    for kernel, plain, other, n in (
            (maple_sddmm_csr, maple_sddmm_csr_plain, b.value, a.nnz_max),
            (maple_spgemm_db, maple_spgemm_db_plain, a.value, b.nnz_max)):
        before = kernel.launches
        got = [kernel(dc, other, plan, n_slots=n) for _ in range(2)]
        torch.cuda.synchronize()
        assert kernel.launches == before + 2
        assert torch.equal(got[0], got[1])
        _close(got[0], plain(dc, other, plan, n_slots=n), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 37, 64, 300])
@pytest.mark.parametrize("k", [25, 80])
def test_spmspm_ell_kernel_matches_plain(cuda, dtype, n, k):
    from repro_torch.core.formats import csr_to_ell
    from repro_torch.core.sparsity import element_pattern_mask
    from repro_torch.kernels.maple_spmspm import (maple_spmspm_ell,
                                                  maple_spmspm_ell_plain)
    rng = np.random.default_rng(2)
    mask = element_pattern_mask("power_law", rng, 30, k)
    mask[3] = False                                 # a row all pad
    if k > 32:
        mask[5, :45] = True                         # L > 32: two tiles
    a = _element_csr(cuda, mask, rng, dtype)
    values, col_ids = csr_to_ell(a)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(
        np.float32)).to(cuda, dtype)
    before = maple_spmspm_ell.launches
    got = maple_spmspm_ell(values, col_ids, b)
    torch.cuda.synchronize()
    assert maple_spmspm_ell.launches == before + 1
    # the same products and sums in the same order: the same bits
    assert torch.equal(got, maple_spmspm_ell_plain(values, col_ids, b))
    assert not got[3].any()


def test_maple_spgemm_on_the_card_matches_the_cpu(cuda):
    from repro_torch.kernels import maple_spgemm
    from repro_torch.kernels.maple_sddmm import maple_sddmm_csr
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                                  maple_spgemm_numeric)
    a, b, plan, _ = _spgemm_operands(cuda, "power_law", torch.float32,
                                     seed=3)
    results = {}
    for dev in ("cpu", cuda):
        av = a.value.detach().to(dev).clone().requires_grad_()
        bv = b.value.detach().to(dev).clone().requires_grad_()
        kernels = (maple_spgemm_numeric, maple_sddmm_csr, maple_spgemm_db)
        before = [k.launches for k in kernels]
        c = maple_spgemm(dataclasses.replace(a, value=av),
                         dataclasses.replace(b, value=bv), plan=plan)
        torch.sin(c.value).sum().backward()
        if dev == cuda:
            torch.cuda.synchronize()
            assert [k.launches - n for k, n in zip(kernels, before)] == \
                [1, 1, 1]
        results[str(dev)] = (c.value.detach().cpu(), av.grad.cpu(),
                             bv.grad.cpu())
    for got, want in zip(results["cuda"], results["cpu"]):
        _close(got, want, torch.float32)


def test_spgemm_psb_wider_than_shared_memory_raises(cuda):
    from repro_torch.kernels import maple_spgemm
    rng = np.random.default_rng(4)
    a = _element_csr(cuda, np.ones((1, 1), bool), rng, torch.float32)
    b = _element_csr(cuda, np.ones((1, 60_000), bool), rng, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        maple_spgemm(a, b)


def test_numeric_route_follows_the_rows_against_the_card(cuda):
    """B5's routes as the C side holds them, and its pick: 8 lanes a row
    where the rows at 8 lanes fill the card's threads at least once
    (cage12's 130 000 rows on an H100), else a warp a row (poisson3Da's
    14 000)."""
    from types import SimpleNamespace
    from repro_torch.kernels.maple_spgemm import numeric_route, numeric_routes
    assert numeric_routes() == [(8, 2, 3), (32, 4, 1)]
    props = torch.cuda.get_device_properties(cuda)
    fill = props.multi_processor_count * props.max_threads_per_multi_processor
    route = lambda m: numeric_route(SimpleNamespace(shape_a=(m, m)), cuda)
    assert [route(m) for m in (-(-fill // 8), fill // 8 - 1, 0)] == [0, 1, 1]
    if props.multi_processor_count == 132:
        assert [route(m) for m in (130_000, 14_000)] == [0, 1]


@pytest.mark.parametrize("route", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SPGEMM_SPLIT_CASES)
def test_spgemm_kernels_past_every_split(cuda, monkeypatch, case, dtype,
                                         route):
    """B5 on each of its routes (pinned: the plan would pick a warp a row
    at these sizes; ``numeric_routes`` lists them), B6 and dB, twice each (same bits), against their
    plain versions; B5 bit for bit (it rounds as its plain version does);
    dB writes 0 on the B rows no A slot consumes."""
    import sys
    monkeypatch.setattr(sys.modules["repro_torch.kernels.maple_spgemm"],
                        "numeric_route", lambda plan, device: route)
    from repro_torch.kernels import plan_spgemm
    from repro_torch.kernels.maple_sddmm import (maple_sddmm_csr,
                                                 maple_sddmm_csr_plain)
    from repro_torch.kernels.maple_spgemm import (maple_spgemm_db,
                                                  maple_spgemm_db_plain,
                                                  maple_spgemm_numeric,
                                                  maple_spgemm_numeric_plain)
    rng = np.random.default_rng(SPGEMM_SPLIT_CASES.index(case) + 40)
    am, bm = spgemm_split_masks(case, rng)
    a, b = _element_csr(cuda, am, rng, dtype), _element_csr(cuda, bm, rng,
                                                             dtype)
    plan = plan_spgemm(a, b, n_lanes=3)
    if case == "long_b_rows":
        assert plan.lb >= 48
    if case == "long_row":
        assert plan.lc > 256
    cap = plan.nnz_c + 5
    got = [maple_spgemm_numeric(a.value, b.value, plan, cap=cap)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], maple_spgemm_numeric_plain(
        a.value, b.value, plan, cap=cap))
    dc = torch.from_numpy(rng.standard_normal(cap).astype(np.float32)).to(
        cuda, dtype)
    for kernel, plain, other, n in (
            (maple_sddmm_csr, maple_sddmm_csr_plain, b.value, a.nnz_max),
            (maple_spgemm_db, maple_spgemm_db_plain, a.value, b.nnz_max)):
        got = [kernel(dc, other, plan, n_slots=n) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(got[0], got[1])
        _close(got[0], plain(dc, other, plan, n_slots=n), dtype)
    unused = ~am.any(axis=0)
    b_rows = np.repeat(np.arange(bm.shape[0]), bm.sum(axis=1))
    assert not got[0][:b.nnz][torch.from_numpy(unused[b_rows]).to(
        cuda)].any()


# --------------------------------------------------------------------------
# the MoE grouped GEMM (B8) and block-sparse local attention (B9)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sizes,d,f,bt", [
    ([256, 0, 384, 128], 256, 256, 128), ([128] * 4, 256, 256, 128),
    ([0, 0, 512, 0], 256, 256, 128),
    ([8, 0, 16, 8, 0, 8, 0, 8], 64, 32, 8),      # decode tile, smoke widths
    ([96, 96, 0], 100, 36, 96),                 # a 32-row tile, ragged F
    ([24, 8, 0], 20, 12, 8),                    # D and F below one panel
    ([8] * 48, 1536, 512, 8),                   # granite decode gate/up
    ([8] * 48, 512, 1536, 8),                   # granite decode down
    ([96] * 48, 1536, 512, 96),                 # granite prefill gate/up
    ([96] * 48, 512, 1536, 96),                 # granite prefill down
    ([128, 0, 128], 192, 320, 128),             # two n64 atoms
    ([384, 0, 384], 128, 64, 384),              # bt > 256: three pieces
    ([200, 0, 200], 64, 72, 200),               # a piece past the tile
    ([16, 16, 0], 72, 64, 16),                  # two n8 atoms
    ([48, 0, 48], 40, 24, 48),                  # ragged D in f32 and bf16
    ([32, 0, 32], 64, 64, 32)])                 # an n32 atom
def test_moe_gemm_kernel_matches_plain(cuda, dtype, sizes, d, f, bt):
    from repro_torch.kernels import moe_expert_gemm
    from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_plain
    from repro_torch.kernels.ops import expert_of_tile
    rng = np.random.default_rng(sum(sizes) + d)
    t = int(np.sum(sizes))
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((len(sizes), d, f))
                         .astype(np.float32) * 0.1)
    x, w = x.to(cuda, dtype), w.to(cuda, dtype)
    gs = torch.tensor(sizes, device=cuda)
    before = moe_gemm.launches
    got = [moe_expert_gemm(x, gs, w, bt=bt) for _ in range(2)]
    torch.cuda.synchronize()
    assert moe_gemm.launches == before + 2
    assert torch.equal(got[0], got[1])
    eot = expert_of_tile(gs, t // bt, bt)
    _close(got[0], moe_gemm_plain(x, eot, w, bt=bt), dtype)


def test_moe_route_matches_the_library(cuda):
    """The wrapper's route (piece, pieces, TMA or the producer's copies,
    stages, F tiles) is the one the C launcher plans."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gemm import moe_route
    lib = _build.library("moe_gemm")
    out = (ctypes.c_int * 5)()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for bt in (8, 16, 24, 40, 96, 128, 136, 384):
            for d, f in ((1536, 512), (100, 36), (20, 12), (0, 8)):
                for aligned in (True, False):
                    r = moe_route(dtype, 4 * bt, d, f, bt, aligned=aligned)
                    assert lib.maple_moe_layout(code, 4 * bt, d, f, bt,
                                                int(aligned), out) == 0
                    assert list(out) == [r["piece"], r["pieces"],
                                         int(r["copy"] == "tma"),
                                         r["stages"], r["f_tiles"]]


def test_moe_gemm_kernel_on_an_unaligned_input_and_zero_d(cuda):
    """A 16-byte-misaligned x takes the producer's copies; D = 0 gives
    zeros."""
    from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_plain
    rng = np.random.default_rng(3)
    for dtype in (torch.float32, torch.bfloat16):
        big = torch.from_numpy(rng.standard_normal(32 * 64 + 2)
                               .astype(np.float32)).to(cuda, dtype)
        x = big[2:].view(32, 64)
        w = torch.from_numpy(rng.standard_normal((2, 64, 48))
                             .astype(np.float32)).to(cuda, dtype)
        eot = torch.tensor([1, 0], dtype=torch.int32, device=cuda)
        got = [moe_gemm(x, eot, w, bt=16) for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(got[0], got[1])
        _close(got[0], moe_gemm_plain(x, eot, w, bt=16), dtype)
        y = moe_gemm(torch.zeros((16, 0), device=cuda, dtype=dtype), eot[:1],
                     torch.zeros((2, 0, 24), device=cuda, dtype=dtype), bt=16)
        torch.cuda.synchronize()
        assert y.shape == (16, 24) and not y.any()


def test_moe_gemm_kernel_refuses_a_tile_not_a_multiple_of_8(cuda):
    from repro_torch.kernels.moe_gemm import moe_gemm
    x = torch.zeros((12, 8), device=cuda)
    w = torch.zeros((2, 8, 4), device=cuda)
    eot = torch.zeros((4,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        moe_gemm(x, eot, w, bt=3)


def test_moe_layer_on_the_card_matches_the_cpu(cuda):
    from repro_torch.kernels.moe_gemm import moe_gemm
    from repro_torch.models import moe as M
    cfg = M.MoEConfig(d_model=48, n_experts=40, n_experts_padded=48,
                      top_k=8, d_expert=24, capacity_factor=0.5)
    p = M.init_moe(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 24, 48)).astype(np.float32))
    want = M.moe_layer(p, cfg, x)
    p_gpu = {k: v.to(cuda) for k, v in p.items()}
    before = moe_gemm.launches
    got = [M.moe_layer(p_gpu, cfg, x.to(cuda)) for _ in range(2)]
    torch.cuda.synchronize()
    assert moe_gemm.launches == before + 6
    assert torch.equal(got[0], got[1])
    _close(got[0].cpu(), want, torch.float32)


# (expert of each tile, E, D, F, bt): bt 8, 16, 56, 96 and 216 (two
# pieces of dx; dW's last stage past the tile), several tiles an expert,
# adjacent or not, experts with no tile, D and F off multiples of 16 (72 ×
# 40: TMA in both dtypes; 70 × 44: the producer's copies in both; 100 × 36
# and 200 × 300: TMA in f32, the copies in bf16), granite-moe-3b's training
# tile (56 rows at 1536 × 512)
MOE_BACKWARD = [([0, 0, 2], 3, 256, 128, 8), ([1, 1, 3, 3], 4, 72, 40, 16),
                ([0, 2, 2], 3, 70, 44, 96), ([1, 1], 3, 64, 48, 216),
                ([0, 0, 0, 2, 2], 4, 1536, 512, 56),
                ([3, 1, 3, 0, 3], 5, 72, 40, 56),
                ([2, 0, 2, 1, 2], 4, 70, 44, 8),
                ([0, 1, 0], 2, 100, 36, 216),
                ([1, 0, 1], 3, 200, 300, 96)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("eot,e,d,f,bt", MOE_BACKWARD)
def test_moe_backward_kernels_match_plain(cuda, dtype, eot, e, d, f, bt):
    """dx on B8's transposed-weight mode and dW on ``moe_dw_kernel``
    against their plain versions, each twice bit for bit; an expert with
    no tile gets a zero dW."""
    from repro_torch.kernels.moe_gemm import (moe_gemm, moe_gemm_dw,
                                              moe_gemm_dw_plain, moe_gemm_dx,
                                              moe_gemm_dx_plain)
    rng = np.random.default_rng(d + bt)
    t = len(eot) * bt
    x, dy = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
             .to(cuda, dtype) for shape in ((t, d), (t, f)))
    w = torch.from_numpy((rng.standard_normal((e, d, f)) * 0.1)
                         .astype(np.float32)).to(cuda, dtype)
    eot_t = torch.tensor(eot, dtype=torch.int32, device=cuda)
    before = moe_gemm.launches, moe_gemm_dw.launches
    dx = [moe_gemm_dx(dy, eot_t, w, bt=bt) for _ in range(2)]
    dw = [moe_gemm_dw(x, dy, eot_t, e, bt=bt) for _ in range(2)]
    torch.cuda.synchronize()
    assert (moe_gemm.launches, moe_gemm_dw.launches) == \
        (before[0] + 2, before[1] + 2)
    assert torch.equal(dx[0], dx[1]) and torch.equal(dw[0], dw[1])
    _close(dx[0], moe_gemm_dx_plain(dy, eot_t, w, bt=bt), dtype)
    _close(dw[0], moe_gemm_dw_plain(x, dy, eot_t, e, bt=bt), dtype)
    unused = sorted(set(range(e)) - set(eot))
    assert not dw[0][unused].any()


def test_moe_dx_route_matches_the_library(cuda):
    """dx's route (the transposed-weight mode) is the one the C launcher
    plans."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gemm import moe_route
    lib = _build.library("moe_gemm")
    out = (ctypes.c_int * 5)()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for bt in (8, 16, 56, 96, 216):
            for d, f in ((1536, 512), (70, 44), (72, 40)):
                for aligned in (True, False):
                    r = moe_route(dtype, 4 * bt, d, f, bt, aligned=aligned,
                                  transposed=True)
                    assert lib.maple_moe_layout_dx(code, 4 * bt, d, f, bt,
                                                   int(aligned), out) == 0
                    assert list(out) == [r["piece"], r["pieces"],
                                         int(r["copy"] == "tma"),
                                         r["stages"], r["f_tiles"]]


def test_moe_dw_route_matches_the_library(cuda):
    """dW's route is the one the C launcher plans."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gemm import moe_dw_route
    lib = _build.library("moe_gemm")
    out = (ctypes.c_int * 7)()
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        for bt in (3, 8, 16, 56, 96, 216):
            for d, f in ((1536, 512), (512, 1536), (70, 44), (72, 40),
                         (100, 36)):
                for aligned in (True, False):
                    r = moe_dw_route(dtype, 4 * bt, d, f, bt,
                                     aligned=aligned)
                    assert lib.maple_moe_layout_dw(code, 4 * bt, d, f, bt,
                                                   int(aligned), out) == 0
                    assert list(out) == [
                        r["rows"], r["stages_a_tile"],
                        int(r["copy"] == "tma"), r["stages"],
                        r["out_buffers"], r["d_tiles"], r["f_tiles"]]


def test_moe_gemm_gradients_on_the_card_match_the_cpu(cuda):
    """A backward through ``moe_gemm``'s Function: one dx and one dW
    launch, gradients within the f32 tolerance of the CPU's."""
    from repro_torch.kernels.moe_gemm import moe_gemm, moe_gemm_dw
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((48, 40)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 40, 24)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((48, 24)).astype(np.float32))
    eot = torch.tensor([2, 2, 0], dtype=torch.int32)
    grads = {}
    for dev in ("cpu", cuda):
        xs, ws = (t.detach().to(dev).requires_grad_() for t in (x, w))
        before = moe_gemm.launches, moe_gemm_dw.launches
        moe_gemm(xs, eot.to(dev), ws, bt=16).backward(g.to(dev))
        grads[str(dev)] = (xs.grad.cpu(), ws.grad.cpu())
        launched = (moe_gemm.launches - before[0],
                    moe_gemm_dw.launches - before[1])
        assert launched == ((0, 0) if dev == "cpu" else (2, 1))
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,w,bq,bk,h,hd", [
    (256, 64, 64, 64, 4, 32), (512, 128, 128, 128, 4, 32),
    (256, 40, 64, 64, 4, 32), (128, 128, 64, 64, 4, 32),
    (256, 40, 128, 64, 2, 32), (256, 100, 32, 128, 2, 64),
    (512, 200, 128, 128, 2, 256), (96, 30, 96, 48, 1, 20)])
def test_block_attention_kernel_matches_plain(cuda, dtype, s, w, bq, bk, h,
                                              hd):
    from repro_torch.kernels import local_window_kv_map
    from repro_torch.kernels.block_attn import (block_attention,
                                                block_attention_plain)
    rng = np.random.default_rng(s + w + bq)
    q, k, v = [torch.from_numpy(rng.standard_normal((2, s, h, hd))
                                .astype(np.float32)).to(cuda, dtype)
               for _ in range(3)]
    kv_map = torch.from_numpy(local_window_kv_map(s, w, bq, bk)).to(cuda)
    before = block_attention.launches
    got = [block_attention(q, k, v, kv_map, bq=bq, bk=bk, window=w)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert block_attention.launches == before + 2
    assert torch.equal(got[0], got[1])
    _close_attn(got[0], block_attention_plain(
        q, k, v, kv_map, bq=bq, bk=bk, window=w), dtype)


def test_block_attention_kernel_skips_pads_and_empty_rows(cuda):
    """Pads between live entries, a q-block with no live entry (its output
    is 0), and no causality."""
    from repro_torch.kernels.block_attn import (block_attention,
                                                block_attention_plain)
    rng = np.random.default_rng(5)
    q, k, v = [torch.from_numpy(rng.standard_normal((2, 256, 3, 16))
                                .astype(np.float32)).to(cuda)
               for _ in range(3)]
    kv_map = torch.tensor([[-1, 2, -1, 0], [3, -1, -1, -1],
                           [-1, -1, -1, -1], [1, 3, 2, 0]],
                          dtype=torch.int32, device=cuda)
    for causal, window in ((False, 0), (False, 90), (True, 0)):
        got = block_attention(q, k, v, kv_map, bq=64, bk=64, causal=causal,
                              window=window)
        torch.cuda.synchronize()
        _close(got, block_attention_plain(q, k, v, kv_map, bq=64, bk=64,
                                          causal=causal, window=window),
               torch.float32)
        assert not got[:, 128:192].any()


def test_block_attention_kernel_refuses_wide_heads(cuda):
    from repro_torch.kernels import local_block_attention
    q = torch.zeros((1, 64, 1, 260), device=cuda)
    with pytest.raises(ValueError, match="multiple of 4 up to 256"):
        local_block_attention(q, q, q, window=16, bq=16, bk=16)


# --------------------------------------------------------------------------
# B9 and B6 on their Hopper layouts: every geometry branch, both dtypes
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,bq,bk,causal,w", [
    (20, 64, 32, True, 50), (64, 96, 48, True, 100),
    (128, 128, 64, True, 0), (256, 64, 128, True, 150),
    (256, 256, 128, True, 300),            # a q-block of two 128-row CTAs
    (64, 128, 128, False, 0), (128, 32, 64, False, 70),
    (256, 128, 96, False, 200)])
def test_block_attention_kernel_on_every_geometry(cuda, dtype, hd, bq, bk,
                                                  causal, w):
    """Head dims over 1, 2, 4 and 8 column blocks (hd 20 in bf16: the
    producer's own loads), bq != bk, slices, no causality with and
    without a window, any kv_map row: rerun bit-identical."""
    from repro_torch.kernels.block_attn import (block_attention,
                                                block_attention_plain)
    s = 768
    rng = np.random.default_rng(hd + bq + bk + w)
    q, k, v = [torch.from_numpy(rng.standard_normal((2, s, 3, hd))
                                .astype(np.float32)).to(cuda, dtype)
               for _ in range(3)]
    nq, nk = s // bq, s // bk
    kv = np.full((nq, 5), -1, np.int32)
    for i in range(nq):                    # live entries in any order, pads
        ids = rng.choice(nk, size=min(4, nk), replace=False)
        kv[i, rng.choice(5, size=len(ids), replace=False)] = ids
    kv_map = torch.from_numpy(kv).to(cuda)
    got = [block_attention(q, k, v, kv_map, bq=bq, bk=bk, causal=causal,
                           window=w) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(got[0], got[1])
    _close_attn(got[0], block_attention_plain(
        q, k, v, kv_map, bq=bq, bk=bk, causal=causal, window=w), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_attention_kernel_rows_that_see_no_key(cuda, dtype):
    """A CTA whose rows see no key (only blocks above the diagonal, or
    behind the window), a warpgroup that sees none of a chunk its CTA
    walks, and a q-block with no live entry: their outputs are 0."""
    from repro_torch.kernels.block_attn import (block_attention,
                                                block_attention_plain)
    rng = np.random.default_rng(11)
    q, k, v = [torch.from_numpy(rng.standard_normal((1, 512, 2, 256))
                                .astype(np.float32)).to(cuda, dtype)
               for _ in range(3)]
    kv_map = torch.tensor([[3, 2, -1], [0, 1, -1], [-1, -1, -1], [3, 0, -1]],
                          dtype=torch.int32, device=cuda)
    got = block_attention(q, k, v, kv_map, bq=128, bk=128, window=200)
    torch.cuda.synchronize()
    _close_attn(got, block_attention_plain(q, k, v, kv_map, bq=128,
                                           bk=128, window=200), dtype)
    assert not got[:, :128].any() and not got[:, 256:384].any()


# B9's layout (csrc/block_attn.cu::layout): 1 KB of alignment slack, Q
# (blocks × 128 rows × 128 B), in f32 the P, correction and row-sum
# buffers (32 768 + 1 536 B), 13 mbarriers (104 B), then as many K / V
# stages (blocks × keys × 128 B) as fit in 232 448 B, at most 6.
@pytest.mark.parametrize("dtype,hd,bq,blocks,keys,stages,smem,ctas,tma", [
    # recurrentgemma-9b: 1024 + 131072 + 34304 + 104 = 166504, and two
    # 32 KB stages of 32 keys × 8 blocks
    (torch.float32, 256, 128, 8, 32, 2, 166504 + 2 * 32768, 1, 1),
    # bf16: 1024 + 65536 + 104 = 66664, five 32 KB stages of 64 keys
    (torch.bfloat16, 256, 128, 4, 64, 5, 66664 + 5 * 32768, 1, 1),
    (torch.float32, 128, 64, 4, 32, 6,
     1024 + 65536 + 34304 + 104 + 6 * 16384, 1, 1),
    (torch.float32, 96, 256, 4, 32, 6, 199272, 2, 1),   # 3 blocks: 4
    (torch.float32, 20, 96, 1, 32, 6,
     1024 + 16384 + 34304 + 104 + 6 * 4096, 1, 1),
    (torch.bfloat16, 64, 32, 1, 64, 6, 1024 + 16384 + 104 + 6 * 8192, 1, 1),
    # hd 20 in bf16: 40-byte rows, which TMA cannot stride
    (torch.bfloat16, 20, 48, 1, 64, 6, 1024 + 16384 + 104 + 6 * 8192, 1, 0),
    (torch.bfloat16, 200, 384, 4, 64, 5, 230504, 3, 1)])
def test_block_attention_layout_by_hand(cuda, dtype, hd, bq, blocks, keys,
                                        stages, smem, ctas, tma):
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.library("block_attn")
    code = 0 if dtype == torch.float32 else 1
    out = (ctypes.c_int * 6)()
    assert lib.maple_block_attention_layout(code, hd, bq, out) == 0
    assert list(out) == [blocks, keys, stages, smem, ctas, tma]


def test_block_attention_layout_fits_and_refuses(cuda):
    """Every head dim the kernel takes fits one CTA with a ring of 2 to 6
    stages; the rest are refused."""
    import ctypes
    from repro_torch.kernels import _build
    lib = _build.library("block_attn")
    out = (ctypes.c_int * 6)()
    for code in (0, 1):
        for hd in range(4, 257, 4):
            assert lib.maple_block_attention_layout(code, hd, 128, out) == 0
            assert 2 <= out[2] <= 6 and out[3] <= 232448
        for hd, bq in ((260, 128), (30, 128), (0, 128), (64, 0)):
            assert lib.maple_block_attention_layout(code, hd, bq, out) != 0
    assert lib.maple_block_attention_layout(2, 64, 128, out) != 0


def _long_row_operands(cuda, dtype, b_density, seed):
    """A (30 × 40) with empty rows and B (40 × 120) whose rows hold
    about 120·b_density entries (some over 32)."""
    from repro_torch.kernels import plan_spgemm
    rng = np.random.default_rng(seed)
    am = rng.random((30, 40)) < 0.3
    am[::7] = False                                  # empty A rows
    bm = rng.random((40, 120)) < b_density
    bm[3] = True                                     # a 120-entry B row
    a = _element_csr(cuda, am, rng, dtype)
    b = _element_csr(cuda, bm, rng, dtype)
    return a, b, plan_spgemm(a, b, n_lanes=3), rng


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_density", [0.1, 0.3, 0.6])
def test_csr_sddmm_kernel_long_b_rows(cuda, dtype, b_density):
    """B6's lane groups of 8 on B rows longer than their three steps (24
    terms) and than a warp, and on empty A rows (4 rows a warp, some of
    them empty): against the plain version, rerun bit-identical."""
    from repro_torch.kernels.maple_sddmm import (maple_sddmm_csr,
                                                 maple_sddmm_csr_plain)
    a, b, plan, rng = _long_row_operands(cuda, dtype, b_density, 7)
    assert plan.lb > 3 * 8 and plan.lb > 32
    dc = torch.from_numpy(rng.standard_normal(plan.nnz_c).astype(
        np.float32)).to(cuda, dtype)
    before = maple_sddmm_csr.launches
    got = [maple_sddmm_csr(dc, b.value, plan, n_slots=a.nnz_max)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert maple_sddmm_csr.launches == before + 2
    assert torch.equal(got[0], got[1])
    _close(got[0], maple_sddmm_csr_plain(dc, b.value, plan,
                                         n_slots=a.nnz_max), dtype)
    assert not got[0][a.nnz:].any()
