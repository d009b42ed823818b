"""The host's half of the B3 and B8 launches, and the kernels' build
names, on the CPU.

* ``maple_spmm.naive_route``: B3's consumer, N tile, whether batches fold
  side by side (the skinny tile, wgmma's n8 tile) or stay in the grid, the
  batch groups, how B's panels are copied, the ring's stages.
* ``moe_gemm.moe_route``: B8's token piece (and pieces past 128 tokens),
  consumer, register tile, TMA or the producer's copies, stages.
* ``_build._target``: a library's name covers its source and every header
  the source includes, so an edited header rebuilds.

The card tests ``test_naive_route_matches_the_library`` and
``test_moe_route_matches_the_library`` hold these functions against the C
launchers' own plans.
"""

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.maple_spmm import naive_route
from repro_torch.kernels.moe_gemm import moe_route

F32, BF16 = torch.float32, torch.bfloat16
MLP_K = 9728                   # qwen3-4b's d_ff: the MLP down-projection's K


def _route(dtype, g, n, *, block=(64, 64), k=MLP_K, gm=40, **kw):
    kw.setdefault("n_slots", 1521)
    kw.setdefault("sms", 132)
    return naive_route(dtype, g, gm, n, k, *block, 128, **kw)


@pytest.mark.parametrize("dtype,g,n,consumer,fold,groups,copy,split", [
    # decode: each weight block read once, 4 columns over 4 warps
    (F32, 4, 1, "skinny", 4, 1, "bulk", True),
    (F32, 3, 1, "skinny", 4, 1, "bulk", True),     # one column idle
    (F32, 8, 1, "skinny", 4, 2, "bulk", True),     # more batches than columns
    (F32, 4, 2, "skinny", 2, 2, "bulk", False),
    (F32, 3, 3, "skinny", 1, 3, "bulk", False),
    (F32, 1, 4, "skinny", 1, 1, "bulk", False),
    (BF16, 4, 1, "wgmma", 8, 1, "tma", False),     # n8: one (8, 64) box
    (BF16, 9, 1, "wgmma", 8, 2, "tma", False),
    (BF16, 4, 2, "wgmma", 4, 1, "bulk", False),
    (BF16, 2, 8, "wgmma", 1, 2, "bulk", False)])
def test_naive_route_folds_narrow_batches(dtype, g, n, consumer, fold,
                                          groups, copy, split):
    r = _route(dtype, g, n)
    assert (r["consumer"], r["fold"], r["groups"], r["copy"],
            r["split"]) == (consumer, fold, groups, copy, split)
    assert r["fold"] * n <= r["tile"] and r["groups"] * r["fold"] >= g
    assert r["n_tiles"] == 1


@pytest.mark.parametrize("dtype,n,consumer,tile,copy", [
    (F32, 112, "ffma", 128, "tma"),    # serve's prefill: 4 prompts of 112
    (F32, 128, "ffma", 128, "tma"),
    (BF16, 112, "wgmma", 128, "tma"),
    (BF16, 64, "wgmma", 64, "tma"),
    (F32, 5, "ffma", 16, "bulk"),      # 20-byte rows: one contiguous panel
    (F32, 201, "ffma", 128, "producer"),   # ragged rows over two N tiles
    (BF16, 17, "wgmma", 64, "producer")])
def test_naive_route_keeps_wide_batches_in_the_grid(dtype, n, consumer,
                                                    tile, copy):
    r = _route(dtype, 4, n)
    assert (r["consumer"], r["tile"], r["copy"]) == (consumer, tile, copy)
    assert r["fold"] == 0 and r["groups"] == 4


def test_naive_route_folds_whatever_g_is_and_column_sums_do_not_see_it():
    """The fold only places batches side by side: the consumer, tile and
    per-column layout (rows N apart) are those of G = 1."""
    one = _route(F32, 1, 1)
    for g in (2, 3, 4, 7):
        r = _route(F32, g, 1)
        assert (r["consumer"], r["tile"], r["frag"]) == (
            one["consumer"], one["tile"], one["frag"])


@pytest.mark.parametrize("dtype,n,k,aligned,want", [
    (F32, 1, MLP_K, True, "bulk"),
    (F32, 1, MLP_K, False, "producer"),      # B not 16-byte aligned
    (BF16, 1, 64 * 41 + 4, True, "producer"),   # batch g's panel misaligned
    (BF16, 1, MLP_K, False, "producer"),
    (F32, 3, 64 * 40, True, "bulk"),
    (BF16, 3, 64 * 40, True, "bulk")])
def test_naive_route_copies_folded_panels_or_leaves_them_to_the_producer(
        dtype, n, k, aligned, want):
    assert _route(dtype, 4, n, k=k, aligned=aligned)["copy"] == want


def test_naive_route_rings_deep_at_decode_and_shallow_at_prefill():
    decode, prefill = _route(F32, 4, 1), _route(F32, 4, 128)
    assert decode["ctas"] == 4 * 40 and decode["stages"] == 4
    assert prefill["ctas"] == 4 * 40 * 4 and prefill["stages"] == 2


def test_naive_route_narrows_the_tile_like_the_run_walk():
    """Few rows at wide N: the N tile halves until the grid fills the
    card, as for B1 and B4 (``walk_tile``)."""
    r = _route(F32, 1, 256, gm=8)
    assert r["tile"] == 32 and r["n_tiles"] == 8


def test_naive_route_keeps_tall_blocks_at_n1_in_the_grid():
    """The split skinny tile takes rows of up to 64: a 128-row block at
    N = 1 runs unfolded, one batch a cluster."""
    r = _route(F32, 4, 1, block=(128, 32))
    assert (r["consumer"], r["fold"], r["groups"], r["split"]) == (
        "skinny", 0, 4, False)
    assert _route(F32, 4, 2, block=(128, 32))["fold"] == 2


def test_naive_route_refuses_a_tile_no_consumer_takes():
    with pytest.raises(ValueError, match="no FFMA register tile"):
        _route(F32, 1, 64, block=(1024, 8))


@pytest.mark.parametrize("bt,piece,pieces", [
    (8, 8, 1), (16, 16, 1), (24, 32, 1), (40, 64, 1), (96, 96, 1),
    (128, 128, 1), (136, 128, 2), (264, 128, 3), (384, 128, 3)])
def test_moe_route_pieces_cover_the_token_tile(bt, piece, pieces):
    r = moe_route(BF16, 4 * bt, 1536, 512, bt)
    assert (r["piece"], r["pieces"]) == (piece, pieces)
    assert r["piece"] * r["pieces"] >= bt
    assert r["piece"] * (r["pieces"] - 1) < bt


@pytest.mark.parametrize("dtype,d,f,aligned,copy", [
    (BF16, 1536, 512, True, "tma"), (F32, 1536, 512, True, "tma"),
    (BF16, 100, 36, True, "producer"),     # 200-byte rows
    (F32, 100, 36, True, "tma"),           # 400 and 144 bytes
    (BF16, 20, 12, True, "producer"),
    (BF16, 1536, 512, False, "producer"),
    (F32, 0, 64, True, "producer")])       # nothing to load
def test_moe_route_takes_tma_only_where_the_strides_allow(dtype, d, f,
                                                          aligned, copy):
    assert moe_route(dtype, 96, d, f, 96, aligned=aligned)["copy"] == copy


@pytest.mark.parametrize("dtype,bt,consumer,tile,stages", [
    (BF16, 96, "wgmma", None, 2), (BF16, 8, "wgmma", None, 5),
    (F32, 96, "ffma", (8, 8), 2), (F32, 8, "ffma", (1, 4), 2),
    (F32, 64, "ffma", (4, 8), 3), (F32, 128, "ffma", (8, 8), 2)])
def test_moe_route_consumer_and_ring(dtype, bt, consumer, tile, stages):
    r = moe_route(dtype, 48 * bt, 1536, 512, bt)
    assert (r["consumer"], r["register_tile"], r["stages"]) == (
        consumer, tile, stages)
    assert r["f_tiles"] == 8


@pytest.mark.parametrize("t,bt", [(96, 12), (100, 8), (96, 0)])
def test_moe_route_refuses_a_bad_token_tile(t, bt):
    with pytest.raises(ValueError, match="multiple of 8"):
        moe_route(BF16, t, 64, 64, bt)


def test_build_target_covers_the_headers_a_source_includes(tmp_path,
                                                           monkeypatch):
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include <cuda.h>\n#include "a.cuh"\n'
                                   'int main() { return 0; }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n  # include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    (tmp_path / "other.cuh").write_text("// not included\n")
    assert [p.name for p in _build._sources("k")] == ["k.cu", "a.cuh",
                                                       "b.cuh"]
    first = _build._target("k")
    assert _build._target("k") == first
    (tmp_path / "other.cuh").write_text("// edited, still not included\n")
    assert _build._target("k") == first
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    second = _build._target("k")
    assert second != first and second.name.startswith("libk-")
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n// a\n')
    assert _build._target("k") not in (first, second)


def test_build_target_of_the_ring_kernels_names_the_shared_header():
    for name in ("maple_spmm", "moe_gemm", "block_attn"):
        assert [p.name for p in _build._sources(name)] == [f"{name}.cu",
                                                           "hopper.cuh"]
    assert [p.name for p in _build._sources("maple_spgemm")] == [
        "maple_spgemm.cu"]
