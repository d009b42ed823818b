"""The Hopper kernels (SpMM forward, block SDDMM and the maple_spmm
backward) against their plain versions, on the card.

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
from repro_torch.kernels import (maple_spmm, maple_spmm_compact,
                                 maple_spmm_naive, plan_spmm)
from repro_torch.kernels.maple_spmm import (maple_spmm_compact_plain,
                                            maple_spmm_naive_plain)
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


def test_maple_spmm_on_the_card_matches_the_cpu(cuda):
    a, rng = _operands(cuda, 2, 10, 6, (8, 8), 0.4, torch.float32)
    a_cpu = dataclasses.replace(a, blocks=a.blocks.cpu(), device_meta={})
    b = rng.standard_normal((2, a.shape[1], 19)).astype(np.float32)
    for kw in (dict(schedule="naive"), dict(n_lanes=8, chunk=1),
               dict(schedule="row_atomic")):
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

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block,bn,g,n,density", [
    ((8, 8), 16, 3, 21, 0.5), ((8, 8), 16, 1, 1, 0.5),
    ((64, 64), 128, 1, 256, 0.3), ((16, 32), 64, 2, 70, 0.4),
    ((8, 8), 16, 2, 40, 0.0)])
def test_sddmm_kernel_matches_plain(cuda, dtype, block, bn, g, n, density):
    from repro_torch.kernels import maple_sddmm_bsr
    from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr_plain
    a, rng = _operands(cuda, 4, 6, 5, block, density, dtype)
    bm, bk = block
    dc = torch.from_numpy(rng.standard_normal((g, a.shape[0], n))
                          .astype(np.float32)).to(cuda, dtype)
    b3 = torch.from_numpy(rng.standard_normal((g, a.shape[1], n))
                          .astype(np.float32)).to(cuda, dtype)
    br = torch.from_numpy(a.block_row).to(cuda)
    bc = torch.from_numpy(a.block_col).to(cuda)
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
        before = (maple_spmm_compact.launches, maple_sddmm_bsr.launches)
        out = maple_spmm(w, bt, bn=16, plan=plan_spmm_vjp(w, n_lanes=4))
        (out * torch.from_numpy(cot).to(dev)).sum().backward()
        if dev == cuda:
            torch.cuda.synchronize()
            # forward and dB on the compact kernel, dA on the SDDMM
            assert (maple_spmm_compact.launches - before[0],
                    maple_sddmm_bsr.launches - before[1]) == (2, 1)
        grads[str(dev)] = (blocks.grad.cpu(), bt.grad.cpu())
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _close(got, want, torch.float32)
