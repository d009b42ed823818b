"""Port parity: ``repro_torch.core.csr`` against ``repro.core.csr``.

``BlockCSR.from_dense`` must give the reference's metadata and payload
bit for bit, pad slots and empty block-rows included, and the pad
contract check must refuse what the reference refuses.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.core.csr import BlockCSR as RefBlockCSR
from repro_torch.core.csr import BlockCSR


def _dense(kind, rng, gm=5, gk=7, bm=8, bk=8, dtype=np.float32):
    mask = rng.random((gm, gk)) < 0.4
    if kind == "empty_rows":
        mask[::2] = False
    elif kind == "all_zero":
        mask[:] = False
    elif kind == "full":
        mask[:] = True
    d = rng.standard_normal((gm * bm, gk * bk)).astype(dtype)
    return d * np.repeat(np.repeat(mask, bm, 0), bk, 1).astype(dtype)


@pytest.mark.parametrize("kind", ["uniform", "empty_rows", "all_zero", "full"])
@pytest.mark.parametrize("extra_pad", [0, 3])
@pytest.mark.parametrize("block", [(8, 8), (4, 16)])
def test_block_csr_from_dense_is_bit_identical(kind, extra_pad, block):
    d = _dense(kind, np.random.default_rng(1), bm=block[0], bk=block[1])
    nnzb = int((np.abs(d.reshape(5, block[0], 7, block[1]))
                .sum(axis=(1, 3)) != 0).sum())
    cap = max(nnzb, 1) + extra_pad
    ref = RefBlockCSR.from_dense(d, block, n_blocks_max=cap)
    got = BlockCSR.from_dense(d, block, n_blocks_max=cap, device="cpu")
    for name in ("block_col", "block_row", "row_ptr"):
        r, g = np.asarray(getattr(ref, name)), getattr(got, name)
        assert g.dtype == r.dtype and np.array_equal(g, r), name
    assert np.array_equal(got.blocks.numpy(), np.asarray(ref.blocks))
    assert got.blocks.dtype == torch.float32
    assert (got.shape, got.block_shape) == (ref.shape, ref.block_shape)
    assert np.array_equal(got.to_dense().numpy(), np.asarray(ref.to_dense()))
    got.check_pad_contract()


def test_block_csr_default_capacity_and_tensor_input():
    d = _dense("uniform", np.random.default_rng(2))
    ref = RefBlockCSR.from_dense(d, (8, 8))
    got = BlockCSR.from_dense(torch.from_numpy(d), (8, 8))
    assert got.blocks.device.type == "cpu"      # the tensor's device
    assert got.n_blocks_max == ref.n_blocks_max
    assert np.array_equal(got.blocks.numpy(), np.asarray(ref.blocks))
    zero = BlockCSR.from_dense(np.zeros((16, 16), np.float32), (8, 8),
                               device="cpu")
    assert zero.n_blocks_max == 1 and zero.block_col.tolist() == [-1]
    assert zero.block_row.tolist() == [1] and zero.row_ptr.tolist() == [0] * 3


def test_block_csr_rejects_bad_shapes_like_the_reference():
    d = np.ones((12, 16), np.float32)
    for cls, kw in ((RefBlockCSR, {}), (BlockCSR, {"device": "cpu"})):
        with pytest.raises(ValueError, match="not divisible"):
            cls.from_dense(d, (8, 8), **kw)
        with pytest.raises(ValueError, match="n_blocks_max"):
            cls.from_dense(np.ones((16, 16), np.float32), (8, 8),
                           n_blocks_max=2, **kw)


@pytest.mark.parametrize("breakage,match", [
    ("row_ptr", "monotone"), ("col_range", "out of range"),
    ("row_owner", "disagrees"), ("pad_col", "pad block_col"),
    ("pad_row", "pad block_row"), ("pad_payload", "pad blocks")])
def test_check_pad_contract_refuses_what_the_reference_refuses(breakage,
                                                               match):
    d = _dense("uniform", np.random.default_rng(3))
    got = BlockCSR.from_dense(d, (8, 8), n_blocks_max=30, device="cpu")
    nnzb = got.nnzb
    meta = {k: getattr(got, k).copy()
            for k in ("block_col", "block_row", "row_ptr")}
    blocks = got.blocks.clone()
    if breakage == "row_ptr":
        meta["row_ptr"][1] = meta["row_ptr"][2] + 1
    elif breakage == "col_range":
        meta["block_col"][0] = got.n_block_cols
    elif breakage == "row_owner":
        meta["block_row"][0] += 1
    elif breakage == "pad_col":
        meta["block_col"][nnzb] = 0
    elif breakage == "pad_row":
        meta["block_row"][nnzb] = 0
    else:
        blocks[nnzb] = 1.0
    bad = dataclasses.replace(got, blocks=blocks, **meta)
    ref_bad = RefBlockCSR(np.asarray(blocks), meta["block_col"],
                          meta["block_row"], meta["row_ptr"], got.shape,
                          got.block_shape)
    with pytest.raises(ValueError, match=match):
        ref_bad.check_pad_contract()
    with pytest.raises(ValueError, match=match):
        bad.check_pad_contract()


def test_stacked_layers_share_metadata():
    d = _dense("uniform", np.random.default_rng(4))
    one = BlockCSR.from_dense(d, (8, 8), device="cpu")
    stacked = dataclasses.replace(one, blocks=torch.stack([one.blocks,
                                                           2 * one.blocks]))
    assert stacked.stacked and not one.stacked
    assert torch.equal(stacked.layer(1).to_dense(), 2 * one.to_dense())
    assert torch.equal(stacked.to_dense()[0], one.to_dense())
    with pytest.raises(ValueError):
        one.layer(0)



@pytest.mark.parametrize("kind", ["uniform", "empty_rows", "all_zero", "full"])
def test_block_csr_density_equals_reference(kind):
    d = _dense(kind, np.random.default_rng(7))
    ref = RefBlockCSR.from_dense(d, (8, 8), n_blocks_max=40)
    got = BlockCSR.from_dense(d, (8, 8), n_blocks_max=40, device="cpu")
    assert got.density() == ref.density()
