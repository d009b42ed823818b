"""Port parity: the storage formats (``repro_torch.core.formats``) against
``repro.core.formats``.

Metadata and payloads of ``EllPack`` and ``BitmapBlocked``, their
conversions, pad-contract checks and the format-independent pattern view
are exactly the reference's; ``maple_spmm`` on an ELL or bitmap operand
equals the ``BlockCSR`` route bit for bit within the port and agrees with
the reference within 1e-5.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as ref_formats
from repro.core.sparsity import block_pattern_mask
from repro.kernels import maple_spmm as ref_maple_spmm
from repro.kernels.schedule import pattern_fingerprint as ref_fingerprint
from repro_torch.core import formats
from repro_torch.core.csr import BlockCSR
from repro_torch.kernels import maple_spmm, pattern_fingerprint, plan_spmm

GM, GK, BM, BK = 8, 6, 4, 4
KINDS = ("uniform", "power_law", "banded", "empty_rows", "all_zero")


def _dense(kind, seed=0):
    """A golden block pattern with ~40% element zeros inside live blocks
    (the pad contracts and the lowering must survive them)."""
    rng = np.random.default_rng(seed)
    mask = block_pattern_mask("uniform" if kind in ("empty_rows", "all_zero")
                              else kind, rng, GM, GK)
    if kind == "empty_rows":
        mask[1] = mask[4] = False
    elif kind == "all_zero":
        mask[:] = False
    d = rng.standard_normal((GM * BM, GK * BK)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, BM, 0), BK, 1)
    return d * (rng.random(d.shape) < 0.6)


def _both(fmt, d, **kw):
    return (ref_formats.from_dense(d, (BM, BK), format=fmt, **kw),
            formats.from_dense(d, (BM, BK), format=fmt, device="cpu", **kw))


def _assert_same(got, want):
    """Field-by-field equality of a port container and a reference one."""
    assert type(got).__name__ == type(want).__name__
    assert tuple(got.shape) == tuple(want.shape)
    assert tuple(got.block_shape) == tuple(want.block_shape)
    for f in dataclasses.fields(got):
        if f.name in ("shape", "block_shape", "device_meta"):
            continue
        g, w = getattr(got, f.name), np.asarray(getattr(want, f.name))
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.dtype == w.dtype and np.array_equal(g, w), f.name


@pytest.mark.parametrize("fmt", ["bcsr", "ell", "bitmap"])
@pytest.mark.parametrize("kind", KINDS)
def test_from_dense_and_round_trip_equal_reference(kind, fmt):
    d = _dense(kind, seed=KINDS.index(kind))
    want, got = _both(fmt, d)
    _assert_same(got, want)
    assert np.array_equal(got.to_dense().numpy(), d)
    got.check_pad_contract()
    if fmt != "bcsr":
        assert got.density() == want.density()
        _assert_same(got.to_block_csr(), want.to_block_csr())
        _assert_same(got.to_block_csr(n_blocks_max=40),
                     want.to_block_csr(n_blocks_max=40))


@pytest.mark.parametrize("kind", KINDS)
def test_converters_and_pattern_view_equal_reference(kind):
    d = _dense(kind, seed=10 + KINDS.index(kind))
    ref_b = ref_formats.from_dense(d, (BM, BK), n_blocks_max=50)
    b = formats.from_dense(d, (BM, BK), n_blocks_max=50, device="cpu")
    ref_ell, ell = ref_formats.to_ell(ref_b), formats.to_ell(b)
    _assert_same(ell, ref_ell)
    _assert_same(formats.to_ell(b, width=GK), ref_formats.to_ell(ref_b,
                                                                 width=GK))
    ref_bmp, bmp = ref_formats.to_bitmap(ref_ell), formats.to_bitmap(ell)
    _assert_same(bmp, ref_bmp)
    _assert_same(formats.to_bitmap(b), ref_formats.to_bitmap(ref_b))
    _assert_same(formats.as_block_csr(bmp), ref_formats.as_block_csr(ref_bmp))
    for got, want in ((b, ref_b), (ell, ref_ell), (bmp, ref_bmp)):
        for g, w in zip(formats.block_pattern_meta(got),
                        ref_formats.block_pattern_meta(want)):
            assert np.array_equal(np.asarray(g), np.asarray(w))
        assert pattern_fingerprint(got) == ref_fingerprint(want)
    assert len({pattern_fingerprint(x) for x in (b, ell, bmp)}) == 1
    e, ref_e = formats.as_element_csr(ell), ref_formats.as_element_csr(
        ref_ell)
    assert np.array_equal(e.col_id, np.asarray(ref_e.col_id))
    assert np.array_equal(e.row_ptr, np.asarray(ref_e.row_ptr))
    assert np.array_equal(e.value.numpy(), np.asarray(ref_e.value))


@pytest.mark.parametrize("fmt", ["ell", "bitmap"])
def test_pad_contract_checks_raise_like_the_reference(fmt):
    """Each corruption raises the same message in both packages (the
    reference's fields copied to writable numpy first)."""
    d = _dense("uniform", seed=3)
    kw = {"width": GK} if fmt == "ell" else {"n_blocks_max": 40}
    _, port0 = _both(fmt, d, **kw)
    if fmt == "ell":
        live = port0.block_col >= 0
        r = int(np.nonzero(~live.all(axis=1))[0][0])
        t = int(live[r].sum())                     # the row's first dead slot
        cases = [("dead block_col must be -1", "block_col", (r, t), -2),
                 ("contiguous prefix", "block_col", (r, t), 0),
                 ("out of range", "block_col", (r, 0), GK),
                 ("dead-slot blocks must be 0", "blocks", (r, t), 1.0)]
    else:
        cases = [("pad blocks must be 0", "blocks", 39, 1.0)]
    for match, field, idx, value in cases:
        ref_c, c = _both(fmt, d, **kw)
        ref_c = dataclasses.replace(ref_c, **{
            field: np.array(getattr(ref_c, field))})
        getattr(ref_c, field)[idx] = value
        getattr(c, field)[idx] = value
        if match == "contiguous prefix":
            ref_c.block_col[r, t - 1] = c.block_col[r, t - 1] = -1
        with pytest.raises(ValueError, match=match):
            ref_c.check_pad_contract()
        with pytest.raises(ValueError, match=match):
            c.check_pad_contract()
    with pytest.raises(ValueError, match="width"):
        formats.EllPack.from_dense(d, (BM, BK), width=1, device="cpu")


@pytest.mark.parametrize("kind", ["uniform", "power_law", "empty_rows"])
def test_spmm_on_ell_and_bitmap_equals_the_block_csr_route(kind):
    d = _dense(kind, seed=20 + KINDS.index(kind))
    b = np.random.default_rng(5).standard_normal((2, GK * BK, 7)).astype(
        np.float32)
    bt = torch.from_numpy(b)
    base = formats.from_dense(d, (BM, BK), device="cpu")
    want = maple_spmm(base, bt, bn=16)
    for fmt in ("ell", "bitmap"):
        op = formats.from_dense(d, (BM, BK), format=fmt, device="cpu")
        assert torch.equal(maple_spmm(op, bt, bn=16), want)
        assert torch.equal(maple_spmm(op, bt, bn=16,
                                      plan=plan_spmm(op, n_lanes=3)),
                           maple_spmm(base, bt, bn=16,
                                      plan=plan_spmm(base, n_lanes=3)))
        ref_op = ref_formats.from_dense(d, (BM, BK), format=fmt)
        ref = np.asarray(ref_maple_spmm(ref_op, jnp.asarray(b), bn=16))
        np.testing.assert_allclose(want.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_spmm_on_ell_is_differentiable_in_its_payload():
    d = _dense("uniform", seed=6)
    ell = formats.from_dense(d, (BM, BK), format="ell", device="cpu")
    blocks = ell.blocks.clone().requires_grad_()
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (GK * BK, 5)).astype(np.float32))
    maple_spmm(dataclasses.replace(ell, blocks=blocks), b).sum().backward()
    live = torch.from_numpy(ell.block_col >= 0)
    want = torch.ones(GM * BM, 5) @ b.T             # d(sum)/dA, dense
    dense_grad = want.reshape(GM, BM, GK, BK).transpose(1, 2)
    r, t = np.nonzero(ell.block_col >= 0)
    assert torch.allclose(blocks.grad[r, t],
                          dense_grad[r, ell.block_col[r, t]], atol=1e-5)
    assert not blocks.grad[~live].any()


def test_front_door_and_misuse_raise_like_the_reference():
    d = _dense("uniform", seed=7)
    c, ref_c = formats.from_dense(d, format="csr", device="cpu"), \
        ref_formats.from_dense(d, format="csr")
    assert np.array_equal(c.col_id, np.asarray(ref_c.col_id))
    for kw, exc, match in ((dict(format="ell"), ValueError, "block_shape"),
                           (dict(format="x", block_shape=(BM, BK)),
                            ValueError, "unknown format"),
                           (dict(format="csr", block_shape=(BM, BK)),
                            ValueError, "element-granular")):
        with pytest.raises(exc, match=match):
            ref_formats.from_dense(d, **kw)
        with pytest.raises(exc, match=match):
            formats.from_dense(d, device="cpu", **kw)
    b = formats.from_dense(d, (BM, BK), device="cpu")
    with pytest.raises(ValueError, match="re-pad"):
        formats.as_block_csr(b, n_blocks_max=99)
    with pytest.raises(TypeError, match="not a blocked sparse format"):
        formats.as_block_csr(np.zeros((2, 2)))
    assert isinstance(b, formats.SparseFormat)
    assert all(isinstance(x, formats.SparseFormat) for x in (
        formats.to_ell(b), formats.to_bitmap(b)))
    assert isinstance(formats.to_ell(b), formats.BLOCK_FORMATS)
    assert isinstance(b, BlockCSR)
