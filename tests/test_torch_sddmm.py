"""Port parity: the block SDDMM (``repro_torch.kernels.maple_sddmm``, on
the CPU, so through its plain version) against
``repro.kernels.maple_sddmm.maple_sddmm_bsr_pallas`` in interpret mode,
at rtol = atol = 1e-5 (f32; only the order of summation differs).
Operands are made in numpy from a seed and fed to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.csr import BlockCSR as RefBlockCSR
from repro.core.sparsity import block_pattern_mask
from repro.kernels.maple_sddmm import maple_sddmm_bsr_pallas
from repro_torch.kernels import maple_sddmm_bsr
from repro_torch.kernels.maple_sddmm import maple_sddmm_bsr_plain

TOL = dict(rtol=1e-5, atol=1e-5)


def _pattern(kind, seed, gm, gk, bm, bk, extra_pad):
    rng = np.random.default_rng(seed)
    if kind == "all_pad":
        mask = np.zeros((gm, gk), bool)
    elif kind == "empty_rows":
        mask = rng.random((gm, gk)) < 0.5
        mask[::2] = False
    else:
        mask = block_pattern_mask(kind, rng, gm, gk)
    d = rng.standard_normal((gm * bm, gk * bk)).astype(np.float32)
    d *= np.repeat(np.repeat(mask, bm, 0), bk, 1)
    a = RefBlockCSR.from_dense(d, (bm, bk), n_blocks_max=max(
        int(mask.sum()), 1) + extra_pad)
    return a, rng


def _both(a, dc, b, bm, bk, bn):
    want = maple_sddmm_bsr_pallas(jnp.asarray(dc), jnp.asarray(b),
                                  a.block_row, a.block_col, bm=bm, bk=bk,
                                  bn=bn, interpret=True)
    br = torch.from_numpy(np.array(a.block_row))
    bc = torch.from_numpy(np.array(a.block_col))
    got = maple_sddmm_bsr(torch.from_numpy(dc), torch.from_numpy(b), br, bc,
                          bm=bm, bk=bk, bn=bn)
    return got, np.asarray(want), bc


@pytest.mark.parametrize("kind", ["uniform", "power_law", "banded",
                                  "empty_rows", "all_pad"])
@pytest.mark.parametrize("g,n,bn,extra_pad", [(1, 16, 16, 0), (3, 32, 16, 3),
                                              (2, 48, 16, 2)])
def test_sddmm_matches_reference_kernel(kind, g, n, bn, extra_pad):
    a, rng = _pattern(kind, 1, 4, 5, 8, 8, extra_pad)
    dc = rng.standard_normal((g, 32, n)).astype(np.float32)
    b = rng.standard_normal((g, 40, n)).astype(np.float32)
    got, want, bc = _both(a, dc, b, 8, 8, bn)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert (got[bc < 0] == 0).all()                 # pads come out 0


def test_sddmm_rectangular_blocks_and_dense_oracle():
    a, rng = _pattern("uniform", 2, 3, 4, 8, 16, 1)
    dc = rng.standard_normal((2, 24, 32)).astype(np.float32)
    b = rng.standard_normal((2, 64, 32)).astype(np.float32)
    got, want, _ = _both(a, dc, b, 8, 16, 16)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    full = np.einsum("gmn,gkn->mk", dc, b).reshape(3, 8, 4, 16)
    nnzb = int(np.asarray(a.row_ptr)[-1])
    br, bcn = np.asarray(a.block_row), np.asarray(a.block_col)
    for s in range(nnzb):
        np.testing.assert_allclose(got[s].numpy(), full[br[s], :, bcn[s]],
                                   rtol=1e-4, atol=1e-4)


def test_sddmm_ragged_n_equals_zero_padded():
    """The port takes a ragged N itself; the reference kernel needs N a
    multiple of bn, so it gets the zero-padded operands."""
    a, rng = _pattern("power_law", 3, 4, 5, 8, 8, 2)
    dc = rng.standard_normal((2, 32, 21)).astype(np.float32)
    b = rng.standard_normal((2, 40, 21)).astype(np.float32)
    pad = ((0, 0), (0, 0), (0, 11))
    want = maple_sddmm_bsr_pallas(jnp.asarray(np.pad(dc, pad)),
                                  jnp.asarray(np.pad(b, pad)), a.block_row,
                                  a.block_col, bm=8, bk=8, bn=16,
                                  interpret=True)
    got = maple_sddmm_bsr(torch.from_numpy(dc), torch.from_numpy(b),
                          torch.from_numpy(np.array(a.block_row)),
                          torch.from_numpy(np.array(a.block_col)),
                          bm=8, bk=8, bn=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sddmm_wrapper_runs_the_plain_version_on_cpu_and_checks():
    a, rng = _pattern("banded", 4, 4, 4, 8, 8, 1)
    dc = torch.from_numpy(rng.standard_normal((1, 32, 5)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((1, 32, 5)).astype(np.float32))
    br = torch.from_numpy(np.array(a.block_row))
    bc = torch.from_numpy(np.array(a.block_col))
    before = maple_sddmm_bsr.launches
    assert torch.equal(maple_sddmm_bsr(dc, b, br, bc, bm=8, bk=8),
                       maple_sddmm_bsr_plain(dc, b, br, bc, bm=8, bk=8))
    assert maple_sddmm_bsr.launches == before
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        maple_sddmm_bsr(dc.double(), b.double(), br, bc, bm=8, bk=8)
    with pytest.raises(TypeError, match="int32"):
        maple_sddmm_bsr(dc, b, br.long(), bc, bm=8, bk=8)
    with pytest.raises(ValueError, match="disagree"):
        maple_sddmm_bsr(dc, b[..., :4], br, bc, bm=8, bk=8)
    with pytest.raises(ValueError, match="not divisible"):
        maple_sddmm_bsr(dc, b, br, bc, bm=12, bk=8)
    with pytest.raises(ValueError, match="contiguous"):
        maple_sddmm_bsr(dc.mT.contiguous().mT, b, br, bc, bm=8, bk=8)
