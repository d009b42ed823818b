"""Port parity of the MoE grouped GEMM's backward (B8) and of the forward-
only entry points under a gradient, against ``repro`` on the CPU.

``moe_gemm`` is an autograd Function in the port: dx runs on B8's
transposed-weight mode and dW on ``moe_dw_kernel`` (on the CPU, their
plain versions).  Its gradients are held against ``jax.grad`` of the
reference's ``moe_gemm_ref`` on the same tiles, within 1e-5·max|ref| +
1e-6 (f32 sums in another order); ``moe_gemm_dw_plain`` against a float64
loop within 1e-5·max + 1e-6.  The entry points that have no gradient in
the reference (``ops.moe_expert_gemm``, ``ops.local_block_attention`` and
the B9 kernel) raise under a gradient in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import local_block_attention as ref_local_attention
from repro.kernels import moe_expert_gemm as ref_moe_expert_gemm
from repro.kernels.block_attn import block_attention_pallas
from repro.kernels.block_attn import local_window_kv_map as ref_kv_map
from repro.kernels.ref import moe_gemm_ref
from repro_torch.kernels import (block_attention, local_block_attention,
                                 moe_expert_gemm)
from repro_torch.kernels.moe_gemm import (moe_gemm, moe_gemm_dw,
                                          moe_gemm_dw_plain, moe_gemm_dx,
                                          moe_gemm_dx_plain, moe_gemm_plain,
                                          moe_dw_route, moe_route)


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    limit = 1e-5 * (float(np.abs(want).max()) if want.size else 0.0) + 1e-6
    assert err <= limit, f"max|port - ref| = {err} > {limit}"


def _operands(seed, eot, e, d, f, bt):
    rng = np.random.default_rng(seed)
    t = len(eot) * bt
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((e, d, f)) * 0.2).astype(np.float32)
    dy = rng.standard_normal((t, f)).astype(np.float32)
    return x, w, dy, np.asarray(eot, np.int32)


# (expert of each tile, E, D, F, bt): several tiles per expert, experts
# with no tile, D and F not multiples of 16
CASES = [([0, 0, 2, 2, 2], 4, 24, 20, 8),
         ([1, 1, 1, 1], 3, 16, 40, 8),
         ([0, 3, 3, 5], 6, 36, 12, 16),
         ([2, 2, 4], 5, 64, 48, 16)]


@pytest.mark.parametrize("eot,e,d,f,bt", CASES)
def test_moe_gemm_grads_match_reference_autodiff(eot, e, d, f, bt):
    x, w, dy, eot = _operands(len(eot) + d, eot, e, d, f, bt)
    jeot = jnp.asarray(eot)
    (want_dx, want_dw) = jax.grad(
        lambda a, b: jnp.sum(moe_gemm_ref(a, jeot, b, bt=bt) * dy),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = moe_gemm(xt, torch.from_numpy(eot), wt, bt=bt)
    _close(y.detach(), moe_gemm_ref(jnp.asarray(x), jeot, jnp.asarray(w),
                                    bt=bt))
    y.backward(torch.from_numpy(dy))
    _close(xt.grad, want_dx)
    _close(wt.grad, want_dw)
    unused = sorted(set(range(e)) - set(eot.tolist()))
    assert not wt.grad[unused].any()           # an expert with no tile: 0


@pytest.mark.parametrize("eot,e,d,f,bt", CASES)
def test_backward_wrappers_are_their_plain_versions_on_the_cpu(eot, e, d, f,
                                                               bt):
    x, w, dy, eot = map(torch.from_numpy, _operands(3, eot, e, d, f, bt))
    assert torch.equal(moe_gemm_dx(dy, eot, w, bt=bt),
                       moe_gemm_dx_plain(dy, eot, w, bt=bt))
    assert torch.equal(moe_gemm_dx_plain(dy, eot, w, bt=bt),
                       moe_gemm_plain(dy, eot, w.transpose(1, 2)
                                      .contiguous(), bt=bt))
    assert torch.equal(moe_gemm_dw(x, dy, eot, e, bt=bt),
                       moe_gemm_dw_plain(x, dy, eot, e, bt=bt))
    before = (moe_gemm.launches, moe_gemm_dw.launches)
    moe_gemm(x.requires_grad_(), eot, w.requires_grad_(), bt=bt).sum() \
        .backward()
    assert (moe_gemm.launches, moe_gemm_dw.launches) == before  # CPU: plain


@pytest.mark.parametrize("eot,e,d,f,bt", CASES)
def test_moe_gemm_dw_plain_is_a_float64_loop(eot, e, d, f, bt):
    x, _, dy, eot = _operands(7, eot, e, d, f, bt)
    want = np.zeros((e, d, f))
    for i, ex in enumerate(eot):
        for r in range(i * bt, (i + 1) * bt):
            want[ex] += np.outer(x[r].astype(np.float64), dy[r])
    got = moe_gemm_dw_plain(torch.from_numpy(x), torch.from_numpy(dy),
                            torch.from_numpy(eot), e, bt=bt)
    assert got.dtype == torch.float32 and got.shape == (e, d, f)
    _close(got, want)


def test_bf16_backward_rounds_once():
    x, w, dy, eot = map(torch.from_numpy, _operands(5, [0, 0, 2], 3, 32, 24,
                                                    8))
    xb, wb = x.bfloat16().requires_grad_(), w.bfloat16().requires_grad_()
    moe_gemm(xb, eot, wb, bt=8).backward(dy.bfloat16())
    assert xb.grad.dtype == wb.grad.dtype == torch.bfloat16
    dyb = dy.bfloat16().float()
    want_dx = moe_gemm_plain(dyb, eot, wb.detach().float().transpose(1, 2),
                             bt=8)
    want_dw = moe_gemm_dw_plain(xb.detach().float(), dyb, eot, 3, bt=8)
    assert torch.equal(xb.grad, want_dx.bfloat16())
    assert torch.equal(wb.grad, want_dw.bfloat16())


@pytest.mark.parametrize("transposed", [False, True])
def test_moe_route_of_the_dx_launch(transposed):
    """dx reduces over F and writes D's tiles; both dtypes read w as it
    lies, by TMA where the strides allow; f32 dx multiplies on the k-major
    FFMA tile, 32 of F (one swizzled 128-byte row) a stage at every
    piece."""
    f32 = moe_route(torch.float32, 96, 1536, 512, 96, transposed=transposed)
    bf16 = moe_route(torch.bfloat16, 96, 1536, 512, 96,
                     transposed=transposed)
    assert f32["f_tiles"] == bf16["f_tiles"] == (24 if transposed else 8)
    assert f32["copy"] == bf16["copy"] == "tma"
    assert f32["consumer"] == ("ffma_k" if transposed else "ffma")
    assert bf16["consumer"] == "wgmma"
    small = moe_route(torch.float32, 16, 1536, 512, 16, transposed=transposed)
    assert small["kc"] == (32 if transposed else 64)
    assert small["register_tile"] == (2, 4)
    assert moe_route(torch.bfloat16, 16, 36, 64, 16,
                     transposed=transposed)["copy"] == "producer"
    assert moe_route(torch.float32, 16, 70, 44, 16,
                     transposed=transposed)["copy"] == "producer"


@pytest.mark.parametrize("dtype,bt,rows,per_tile,tail", [
    (torch.bfloat16, 8, 16, 1, 8), (torch.float32, 8, 8, 1, 0),
    (torch.bfloat16, 56, 64, 1, 8), (torch.float32, 56, 24, 3, 16),
    (torch.bfloat16, 216, 64, 4, 40), (torch.float32, 216, 24, 9, 0),
    (torch.bfloat16, 3, 16, 1, 13), (torch.float32, 96, 24, 4, 0)])
def test_moe_dw_route_covers_the_token_tile(dtype, bt, rows, per_tile, tail):
    """dW's stages cover a token tile in order; the last stage's rows
    past the tile (a 3D box past bt) arrive as zeros, never the next
    expert's rows."""
    r = moe_dw_route(dtype, 4 * bt, 1536, 512, bt)
    assert (r["rows"], r["stages_a_tile"], r["tail"]) == (rows, per_tile,
                                                          tail)
    assert r["rows"] * r["stages_a_tile"] - r["tail"] == bt
    assert 0 <= r["tail"] < r["rows"]
    assert r["rows"] % (16 if dtype == torch.bfloat16 else 8) == 0


@pytest.mark.parametrize("dtype,d,f,aligned,copy", [
    (torch.bfloat16, 1536, 512, True, "tma"),
    (torch.float32, 1536, 512, True, "tma"),
    (torch.bfloat16, 72, 40, True, "tma"),
    (torch.float32, 70, 44, True, "producer"),     # 280-byte rows of x
    (torch.bfloat16, 100, 36, True, "producer"),   # 200-byte rows
    (torch.float32, 100, 36, True, "tma"),
    (torch.bfloat16, 200, 300, True, "producer"),  # 600-byte rows of dy
    (torch.bfloat16, 1536, 512, False, "producer")])
def test_moe_dw_route_takes_tma_only_where_the_strides_allow(dtype, d, f,
                                                             aligned, copy):
    assert moe_dw_route(dtype, 112, d, f, 56,
                        aligned=aligned)["copy"] == copy


@pytest.mark.parametrize("dtype,bt,consumer,tile,stages,outs", [
    (torch.bfloat16, 56, "wgmma", None, 3, 2),
    (torch.float32, 56, "ffma", (8, 8), 2, 1),
    (torch.bfloat16, 8, "wgmma", None, 4, 2),
    (torch.float32, 8, "ffma", (8, 8), 4, 1)])
def test_moe_dw_route_consumer_and_ring(dtype, bt, consumer, tile, stages,
                                        outs):
    """bf16 on wgmma with two out buffers, f32 on an 8 × 8 FFMA tile
    with one; 2 to 4 stages; granite's gate (D 1 536, F 512) in 24 × 4
    tiles an expert."""
    r = moe_dw_route(dtype, 48 * bt, 1536, 512, bt)
    assert (r["consumer"], r["register_tile"], r["stages"],
            r["out_buffers"]) == (consumer, tile, stages, outs)
    assert (r["tile"], r["d_tiles"], r["f_tiles"]) == ((64, 128), 24, 4)
    with pytest.raises(ValueError, match="divide"):
        moe_dw_route(dtype, 100, 1536, 512, 8)


def test_backward_wrappers_refuse_bad_operands():
    x, w, dy, eot = map(torch.from_numpy, _operands(1, [0, 1], 2, 16, 8, 8))
    with pytest.raises(ValueError, match="tiles"):
        moe_gemm_dw(x, dy[:8].contiguous(), eot, 2, bt=8)
    with pytest.raises(ValueError, match="contiguous"):
        moe_gemm_dw(x, dy.t().contiguous().t(), eot, 2, bt=8)
    with pytest.raises(TypeError, match="dtype"):
        moe_gemm_dw(x, dy.bfloat16(), eot, 2, bt=8)
    with pytest.raises(ValueError, match="D mismatch"):
        moe_gemm_dx(dy, eot, w.transpose(1, 2).contiguous(), bt=8)
    with pytest.raises(ValueError, match="contiguous"):
        moe_gemm_dx(dy, eot, w.transpose(1, 2).contiguous().transpose(1, 2),
                    bt=8)


# --------------------------------------------------------------------------
# fault C3: the entry points without a gradient raise in both packages
# --------------------------------------------------------------------------

def test_forward_only_entry_points_raise_under_a_gradient_in_both():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((256, 128)).astype(np.float32)
    w = (rng.standard_normal((2, 128, 128)) * 0.1).astype(np.float32)
    sizes = np.array([128, 128], np.int32)
    with pytest.raises(NotImplementedError):
        jax.grad(lambda a: jnp.sum(ref_moe_expert_gemm(
            a, jnp.asarray(sizes), jnp.asarray(w), bt=128)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    with pytest.raises(NotImplementedError, match="no gradient"):
        moe_expert_gemm(xt, torch.from_numpy(sizes), torch.from_numpy(w),
                        bt=128)
    with pytest.raises(NotImplementedError, match="no gradient"):
        moe_expert_gemm(torch.from_numpy(x), torch.from_numpy(sizes),
                        torch.from_numpy(w).requires_grad_(), bt=128)
    with torch.no_grad():                       # no gradient asked: it runs
        y = moe_expert_gemm(xt, torch.from_numpy(sizes), torch.from_numpy(w),
                            bt=128)
    _close(y, ref_moe_expert_gemm(jnp.asarray(x), jnp.asarray(sizes),
                                  jnp.asarray(w), bt=128))

    q = rng.standard_normal((1, 256, 2, 64)).astype(np.float32)
    with pytest.raises(NotImplementedError):
        jax.grad(lambda a: jnp.sum(ref_local_attention(
            a, a, a, window=128)))(jnp.asarray(q))
    kv_map = ref_kv_map(256, 128, 128, 128)
    with pytest.raises(NotImplementedError):
        jax.grad(lambda a: jnp.sum(block_attention_pallas(
            a, a, a, jnp.asarray(kv_map), bq=128, bk=128, causal=True,
            window=128, interpret=True)))(jnp.asarray(q[0]))
    qt = torch.from_numpy(q).requires_grad_()
    k = torch.from_numpy(q)
    with pytest.raises(NotImplementedError, match="local attention's "
                       "backward is not ported"):
        local_block_attention(qt, k, k, window=128)
    for grad_of in range(3):
        ops = [k, k, k]
        ops[grad_of] = qt
        with pytest.raises(NotImplementedError, match="B9"):
            block_attention(*ops, torch.from_numpy(kv_map), bq=128, bk=128,
                            window=128)
    with torch.no_grad():
        out = local_block_attention(qt, k, k, window=128)
    _close(out, ref_local_attention(jnp.asarray(q), jnp.asarray(q),
                                    jnp.asarray(q), window=128))
