"""Port parity: block-sparse local attention of ``repro_torch`` against
``repro``.

The banded ``kv_map`` must equal the reference's array for array; the
attention entry point and its kernel wrapper (the reference's Pallas
kernel in interpret mode, vmapped over the batch) agree within 2e-5 in
f32 (both walk the same blocks with the same online softmax; only the
order of the dot products' sums differs) and within 2e-2 in bf16 (one
bf16 rounding of the f32 output, the reference test's tolerance).
Inputs come from numpy seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import local_block_attention as ref_local_block_attention
from repro.kernels.block_attn import block_attention_pallas
from repro.kernels.block_attn import local_window_kv_map as ref_kv_map
from repro.kernels.ref import local_attention_ref as ref_local_attention_ref
from repro_torch.kernels import local_block_attention, local_window_kv_map
from repro_torch.kernels.block_attn import (block_attention,
                                            block_attention_plain)
from repro_torch.kernels.ref import local_attention_ref

SWEEP = [(256, 64, 64, 64), (512, 128, 128, 128), (256, 40, 64, 64),
         (128, 128, 64, 64)]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _qkv(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    return ([jnp.asarray(a).astype(jdt) for a in arrs],
            [torch.from_numpy(a).to(tdt) for a in arrs])


def _err(got, want):
    return float(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)).max())


@pytest.mark.parametrize("seq,window,bq,bk", SWEEP + [
    (1024, 256, 128, 128), (8192, 2048, 128, 128), (256, 40, 32, 64),
    (256, 100, 64, 32), (192, 1000, 64, 64), (64, 1, 16, 16)])
def test_kv_map_equals_reference(seq, window, bq, bk):
    got = local_window_kv_map(seq, window, bq, bk)
    want = ref_kv_map(seq, window, bq, bk)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_kv_map_at_recurrentgemma_shape():
    m = local_window_kv_map(8192, 2048, 128, 128)
    assert m.shape == (64, 17) and int((m >= 0).sum()) == 952


@pytest.mark.parametrize("s,w,bq,bk", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_local_block_attention_matches_reference(s, w, bq, bk, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(s + w, (2, s, 4, 32), dtype)
    want = ref_local_block_attention(jq, jk, jv, window=w, bq=bq, bk=bk)
    before = block_attention.launches
    got = local_block_attention(q, k, v, window=w, bq=bq, bk=bk)
    assert block_attention.launches == before    # CPU: the plain version
    assert got.dtype == q.dtype and got.shape == q.shape
    assert _err(got, want) <= TOL[dtype]


@pytest.mark.parametrize("causal,window,bq,bk", [
    (True, 0, 64, 32),       # causal only, bq != bk
    (False, 48, 32, 64),     # window without causality
    (True, 72, 32, 32)])
def test_block_attention_matches_pallas_kernel_on_any_kv_map(causal, window,
                                                             bq, bk):
    """A kv_map with pads between live entries and rows that see nothing
    before their first live key: the reference kernel, vmapped."""
    s = 256
    (jq, jk, jv), (q, k, v) = _qkv(bq + bk, (2, s, 3, 16), "float32")
    rng = np.random.default_rng(7)
    nq, nk = s // bq, s // bk
    kv_map = np.full((nq, nk + 2), -1, np.int32)
    for i in range(nq):
        ids = np.flatnonzero(rng.random(nk) < 0.6)
        slots = np.sort(rng.choice(nk + 2, size=len(ids), replace=False))
        kv_map[i, slots] = ids
    want = jax.vmap(lambda a, b, c: block_attention_pallas(
        a, b, c, jnp.asarray(kv_map), bq=bq, bk=bk, causal=causal,
        window=window, interpret=True))(jq, jk, jv)
    got = block_attention(q, k, v, torch.from_numpy(kv_map), bq=bq, bk=bk,
                          causal=causal, window=window)
    assert _err(got, want) <= TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,bq,bk,causal,window", [
    (20, 64, 32, True, 50), (64, 96, 48, True, 100),
    (256, 64, 128, True, 150), (64, 128, 128, False, 0),
    (128, 32, 64, False, 70)])
def test_block_attention_matches_pallas_kernel_on_every_geometry(
        hd, bq, bk, causal, window, dtype):
    """The geometries the card tests hold B9 to this plain version on:
    head dims over 1 to 8 of its 128-byte column blocks, bq != bk, no
    causality with and without a window, live entries in any slot of a
    kv_map row, and a q-block with no live entry (its output is 0)."""
    s = 384
    (jq, jk, jv), (q, k, v) = _qkv(hd + bq + bk, (2, s, 2, hd), dtype)
    rng = np.random.default_rng(window)
    nq, nk = s // bq, s // bk
    kv_map = np.full((nq, 5), -1, np.int32)
    for i in range(nq - 1):
        ids = rng.choice(nk, size=min(4, nk), replace=False)
        kv_map[i, rng.choice(5, size=len(ids), replace=False)] = ids
    want = jax.vmap(lambda a, b, c: block_attention_pallas(
        a, b, c, jnp.asarray(kv_map), bq=bq, bk=bk, causal=causal,
        window=window, interpret=True))(jq, jk, jv)
    got = block_attention(q, k, v, torch.from_numpy(kv_map), bq=bq, bk=bk,
                          causal=causal, window=window)
    assert got.dtype == q.dtype and _err(got, want) <= TOL[dtype]
    assert not got[:, (nq - 1) * bq:].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_oracle_matches_reference(dtype):
    (jq, jk, jv), (q, k, v) = _qkv(3, (2, 96, 2, 16), dtype)
    got = local_attention_ref(q, k, v, window=40)
    want = ref_local_attention_ref(jq, jk, jv, window=40)
    assert got.dtype == q.dtype and _err(got, want) <= TOL[dtype]
    # the block walk equals the dense oracle on the full band
    walk = block_attention_plain(
        q, k, v, torch.from_numpy(local_window_kv_map(96, 40, 32, 16)),
        bq=32, bk=16, causal=True, window=40)
    assert _err(walk, got.float().numpy()) <= TOL[dtype]


def test_block_attention_refuses_bad_operands():
    q = torch.zeros((1, 64, 2, 8))
    kv_map = torch.from_numpy(local_window_kv_map(64, 16, 16, 16))
    with pytest.raises(ValueError, match="S=64"):
        block_attention(q, q, q, kv_map, bq=24, bk=16)
    with pytest.raises(ValueError, match="kv_map"):
        block_attention(q, q, q, kv_map[:2], bq=16, bk=16)
    with pytest.raises(ValueError, match="shape"):
        block_attention(q, q[:, :32], q, kv_map, bq=16, bk=16)
    with pytest.raises(TypeError, match="bfloat16"):
        block_attention(q, q.bfloat16(), q, kv_map, bq=16, bk=16)
    with pytest.raises(TypeError, match="int32"):
        block_attention(q, q, q, kv_map.long(), bq=16, bk=16)
