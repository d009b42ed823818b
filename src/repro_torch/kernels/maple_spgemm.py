"""SpGEMM numeric phase on Hopper: C's values from A's and B's, and the dA
and dB of its backward (CUDA C++, ``csrc/maple_spgemm.cu``).

* :func:`maple_spgemm_numeric` (B5) — replaces ``maple_spgemm_pallas``
  (``repro/kernels/maple_spgemm.py``): every partial product
  A[i,k']·B[k',u] is added, in f32 and in slot order, at its planned
  position of output row i, and the row is flushed once, in A's dtype,
  straight into C's padded-CSR value vector (the reference's ELL → CSR
  compaction, fused).
* :func:`maple_sddmm_csr` (B6) — replaces ``maple_sddmm_csr_pallas``
  (``repro/kernels/maple_sddmm.py``): the dA of the backward, the
  forward's scatter positions run in reverse, dA[s] = Σ_u B[k',u] ·
  dC[row(s), pos(s,u)], one f32 value per live A slot, written in A's
  value layout.  :mod:`repro_torch.kernels.maple_sddmm` re-exports it.
* :func:`maple_spgemm_db` — replaces the scatter-add by consumed B row in
  ``repro.kernels.ops._spgemm_value_call``'s backward: dB[k',u] =
  Σ_{s in A's column fiber k'} A[s] · dC[row(s), pos(s,u)], in fiber
  order, f32.

All three take the :class:`~repro_torch.kernels.schedule.SpgemmPlan` and
read its device view (``plan.on_device``).  A wrapper runs the plain PyTorch
version only for tensors on the CPU; for CUDA tensors it launches the
kernel or raises, and each launch adds one to its ``launches`` count.
Values are f32 or bf16 (both operands alike), accumulated in f32.  B5
rounds as its plain version does (product, then sum), so the two give
the same bits; two runs of any of them give the same bits.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.regions import region

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_WARPS = 8               # warps a block of B6 and dB (4 rows a warp)
_ROWS = 16               # output rows a block of B5 (8 lanes a row)
_SMEM_DEFAULT = 48 * 1024


def check_values(what, x, y, x_len: int, y_len: int) -> None:
    """The two value vectors of one SpGEMM kernel: 1-D, contiguous, alike
    in dtype (f32 or bf16) and device, and at least as long as the plan
    reads."""
    for name, t, n in ((what[0], x, x_len), (what[1], y, y_len)):
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D value vector, "
                             f"got {tuple(t.shape)}")
        if t.shape[0] < n:
            raise ValueError(f"{name} holds {t.shape[0]} values; the plan "
                             f"reads {n}")
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise TypeError(f"{what[0]} and {what[1]} must both be float32 or "
                        f"bfloat16, got {x.dtype} and {y.dtype}")
    if y.device != x.device:
        raise ValueError(f"{what[1]} is on {y.device}, {what[0]} on "
                         f"{x.device}")


# --------------------------------------------------------------------------
# B5: the numeric phase
# --------------------------------------------------------------------------

@region
def maple_spgemm_numeric(a_value: torch.Tensor, b_value: torch.Tensor,
                         plan, *, cap: int) -> torch.Tensor:
    """C's padded-CSR value vector ``(cap,)`` in A's dtype: slot
    ``out_row_ptr[i] + p`` holds the f32 sum, in A-slot order, of the
    partials the plan scatters to position p of row i, cast once; slots
    past ``nnz_c`` hold 0.  On the card :func:`numeric_route` picks the
    kernel's route; every route gives the same bits."""
    check_values(("A values", "B values"), a_value, b_value,
                 plan.stats.nnz_a, plan.stats.nnz_b)
    if cap < plan.nnz_c:
        raise ValueError(f"cap={cap} < nnz(C)={plan.nnz_c}")
    if a_value.is_meta:
        return a_value.new_empty((cap,))
    if not a_value.is_cuda:
        return maple_spgemm_numeric_plain(a_value, b_value, plan, cap=cap)
    out = torch.empty((cap,), dtype=a_value.dtype, device=a_value.device)
    out[plan.nnz_c:].zero_()
    if plan.nnz_c == 0:
        return out
    lib = _build.library("maple_spgemm")
    psb = 4 * plan.lc
    optin = lib.maple_smem_optin(a_value.device.index)
    if psb > optin:
        raise ValueError(
            f"the longest output row has {plan.lc} entries: its f32 PSB "
            f"({psb} bytes) exceeds the {optin} bytes of shared memory a "
            f"block can have on this card")
    rows = max(1, min(_ROWS, _SMEM_DEFAULT // psb))
    route = numeric_route(plan, a_value.device)
    d = plan.on_device(a_value.device)
    err = _build.launch(
        lib.maple_spgemm, a_value.device,
        a_value.data_ptr(), b_value.data_ptr(), d["row_meta"].data_ptr(),
        d["row_base"].data_ptr(), d["slot_b"].data_ptr(), d["pos"].data_ptr(),
        out.data_ptr(), _DTYPES[a_value.dtype], plan.shape_a[0], plan.lc,
        rows, route)
    _build.check(lib, err, "maple_spgemm")
    maple_spgemm_numeric.launches += 1
    return out


maple_spgemm_numeric.launches = 0


def numeric_route(plan, device: torch.device) -> int:
    """B5's route for ``plan`` on ``device``: an index of
    ``csrc/maple_spgemm.cu``'s ``MAPLE_SPGEMM_ROUTES``, picked by the C
    side from the plan's rows and the card's threads."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    route = _build.library("maple_spgemm").maple_spgemm_route(
        plan.shape_a[0], index)
    if route < 0:
        raise RuntimeError(f"maple_spgemm_route failed on {device}")
    return route


def numeric_routes() -> list:
    """B5's routes as the C side holds them: ``(lanes a row, slots in
    flight, steps of that many terms of a slot loaded at once)``, by
    index."""
    lib = _build.library("maple_spgemm")
    shapes = []
    for route in range(lib.maple_spgemm_route_shape(0, None)):
        shape = (ctypes.c_int * 3)()
        lib.maple_spgemm_route_shape(route, shape)
        shapes.append(tuple(shape))
    return shapes


def partials(plan, device) -> dict:
    """Every partial product of the plan, in (A slot, B entry) order, as
    index tensors on ``device``: ``s`` (the A slot), ``t`` (its rank in
    its row), ``b`` (the B entry) and ``c`` (the C slot it lands in).
    The plain versions' expansion of the kernels' loops."""
    d = plan.on_device(device)
    part_len = d["part_ptr"][1:] - d["part_ptr"][:-1]
    s = torch.repeat_interleave(
        torch.arange(part_len.numel(), device=device), part_len)
    u = torch.arange(s.numel(), device=device) - d["part_ptr"][s]
    rows = d["a_rows"].long()[s]
    return {"s": s, "t": s - d["a_rptr"].long()[rows],
            "b": d["b_rptr"].long()[d["a_cols"].long()[s]] + u,
            "c": d["out_rptr"][rows] + d["pos"].long()}


def maple_spgemm_numeric_plain(a_value, b_value, plan, *,
                               cap: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`maple_spgemm_numeric`: the partials
    of each slot rank ``t`` go to distinct C slots within a row, so one
    gather, add and scatter per rank, in rank order, sums each C slot in
    the kernel's order."""
    p = partials(plan, a_value.device)
    prod = a_value[p["s"]].float() * b_value[p["b"]].float()
    acc = torch.zeros((plan.nnz_c,), dtype=torch.float32,
                      device=a_value.device)
    for t in range(plan.la):
        sel = p["t"] == t
        c = p["c"][sel]
        acc[c] = acc[c] + prod[sel]
    out = a_value.new_zeros((cap,))
    out[:plan.nnz_c] = acc.to(a_value.dtype)
    return out


# --------------------------------------------------------------------------
# B6: dA of the backward
# --------------------------------------------------------------------------

@region
def maple_sddmm_csr(dc: torch.Tensor, b_value: torch.Tensor, plan, *,
                    n_slots: int) -> torch.Tensor:
    """dA ``(n_slots,)`` f32 in A's value layout for the SpGEMM ``plan``:
    live slot ``s`` of row i holds Σ_u B[k', u] · dC[out_row_ptr[i] +
    pos(s, u)] (k' = A's column at s); slots past nnz(A) hold 0."""
    nnz_a = plan.stats.nnz_a
    check_values(("dC", "B values"), dc, b_value, plan.nnz_c,
                 plan.stats.nnz_b)
    if n_slots < nnz_a:
        raise ValueError(f"n_slots={n_slots} < nnz(A)={nnz_a}")
    if dc.is_meta:
        return dc.new_empty((n_slots,), dtype=torch.float32)
    if not dc.is_cuda:
        return maple_sddmm_csr_plain(dc, b_value, plan, n_slots=n_slots)
    out = torch.empty((n_slots,), dtype=torch.float32, device=dc.device)
    out[nnz_a:].zero_()
    m = plan.shape_a[0]
    if m == 0:
        return out
    d = plan.on_device(dc.device)
    lib = _build.library("maple_spgemm")
    err = _build.launch(
        lib.maple_sddmm_csr, dc.device,
        dc.data_ptr(), b_value.data_ptr(), d["a_rptr"].data_ptr(),
        d["a_cols"].data_ptr(), d["b_rptr"].data_ptr(),
        d["part_ptr"].data_ptr(), d["pos"].data_ptr(),
        d["out_rptr"].data_ptr(), out.data_ptr(), _DTYPES[dc.dtype], m, _WARPS)
    _build.check(lib, err, "maple_sddmm_csr")
    maple_sddmm_csr.launches += 1
    return out


maple_sddmm_csr.launches = 0


def maple_sddmm_csr_plain(dc, b_value, plan, *, n_slots: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`maple_sddmm_csr` (one scatter-add
    over the partials)."""
    p = partials(plan, dc.device)
    out = torch.zeros((n_slots,), dtype=torch.float32, device=dc.device)
    return out.index_add_(0, p["s"], b_value[p["b"]].float()
                          * dc[p["c"]].float())


# --------------------------------------------------------------------------
# dB of the backward
# --------------------------------------------------------------------------

@region
def maple_spgemm_db(dc: torch.Tensor, a_value: torch.Tensor, plan, *,
                    n_slots: int) -> torch.Tensor:
    """dB ``(n_slots,)`` f32 in B's value layout: entry ``b_rptr[k'] + u``
    holds Σ A[s] · dC[out_row_ptr[row(s)] + pos(s, u)] over the A slots s
    that consume B row k', in row order; slots past nnz(B) hold 0."""
    nnz_b = plan.stats.nnz_b
    check_values(("dC", "A values"), dc, a_value, plan.nnz_c,
                 plan.stats.nnz_a)
    if n_slots < nnz_b:
        raise ValueError(f"n_slots={n_slots} < nnz(B)={nnz_b}")
    if dc.is_meta:
        return dc.new_empty((n_slots,), dtype=torch.float32)
    if not dc.is_cuda:
        return maple_spgemm_db_plain(dc, a_value, plan, n_slots=n_slots)
    out = torch.empty((n_slots,), dtype=torch.float32, device=dc.device)
    out[nnz_b:].zero_()
    kb = plan.shape_b[0]
    if kb == 0:
        return out
    d = plan.on_device(dc.device)
    lib = _build.library("maple_spgemm")
    err = _build.launch(
        lib.maple_spgemm_db, dc.device,
        dc.data_ptr(), a_value.data_ptr(), d["fiber_meta"].data_ptr(),
        d["fiber_base"].data_ptr(), d["t_perm"].data_ptr(),
        plan.fiber_positions(dc.device).data_ptr(), out.data_ptr(),
        _DTYPES[dc.dtype], kb, _WARPS)
    _build.check(lib, err, "maple_spgemm_db")
    maple_spgemm_db.launches += 1
    return out


maple_spgemm_db.launches = 0


def maple_spgemm_db_plain(dc, a_value, plan, *, n_slots: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`maple_spgemm_db` (one scatter-add
    over the partials)."""
    p = partials(plan, dc.device)
    out = torch.zeros((n_slots,), dtype=torch.float32, device=dc.device)
    return out.index_add_(0, p["b"], a_value[p["s"]].float()
                          * dc[p["c"]].float())
