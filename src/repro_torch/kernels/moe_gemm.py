"""MoE grouped GEMM on Hopper (CUDA C++, ``csrc/moe_gemm.cu``).

:func:`moe_gemm` (B8) replaces ``moe_gemm_pallas``
(``repro/kernels/moe_gemm.py``): for expert-sorted, tile-padded tokens
``x (T, D)``, ``y[t] = x[t] @ w[expert_of_tile[t // bt]]`` with the
``(E, D, F)`` expert weights, summed in f32 and written once in x's
dtype.  Routed MoE expert compute is a row-wise product on CSR metadata:
the tile's expert id is the ``col_id`` that selects the weight panel, and
an expert with no tile is never read.

Under a gradient :func:`moe_gemm` is a ``torch.autograd.Function``:
``dx = dy · w[e]ᵀ`` runs on the same kernel in a transposed-weight mode
(:func:`moe_gemm_dx`, w read in place) and ``dW[e] = Σ x_tileᵀ · dy_tile``
over the tiles expert e owns on ``moe_dw_kernel`` (:func:`moe_gemm_dw`),
in tile order and without atomics, so reruns are bit-identical.  The
reference's kernel has no gradient (its MoE layer trains through
``einsum``); the port's MoE layer trains through this Function.

Each wrapper runs its plain PyTorch version only for tensors on the CPU.
For CUDA tensors it launches its kernel or raises; the forward and dx
launches add one to ``moe_gemm.launches``, dW's to
``moe_gemm_dw.launches``.  The reference needs D and F to be multiples
of its 128-wide Pallas tiles; the kernels take any D and F, and a token
tile bt that is a multiple of 8 (the MoE layer's capacity always is; dW
takes any bt).  :func:`moe_route` (forward and dx) and
:func:`moe_dw_route` are the host's side of a launch: the consumer, what
a thread block owns, and whether the operands come by TMA.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.maple_spmm import ffma_tile
from repro_torch.regions import region

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
PIECES = (8, 16, 32, 64, 96, 128)   # token pieces a thread block can take
F_TILE = 64                         # output columns of a thread block
_RING = 48 * 1024                   # bytes of a block's ring
_MAX_STAGES = 8
DW_TILE = (64, 128)                 # (D rows, F columns) of a dW tile
_DW_BUDGET = {torch.bfloat16: 112 * 1024, torch.float32: 72 * 1024}
_DW_MAX_STAGES, _DW_MAX_OUT = 4, 2


def moe_route(dtype: torch.dtype, t: int, d: int, f: int, bt: int, *,
              aligned: bool = True, transposed: bool = False) -> dict:
    """How a B8 launch runs on the card (``plan_moe`` in
    ``csrc/moe_gemm.cu``).  A thread block owns ``piece`` tokens of one
    token tile and :data:`F_TILE` columns of F: the smallest of
    :data:`PIECES` that covers ``bt``, or 128 tokens at a time where
    ``bt`` is wider (``pieces`` blocks a tile, the last one's rows past
    the tile unwritten).  bf16 runs on ``"wgmma"`` (tokens as the
    instruction's N), f32 on ``"ffma"`` with :func:`ffma_tile`'s register
    tile.  Both operands come by ``"tma"`` where D·size and F·size are
    multiples of 16 bytes and the pointers 16-byte aligned, else the
    producer warp copies them (``"producer"``).  A stage holds ``kc``
    rows of D (64; 32 for f32 pieces of 32 tokens or more, so that 3
    blocks share an SM) of x's and w's panels,
    ``(piece + 64) · kc`` elements; ``stages`` of them fill a 48 KB ring
    (2 to 8).  ``transposed`` is dx's launch over w ``(E, d, f)``
    (``plan_moe``'s ``trans``): f is the reduction and d the output
    columns (``f_tiles`` counts d's tiles), and w's panel comes as it
    lies (64 rows of d, ``kc`` of f); f32 stages ``kc`` 32 (one 128-byte
    row, swizzled) at every piece and multiplies on the k-major FFMA tile
    (``"ffma_k"``: both operands' rows along f)."""
    if bt <= 0 or bt % 8 or t % bt:
        raise ValueError(f"bt={bt} must be a positive multiple of 8 that "
                         f"divides T={t}")
    isz = 2 if dtype == torch.bfloat16 else 4
    piece = next((p for p in PIECES if p >= bt), PIECES[-1])
    k, n = (f, d) if transposed else (d, f)
    tma = k > 0 and (k * isz) % 16 == 0 and (n * isz) % 16 == 0 and aligned
    if dtype == torch.bfloat16:
        kc, consumer = 64, "wgmma"
    elif transposed:
        kc, consumer = 32, "ffma_k"
    else:
        kc, consumer = (64 if piece < 32 else 32), "ffma"
    stage = (piece + F_TILE) * kc * isz
    return {"consumer": consumer,
            "register_tile": (None if dtype == torch.bfloat16
                              else ffma_tile(piece, F_TILE)),
            "piece": piece, "pieces": -(-bt // piece), "kc": kc,
            "copy": "tma" if tma else "producer",
            "stages": min(max(_RING // stage, 2), _MAX_STAGES),
            "f_tiles": -(-n // F_TILE)}


def moe_dw_route(dtype: torch.dtype, t: int, d: int, f: int, bt: int, *,
                 aligned: bool = True) -> dict:
    """How a ``moe_dw_kernel`` launch runs on the card (``plan_dw`` in
    ``csrc/moe_gemm.cu``).  Persistent thread blocks walk the (expert,
    :data:`DW_TILE`) output tiles; bf16 multiplies on ``"wgmma"`` (both
    operands MN-major), f32 on ``"ffma"`` with an 8 × 8 register tile.  A
    stage holds ``rows`` token rows of one tile (bf16 up to 64, a multiple
    of 16; f32 up to 24, a multiple of 8): ``stages_a_tile`` of them cover
    ``bt``, the last one's ``tail`` rows past the tile arriving as zeros.
    x's and dy's panels and the dW tile go by ``"tma"`` where D·size and
    F·size are multiples of 16 bytes and the pointers 16-byte aligned,
    else by the threads' own copies (``"producer"``).  The most out
    buffers (up to 2) beside 2 stages, then the most stages (up to 4), fit
    112 KB in bf16 (2 blocks an SM) and 72 KB in f32 (3 blocks an SM, for
    the FFMAs)."""
    if bt <= 0 or t % bt:
        raise ValueError(f"bt={bt} must be positive and divide T={t}")
    bf16 = dtype == torch.bfloat16
    isz = 2 if bf16 else 4
    step, most = (16, 64) if bf16 else (8, 24)
    rows = min(most, -(-bt // step) * step)
    per_tile = -(-bt // rows)
    tma = t > 0 and (d * isz) % 16 == 0 and (f * isz) % 16 == 0 and aligned
    stage = rows * (DW_TILE[0] + DW_TILE[1]) * isz
    out = DW_TILE[0] * DW_TILE[1] * isz
    budget = _DW_BUDGET[dtype]
    out_buffers = max(1, min(_DW_MAX_OUT, (budget - 2 * stage) // out))
    stages = max(1, min(_DW_MAX_STAGES,
                        (budget - out_buffers * out) // stage))
    return {"consumer": "wgmma" if bf16 else "ffma",
            "register_tile": None if bf16 else (8, 8), "tile": DW_TILE,
            "rows": rows, "stages_a_tile": per_tile,
            "tail": rows * per_tile - bt, "copy": "tma" if tma else "producer",
            "stages": stages, "out_buffers": out_buffers,
            "d_tiles": -(-d // DW_TILE[0]), "f_tiles": -(-f // DW_TILE[1])}


def _check(x, expert_of_tile, w, bt: int, *, transposed: bool = False
           ) -> None:
    """x ``(T, K)`` against its tiles and, unless ``w`` is None, against
    the weights ``(E, K, N)`` (``transposed``, dx's: ``(E, N, K)``)."""
    if x.dim() != 2 or (w is not None and w.dim() != 3) \
            or expert_of_tile.dim() != 1:
        raise ValueError(f"x must be (T, D), w (E, D, F) and expert_of_tile "
                         f"(T/bt,); got {tuple(x.shape)}, "
                         f"{None if w is None else tuple(w.shape)} "
                         f"and {tuple(expert_of_tile.shape)}")
    t, d = x.shape
    if w is not None and w.shape[2 if transposed else 1] != d:
        raise ValueError(f"D mismatch {d} vs {w.shape[2 if transposed else 1]}")
    if bt <= 0 or t % bt:
        raise ValueError(f"T={t} not divisible by bt={bt}")
    if expert_of_tile.shape[0] != t // bt:
        raise ValueError(f"expert_of_tile holds {expert_of_tile.shape[0]} "
                         f"tiles, T/bt = {t // bt}")
    if x.dtype not in _DTYPES or (w is not None and w.dtype != x.dtype):
        raise TypeError(f"x and w must both be float32 or bfloat16, got "
                        f"{x.dtype} and {None if w is None else w.dtype}")
    if expert_of_tile.dtype != torch.int32:
        raise TypeError(f"expert_of_tile must be int32, got "
                        f"{expert_of_tile.dtype}")
    for name, a in (("x", x), ("w", w), ("expert_of_tile", expert_of_tile)):
        if a is None:
            continue
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_tile(bt: int) -> None:
    if bt % 8:
        raise ValueError(f"the CUDA kernel takes a token tile bt that is a "
                         f"multiple of 8, got {bt}")


@region
def _forward(x, expert_of_tile, w, bt: int) -> torch.Tensor:
    if x.is_meta:
        return x.new_empty((x.shape[0], w.shape[2]))
    if not x.is_cuda:
        return moe_gemm_plain(x, expert_of_tile, w, bt=bt)
    _check_tile(bt)
    e, d, f = w.shape
    y = torch.empty((x.shape[0], f), dtype=x.dtype, device=x.device)
    lib = _build.library("moe_gemm")
    err = _build.launch(
        lib.maple_moe_gemm, x.device,
        x.data_ptr(), expert_of_tile.data_ptr(), w.data_ptr(), y.data_ptr(),
        _DTYPES[x.dtype], x.shape[0], d, f, e, bt)
    _build.check(lib, err, "moe_gemm")
    moe_gemm.launches += 1
    return y


class _MoeGemmFunction(torch.autograd.Function):
    """B8 with its backward: dx on B8's transposed-weight mode, dW on
    ``moe_dw_kernel`` (their plain versions for CPU tensors)."""

    @staticmethod
    def forward(ctx, x, expert_of_tile, w, bt):
        ctx.bt = bt
        ctx.save_for_backward(x, expert_of_tile, w)
        return _forward(x, expert_of_tile, w, bt)

    @staticmethod
    def backward(ctx, dy):
        x, expert_of_tile, w = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = moe_gemm_dx(dy, expert_of_tile, w, bt=ctx.bt)
        if ctx.needs_input_grad[2]:
            dw = moe_gemm_dw(x, dy, expert_of_tile, w.shape[0], bt=ctx.bt)
        return dx, None, dw, None


def moe_gemm(x: torch.Tensor, expert_of_tile: torch.Tensor,
             w: torch.Tensor, *, bt: int) -> torch.Tensor:
    """``(T, F)`` in x's dtype: token tile ``i`` (rows ``i·bt`` to
    ``(i+1)·bt``) times ``w[expert_of_tile[i]]``, in f32.  Differentiable
    in x and w (:class:`_MoeGemmFunction`) on both devices."""
    _check(x, expert_of_tile, w, bt)
    if x.is_cuda:
        _check_tile(bt)
    return _MoeGemmFunction.apply(x, expert_of_tile, w, bt)


moe_gemm.launches = 0


@region
def moe_gemm_dx(dy: torch.Tensor, expert_of_tile: torch.Tensor,
                w: torch.Tensor, *, bt: int) -> torch.Tensor:
    """dx ``(T, D)`` of :func:`moe_gemm`: ``dy (T, F)`` tile ``i`` times
    ``w[expert_of_tile[i]]ᵀ``, on B8's transposed-weight mode (w read in
    place, no transposed copy); a launch adds one to
    ``moe_gemm.launches``."""
    e, d, f = w.shape
    _check(dy, expert_of_tile, w, bt, transposed=True)
    if dy.is_meta:
        return dy.new_empty((dy.shape[0], d))
    if not dy.is_cuda:
        return moe_gemm_dx_plain(dy, expert_of_tile, w, bt=bt)
    _check_tile(bt)
    dx = torch.empty((dy.shape[0], d), dtype=dy.dtype, device=dy.device)
    lib = _build.library("moe_gemm")
    err = _build.launch(
        lib.maple_moe_gemm_dx, dy.device,
        dy.data_ptr(), expert_of_tile.data_ptr(), w.data_ptr(), dx.data_ptr(),
        _DTYPES[dy.dtype], dy.shape[0], d, f, e, bt)
    _build.check(lib, err, "moe_gemm_dx")
    moe_gemm.launches += 1
    return dx


@region
def moe_gemm_dw(x: torch.Tensor, dy: torch.Tensor,
                expert_of_tile: torch.Tensor, n_experts: int, *,
                bt: int) -> torch.Tensor:
    """dW ``(E, D, F)`` of :func:`moe_gemm`, in x's dtype: for each expert
    the sum over the tiles it owns, in ascending order, of ``x_tileᵀ ·
    dy_tile``, in f32; zeros for an expert with no tile.  On the card one
    ``moe_dw_kernel`` launch, which adds one to ``moe_gemm_dw.launches``."""
    _check(x, expert_of_tile, None, bt)
    _check(dy, expert_of_tile, None, bt)      # so dy has x's T and device
    if dy.dtype != x.dtype:
        raise TypeError(f"dy must have x's dtype {x.dtype}, got {dy.dtype}")
    w_shape = (n_experts, x.shape[1], dy.shape[1])
    if x.is_meta:
        return x.new_empty(w_shape)
    if not x.is_cuda:
        return moe_gemm_dw_plain(x, dy, expert_of_tile, n_experts, bt=bt)
    dw = torch.empty(w_shape, dtype=x.dtype, device=x.device)
    lib = _build.library("moe_gemm")
    err = _build.launch(
        lib.maple_moe_dw, x.device,
        x.data_ptr(), dy.data_ptr(), expert_of_tile.data_ptr(), dw.data_ptr(),
        _DTYPES[x.dtype], x.shape[0], w_shape[1], w_shape[2], n_experts, bt)
    _build.check(lib, err, "moe_gemm_dw")
    moe_gemm_dw.launches += 1
    return dw


moe_gemm_dw.launches = 0


def moe_gemm_plain(x, expert_of_tile, w, *, bt: int) -> torch.Tensor:
    """Plain PyTorch version of :func:`moe_gemm`: one f32 batched product
    over the tiles, each against its expert's gathered weights."""
    t, d = x.shape
    tiles = x.float().view(t // bt, bt, d)
    out = torch.bmm(tiles, w.float()[expert_of_tile.long()])
    return out.reshape(t, w.shape[2]).to(x.dtype)


def moe_gemm_dx_plain(dy, expert_of_tile, w, *, bt: int) -> torch.Tensor:
    """Plain version of :func:`moe_gemm_dx`: :func:`moe_gemm_plain` over
    w transposed."""
    return moe_gemm_plain(dy, expert_of_tile, w.transpose(1, 2), bt=bt)


def moe_gemm_dw_plain(x, dy, expert_of_tile, n_experts: int, *,
                      bt: int) -> torch.Tensor:
    """Plain version of :func:`moe_gemm_dw`: each tile's f32 ``xᵀ · dy``,
    added into its expert's ``(D, F)`` in tile order."""
    t, d = x.shape
    f = dy.shape[1]
    prods = torch.bmm(x.float().view(t // bt, bt, d).transpose(1, 2),
                      dy.float().view(t // bt, bt, f))
    out = torch.zeros((n_experts, d, f), dtype=torch.float32,
                      device=x.device)
    for i, e in enumerate(expert_of_tile.tolist()):
        out[e] += prods[i]
    return out.to(x.dtype)
