// Maple two-phase SpGEMM for Hopper (sm_90a): the numeric phase (B5), the
// dA of its backward (B6) and the dB.
//
// Replaces repro/kernels/maple_spgemm.py::maple_spgemm_pallas (B5) and
// repro/kernels/maple_sddmm.py::maple_sddmm_csr_pallas (B6); dB replaces
// the XLA scatter-add of repro/kernels/ops.py::_spgemm_value_call.
//
// The symbolic phase (kernels/schedule.py::plan_spgemm, on the host) has
// fixed C's pattern and, for every partial product A[i,k']·B[k',u], its
// position within output row i.  SpgemmPlan.on_device hands the kernels
// that plan in A's CSR slot order: slot s of row i (a_rptr[i] <= s <
// a_rptr[i+1]) consumes B row a_cols[s] (b_rptr[k'] .. b_rptr[k'+1]), and
// its partials land at positions pos[part_ptr[s] + u] of row i, whose
// values sit at out_rptr[i] .. out_rptr[i+1] of C's value vector.
//
// The TPU kernel walks 8 lanes of rows serially, one A slot per grid step,
// with a (1, lc) f32 PSB in VMEM.  Rows are atomic in the plan, so here one
// warp owns one output row and the card runs ~8 000 rows at once:
//
//  * B5: the warp zeroes a PSB of the row's C length in shared memory,
//    applies the row's slots in order (lane u adds partial u; the partials
//    of one slot go to distinct positions, so no atomics), __syncwarp
//    between slots, and flushes the PSB straight into C's value vector
//    (the reference's ELL -> CSR compaction, fused; no (m+1, lc) buffer).
//    Products and sums round as the plain version's do (__fmul_rn then
//    __fadd_rn: no FMA contraction), so the two agree bit for bit in f32.
//  * B6: dA[s] = Σ_u B[k', u] · dC[out_rptr[i] + pos[part_ptr[s] + u]],
//    written into A's value layout at s.  A group of kCsrGroup = 8 lanes
//    owns row i (three steps of 8 cover cage12's B rows of about 15
//    entries; four rows a warp).  Lane j takes the terms j, j + 8, ... of
//    each slot's B row, the first kCsrSteps terms of kCsrDepth slots loaded together
//    (pos, B and the dC gathers through __ldg: a row's dC values are a
//    few lines of L1 that all its slots reuse), and a fixed xor-shuffle
//    tree sums each slot: reruns give the same bits.
//  * dB: one warp per B row k'; lane u owns B[k', u] and sums
//    A[s] · dC[out_rptr[row(s)] + pos[part_ptr[s] + u]] over A's column
//    fiber k' (t_perm[t_ptr[k'] .. t_ptr[k'+1]], in row order): a fixed
//    order, no atomics, so two runs give the same bits.
//
// Each lane first fetches one slot's metadata and the warp broadcasts it
// with __shfl_sync; B5 and dB issue kDepth slots' operand loads before
// their updates, so each lane keeps 2·kDepth loads in flight.
//
// What bounds it on the H100: bytes.  Per partial product a 4-byte
// position and a B value (B5, B6) or a dC value (B6, dB) are read once;
// 2 flops per partial cannot bound it (62 MFLOP at cage12 against ~0.1 ms
// of bytes).  Not done yet: staging B panels shared by neighbouring rows,
// vector loads, and splitting rows longer than 32 slots across warps.
//
// Plain C interface (bound with ctypes); each launcher returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kDepth = 8;        // slots whose loads are issued together
constexpr int kCsrGroup = 8;     // B6: lanes an output row and a slot,
constexpr int kCsrDepth = 2;     // slots a lane group has in flight,
constexpr int kCsrSteps = 3;     // the first steps of 8 terms of each
constexpr unsigned kFull = 0xffffffffu;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The plan in A's CSR slot order (SpgemmPlan.on_device).
struct Plan {
  const int* a_rptr;          // (m + 1)
  const int* a_cols;          // (nnz_a)
  const int* b_rptr;          // (k + 1)
  const long long* part_ptr;  // (nnz_a + 1)
  const int* pos;             // (P)
  const long long* out_rptr;  // (m + 1)
};

// One A slot's metadata, fetched by one lane and broadcast to the warp.
struct Slot {
  float a;         // A value (B5) or 0 (B6)
  int b0, bn;      // the B row's first value and length
  long long pp;    // first partial
};

__device__ __forceinline__ Slot shfl(const Slot& s, int src) {
  return Slot{__shfl_sync(kFull, s.a, src), __shfl_sync(kFull, s.b0, src),
              __shfl_sync(kFull, s.bn, src), __shfl_sync(kFull, s.pp, src)};
}

template <typename T>
__device__ __forceinline__ Slot fetch_slot(const T* __restrict__ a_val,
                                           const Plan& plan, int s) {
  const int col = plan.a_cols[s];
  const int b0 = plan.b_rptr[col];
  return Slot{a_val ? to_f32(a_val[s]) : 0.0f, b0, plan.b_rptr[col + 1] - b0,
              plan.part_ptr[s]};
}

// ---------------------------------------------------------------- B5 ----
// grid: (ceil(m / warps),), block: warps · 32; shared: warps · lc floats.
template <typename T>
__global__ void spgemm_kernel(const T* __restrict__ a_val,
                              const T* __restrict__ b_val, Plan plan,
                              T* __restrict__ out, int m, int lc) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (row >= m) return;                      // the whole warp leaves
  const long long c0 = plan.out_rptr[row];
  const int n_c = (int)(plan.out_rptr[row + 1] - c0);
  if (n_c == 0) return;
  float* psb = smem + (size_t)warp * lc;
  for (int p = lane; p < n_c; p += kWarp) psb[p] = 0.0f;
  __syncwarp();
  const int s0 = plan.a_rptr[row], s1 = plan.a_rptr[row + 1];
  for (int base = s0; base < s1; base += kWarp) {
    const Slot mine = base + lane < s1 ? fetch_slot(a_val, plan, base + lane)
                                       : Slot{0.0f, 0, 0, 0};
    const int cnt = min(kWarp, s1 - base);
    for (int j0 = 0; j0 < cnt; j0 += kDepth) {
      // only each lane's first partial of kDepth slots stays in registers
      // (2 a slot); a panel wider than a warp re-reads its metadata below
      float prod[kDepth];
      int at[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        const Slot sl = shfl(mine, (j0 + d) & (kWarp - 1));
        at[d] = -1;
        if (j0 + d < cnt && lane < sl.bn) {
          at[d] = plan.pos[sl.pp + lane];
          prod[d] = __fmul_rn(sl.a, to_f32(b_val[sl.b0 + lane]));
        }
      }
#pragma unroll
      for (int d = 0; d < kDepth; ++d) {
        if (j0 + d >= cnt) break;                // the same for every lane
        if (at[d] >= 0) psb[at[d]] = __fadd_rn(psb[at[d]], prod[d]);
        if (__shfl_sync(kFull, mine.bn, j0 + d) > kWarp) {
          const Slot sl = shfl(mine, j0 + d);
          for (int u = lane + kWarp; u < sl.bn; u += kWarp) {
            const int p = plan.pos[sl.pp + u];
            psb[p] = __fadd_rn(psb[p],
                               __fmul_rn(sl.a, to_f32(b_val[sl.b0 + u])));
          }
        }
        __syncwarp();
      }
    }
  }
  for (int p = lane; p < n_c; p += kWarp) out[c0 + p] = from_f32<T>(psb[p]);
}

// ---------------------------------------------------------------- B6 ----
// grid: (ceil(m / (warps · 4)),), block: warps · 32.  A group of G = 8
// lanes owns one output row (4 rows a warp) and walks the row's
// slots one at a time: lane j takes terms j, j + G, ... of the slot's B
// row, the first kCsrSteps terms of kCsrDepth slots loaded together, and
// the group's terms meet in a fixed xor-shuffle tree.  The row's dC
// values are gathered through L1 (__ldg): they are a few cache lines
// that every slot of the row reuses.
template <typename T>
__global__ void __launch_bounds__(256)
sddmm_csr_kernel(const T* __restrict__ dc, const T* __restrict__ b_val,
                 Plan plan, float* __restrict__ da, int m) {
  constexpr int G = kCsrGroup, D = kCsrDepth, KS = kCsrSteps;
  const int lane = threadIdx.x % kWarp, j = lane % G;
  const int row = blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  int s0 = 0, n_s = 0;
  long long pp_row = 0;
  const T* dc_row = dc;
  if (row < m) {
    s0 = __ldg(plan.a_rptr + row);
    n_s = __ldg(plan.a_rptr + row + 1) - s0;
    dc_row = dc + __ldg(plan.out_rptr + row);
    if (n_s) pp_row = __ldg(plan.part_ptr + s0);
  }
  // the warp walks as many slots as its longest row has
  int n_max = n_s;
#pragma unroll
  for (int off = G; off < kWarp; off *= 2)
    n_max = max(n_max, __shfl_xor_sync(kFull, n_max, off));
  const int* pos_row = plan.pos + pp_row;     // partials from the row's first
  for (int t0 = 0; t0 < n_max; t0 += G) {
    // lane j fetches slot t0 + j of its row: its B row and first partial
    int my_b0 = 0, my_bn = 0, my_pp = 0;
    if (t0 + j < n_s) {
      const int s = s0 + t0 + j;
      const int col = __ldg(plan.a_cols + s);
      my_pp = (int)(__ldg(plan.part_ptr + s) - pp_row);
      my_b0 = __ldg(plan.b_rptr + col);
      my_bn = __ldg(plan.b_rptr + col + 1) - my_b0;
    }
    const int span = min(G, n_max - t0);
    for (int d0 = 0; d0 < span; d0 += D) {
      int b0[D], bn[D], pp[D], at[D][KS];
      float bv[D][KS];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int src = (d0 + d) & (G - 1);
        b0[d] = __shfl_sync(kFull, my_b0, src, G);
        bn[d] = __shfl_sync(kFull, my_bn, src, G);
        pp[d] = __shfl_sync(kFull, my_pp, src, G);
        if (d0 + d >= span || t0 + d0 + d >= n_s) bn[d] = 0;
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const int u = j + k * G;
          at[d][k] = -1;
          if (u < bn[d]) {
            at[d][k] = __ldg(pos_row + pp[d] + u);
            bv[d][k] = to_f32(__ldg(b_val + b0[d] + u));
          }
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float acc = at[d][0] >= 0
                        ? bv[d][0] * to_f32(__ldg(dc_row + at[d][0])) : 0.0f;
#pragma unroll
        for (int k = 1; k < KS; ++k)
          if (at[d][k] >= 0)
            acc = fmaf(bv[d][k], to_f32(__ldg(dc_row + at[d][k])), acc);
        for (int u = j + KS * G; u < bn[d]; u += G)   // rows over KS·G
          acc = fmaf(to_f32(__ldg(b_val + b0[d] + u)),
                     to_f32(__ldg(dc_row + __ldg(pos_row + pp[d] + u))),
                     acc);
#pragma unroll
        for (int off = G / 2; off > 0; off /= 2)
          acc += __shfl_xor_sync(kFull, acc, off);
        const int t = t0 + d0 + d;
        if (j == 0 && d0 + d < span && t < n_s) da[s0 + t] = acc;
      }
    }
  }
}

// ---------------------------------------------------------------- dB ----
// grid: (ceil(kb / warps),), block: warps · 32.
template <typename T>
__global__ void spgemm_db_kernel(const T* __restrict__ dc,
                                 const T* __restrict__ a_val,
                                 const int* __restrict__ a_rows,
                                 const int* __restrict__ t_ptr,
                                 const int* __restrict__ t_perm, Plan plan,
                                 float* __restrict__ db, int kb) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int k = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (k >= kb) return;
  const int b0 = plan.b_rptr[k], bn = plan.b_rptr[k + 1] - b0;
  const int f0 = t_ptr[k], f1 = t_ptr[k + 1];
  for (int u0 = 0; u0 < bn; u0 += kWarp) {
    const int u = u0 + lane;
    float acc = 0.0f;
    for (int base = f0; base < f1; base += kWarp) {
      // lane j fetches the fiber's j-th slot: its A value, first partial
      // and output row's first value
      float my_a = 0.0f;
      long long my_pp = 0, my_c0 = 0;
      if (base + lane < f1) {
        const int s = t_perm[base + lane];
        my_a = to_f32(a_val[s]);
        my_pp = plan.part_ptr[s];
        my_c0 = plan.out_rptr[a_rows[s]];
      }
      const int cnt = min(kWarp, f1 - base);
      for (int j0 = 0; j0 < cnt; j0 += kDepth) {
        float a[kDepth], g[kDepth];
#pragma unroll
        for (int d = 0; d < kDepth; ++d) {
          const int src = (j0 + d) & (kWarp - 1);
          a[d] = __shfl_sync(kFull, my_a, src);
          const long long pp = __shfl_sync(kFull, my_pp, src);
          const long long c0 = __shfl_sync(kFull, my_c0, src);
          g[d] = 0.0f;
          if (j0 + d < cnt && u < bn) g[d] = to_f32(dc[c0 + plan.pos[pp + u]]);
        }
#pragma unroll
        for (int d = 0; d < kDepth; ++d)
          if (j0 + d < cnt) acc = fmaf(a[d], g[d], acc);
      }
    }
    if (u < bn) db[b0 + u] = acc;
  }
}

template <typename K>
cudaError_t fit_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T>
cudaError_t launch_spgemm(const void* a_val, const void* b_val,
                          const Plan& plan, void* out, int m, int lc,
                          int warps, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)warps * lc;
  const cudaError_t err = fit_smem(spgemm_kernel<T>, smem);
  if (err != cudaSuccess) return err;
  spgemm_kernel<T><<<(m + warps - 1) / warps, warps * kWarp, smem, st>>>(
      (const T*)a_val, (const T*)b_val, plan, (T*)out, m, lc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sddmm(const void* dc, const void* b_val, const Plan& plan,
                         float* da, int m, int warps, cudaStream_t st) {
  const int rows = warps * kWarp / kCsrGroup;     // rows a CTA
  sddmm_csr_kernel<T><<<(m + rows - 1) / rows, warps * kWarp, 0, st>>>(
      (const T*)dc, (const T*)b_val, plan, da, m);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_db(const void* dc, const void* a_val, const int* a_rows,
                      const int* t_ptr, const int* t_perm, const Plan& plan,
                      float* db, int kb, int warps, cudaStream_t st) {
  spgemm_db_kernel<T><<<(kb + warps - 1) / warps, warps * kWarp, 0, st>>>(
      (const T*)dc, (const T*)a_val, a_rows, t_ptr, t_perm, plan, db, kb);
  return cudaGetLastError();
}

bool bad_warps(int warps) { return warps < 1 || warps > 32; }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (the two value operands alike).

// B5: C's value vector out[out_rptr[0] .. out_rptr[m]] in the values'
// dtype (slots past it are the caller's).  lc is the longest output row.
int maple_spgemm(const void* a_val, const void* b_val, const int* a_rptr,
                 const int* a_cols, const int* b_rptr,
                 const long long* part_ptr, const int* pos,
                 const long long* out_rptr, void* out, int dtype, int m,
                 int lc, int warps, void* stream) {
  if (m == 0) return (int)cudaSuccess;
  if (bad_warps(warps) || lc < 1) return (int)cudaErrorInvalidValue;
  const Plan plan{a_rptr, a_cols, b_rptr, part_ptr, pos, out_rptr};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_spgemm<float>(a_val, b_val, plan, out, m, lc, warps,
                                     st);
  if (dtype == 1)
    return (int)launch_spgemm<__nv_bfloat16>(a_val, b_val, plan, out, m, lc,
                                             warps, st);
  return (int)cudaErrorInvalidValue;
}

// B6: da[a_rptr[0] .. a_rptr[m]] (f32), one value per live A slot.
int maple_sddmm_csr(const void* dc, const void* b_val, const int* a_rptr,
                    const int* a_cols, const int* b_rptr,
                    const long long* part_ptr, const int* pos,
                    const long long* out_rptr, float* da, int dtype, int m,
                    int warps, void* stream) {
  if (m == 0) return (int)cudaSuccess;
  if (bad_warps(warps) || warps > 8) return (int)cudaErrorInvalidValue;
  const Plan plan{a_rptr, a_cols, b_rptr, part_ptr, pos, out_rptr};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_sddmm<float>(dc, b_val, plan, da, m, warps, st);
  if (dtype == 1)
    return (int)launch_sddmm<__nv_bfloat16>(dc, b_val, plan, da, m, warps,
                                            st);
  return (int)cudaErrorInvalidValue;
}

// dB: db[b_rptr[0] .. b_rptr[kb]] (f32), one value per live B entry.
int maple_spgemm_db(const void* dc, const void* a_val, const int* a_rows,
                    const long long* part_ptr, const int* pos,
                    const long long* out_rptr, const int* b_rptr,
                    const int* t_ptr, const int* t_perm, float* db,
                    int dtype, int kb, int warps, void* stream) {
  if (kb == 0) return (int)cudaSuccess;
  if (bad_warps(warps)) return (int)cudaErrorInvalidValue;
  const Plan plan{nullptr, nullptr, b_rptr, part_ptr, pos, out_rptr};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_db<float>(dc, a_val, a_rows, t_ptr, t_perm, plan, db,
                                 kb, warps, st);
  if (dtype == 1)
    return (int)launch_db<__nv_bfloat16>(dc, a_val, a_rows, t_ptr, t_perm,
                                         plan, db, kb, warps, st);
  return (int)cudaErrorInvalidValue;
}

// The shared memory one block may opt in to on `device`, in bytes (the
// PSB of B5 must fit in it), or -1 on error.
int maple_smem_optin(int device) {
  int bytes = 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return bytes;
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
