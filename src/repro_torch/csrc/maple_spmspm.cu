// Maple element walk with a dense B for Hopper (sm_90a): C = A_ell · B.
//
// Replaces repro/kernels/maple_spmspm.py::maple_spmspm_pallas.  A is
// ELL-regularized CSR, values and col_ids (M, L) with col -1 and value 0
// on pads; B is dense (K, N).  Row i of C is Σ_t A[i, t] · B[col(i, t), :],
// summed in f32 in slot order and written once in A's dtype:
//
//   C[i, n] = (((0 + a_0·B[c_0, n]) + a_1·B[c_1, n]) + ...)
//
// The TPU grid (M, L) walks one slot per step with a (1, N) f32 PSB in
// VMEM, zeroed at t = 0 and flushed at t = L - 1.  Here a group of lanes
// owns a row: 16 lanes where 16 vectors cover N (N ≤ 64 with 4-wide
// loads: cage12 at N = 64 puts two rows in a warp), else the whole warp,
// walking N in passes of 32 vectors.  A 256-thread CTA holds 8 warps, so
// 8 or 16 rows.  Each lane holds 4 columns (4-wide loads where N·size and
// the pointers allow, else one column) and their f32 PSB in registers.
//   - The group loads its row's col_ids and values once per 32 slots,
//     coalesced (slot t on lane t % group), and hands each slot out with
//     __shfl_sync.
//   - It issues the B-row loads of 4 slots before the first add, so 4
//     loads a lane are in flight instead of one chain of dependent loads;
//     the adds then follow in slot order.  Pad slots are skipped, loads and
//     adds alike (the reference multiplies them by 0).  B is read through
//     the read-only path (__ldg), so that the B rows a CTA's neighbouring
//     rows share are found in L1.
//   - Products and sums round as the plain version's do (__fmul_rn, then
//     __fadd_rn: no FMA contraction), so the two agree bit for bit.
//
// What bounds it on the H100: bytes.  Each live slot reads one B row
// (N values) and does 2N flops.  The bound counts B once; rows that share
// B rows read them again, from L1 where they are close (a CTA's 8 to 16
// consecutive rows of a banded matrix share most of their columns) and
// from L2 otherwise, so the design is about loads in flight.
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() right after the launch.

#include "hopper.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kBatch = 4;        // B-row loads a lane issues before adding

// grid: (ceil(M / (kWarps · 32 / G)),); G lanes a row, kV columns a lane
template <typename T, int G, int kV>
__global__ void __launch_bounds__(kWarps * 32)
spmspm_kernel(const T* __restrict__ values, const int* __restrict__ col_ids,
              const T* __restrict__ b, T* __restrict__ out, int M, int L,
              int N) {
  constexpr int kRows = 32 / G;                      // rows a warp
  constexpr int kRegs = 32 / G;                      // slots a lane, a tile
  const int lane = threadIdx.x % 32, j = lane % G;
  const int64_t row = ((int64_t)blockIdx.x * kWarps + threadIdx.x / 32) *
                          kRows + lane / G;
  const bool live_row = row < M;                     // the warp stays whole
  const T* v_row = values + row * L;
  const int* c_row = col_ids + row * L;
  for (int n0 = 0; n0 < N; n0 += G * kV) {
    const int n = n0 + j * kV;
    float acc[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) acc[e] = 0.0f;
    for (int t0 = 0; t0 < L; t0 += 32) {
      // slots t0 .. t0 + 31: slot t0 + j + G·r in register r of lane j
      int cr[kRegs];
      float vr[kRegs];
#pragma unroll
      for (int r = 0; r < kRegs; ++r) {
        const int t = t0 + j + G * r;
        const bool in = live_row && t < L;
        cr[r] = in ? c_row[t] : -1;
        vr[r] = in ? to_f32(v_row[t]) : 0.0f;
      }
      const int span = min(32, L - t0);
      for (int u0 = 0; u0 < span; u0 += kBatch) {
        // the batch's slots lie in one register: kBatch divides G
        const int reg = u0 / G;
        int c_sel = cr[0];
        float v_sel = vr[0];
#pragma unroll
        for (int r = 1; r < kRegs; ++r)
          if (reg == r) { c_sel = cr[r]; v_sel = vr[r]; }
        int c[kBatch];
        float a[kBatch], x[kBatch][kV];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          c[u] = __shfl_sync(0xffffffffu, c_sel, (u0 + u) % G, G);
          a[u] = __shfl_sync(0xffffffffu, v_sel, (u0 + u) % G, G);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const T* src = b + (int64_t)c[u] * N + n;
          if constexpr (kV == 4) {
            using V = typename Vec4<T>::type;
            if (c[u] >= 0 && n < N)
              Vec4<T>::unpack(__ldg(reinterpret_cast<const V*>(src)), x[u]);
          } else if (c[u] >= 0 && n < N) {
            x[u][0] = to_f32(__ldg(src));
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (c[u] >= 0)
#pragma unroll
            for (int e = 0; e < kV; ++e)
              acc[e] = __fadd_rn(acc[e], __fmul_rn(a[u], x[u][e]));
      }
    }
    if (live_row && n < N) {
      T* o = out + row * N + n;
      if constexpr (kV == 4) {
        __align__(8) T w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = from_f32<T>(acc[e]);
        *reinterpret_cast<typename Vec4<T>::type*>(o) =
            *reinterpret_cast<const typename Vec4<T>::type*>(w);
      } else {
        *o = from_f32<T>(acc[0]);
      }
    }
  }
}

template <typename T, int G, int kV>
cudaError_t launch(const void* values, const int* col_ids, const void* b,
                   void* out, int M, int L, int N, cudaStream_t st) {
  const int rows = kWarps * 32 / G;
  spmspm_kernel<T, G, kV><<<(M + rows - 1) / rows, kWarps * 32, 0, st>>>(
      (const T*)values, col_ids, (const T*)b, (T*)out, M, L, N);
  return cudaGetLastError();
}

// 4-wide where every row of B and C starts on a vector; 16 lanes a row
// where they cover N
template <typename T>
cudaError_t route(const void* values, const int* col_ids, const void* b,
                  void* out, int M, int L, int N, cudaStream_t st) {
  const size_t vec = 4 * sizeof(T);
  const bool v4 = N % 4 == 0 && reinterpret_cast<uintptr_t>(b) % vec == 0 &&
                  reinterpret_cast<uintptr_t>(out) % vec == 0;
  const int per = v4 ? 4 : 1;
  if ((N + per - 1) / per <= 16)
    return v4 ? launch<T, 16, 4>(values, col_ids, b, out, M, L, N, st)
              : launch<T, 16, 1>(values, col_ids, b, out, M, L, N, st);
  return v4 ? launch<T, 32, 4>(values, col_ids, b, out, M, L, N, st)
            : launch<T, 32, 1>(values, col_ids, b, out, M, L, N, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (values and B alike); out is (M, N) in
// that dtype.
int maple_spmspm(const void* values, const int* col_ids, const void* b,
                 void* out, int dtype, int M, int L, int N, void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)route<float>(values, col_ids, b, out, M, L, N, st);
  if (dtype == 1)
    return (int)route<__nv_bfloat16>(values, col_ids, b, out, M, L, N, st);
  return (int)cudaErrorInvalidValue;
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
