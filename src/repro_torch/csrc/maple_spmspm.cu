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
// VMEM, zeroed at t = 0 and flushed at t = L - 1.  Here one thread block
// owns one (row, N tile), each thread one column of the tile, and the PSB
// is one f32 register a thread: the block loops over the row's L slots
// itself.  Pad slots are skipped (the reference multiplies them by 0).
// Products and sums round as the plain version's do (__fmul_rn, then
// __fadd_rn: no FMA contraction), so the two agree bit for bit.
//
// What bounds it on the H100: bytes.  Each live slot reads one B row
// (N values) and does 2N flops; neighbouring threads read neighbouring
// columns, so each B row is read in whole sectors.  Rows that share B
// rows read them again (through L2): the bound counts B once.  Not done
// yet: several rows per block sharing staged B rows, vector loads.
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// grid: (M, ceil(N / blockDim.x)); thread n of the tile owns column
// blockIdx.y · blockDim.x + n.
template <typename T>
__global__ void spmspm_kernel(const T* __restrict__ values,
                              const int* __restrict__ col_ids,
                              const T* __restrict__ b, T* __restrict__ out,
                              int L, int N) {
  const int64_t row = blockIdx.x;
  const int n = blockIdx.y * blockDim.x + threadIdx.x;
  const T* v = values + row * L;
  const int* c = col_ids + row * L;
  float acc = 0.0f;
  if (n < N) {
    for (int t = 0; t < L; ++t) {
      const int col = c[t];
      if (col < 0) continue;
      acc = __fadd_rn(acc, __fmul_rn(to_f32(v[t]),
                                     to_f32(b[(int64_t)col * N + n])));
    }
    out[row * N + n] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* values, const int* col_ids, const void* b,
                   void* out, int M, int L, int N, int tile,
                   cudaStream_t st) {
  const dim3 grid(M, (N + tile - 1) / tile);
  spmspm_kernel<T><<<grid, tile, 0, st>>>((const T*)values, col_ids,
                                          (const T*)b, (T*)out, L, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (values and B alike); out is (M, N) in
// that dtype.  tile (threads per block) is a power of two in [32, 1024].
int maple_spmspm(const void* values, const int* col_ids, const void* b,
                 void* out, int dtype, int M, int L, int N, int tile,
                 void* stream) {
  if (M == 0 || N == 0) return (int)cudaSuccess;
  if (tile < 32 || tile > 1024 || (tile & (tile - 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(values, col_ids, b, out, M, L, N, tile, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(values, col_ids, b, out, M, L, N, tile,
                                      st);
  return (int)cudaErrorInvalidValue;
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
