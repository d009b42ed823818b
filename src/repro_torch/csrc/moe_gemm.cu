// MoE grouped GEMM for Hopper (sm_90a): y[t] = x[t] · w[expert(t)].
//
// Replaces repro/kernels/moe_gemm.py::moe_gemm_pallas.  x is (T, D) with
// the tokens sorted by expert and each expert's segment padded to a
// multiple of the token tile bt; expert_of_tile (T / bt,) int32 names the
// expert that owns each tile; w is (E, D, F).  Every output element is an
// f32 sum over D, written once in x's dtype:
//
//   y[t, f] = Σ_d x[t, d] · w[expert_of_tile[t / bt], d, f]
//
// The TPU grid (T/bt, F/bf, D/bd) carries a (bt, bf) f32 PSB in VMEM
// across the sequential D steps.  Here one thread block owns one
// (TM rows, TN columns) output tile and loops over D itself, TK rows of
// x's and w's panels at a time through shared memory; the PSB is RM × RN
// f32 registers a thread.  TM divides bt (the largest of 64, 32, 16 and 8
// that does: 8 at decode, 32 at prefill), so a tile never spans two
// experts: the block reads its expert id once.  An expert with no
// tile is never read (the Maple zero-block skip).  No atomics: every
// output element has one owner.
//
// What bounds it on the H100: at decode (bt = 8, every expert's weights
// read once for a few rows) bytes, the expert weights; at prefill
// (bt = 96) f32 operations.  The design is the plain shared-memory tiled
// FMA GEMM, with the next panel's loads in flight in registers while this
// one is multiplied; not done yet: tensor cores (TF32 would break f32
// parity, bf16 wgmma would not), TMA, and larger register tiles.
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

constexpr int kTN = 64;   // output columns of a tile
constexpr int kTK = 64;   // D rows of a shared-memory panel
constexpr int kRN = 4;    // columns a thread owns
constexpr int kTX = kTN / kRN;

// grid: (T / TM, ceil(F / kTN)); block: kTX × TY threads.  Thread (ty, tx)
// owns rows ty + i·TY (i < RM) and columns tx·kRN + j (j < kRN) of the
// tile.  The next D panel is loaded into registers (XN values of x, WN of
// w a thread, coalesced, converted to f32 only when stored to shared
// memory) while the current one is multiplied out of shared memory.
template <typename T, int TM>
__global__ void __launch_bounds__(kTX * (TM < 16 ? TM : 16))
moe_gemm_kernel(const T* __restrict__ x, const int* __restrict__ eot,
                const T* __restrict__ w, T* __restrict__ y, int D, int F,
                int bt) {
  constexpr int TY = TM < 16 ? TM : 16;
  constexpr int RM = TM / TY;
  constexpr int NT = kTX * TY;
  constexpr int XN = (TM * kTK + NT - 1) / NT;
  constexpr int WN = kTK * kTN / NT;
  __shared__ float xs[kTK][TM + 1];      // x panel, transposed
  __shared__ __align__(16) float ws[kTK][kTN];

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int64_t row0 = (int64_t)blockIdx.x * TM;
  const int col0 = blockIdx.y * kTN;
  const int64_t e = eot[row0 / bt];
  const T* xp = x + row0 * D;
  const T* wp = w + e * D * F;

  const T zero = from_f32<T>(0.0f);
  T xr[XN], wr[WN];
  auto stage = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XN; ++i) {
      const int idx = tid + i * NT;
      const int m = idx / kTK, k = k0 + idx % kTK;
      xr[i] = (idx < TM * kTK && k < D) ? xp[(int64_t)m * D + k] : zero;
    }
#pragma unroll
    for (int i = 0; i < WN; ++i) {
      const int idx = tid + i * NT;
      const int k = k0 + idx / kTN, c = col0 + idx % kTN;
      wr[i] = (k < D && c < F) ? wp[(int64_t)k * F + c] : zero;
    }
  };

  float acc[RM][kRN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < kRN; ++j) acc[i][j] = 0.0f;

  if (D > 0) stage(0);
  for (int k0 = 0; k0 < D; k0 += kTK) {
#pragma unroll
    for (int i = 0; i < XN; ++i) {
      const int idx = tid + i * NT;
      if (idx < TM * kTK) xs[idx % kTK][idx / kTK] = to_f32(xr[i]);
    }
#pragma unroll
    for (int i = 0; i < WN; ++i) {
      const int idx = tid + i * NT;
      ws[idx / kTN][idx % kTN] = to_f32(wr[i]);
    }
    __syncthreads();
    if (k0 + kTK < D) stage(k0 + kTK);
#pragma unroll 8
    for (int kk = 0; kk < kTK; ++kk) {
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * kRN]);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float a = xs[kk][ty + i * TY];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    T* yp = y + (row0 + ty + i * TY) * F;
#pragma unroll
    for (int j = 0; j < kRN; ++j) {
      const int c = col0 + tx * kRN + j;
      if (c < F) yp[c] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T, int TM>
cudaError_t launch_tm(const void* x, const int* eot, const void* w, void* y,
                      int T_rows, int D, int F, int bt, cudaStream_t st) {
  constexpr int TY = TM < 16 ? TM : 16;
  const dim3 grid(T_rows / TM, (F + kTN - 1) / kTN);
  moe_gemm_kernel<T, TM><<<grid, kTX * TY, 0, st>>>(
      (const T*)x, eot, (const T*)w, (T*)y, D, F, bt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const int* eot, const void* w, void* y,
                   int T_rows, int D, int F, int bt, cudaStream_t st) {
  if (bt % 64 == 0)
    return launch_tm<T, 64>(x, eot, w, y, T_rows, D, F, bt, st);
  if (bt % 32 == 0)
    return launch_tm<T, 32>(x, eot, w, y, T_rows, D, F, bt, st);
  if (bt % 16 == 0)
    return launch_tm<T, 16>(x, eot, w, y, T_rows, D, F, bt, st);
  return launch_tm<T, 8>(x, eot, w, y, T_rows, D, F, bt, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, w and y alike).  bt is a positive
// multiple of 8 that divides T; expert_of_tile holds T / bt ids in
// [0, E).
int maple_moe_gemm(const void* x, const int* expert_of_tile, const void* w,
                   void* y, int dtype, int T_rows, int D, int F, int bt,
                   void* stream) {
  if (bt <= 0 || bt % 8 || T_rows % bt) return (int)cudaErrorInvalidValue;
  if (T_rows == 0 || F == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(x, expert_of_tile, w, y, T_rows, D, F, bt, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, expert_of_tile, w, y, T_rows, D, F,
                                      bt, st);
  return (int)cudaErrorInvalidValue;
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
