// Maple block SDDMM for Hopper (sm_90a), f32 FMA: the dA half of the
// maple_spmm backward.
//
// Replaces repro/kernels/maple_sddmm.py::maple_sddmm_bsr_pallas.  For
// C = A·B with A block-sparse, the gradient of A's payload is the dense
// product dC·Bᵀ sampled at A's block pattern:
//
//   dA[s] = Σ_g Σ_n dC[g, row(s)·bm + i, n] · B[g, col(s)·bk + k, n]
//
// one (bm, bk) f32 tile per block slot s; pad slots (block_col < 0) come
// out 0.  The TPU grid (n_blocks, G, N/bn) keeps the slot outermost and
// carries the (bm, bk) PSB across the sequential (g, j) steps.  Here one
// thread block owns one slot and runs that (g, N-tile) walk itself, in a
// fixed order, with the PSB in registers (TM × TN per thread): no atomics,
// so two runs give the same bits.  Each N-tile stages the slot's dC row
// tile (bm × kc) and B column panel (bk × kc) in shared memory, transposed
// so that the FMA loop reads both operands along the tile's rows.  A dense
// dC·Bᵀ is never formed: only the live slots' tiles are computed.
//
// What bounds it on the H100: each live slot does 2·bm·bk·G·N FLOPs and
// writes bm·bk·4 bytes.  At the MLP's training shape (64×64 blocks, G=1,
// N=256 tokens) that is 512 FLOPs per output byte, above the FP32 ridge
// (67 TFLOP/s / 3.35 TB/s = 20), so FMA throughput bounds it; the staged
// operands are reused bk/TN and bm/TM times from shared memory.  At the
// logit head's shape (N = 4 tokens) it is 8 FLOPs per byte: the 16 KB
// output tile of each of ~48 000 slots bounds it, and the stores of
// neighbouring threads fall on neighbouring addresses.  Not done yet:
// tensor cores (wgmma), overlapping the next tile's loads with the FMAs
// (cp.async / TMA), and sharing one staged dC row tile among the slots of
// a block-row.
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;      // loads a thread starts before storing any
constexpr int kMaxThreads = 256;

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One launch: dC is (G, M, N), B is (G, K, N), both row-major; kc columns
// of N are staged at a time.
struct Geom {
  int G, M, K, N, bm, bk, kc;
};

// Stage columns n0 .. n0+kc (zero past N) of `rows` rows of x, starting at
// row0, into dst[kk * (rows + 1) + r].  Neighbouring threads read
// neighbouring columns; the +1 pad puts the transposed stores of one warp
// in distinct banks.
template <typename T>
__device__ __forceinline__ void stage_t(const T* __restrict__ x,
                                        int64_t row0, int rows, int n0,
                                        const Geom& geo, float* dst) {
  const int stride = rows + 1;
  const int total = rows * geo.kc;
  for (int base = threadIdx.x; base < total;
       base += kUnroll * blockDim.x) {
    float v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * blockDim.x;
      const int r = idx / geo.kc, n = n0 + idx % geo.kc;
      v[u] = (idx < total && n < geo.N)
                 ? to_f32(x[(row0 + r) * geo.N + n]) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < total) dst[(idx % geo.kc) * stride + idx / geo.kc] = v[u];
    }
  }
}

// grid: (n_blocks,); thread (ty, tx) holds rows ty + i·(bm/TM) and
// columns tx + j·(bk/TN) of the slot's (bm, bk) tile.
template <typename T, int TM, int TN>
__global__ void __launch_bounds__(kMaxThreads)
sddmm_bsr_kernel(const T* __restrict__ dc, const T* __restrict__ b,
                 const int* __restrict__ block_row,
                 const int* __restrict__ block_col, float* __restrict__ out,
                 Geom geo) {
  extern __shared__ float smem[];
  const int s = blockIdx.x;
  const int col = block_col[s];
  const int tx_n = geo.bk / TN, ty_n = geo.bm / TM;
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  if (col >= 0) {                   // the same branch for the whole block
    const int64_t row0 = (int64_t)block_row[s] * geo.bm;
    const int64_t col0 = (int64_t)col * geo.bk;
    float* ds = smem;                                 // (kc, bm + 1)
    float* bs = smem + geo.kc * (geo.bm + 1);         // (kc, bk + 1)
    for (int g = 0; g < geo.G; ++g) {
      const T* dc_g = dc + (int64_t)g * geo.M * geo.N;
      const T* b_g = b + (int64_t)g * geo.K * geo.N;
      for (int n0 = 0; n0 < geo.N; n0 += geo.kc) {
        stage_t(dc_g, row0, geo.bm, n0, geo, ds);
        stage_t(b_g, col0, geo.bk, n0, geo, bs);
        __syncthreads();
        for (int kk = 0; kk < geo.kc; ++kk) {
          float av[TM], bv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i)
            av[i] = ds[kk * (geo.bm + 1) + ty + i * ty_n];
#pragma unroll
          for (int j = 0; j < TN; ++j)
            bv[j] = bs[kk * (geo.bk + 1) + tx + j * tx_n];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
    }
  }
  float* o = out + (int64_t)s * geo.bm * geo.bk;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      o[(ty + i * ty_n) * geo.bk + tx + j * tx_n] = acc[i][j];
}

// Register tile per thread: the first (TM, TN) that divides the block and
// gives 64..256 threads; (1, 1) for the small blocks of the tests.
// Returns -1 when no tile fits.
int pick_config(int bm, int bk) {
  const int tms[5] = {4, 8, 2, 2, 1}, tns[5] = {4, 8, 4, 2, 1};
  for (int c = 0; c < 5; ++c) {
    if (bm % tms[c] || bk % tns[c]) continue;
    const int tpg = (bm / tms[c]) * (bk / tns[c]);
    if (tpg >= 64 && tpg <= kMaxThreads) return c;
  }
  return bm * bk <= kMaxThreads ? 4 : -1;
}

template <typename T, int TM, int TN>
cudaError_t launch(const void* dc, const void* b, const int* block_row,
                   const int* block_col, float* out, int n_blocks,
                   const Geom& geo, cudaStream_t stream) {
  const int threads = (geo.bm / TM) * (geo.bk / TN);
  const size_t smem = sizeof(float) * geo.kc * (geo.bm + geo.bk + 2);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        sddmm_bsr_kernel<T, TM, TN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sddmm_bsr_kernel<T, TM, TN><<<n_blocks, threads, smem, stream>>>(
      (const T*)dc, (const T*)b, block_row, block_col, out, geo);
  return cudaGetLastError();
}

#define DISPATCH_CONFIG(cfg, T, ...)                          \
  switch (cfg) {                                              \
    case 0: return (int)launch<T, 4, 4>(__VA_ARGS__);         \
    case 1: return (int)launch<T, 8, 8>(__VA_ARGS__);         \
    case 2: return (int)launch<T, 2, 4>(__VA_ARGS__);         \
    case 3: return (int)launch<T, 2, 2>(__VA_ARGS__);         \
    case 4: return (int)launch<T, 1, 1>(__VA_ARGS__);         \
    default: return (int)cudaErrorInvalidConfiguration;       \
  }

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (dC and B alike).  out is the f32
// (n_blocks, bm, bk) payload gradient; every slot is written.  kc (the N
// columns staged at a time) is a power of two in [16, 64].
int maple_sddmm_bsr(const void* dc, const void* b, const int* block_row,
                    const int* block_col, float* out, int dtype,
                    int n_blocks, int G, int M, int K, int N, int bm, int bk,
                    int kc, void* stream) {
  if (n_blocks == 0) return (int)cudaSuccess;
  if (kc < 16 || kc > 64 || (kc & (kc - 1))) return (int)cudaErrorInvalidValue;
  const int cfg = pick_config(bm, bk);
  const Geom geo{G, M, K, N, bm, bk, kc};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    DISPATCH_CONFIG(cfg, float, dc, b, block_row, block_col, out, n_blocks,
                    geo, st)
  }
  if (dtype == 1) {
    DISPATCH_CONFIG(cfg, __nv_bfloat16, dc, b, block_row, block_col, out,
                    n_blocks, geo, st)
  }
  return (int)cudaErrorInvalidValue;
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
