// Block-sparse local flash attention for Hopper (sm_90a).
//
// Replaces repro/kernels/block_attn.py::block_attention_pallas.  q, k and
// v are (B, S, H, hd); kv_map (nq, max_nb) int32 lists, for each q-block
// of bq rows, the kv-blocks of bk keys it may touch (-1 pads).  Within a
// listed block, key kpos is visible to query qpos when qpos >= kpos
// (causal) and qpos - kpos < window (window > 0).  Scores are
// (q · k) / scale with scale = sqrt(hd), and the softmax runs online in
// f32 (m, l, acc) with the reference's guards: m_safe = 0 while a row's
// max is -inf, corr = 0 while its previous max was -inf, and the output is
// acc / max(l, 1e-20), written once in q's dtype.
//
// The TPU kernel takes one example and folds all H heads into one
// (bq, H, hd) block, walking grid (nq, max_nb) and fetching block 0 for
// pad entries.  At H = 16 and hd = 256 in f32 that block alone is 2 MB,
// where one SM has 227 KB of shared memory.  Here one thread block owns
// one (example, head, QT-row slice of a q-block): the batch is in the
// grid, Q stays in shared memory, and the block walks only the live
// entries of its q-block's kv_map row, streaming each kv-block through
// shared memory KT keys at a time (K, then V into the same buffer).
// Chunks that no row of the slice may see (above the causal diagonal,
// behind the window) are skipped: they would leave (m, l, acc) unchanged.
//
// Threads: 256 as 16 × 16.  Scores: thread (ty, tx) owns rows ty·4 + i
// and keys tx + 16·j of the 64 × 64 chunk, four hd values per float4
// shared load.  P·V: the same thread owns rows ty·4 + i and columns
// tx·4 + 64·j + c of the output.  The row max and sum are taken by four
// threads a row (keys interleaved) and two shuffles.  Rows are padded by
// four floats in shared memory, so float4 loads stay aligned and the
// strided rows fall in distinct banks.  Tiles come in from device memory
// as four-value loads, hd / 4 threads a row and four rows in flight a
// thread.
//
// What bounds it on the H100: f32 operations (4·hd per visible-tile
// score, 256 to 512 per byte moved at recurrentgemma's shape).  Not done
// yet: tensor cores (TF32 would break f32 parity), TMA and double
// buffering of the K/V chunks.
//
// Plain C interface (bound with ctypes); the launcher returns
// cudaGetLastError() right after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four consecutive values of one row as f32 (16-byte f32 or 8-byte bf16
// loads: hd is a multiple of 4, so every row start is aligned).
template <typename T> __device__ __forceinline__ float4 load4(const T* p);
template <> __device__ __forceinline__ float4 load4<float>(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
template <>
__device__ __forceinline__ float4 load4<__nv_bfloat16>(
    const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

constexpr int kQT = 64;        // query rows of a thread block
constexpr int kKT = 64;        // keys of a streamed chunk
constexpr int kThreads = 256;  // 16 × 16
constexpr int kLdP = kKT + 4;  // row stride of the score / P tile

struct Args {
  int S, H, hd, max_nb, bq, bk, causal, window;
  float scale;
};

size_t smem_bytes(int hd) {
  const size_t ld = hd + 4;
  return sizeof(float) * ((kQT + kKT) * ld + kQT * kLdP + 3 * kQT);
}

// Rows [0, n_rows) of a (rows, hd) tile into shared memory (row stride
// ld), rows from `valid` on as zeros; src is row 0, rows row_stride
// apart.  hd / 4 threads a row, four rows' loads in flight a thread.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t row_stride, int valid,
                                          int n_rows, int hd, int ld) {
  const int per_row = hd / 4;
  const int rows_per_pass = kThreads / per_row;
  const int r0 = threadIdx.x / per_row;
  if (r0 >= rows_per_pass) return;
  const int d = (threadIdx.x % per_row) * 4;
  for (int r = r0; r < n_rows; r += 4 * rows_per_pass) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int rr = r + u * rows_per_pass;
      v[u] = rr < valid ? load4(src + rr * row_stride + d)
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int rr = r + u * rows_per_pass;
      if (rr < n_rows) *reinterpret_cast<float4*>(&dst[rr * ld + d]) = v[u];
    }
  }
}

// grid: (nq · ceil(bq / kQT), H, B).  NJ = ceil(hd / 64) column groups.
template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads)
block_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ kv_map,
                  T* __restrict__ out, const Args a) {
  extern __shared__ float4 smem4[];
  const int hd = a.hd, ld = hd + 4;
  float* qs = reinterpret_cast<float*>(smem4);   // kQT × ld
  float* kv = qs + kQT * ld;                     // kKT × ld: K, then V
  float* ps = kv + kKT * ld;                     // kQT × kLdP
  float* m_s = ps + kQT * kLdP;
  float* l_s = m_s + kQT;
  float* c_s = l_s + kQT;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n_sub = (a.bq + kQT - 1) / kQT;
  const int qi = blockIdx.x / n_sub, sub = blockIdx.x % n_sub;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_lo = qi * a.bq + sub * kQT;
  const int q_rows = min(kQT, a.bq - sub * kQT);
  const int64_t row_stride = (int64_t)a.H * hd;   // one sequence position
  const int64_t head0 = (int64_t)b * a.S * row_stride + (int64_t)h * hd;

  load_tile(qs, q + head0 + (int64_t)q_lo * row_stride, row_stride, q_rows,
            kQT, hd, ld);
  if (tid < kQT) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[4][NJ][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0f;
  __syncthreads();

  const int q_hi = q_lo + q_rows - 1;
  for (int t = 0; t < a.max_nb; ++t) {
    const int kv_id = kv_map[qi * a.max_nb + t];
    if (kv_id < 0) continue;                          // pad: never fetched
    for (int c0 = 0; c0 < a.bk; c0 += kKT) {
      const int k_lo = kv_id * a.bk + c0;
      const int k_n = min(kKT, a.bk - c0);
      if (a.causal && k_lo > q_hi) continue;
      if (a.window > 0 && q_lo - (k_lo + k_n - 1) >= a.window) continue;
      const int64_t kv0 = head0 + (int64_t)k_lo * row_stride;
      load_tile(kv, k + kv0, row_stride, k_n, kKT, hd, ld);
      __syncthreads();

      // scores of rows ty·4 + i against keys tx + 16·j
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
      for (int d = 0; d < hd; d += 4) {
        float4 qa[4], kb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qa[i] =
              *reinterpret_cast<const float4*>(&qs[(ty * 4 + i) * ld + d]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kb[j] =
              *reinterpret_cast<const float4*>(&kv[(tx + 16 * j) * ld + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qa[i].x, kb[j].x, s[i][j]);
            s[i][j] = fmaf(qa[i].y, kb[j].y, s[i][j]);
            s[i][j] = fmaf(qa[i].z, kb[j].z, s[i][j]);
            s[i][j] = fmaf(qa[i].w, kb[j].w, s[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = ty * 4 + i, key = tx + 16 * j;
          const int qpos = q_lo + r, kpos = k_lo + key;
          const bool ok = key < k_n && (!a.causal || qpos >= kpos) &&
                          (a.window <= 0 || qpos - kpos < a.window);
          ps[r * kLdP + key] = ok ? s[i][j] / a.scale : -INFINITY;
        }
      __syncthreads();

      // V replaces K (every thread is past its score loop); meanwhile the
      // online softmax, four threads a row
      load_tile(kv, v + kv0, row_stride, k_n, kKT, hd, ld);
      {
        const int r = tid >> 2, part = tid & 3;
        float* prow = ps + r * kLdP;
        float mx = -INFINITY;
        for (int u = 0; u < kKT / 4; ++u) mx = fmaxf(mx, prow[part + 4 * u]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        const float m_safe = isfinite(m_new) ? m_new : 0.0f;
        float sum = 0.0f;
        for (int u = 0; u < kKT / 4; ++u) {
          const float sv = prow[part + 4 * u];
          const float p = sv == -INFINITY ? 0.0f : expf(sv - m_safe);
          prow[part + 4 * u] = p;
          sum += p;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float corr = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.0f;
        __syncwarp();
        if (part == 0) {
          m_s[r] = m_new;
          l_s[r] = l_s[r] * corr + sum;
          c_s[r] = corr;
        }
      }
      __syncthreads();

      // acc = acc · corr + P · V
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float corr = c_s[ty * 4 + i];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] *= corr;
      }
      for (int kk = 0; kk < kKT; kk += 4) {
        float4 pa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[i] = *reinterpret_cast<const float4*>(&ps[(ty * 4 + i) * kLdP
                                                       + kk]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int col = tx * 4 + 64 * j;
            if (col >= hd) continue;
            const float4 vb =
                *reinterpret_cast<const float4*>(&kv[(kk + u) * ld + col]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = u == 0 ? pa[i].x : u == 1 ? pa[i].y
                              : u == 2 ? pa[i].z : pa[i].w;
              acc[i][j][0] = fmaf(p, vb.x, acc[i][j][0]);
              acc[i][j][1] = fmaf(p, vb.y, acc[i][j][1]);
              acc[i][j][2] = fmaf(p, vb.z, acc[i][j][2]);
              acc[i][j][3] = fmaf(p, vb.w, acc[i][j][3]);
            }
          }
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= q_rows) continue;
    const float l = fmaxf(l_s[r], 1e-20f);
    T* orow = out + head0 + (int64_t)(q_lo + r) * row_stride;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx * 4 + 64 * j;
      if (col >= hd) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        orow[col + c] = from_f32<T>(acc[i][j][c] / l);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch_nj(const void* q, const void* k, const void* v,
                      const int* kv_map, void* out, int B, int nq,
                      const Args& a, cudaStream_t st) {
  const size_t smem = smem_bytes(a.hd);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        block_attn_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(nq * ((a.bq + kQT - 1) / kQT), a.H, B);
  block_attn_kernel<T, NJ><<<grid, kThreads, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, kv_map, (T*)out, a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* kv_map, void* out, int B, int nq, const Args& a,
                   cudaStream_t st) {
  switch ((a.hd + 63) / 64) {
    case 1: return launch_nj<T, 1>(q, k, v, kv_map, out, B, nq, a, st);
    case 2: return launch_nj<T, 2>(q, k, v, kv_map, out, B, nq, a, st);
    case 3: return launch_nj<T, 3>(q, k, v, kv_map, out, B, nq, a, st);
    case 4: return launch_nj<T, 4>(q, k, v, kv_map, out, B, nq, a, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike), all
// contiguous (B, S, H, hd); kv_map is (nq, max_nb) int32 with ids in
// [-1, S / bk).  hd is a positive multiple of 4 up to 256; S is a multiple
// of bq and of bk; scale divides the scores.
int maple_block_attention(const void* q, const void* k, const void* v,
                          const int* kv_map, void* out, int dtype, int B,
                          int S, int H, int hd, int nq, int max_nb, int bq,
                          int bk, int causal, int window, float scale,
                          void* stream) {
  if (hd <= 0 || hd % 4 || hd > 256 || bq <= 0 || bk <= 0 || S % bq ||
      S % bk || nq != S / bq)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0 || H == 0) return (int)cudaSuccess;
  const Args a{S, H, hd, max_nb, bq, bk, causal, window, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch<float>(q, k, v, kv_map, out, B, nq, a, st);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(q, k, v, kv_map, out, B, nq, a, st);
  return (int)cudaErrorInvalidValue;
}

const char* maple_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
