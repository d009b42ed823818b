// Hopper (sm_90a) building blocks shared by the ring-fed kernels:
// maple_spmm.cu (B1, B3, B4), maple_sddmm.cu (B2), moe_gemm.cu (B8) and,
// for its element types, maple_spmspm.cu (B7).
//
// * element types: 4-wide vector loads, f32 widening and rounding;
// * the ring: mbarriers, 1D bulk copies and 2D / 3D TMA loads that
//   complete on them, the consumer warpgroup's named barrier;
// * bulk stores: a contiguous tile from shared to global memory
//   (cp.async.bulk.global.shared::cta) or a 3D TMA box, in bulk groups,
//   and the waits for their reads of shared memory;
// * wgmma: shared-memory descriptors (128-byte swizzle, or the plain
//   interleaved layout) and the m64 n8 / n32 / n64 bf16 products with the
//   transpose bits as template arguments;
// * the FFMA register tile, one output tile of a warpgroup multiplied out
//   of a stage of shared memory (A rows along k, B rows along n), and its
//   k-major variant (both operands' rows along k, 16-byte units swizzled
//   as the TMA's 128-byte swizzle lays them out: B2's dC·Bᵀ);
// * host: cuTensorMapEncodeTiled through the runtime's driver entry point.
//
// Everything is in an anonymous namespace: each source that includes this
// file gets its own copy, and each builds into its own library.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kConsumers = 128;              // one warpgroup
constexpr int kThreads = kConsumers + 32;    // and the producer warp
constexpr int kUnroll = 8;                   // loads a lane starts before storing

// ---- element types

template <typename T> struct Vec4;
template <> struct Vec4<float> {
  using type = float4;
  __device__ __forceinline__ static void unpack(const float4& v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <> struct Vec4<__nv_bfloat16> {
  using type = uint2;
  __device__ __forceinline__ static void unpack(const uint2& v, float* o) {
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&v.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&v.y);
    o[0] = __low2float(lo); o[1] = __high2float(lo);
    o[2] = __low2float(hi); o[3] = __high2float(hi);
  }
};

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
  return __float2bfloat16_rn(v);  // round to nearest even, like torch's cast
}

// ---- the ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Spin until the phase of parity `parity` has completed.  A wait that
// lasts seconds means a lost copy: trap rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- bulk stores: shared → global, tracked per thread in bulk groups

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}

// the map's box at (c0, c1, c2) from shared memory laid out as a load of
// that box lays it; elements past the tensor's bounds are not written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0),
         "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// until at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" :: "n"(N) : "memory");
}

// until every bulk group of this thread has completed
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// generic-proxy stores to shared memory, read next by the async proxy
// (wgmma, bulk stores)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// the consumer warpgroup alone (named barrier 1)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 128;" ::: "memory");
}

// ---- wgmma

// a 128-byte-swizzled operand: 8-row groups 1 KB apart
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((1024 >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

// an unswizzled (interleaved) operand of 8 × 16-byte core matrices, the
// next 8 rows 128 bytes on
__device__ __forceinline__ uint64_t gmma_desc_plain(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)(128 >> 4) << 16;
  d |= (uint64_t)(128 >> 4) << 32;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

#define WG_D4(b) "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), \
    "+f"(d[b + 3])
#define WG_D8(b) WG_D4(b), WG_D4(b + 4)

// D(64 × 64, f32 registers d[base ..]) += A(64 × 16) · B(16 × 64), both
// from shared memory; TA / TB: the transpose bits (1 = MN-major)
template <int TA, int TB, int base, int R>
__device__ __forceinline__ void wgmma_n64(float (&d)[R], uint64_t da,
                                          uint64_t db) {
  static_assert(base + 32 <= R, "accumulator too small");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : WG_D8(base), WG_D8(base + 8), WG_D8(base + 16), WG_D8(base + 24)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D(64 × 32) += A(64 × 16) · B(16 × 32)
template <int TA, int TB, int base, int R>
__device__ __forceinline__ void wgmma_n32(float (&d)[R], uint64_t da,
                                          uint64_t db) {
  static_assert(base + 16 <= R, "accumulator too small");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : WG_D8(base), WG_D8(base + 8)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D(64 × 8) += A(64 × 16) · B(16 × 8)
template <int TA, int TB, int base, int R>
__device__ __forceinline__ void wgmma_n8(float (&d)[R], uint64_t da,
                                         uint64_t db) {
  static_assert(base + 4 <= R, "accumulator too small");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : WG_D4(base)
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// The accumulator fragment of an m64nN product: register i of thread t
// (of the warpgroup) holds row 16·warp + lane/4 + 8·((i % 4) / 2) and
// column 8·(i / 4) + 2·(lane % 4) + i % 2, across consecutive atoms alike.
__device__ __forceinline__ void wgmma_at(int i, int t, int& r, int& c) {
  const int w = t / 32, l = t % 32;
  r = 16 * w + l / 4 + 8 * ((i % 4) / 2);
  c = 8 * (i / 4) + 2 * (l % 4) + i % 2;
}

// ---- the FFMA register tile.  Geo names the stage: A at its start, bm
// rows of bk (k contiguous); B at b_off, bk rows of ldb (n contiguous);
// the output tile is (bm, tile).  Thread (ty, tx) holds rows ty + i·ty_n
// and, for TN % 4 == 0, columns 4·tx + (j % 4) + (j / 4)·4·tx_n (4-wide
// groups, so that a quarter warp reads 128 contiguous bytes of a B row).
// Each output element is one FFMA chain over k in order.

template <typename T, int TM, int TN>
struct FfmaTile {
  static constexpr int R = TM * TN;
  static constexpr bool kWgmma = false;

  template <class Geo>
  __device__ static bool place(const Geo& geo, int t, int& tx, int& ty,
                               int& tx_n, int& ty_n) {
    tx_n = geo.tile / TN;
    ty_n = geo.bm / TM;
    tx = t % tx_n;
    ty = t / tx_n;
    return t < tx_n * ty_n;
  }

  __device__ static int col(int j, int tx, int tx_n) {
    return TN % 4 == 0 ? (j / 4) * 4 * tx_n + 4 * tx + j % 4 : tx * TN + j;
  }

  template <bool kFold = false, class Geo>
  __device__ static void step(float (&acc)[R], const unsigned char* stage,
                              const Geo& geo, int t, int /*cols*/) {
    using V = typename Vec4<T>::type;
    int tx, ty, tx_n, ty_n;
    if (!place(geo, t, tx, ty, tx_n, ty_n)) return;
    const T* a_s = reinterpret_cast<const T*>(stage);
    const T* b_s = reinterpret_cast<const T*>(stage + geo.b_off);
    const bool bvec = geo.ldb % 4 == 0;
    for (int k0 = 0; k0 < geo.bk; k0 += 4) {
      float a[TM][4];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        Vec4<T>::unpack(*reinterpret_cast<const V*>(
                            a_s + (ty + i * ty_n) * geo.bk + k0), a[i]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const T* brow = b_s + (k0 + kk) * geo.ldb;
        float bv[TN];
        if constexpr (TN % 4 == 0) {
          if (bvec) {
#pragma unroll
            for (int j = 0; j < TN; j += 4) {
              float q[4];
              Vec4<T>::unpack(*reinterpret_cast<const V*>(
                                  brow + col(j, tx, tx_n)), q);
              bv[j] = q[0]; bv[j + 1] = q[1]; bv[j + 2] = q[2];
              bv[j + 3] = q[3];
            }
          } else {
#pragma unroll
            for (int j = 0; j < TN; ++j) bv[j] = to_f32(brow[col(j, tx, tx_n)]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < TN; ++j) bv[j] = to_f32(brow[col(j, tx, tx_n)]);
        }
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i * TN + j] = fmaf(a[i][kk], bv[j], acc[i * TN + j]);
      }
    }
  }

  // the row and the column (from the tile's first) of register i
  template <class Geo>
  __device__ static bool at(int i, const Geo& geo, int t, int& r, int& c) {
    int tx, ty, tx_n, ty_n;
    if (!place(geo, t, tx, ty, tx_n, ty_n)) return false;
    r = ty + (i / TN) * ty_n;
    c = col(i % TN, tx, tx_n);
    return true;
  }
};

// ---- the k-major FFMA register tile: out(bm, bk) += A · Bᵀ with A's bm
// rows and B's bk rows both along k (B2: dC rows and B rows, N
// contiguous).  A row is `pitch` bytes; where `swz` is set (pitch 128)
// the 16-byte units of row r are XOR-swizzled by r % 8, as the TMA's
// 128-byte swizzle lays them out, so that 8 consecutive rows read at one
// k fall in 8 distinct bank groups.  Thread (ty, tx) holds rows
// ty + i·ty_n and columns tx + j·tx_n: a quarter warp shares ty (one A
// row, broadcast) and reads 8 consecutive B rows.  Each output element is
// one FFMA chain over k in order.  BM, BK and PITCH, where not 0, fix
// bm, bk and pitch (swizzled at 128) at compile time, so that the rows'
// offsets become immediates of the loads; UNROLL quads a loop turn.

template <typename T, int TM, int TN, int BM = 0, int BK = 0, int PITCH = 0,
          int UNROLL = 1>
struct FfmaTileK {
  static constexpr int R = TM * TN;

  __device__ static bool place(int bm, int bk, int t, int& tx, int& ty,
                               int& tx_n, int& ty_n) {
    tx_n = (BK ? BK : bk) / TN;
    ty_n = (BM ? BM : bm) / TM;
    tx = t % tx_n;
    ty = t / tx_n;
    return t < tx_n * ty_n;
  }

  // acc += A[:, 0 : 4·quads] · B[:, 0 : 4·quads]ᵀ
  __device__ static void step(float (&acc)[R], const unsigned char* a,
                              const unsigned char* b, int bm, int bk,
                              int pitch, bool swz, int quads, int t) {
    int tx, ty, tx_n, ty_n;
    if (!place(bm, bk, t, tx, ty, tx_n, ty_n)) return;
    if (PITCH) {
      pitch = PITCH;
      swz = PITCH == 128;
    }
    // rows 8 apart share their swizzle: then one key serves all A rows of
    // a thread and one all its B rows
    if (!swz || (ty_n % 8 == 0 && tx_n % 8 == 0))
      walk<true>(acc, a, b, pitch, swz, quads, tx, ty, tx_n, ty_n);
    else
      walk<false>(acc, a, b, pitch, swz, quads, tx, ty, tx_n, ty_n);
  }

  template <bool kShared>
  __device__ static void walk(float (&acc)[R], const unsigned char* a,
                              const unsigned char* b, int pitch, bool swz,
                              int quads, int tx, int ty, int tx_n,
                              int ty_n) {
    using V = typename Vec4<T>::type;
    const int m = swz ? 7 : 0;
#pragma unroll UNROLL
    for (int q = 0; q < quads; ++q) {
      // elements 4q .. 4q + 3 of a row: 16-byte unit u, byte w within it
      const int byte = q * 4 * (int)sizeof(T), u = byte >> 4, w = byte & 15;
      const int ua = ((u ^ (ty & m)) << 4) | w;
      const int ub = ((u ^ (tx & m)) << 4) | w;
      float av[TM][4], bv[TN][4];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty + i * ty_n;
        const int off = kShared ? ua : ((u ^ (r & m)) << 4) | w;
        Vec4<T>::unpack(*reinterpret_cast<const V*>(a + r * pitch + off),
                        av[i]);
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = tx + j * tx_n;
        const int off = kShared ? ub : ((u ^ (r & m)) << 4) | w;
        Vec4<T>::unpack(*reinterpret_cast<const V*>(b + r * pitch + off),
                        bv[j]);
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[i * TN + j] = fmaf(av[i][kk], bv[j][kk], acc[i * TN + j]);
    }
  }

  // the row and column of register i
  __device__ static bool at(int i, int bm, int bk, int t, int& r, int& c) {
    int tx, ty, tx_n, ty_n;
    if (!place(bm, bk, t, tx, ty, tx_n, ty_n)) return false;
    r = ty + (i / TN) * ty_n;
    c = tx + (i % TN) * tx_n;
    return true;
  }
};

// The FFMA register tiles, largest first, and the one that puts the most
// of the 128 consumer threads to work on a (bm, tile) output tile (the
// larger tile on a tie); -1 when none fits.
constexpr int kTiles[7][2] = {{8, 8}, {4, 8}, {4, 4}, {2, 4}, {1, 4},
                              {1, 2}, {1, 1}};

constexpr int ffma_tile(int bm, int tile) {
  int best = -1, best_threads = 0;
  for (int c = 0; c < 7; ++c) {
    const int tm = kTiles[c][0], tn = kTiles[c][1];
    if (bm % tm || tile % tn) continue;
    const int threads = (bm / tm) * (tile / tn);
    if (threads <= kConsumers && threads > best_threads) {
      best = c;
      best_threads = threads;
    }
  }
  return best;
}

// ---- host: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      p = nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) p = nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map of `rank` (2 or 3) dimensions, innermost first: dims in elements,
// strides[d] the bytes between consecutive indices of dimension d + 1,
// box the elements a load brings.  Reads past a dimension come in as zeros.
inline bool encode_map(CUtensorMap* map, int dtype, const void* base,
                       int rank, const uint64_t* dims,
                       const uint64_t* strides, const uint32_t* box,
                       bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  cuuint64_t d[3], s[2];
  cuuint32_t b[3], unit[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) { d[i] = dims[i]; b[i] = box[i]; }
  for (int i = 0; i + 1 < rank; ++i) s[i] = strides[i];
  return fn(map, dtype ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
            rank, const_cast<void*>(base), d, s, b, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 2D map over rows of `inner` elements, `row_bytes` apart
inline bool encode_2d(CUtensorMap* map, int dtype, const void* base,
                      uint64_t inner, uint64_t outer, uint64_t row_bytes,
                      uint32_t box_inner, uint32_t box_outer, bool swizzle) {
  const uint64_t dims[2] = {inner, outer}, strides[1] = {row_bytes};
  const uint32_t box[2] = {box_inner, box_outer};
  return encode_map(map, dtype, base, 2, dims, strides, box, swizzle);
}

}  // namespace
