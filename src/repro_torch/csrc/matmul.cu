// Matrix product for Hopper (sm_90a), with the int8-weight variant: two
// kernels in one library, picked per call by kernels/matmul.py's
// matmul_route from the operands' dtypes and alignment alone.
//
// Replaces the TPU kernels of matmul_pallas (src/repro/kernels/matmul.py,
// bodies _mm_kernel and _mm_q_kernel): out (M, N) = x (M, K) @ w (K, N)
// with a float32 accumulator, written in x's dtype. An int8 w comes with
// a (1, N) float32 column scale.
//
// Route "wgmma" (bf16 x; bf16 w, or int8 w with its scale; K % 8 == 0,
// N % 8 == 0 and N % 16 == 0 for int8 w, 16-byte aligned pointers, so
// that TMA's 16-byte strides hold): matmul_wgmma_kernel. A block owns a
// 128 x 128 output tile and walks K in steps of 64 through a ring of
// kStages = 5 shared-memory stages, each with a full and an empty
// mbarrier. One producer thread issues the TMA copies: the x tile
// (128 x 64, K-major) and the w tile (64 x 128, N-major, as two 64-column
// boxes), both with 128-byte swizzle; TMA's out-of-bounds fill zeroes the
// ragged edges of M, N and K, nothing is padded on the host. Two consumer
// warpgroups, 64 rows each, issue wgmma.mma_async m64n128k16 bf16 -> f32
// with the B operand transposed (w is N-major) and keep the accumulators
// in registers; each releases a stage once the wgmma group after it has
// been issued (wait_group 1). The epilogue rounds to bf16 and stores.
// An int8 w tile arrives by TMA as one byte per element (no swizzle); seven
// more warps widen it to bf16 (integer and float adds, no conversion
// instruction) into the stage's swizzled bf16 tile, fence it for wgmma
// and signal a third mbarrier per stage. That is exact (|code| <= 127 fits bf16's 8-bit significand); the
// column scale then multiplies the float32 accumulator in the epilogue:
// (x @ codes) * scale, where _mm_q_kernel computes x @ (codes * scale).
// The two differ only in float32 rounding order. A narrow M (decode) has
// too few output tiles to keep the card streaming w, so K is split over
// blockIdx.z (matmul_splits in kernels/matmul.py picks the count): each
// split writes a float32 partial tile and matmul_splitk_reduce_kernel
// sums the splits in a fixed order, scales and rounds. Blocks walk M
// fastest, so the x tiles stay in L2 while each w tile is read once.
//
// Route "simt" (float32 x, and shapes that TMA cannot describe, such as
// the reference's sweep (70, 90, 50) or (33, 257, 65)): matmul_kernel, a
// shared-memory tiled SIMT kernel with 64 x 64 tiles, K steps of 16 staged
// as float32 and a 4 x 4 register patch per thread; an int8 w is widened
// and multiplied by its column scale on the way in, as _mm_q_kernel does.
// Float32 x stays here because the tensor cores would round float32
// operands to TF32, while the reference's product is float32.
//
// What bounds it on the H100: at minitron-4b's prefill MLP-up product
// ((2048, 3072) x (3072, 9216), bf16, 116 GFLOP) the operations, 0.117 ms
// at the 989 TFLOP/s bf16 tensor-core rate; at its decode product
// ((4, 3072) x (3072, 9216)) the 56.6 MB of w, 17 us at 3.35 TB/s. The
// float32 path is held to the 67 TFLOP/s SIMT rate (1.7 ms at the prefill
// shape). Resources (ptxas -v, printed by chip_smoke.py's build phase):
// matmul_wgmma_kernel 90 registers, no spills, 164,984 bytes of dynamic
// shared memory (bf16 w: 5 x (16 KB x + 16 KB w) + barriers + alignment
// slack) or 205,944 (int8 w: 5 x (16 KB x + 8 KB codes + 16 KB widened)),
// one block per SM; matmul_kernel 64 registers, 8,704 bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "tma.cuh"

namespace repro_torch {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;       // 16 x 16 threads, a 4 x 4 patch each
constexpr int kPatch = 4;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename TW>
__device__ __forceinline__ float load_w(const TW* w, const float* scale, int64_t idx, int n) {
  return widen(w[idx]);
}
template <>
__device__ __forceinline__ float load_w<int8_t>(const int8_t* w, const float* scale, int64_t idx,
                                                int n) {
  return static_cast<float>(w[idx]) * scale[n];
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
matmul_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
              const float* __restrict__ scale, TX* __restrict__ out, int M, int N, int K) {
  __shared__ float xs[kBK][kBM + 4];
  __shared__ float ws[kBK][kBN + 4];
  const int tx = threadIdx.x % (kBN / kPatch);
  const int ty = threadIdx.x / (kBN / kPatch);
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  float acc[kPatch][kPatch];
#pragma unroll
  for (int i = 0; i < kPatch; ++i)
#pragma unroll
    for (int j = 0; j < kPatch; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = threadIdx.x; e < kBM * kBK; e += kThreads) {
      const int mm = e / kBK, kk = e % kBK;        // neighbouring threads: along K
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < M && gk < K) ? widen(x[static_cast<int64_t>(gm) * K + gk]) : 0.f;
    }
    for (int e = threadIdx.x; e < kBK * kBN; e += kThreads) {
      const int kk = e / kBN, nn = e % kBN;        // neighbouring threads: along N
      const int gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < K && gn < N)
                       ? load_w(w, scale, static_cast<int64_t>(gk) * N + gn, gn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kPatch], bv[kPatch];
#pragma unroll
      for (int i = 0; i < kPatch; ++i) a[i] = xs[kk][ty * kPatch + i];
#pragma unroll
      for (int j = 0; j < kPatch; ++j) bv[j] = ws[kk][tx * kPatch + j];
#pragma unroll
      for (int i = 0; i < kPatch; ++i)
#pragma unroll
        for (int j = 0; j < kPatch; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kPatch; ++i) {
    const int gm = m0 + ty * kPatch + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < kPatch; ++j) {
      const int gn = n0 + tx * kPatch + j;
      if (gn < N) store(out + static_cast<int64_t>(gm) * N + gn, acc[i][j]);
    }
  }
}

template <typename TX, typename TW>
void launch(const void* x, const void* w, const float* scale, void* out, int M, int N, int K,
            cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  matmul_kernel<TX, TW><<<grid, kThreads, 0, s>>>(static_cast<const TX*>(x),
                                                  static_cast<const TW*>(w), scale,
                                                  static_cast<TX*>(out), M, N, K);
}

// ---------------------------------------------------------------------------
// the wgmma route
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kBM = 128;                  // two consumer warpgroups of 64 rows
constexpr int kBN = 128;
constexpr int kBK = 64;                   // 64 bf16 = one 128-byte swizzled row
constexpr int kStages = 5;
constexpr int kConsumers = 2;
// + the producer warpgroup (+ one more warpgroup of wideners for int8 w)
constexpr int threads(bool int8) { return 128 * (kConsumers + (int8 ? 2 : 1)); }
constexpr int kWideners = 128 - 32 + 128;  // warps 1-3 of the producer warpgroup + 4 more
constexpr int kXTile = kBM * kBK * 2;      // 16 KB: 128 rows of 128 bytes
constexpr int kWChunk = kBK * 64 * 2;      // 8 KB: 64 K rows x 64 N columns, bf16
constexpr int kWTile16 = 2 * kWChunk;      // the bf16 w tile: two N chunks
constexpr int kWTile8 = kBK * kBN;         // the int8 w tile: 64 rows of 128 bytes

constexpr int smem_bytes(bool int8) {
  return 1024 /* alignment slack */ + kStages * kXTile +
         kStages * (int8 ? kWTile8 + kWTile16 : kWTile16) + 3 * kStages * 8;
}

using namespace tma;

// A wgmma shared-memory descriptor with 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, f32, the warpgroup's fragment) += A (64 x 16, K-major) .
// B (16 x 128, N-major: the transpose bit)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The four k16 steps of one 64-deep stage for this warpgroup: A rows
// advance 32 bytes inside the swizzled 128-byte row, B rows 16 x 128 bytes.
__device__ __forceinline__ void mma_stage(float (&acc)[64], uint32_t x_tile, uint32_t w_tile) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t da = desc_sw128(x_tile + kk * 32, 16, 1024);
    const uint64_t db = desc_sw128(w_tile + kk * 16 * 128, kWChunk, 1024);
    wgmma_m64n128k16(acc, da, db);
  }
}

// Four int8 codes (one 32-bit word) as four exact bf16 values, packed in
// two words: byte i + 128 goes into the low byte of the float 2^23 (bits
// 0x4B0000xx), 2^23 + 128 is subtracted exactly, and since |code| <= 128
// needs at most 8 significant bits, the bf16 is the float's upper half.
// Integer and float adds only: no int-to-float conversion instruction.
__device__ __forceinline__ uint2 codes_to_bf16(uint32_t word) {
  const uint32_t u = word ^ 0x80808080u;           // code + 128, per byte
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440 + i)) - 8388736.f;
  return make_uint2(__byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632),
                    __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632));
}

// The int8 w tile (64 rows of 128 one-byte codes, unswizzled) widened to
// bf16 in the layout that TMA's 128-byte swizzle gives a bf16 tile: two
// 64-column chunks, row k's 16-byte group g stored at group g ^ (k % 8).
__device__ __forceinline__ void widen_codes(const uint8_t* codes, uint8_t* dst, int t) {
#pragma unroll
  for (int i = 0; i < (kBK * kBN / 8 + kWideners - 1) / kWideners; ++i) {
    const int e = t + i * kWideners;
    if (e >= kBK * kBN / 8) break;
    const int k = e / (kBN / 8), g16 = e % (kBN / 8);
    const uint2 raw = *reinterpret_cast<const uint2*>(codes + k * kBN + g16 * 8);
    const uint2 lo = codes_to_bf16(raw.x), hi = codes_to_bf16(raw.y);
    const int chunk = g16 / 8, g = g16 % 8;
    *reinterpret_cast<uint4*>(dst + chunk * kWChunk + k * 128 + ((g ^ (k & 7)) * 16)) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

}  // namespace wg

// kInt8: w is int8 codes (scale in the epilogue) instead of bf16. With
// `partial` non-null the block writes its split's float32 sums there,
// (gridDim.z, M, N), instead of the scaled bf16 output.
//
// Roles: warpgroups 0 and 1 consume (wgmma, 64 rows each); in warpgroup 2
// one thread issues the TMA copies; for int8 w the other three warps of
// warpgroup 2 and the four of warpgroup 3 widen each stage's codes into
// the stage's bf16 tile.
template <bool kInt8>
__global__ void __launch_bounds__(wg::threads(kInt8), 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap w_map, const float* __restrict__ scale,
                    __nv_bfloat16* __restrict__ out, float* __restrict__ partial, int M, int N,
                    int K, int k_tiles_per_split) {
  using namespace wg;
  constexpr int kWTile = kInt8 ? kWTile8 : kWTile16;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* xs = smem;
  uint8_t* ws = xs + kStages * kXTile;
  uint8_t* widened = ws + kStages * kWTile;         // int8 w only: a bf16 tile per stage
  uint64_t* full = reinterpret_cast<uint64_t*>(widened + (kInt8 ? kStages * kWTile16 : 0));
  uint64_t* empty = full + kStages;
  uint64_t* ready = empty + kStages;                // int8 w only: the stage is widened

  const int m0 = blockIdx.x * wg::kBM;
  const int n0 = blockIdx.y * wg::kBN;
  const int split = blockIdx.z;
  const int k_tiles = (K + wg::kBK - 1) / wg::kBK;
  const int kt0 = split * k_tiles_per_split;
  const int n_k = max(0, min(k_tiles, kt0 + k_tiles_per_split) - kt0);
  const int wgi = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
      if (kInt8) mbar_init(&ready[s], kWideners);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wgi >= kConsumers) {
    const int t = threadIdx.x - kConsumers * 128;
    if (t == 0) {                             // the producer: TMA
      for (int j = 0; j < n_k; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&full[s], kXTile + kWTile);
        const int kc = (kt0 + j) * wg::kBK;
        load_2d(xs + s * kXTile, &x_map, &full[s], kc, m0);
        load_2d(ws + s * kWTile, &w_map, &full[s], n0, kc);
        if (!kInt8) load_2d(ws + s * kWTile + kWChunk, &w_map, &full[s], n0 + 64, kc);
      }
    } else if (kInt8 && t >= 32) {            // the wideners
      for (int j = 0; j < n_k; ++j) {
        const int s = j % kStages;
        mbar_wait(&full[s], (j / kStages) & 1);
        widen_codes(ws + s * kWTile, widened + s * kWTile16, t - 32);
        // the generic-proxy writes are made visible to wgmma, then released
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        mbar_arrive(&ready[s]);
      }
    }
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const bool live = m0 + wgi * 64 < M;      // warpgroup-uniform: rows past M skip wgmma
  const uint32_t x_base = smem_u32(xs) + wgi * 64 * 128;
  const uint32_t w_base = smem_u32(kInt8 ? widened : ws);
  for (int j = 0; j < n_k; ++j) {
    const int s = j % kStages;
    mbar_wait(&full[s], (j / kStages) & 1);
    if (kInt8) mbar_wait(&ready[s], (j / kStages) & 1);
    if (live) {
      fence_acc(acc);
      wgmma_fence();
      mma_stage(acc, x_base + s * kXTile, w_base + s * kWTile16);
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();                      // the previous stage's group is done
    }
    if (j > 0 && threadIdx.x % 128 == 0) mbar_arrive(&empty[(j - 1) % kStages]);
  }
  wgmma_wait<0>();
  fence_acc(acc);
  if (!live) return;

  // the m64n128 fragment: register 4j + 2h + e holds row 16 * warp + lane / 4
  // + 8h, column 8j + 2 (lane % 4) + e
  const int warp_in_wg = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = m0 + wgi * 64 + warp_in_wg * 16 + lane / 4;
  const int col0 = n0 + (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < wg::kBN / 8; ++j) {
    const int col = col0 + j * 8;
    if (col >= N) continue;                 // N is even: col + 1 < N as well
    float s0 = 1.f, s1 = 1.f;
    if (kInt8 && partial == nullptr) {
      s0 = scale[col];
      s1 = scale[col + 1];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
      const float a = acc[4 * j + 2 * h], b = acc[4 * j + 2 * h + 1];
      if (partial != nullptr) {
        *reinterpret_cast<float2*>(partial + (static_cast<int64_t>(split) * M + row) * N + col) =
            make_float2(a, b);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(out + static_cast<int64_t>(row) * N + col) =
            __floats2bfloat162_rn(a * s0, b * s1);
      }
    }
  }
}

// Sums the splits' float32 partials in split order, applies the column
// scale (int8 w) and rounds to bf16; two columns per thread.
__global__ void matmul_splitk_reduce_kernel(const float* __restrict__ partial,
                                            const float* __restrict__ scale,
                                            __nv_bfloat16* __restrict__ out, int M, int N,
                                            int splits) {
  const int64_t pairs = static_cast<int64_t>(M) * N / 2;
  const float2* p2 = reinterpret_cast<const float2*>(partial);
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < pairs;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float2 v = p2[s * pairs + i];
      a += v.x;
      b += v.y;
    }
    if (scale != nullptr) {
      const int col = static_cast<int>((2 * i) % N);
      a *= scale[col];
      b *= scale[col + 1];
    }
    reinterpret_cast<__nv_bfloat162*>(out)[i] = __floats2bfloat162_rn(a, b);
  }
}

// A 2-D row-major (rows, cols) tensor map with a (box_rows, box_cols) box;
// elements past the edges read as zero.
static bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes, const void* base,
                      int rows, int cols, int box_rows, int box_cols, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols), static_cast<cuuint32_t>(box_rows)};
  return tma::encode(map, type, 2, base, dims, strides, box, swizzle);
}

template <bool kInt8>
static int launch_wgmma(const CUtensorMap& xm, const CUtensorMap& wm, const float* scale,
                        __nv_bfloat16* out, float* partial, int M, int N, int K, int splits,
                        cudaStream_t s) {
  constexpr int smem = wg::smem_bytes(kInt8);
  cudaError_t e = cudaFuncSetAttribute(matmul_wgmma_kernel<kInt8>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int k_tiles = (K + wg::kBK - 1) / wg::kBK;
  const int per_split = (k_tiles + splits - 1) / splits;
  const dim3 grid((M + wg::kBM - 1) / wg::kBM, (N + wg::kBN - 1) / wg::kBN, splits);
  matmul_wgmma_kernel<kInt8><<<grid, wg::threads(kInt8), smem, s>>>(
      xm, wm, scale, out, splits > 1 ? partial : nullptr, M, N, K, per_split);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const int64_t pairs = static_cast<int64_t>(M) * N / 2;
  // a thread per pair of columns (the loop strides the grid past 65,535 blocks)
  const int blocks = static_cast<int>(std::min<int64_t>((pairs + 255) / 256, 65535));
  matmul_splitk_reduce_kernel<<<blocks, 256, 0, s>>>(partial, kInt8 ? scale : nullptr, out, M, N,
                                                     splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// x_dtype: 0 float32, 1 bfloat16 (out alike); w_dtype: 0 float32,
// 1 bfloat16 (equal to x_dtype), 2 int8 codes with a (1, N) float32 scale.
// The SIMT route. Returns cudaGetLastError() after the launch.
extern "C" int matmul_forward(int x_dtype, int w_dtype, const void* x, const void* w,
                              const void* scale, void* out, int M, int N, int K,
                              void* stream) {
  using namespace repro_torch;
  if (M == 0 || N == 0) return 0;
  if ((M + kBM - 1) / kBM > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* sc = static_cast<const float*>(scale);
  if (x_dtype == 0 && w_dtype == 0) {
    launch<float, float>(x, w, sc, out, M, N, K, s);
  } else if (x_dtype == 1 && w_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, w, sc, out, M, N, K, s);
  } else if (x_dtype == 0 && w_dtype == 2 && sc != nullptr) {
    launch<float, int8_t>(x, w, sc, out, M, N, K, s);
  } else if (x_dtype == 1 && w_dtype == 2 && sc != nullptr) {
    launch<__nv_bfloat16, int8_t>(x, w, sc, out, M, N, K, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The wgmma route: bf16 x (M, K); w_dtype 1 bf16 w (K, N), 2 int8 codes
// with a (1, N) float32 scale; bf16 out (M, N). K % 8 == 0, N % 8 == 0
// (N % 16 == 0 for int8 w), 16-byte aligned x and w. splits > 1 splits K
// over blocks and needs `partial`, float32 (splits, M, N). Returns the
// first non-zero cudaGetLastError() of its launches (cudaErrorInvalidValue
// for operands it does not take or a tensor map it cannot encode).
extern "C" int matmul_wgmma_forward(int w_dtype, const void* x, const void* w, const void* scale,
                                    void* out, void* partial, int M, int N, int K, int splits,
                                    void* stream) {
  using namespace repro_torch;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const bool int8 = w_dtype == 2;
  if ((w_dtype != 1 && !int8) || (int8 && scale == nullptr) || K < 1 || K % 8 != 0 ||
      N % (int8 ? 16 : 8) != 0 || splits < 1 || splits > 65535 ||
      (splits > 1 && partial == nullptr) || (N + wg::kBN - 1) / wg::kBN > 65535 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) % 16 != 0)
    return bad;
  CUtensorMap xm, wm;
  if (!encode_2d(&xm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, wg::kBM, wg::kBK,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return bad;
  const bool ok = int8 ? encode_2d(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, N, wg::kBK,
                                   wg::kBN, CU_TENSOR_MAP_SWIZZLE_NONE)
                       : encode_2d(&wm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, w, K, N, wg::kBK,
                                   64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* part = static_cast<float*>(partial);
  const auto* sc = static_cast<const float*>(scale);
  return int8 ? launch_wgmma<true>(xm, wm, sc, o, part, M, N, K, splits, s)
              : launch_wgmma<false>(xm, wm, sc, o, part, M, N, K, splits, s);
}
