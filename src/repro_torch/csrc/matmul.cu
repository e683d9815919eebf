// Tiled matrix product for Hopper (sm_90a), with the int8-weight variant
// that dequantizes inside the kernel.
//
// Replaces the TPU kernels of matmul_pallas (src/repro/kernels/matmul.py,
// bodies _mm_kernel and _mm_q_kernel): out (M, N) = x (M, K) @ w (K, N)
// with a float32 accumulator, written in x's dtype. bf16 operands multiply
// exactly in float32 (the TPU's bf16 products with a float32 sum); an int8
// w is widened to float32 and multiplied by its column's float32 scale
// element by element before the product, as the TPU kernel dequantizes
// its tile, and then x (float32 or bf16) and the dequantized w meet in a
// float32 product.
//
// Design: a classic shared-memory tiled SIMT kernel. A block of 256
// threads owns a 64 x 64 output tile and walks K in steps of 16; each
// step stages the x and w tiles in shared memory as float32 (x
// transposed), zero-filled past the ragged edges of M, N and K, and each
// thread accumulates a 4 x 4 patch of the tile in registers. The TPU's
// bm / bn / bk are VMEM tile sizes; here the tiles are fixed, and like
// bm / bn / bk they change only the order of the float32 sum.
//
// What bounds it on the H100: at minitron-4b's prefill MLP-up product
// ((2048, 3072) x (3072, 9216), bf16, 116 GFLOP) the operations: 0.117 ms
// at the bf16 tensor-core rate, 1.7 ms at the float32 SIMT rate this
// kernel is limited to. At its decode product ((4, 3072) x (3072, 9216))
// the bytes of w: 56.6 MB, 17 us at 3.35 TB/s. This first version is
// simple and right; wgmma with TMA-fed shared-memory rings (and a
// split-K or a narrow-M tiling for decode) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace repro_torch

// x_dtype: 0 float32, 1 bfloat16 (out alike); w_dtype: 0 float32,
// 1 bfloat16 (equal to x_dtype), 2 int8 codes with a (1, N) float32 scale.
// Returns cudaGetLastError() after the launch.
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
