// One-token GQA flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_decode_pallas (src/repro/kernels/
// flash_decode.py, body _kernel). For each sequence b and query head h it
// computes softmax(q_h . K / sqrt(Dh)) . V over a (B, W, Hkv, Dh) KV cache
// with a per-slot validity mask, and matches the TPU kernel's arithmetic:
//   * query head h reads KV head h / n_rep with n_rep = ceil(Hq / Hkv);
//   * a score is the dot product rounded to the input dtype, then widened
//     to float32 and scaled by 1/sqrt(Dh); invalid slots score -1e30;
//   * the online max and sum start at -1e30 and 0, P.V is summed in
//     float32, and the denominator is clamped at 1e-20;
//   * the TPU kernel pads W to a multiple of its chunk with invalid zero
//     slots. They change only a row with no valid slot, whose softmax
//     is then uniform over real and padded slots alike: the sum gains
//     one per padded slot and the numerator nothing (argument `pad`).
//
// Design: one block per (b, KV head, group of up to kMaxRep query heads of
// that KV head), so each K/V row is read once for all the query heads
// that share it. Each of the block's warps walks its own slots, loading
// kSlotsPerStep slots' K and V rows before it computes, with lane =
// channel (Dh <= 128, four channels per lane) and the online-softmax state
// of every query head in registers; the warps' states merge through
// shared memory at the end.
//
// What bounds it on the H100: memory. At minitron-4b's decode shape
// (B = 4, Hq = 24, Hkv = 8, Dh = 128, W = 4096, bf16) the K and V rows
// are 67.1 MB, about 20 us at 3.35 TB/s; the operations (4 per score
// channel and per P.V channel, 0.2 GFLOP) are far below the rate. This
// first version is simple and right: its B * Hkv = 32 blocks use 32 of
// the 132 SMs. Splitting W across blocks (with a second pass that merges
// the partial softmax states) and 16-byte loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kWarp = 32;
constexpr int kWarps = 16;          // warps per block, each on its own slots
constexpr int kMaxRep = 4;          // query heads per block
constexpr int kLaneCh = 4;          // channels per lane: Dh <= 128
constexpr int kMaxDh = kWarp * kLaneCh;
constexpr int kSlotsPerStep = 4;    // slots a warp loads before it computes
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// a float32 sum rounded to the input dtype, as the TPU kernel's einsum
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kWarps)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ valid,
                    T* __restrict__ out, int Hq, int Hkv, int Dh, int W, int n_rep,
                    int pad, float scale) {
  __shared__ float sm_m[kWarps][kMaxRep];
  __shared__ float sm_l[kWarps][kMaxRep];
  __shared__ float sm_acc[kWarps][kMaxRep][kMaxDh];

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int n_groups = (n_rep + kMaxRep - 1) / kMaxRep;
  const int grp = blockIdx.x % n_groups;
  const int g = (blockIdx.x / n_groups) % Hkv;
  const int b = blockIdx.x / n_groups / Hkv;
  const int h0 = g * n_rep + grp * kMaxRep;
  const int nh = min(min(kMaxRep, n_rep - grp * kMaxRep), Hq - h0);
  if (nh <= 0) return;                       // heads past Hq: the whole block

  float qr[kMaxRep][kLaneCh];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int i = 0; i < kLaneCh; ++i) {
      const int ch = lane + kWarp * i;
      qr[r][i] = (r < nh && ch < Dh)
                     ? widen(q[(static_cast<int64_t>(b) * Hq + h0 + r) * Dh + ch]) : 0.f;
    }
  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][kLaneCh];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kLaneCh; ++i) acc[r][i] = 0.f;
  }

  const int64_t row = static_cast<int64_t>(Hkv) * Dh;
  const T* kb = k + static_cast<int64_t>(b) * W * row + static_cast<int64_t>(g) * Dh;
  const T* vb = v + static_cast<int64_t>(b) * W * row + static_cast<int64_t>(g) * Dh;
  const uint8_t* ok_b = valid + static_cast<int64_t>(b) * W;
  for (int w0 = warp * kSlotsPerStep; w0 < W; w0 += kWarps * kSlotsPerStep) {
    float kr[kSlotsPerStep][kLaneCh], vr[kSlotsPerStep][kLaneCh];
    bool ok[kSlotsPerStep];
#pragma unroll
    for (int j = 0; j < kSlotsPerStep; ++j) {
      const int w = w0 + j;
      ok[j] = w < W && ok_b[w] != 0;
#pragma unroll
      for (int i = 0; i < kLaneCh; ++i) {
        const int ch = lane + kWarp * i;
        const bool in = w < W && ch < Dh;
        kr[j][i] = in ? widen(kb[w * row + ch]) : 0.f;
        vr[j][i] = in ? widen(vb[w * row + ch]) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kSlotsPerStep; ++j) {
      if (w0 + j >= W) break;                // warp-uniform
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r) {
        if (r >= nh) break;                  // block-uniform
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < kLaneCh; ++i) s += qr[r][i] * kr[j][i];
        s = round_to<T>(warp_sum(s)) * scale;
        if (!ok[j]) s = kNeg;
        const float m_new = fmaxf(m[r], s);
        const float p = expf(s - m_new);
        const float corr = expf(m[r] - m_new);
        l[r] = l[r] * corr + p;
#pragma unroll
        for (int i = 0; i < kLaneCh; ++i) acc[r][i] = acc[r][i] * corr + p * vr[j][i];
        m[r] = m_new;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m[r];
      sm_l[warp][r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < kLaneCh; ++i) sm_acc[warp][r][lane + kWarp * i] = acc[r][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < nh * Dh; idx += blockDim.x) {
    const int r = idx / Dh;
    const int ch = idx % Dh;
    float mx = kNeg;
    for (int wp = 0; wp < kWarps; ++wp) mx = fmaxf(mx, sm_m[wp][r]);
    float den = 0.f, num = 0.f;
    for (int wp = 0; wp < kWarps; ++wp) {
      const float c = expf(sm_m[wp][r] - mx);
      den += sm_l[wp][r] * c;
      num += sm_acc[wp][r][ch] * c;
    }
    if (mx == kNeg) den += static_cast<float>(pad);   // no valid slot
    store(out + (static_cast<int64_t>(b) * Hq + h0 + r) * Dh + ch, num / fmaxf(den, 1e-20f));
  }
}

}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike); valid is one byte
// per slot (torch.bool). n_rep = ceil(Hq / Hkv); pad = the TPU kernel's
// padded slots, (-W) mod min(chunk, W). Returns cudaGetLastError() after
// the launch.
extern "C" int flash_decode_forward(int dtype, const void* q, const void* k, const void* v,
                                    const void* valid, void* out, int B, int Hq, int Hkv,
                                    int Dh, int W, int n_rep, int pad, float scale,
                                    void* stream) {
  using namespace repro_torch;
  if (Dh > kMaxDh || n_rep < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks =
      static_cast<long long>(B) * Hkv * ((n_rep + kMaxRep - 1) / kMaxRep);
  if (blocks == 0) return 0;
  const dim3 threads(kWarp * kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ok = static_cast<const uint8_t*>(valid);
  switch (dtype) {
    case 0:
      flash_decode_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), ok, static_cast<float*>(out), Hq, Hkv, Dh, W,
          n_rep, pad, scale);
      break;
    case 1:
      flash_decode_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), ok, static_cast<__nv_bfloat16*>(out), Hq,
          Hkv, Dh, W, n_rep, pad, scale);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
