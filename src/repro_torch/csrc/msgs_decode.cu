// Persistent-cache decode MSGS + aggregation for Hopper (sm_90a), forward.
//
// Replaces the TPU kernel _decode_pallas_call (src/repro/kernels/
// msgs_decode.py, body _make_decode_kernel), behind msgs_decode_pallas
// (one layer) and msgs_decode_layers_pallas (L stacked layers, one
// launch). It runs the same Eq. 4 device routine as the fused kernel
// (eq4.cuh) over the once-staged layout vp (B, H/G, N_rows, G*Dh): head h
// is lane group j = h % G of row group h / G. The grid carries a layer
// axis: one warp per (b, layer, q, h) item of the stacked
// (B, L, Nq, H, K) points, so the stacked entry point is one launch too.
// Its backward is msgs_decode_bwd.cu.
//
// The TPU kernel keeps the staged table resident in VMEM across its
// (query-tile x layer) sweep. No explicit staging is needed here: the
// table is about 13 MB per image compacted and 22 MB dense at 512 px,
// which fits the H100's 50 MB L2, so every decoder layer re-reads it
// from L2 without any shared-memory copy.
//
// What bounds it on the H100: a decoder layer at B = 2 (300 queries,
// 8 heads, K = 4 points, Dh = 32) moves about 3.5 MB at most — about 1 us
// of memory time — so one launch is bound by launch latency, not by
// bytes or operations. Making it fast is later work: fusing the six
// layer launches into a CUDA graph, shared-memory corner reuse,
// vectorised loads and several (q, h) items per warp.
#include "eq4.cuh"

namespace repro_torch {

template <typename T, typename O>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
msgs_decode_kernel(const T* __restrict__ vp, const float* __restrict__ x,
                   const float* __restrict__ y, const int* __restrict__ st,
                   const int* __restrict__ wl, const int* __restrict__ hl,
                   const float* __restrict__ probs, const int* __restrict__ remap,
                   const float* __restrict__ scale, O* __restrict__ out, int B,
                   int L, int Nq, int H, int K, int Dh, int G, int64_t n_rows,
                   int64_t n_pix) {
  const int lane = threadIdx.x % kWarp;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (item >= static_cast<int64_t>(B) * L * Nq * H) return;   // whole warp
  const int h = static_cast<int>(item % H);
  const int b = static_cast<int>(item / H / Nq / L);
  const int n_groups = H / G;
  const int gi = h / G;
  const int j = h % G;
  const int64_t gdh = static_cast<int64_t>(G) * Dh;
  const int64_t pt = item * K;
  const PointRefs pts{x + pt, y + pt, probs + pt, st + pt, wl + pt, hl + pt};
  const int64_t group = static_cast<int64_t>(b) * n_groups + gi;
  const T* rows = vp + group * n_rows * gdh + static_cast<int64_t>(j) * Dh;
  const int* rm = remap != nullptr ? remap + static_cast<int64_t>(b) * n_pix : nullptr;
  float acc[kMaxChannelsPerLane];
  eq4_sample_agg<T>(pts, K, rm, rows, gdh, Dh, lane, acc);
  O* o = out + item * Dh;
  const float* sc = scale != nullptr ? scale + group * gdh + static_cast<int64_t>(j) * Dh : nullptr;
#pragma unroll
  for (int i = 0; i < kMaxChannelsPerLane; ++i) {
    const int ch = lane + kWarp * i;
    if (ch < Dh) store_out(o + ch, sc != nullptr ? acc[i] * sc[ch] : acc[i]);
  }
}

}  // namespace repro_torch

// table_dtype: 0 float32 (out float32), 1 bfloat16 (out bfloat16),
// 2 int8 codes with a (B, H/G, G*Dh) f32 scale (out float32).
// Returns cudaGetLastError() after the launch.
extern "C" int msgs_decode_forward(int table_dtype, const void* vp, const void* x,
                                   const void* y, const void* st, const void* wl,
                                   const void* hl, const void* probs,
                                   const void* remap, const void* scale, void* out,
                                   int B, int L, int Nq, int H, int K, int Dh, int G,
                                   long long n_rows, long long n_pix, void* stream) {
  using namespace repro_torch;
  const long long items = static_cast<long long>(B) * L * Nq * H;
  if (items == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((items + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 threads(kWarp * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  const auto* pf = static_cast<const float*>(probs);
  const auto* sti = static_cast<const int*>(st);
  const auto* wli = static_cast<const int*>(wl);
  const auto* hli = static_cast<const int*>(hl);
  const auto* rm = static_cast<const int*>(remap);
  const auto* sc = static_cast<const float*>(scale);
  switch (table_dtype) {
    case 0:
      msgs_decode_kernel<float, float><<<blocks, threads, 0, s>>>(
          static_cast<const float*>(vp), xf, yf, sti, wli, hli, pf, rm, sc,
          static_cast<float*>(out), B, L, Nq, H, K, Dh, G, n_rows, n_pix);
      break;
    case 1:
      msgs_decode_kernel<__nv_bfloat16, __nv_bfloat16><<<blocks, threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(vp), xf, yf, sti, wli, hli, pf, rm, sc,
          static_cast<__nv_bfloat16*>(out), B, L, Nq, H, K, Dh, G, n_rows, n_pix);
      break;
    case 2:
      msgs_decode_kernel<int8_t, float><<<blocks, threads, 0, s>>>(
          static_cast<const int8_t*>(vp), xf, yf, sti, wli, hli, pf, rm, sc,
          static_cast<float*>(out), B, L, Nq, H, K, Dh, G, n_rows, n_pix);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
