// Fused MSGS (bilinear grid-sampling) + aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernels msgs_fused_pallas and msgs_fused_packed_pallas
// (src/repro/kernels/msgs_fused.py, bodies _make_kernel and
// _make_kernel_packed, math _eq4_sample_agg). The packed form is a TPU
// lane layout (128 / Dh heads side by side in one 128-lane row); here
// both entry points are this one kernel over the (B, N_rows, H, Dh)
// table, one warp per (b, q, h) item, lane = channel (see eq4.cuh).
//
// The TPU kernel stages a head's whole table in VMEM. Nothing here stages
// it: at 512 px an encoder block's table is about 13 MB per image after
// FWP compaction (22 MB dense), so both images' tables fit the H100's
// 50 MB L2 and the corner rows of neighbouring queries hit in L2.
//
// What bounds it on the H100: memory traffic. An encoder block of the
// 512 px detector at B = 2 (N_q = 21,760 raster queries, 8 heads, K = 4
// PAP-kept points, Dh = 32, f32) moves about 105 MB of unique bytes:
// point operands about 33 MB, compact table about 27 MB, output about
// 45 MB — about 31 us at 3.35 TB/s. The arithmetic (Eq. 4 is 3 multiplies
// per channel per point) is two orders of magnitude below the f32 rate.
// This first version is simple and right; making it fast is later work:
// shared-memory reuse of corner rows across the queries of a tile,
// vectorised (16 B) loads, and several (q, h) items per warp so fewer
// lanes idle on the point loads.
#include "eq4.cuh"

namespace repro_torch {

template <typename T, typename O>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
msgs_fused_kernel(const T* __restrict__ v, const float* __restrict__ x,
                  const float* __restrict__ y, const int* __restrict__ st,
                  const int* __restrict__ wl, const int* __restrict__ hl,
                  const float* __restrict__ probs, const int* __restrict__ remap,
                  const float* __restrict__ scale, O* __restrict__ out, int B,
                  int Nq, int H, int K, int Dh, int64_t n_rows, int64_t n_pix) {
  const int lane = threadIdx.x % kWarp;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (item >= static_cast<int64_t>(B) * Nq * H) return;   // whole warp
  const int h = static_cast<int>(item % H);
  const int b = static_cast<int>(item / H / Nq);
  const int64_t pt = item * K;
  const PointRefs pts{x + pt, y + pt, probs + pt, st + pt, wl + pt, hl + pt};
  const T* rows = v + static_cast<int64_t>(b) * n_rows * H * Dh + static_cast<int64_t>(h) * Dh;
  const int* rm = remap != nullptr ? remap + static_cast<int64_t>(b) * n_pix : nullptr;
  float acc[kMaxChannelsPerLane];
  eq4_sample_agg<T>(pts, K, rm, rows, static_cast<int64_t>(H) * Dh, Dh, lane, acc);
  O* o = out + item * Dh;
  const float* sc = scale != nullptr ? scale + (static_cast<int64_t>(b) * H + h) * Dh : nullptr;
#pragma unroll
  for (int i = 0; i < kMaxChannelsPerLane; ++i) {
    const int ch = lane + kWarp * i;
    if (ch < Dh) store_out(o + ch, sc != nullptr ? acc[i] * sc[ch] : acc[i]);
  }
}

}  // namespace repro_torch

// table_dtype: 0 float32 (out float32), 1 bfloat16 (out bfloat16),
// 2 int8 codes with a (B, 1, H, Dh) f32 scale (out float32).
// Returns cudaGetLastError() after the launch.
extern "C" int msgs_fused_forward(int table_dtype, const void* v, const void* x,
                                  const void* y, const void* st, const void* wl,
                                  const void* hl, const void* probs,
                                  const void* remap, const void* scale, void* out,
                                  int B, int Nq, int H, int K, int Dh,
                                  long long n_rows, long long n_pix, void* stream) {
  using namespace repro_torch;
  const long long items = static_cast<long long>(B) * Nq * H;
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
      msgs_fused_kernel<float, float><<<blocks, threads, 0, s>>>(
          static_cast<const float*>(v), xf, yf, sti, wli, hli, pf, rm, sc,
          static_cast<float*>(out), B, Nq, H, K, Dh, n_rows, n_pix);
      break;
    case 1:
      msgs_fused_kernel<__nv_bfloat16, __nv_bfloat16><<<blocks, threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(v), xf, yf, sti, wli, hli, pf, rm, sc,
          static_cast<__nv_bfloat16*>(out), B, Nq, H, K, Dh, n_rows, n_pix);
      break;
    case 2:
      msgs_fused_kernel<int8_t, float><<<blocks, threads, 0, s>>>(
          static_cast<const int8_t*>(v), xf, yf, sti, wli, hli, pf, rm, sc,
          static_cast<float*>(out), B, Nq, H, K, Dh, n_rows, n_pix);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
