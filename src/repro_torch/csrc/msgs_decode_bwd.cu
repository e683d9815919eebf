// Persistent-cache decode MSGS + aggregation for Hopper (sm_90a), backward.
//
// Replaces the backward of the reference's jax.custom_vjp around the TPU
// decode kernel (_msgs_decode_bwd in src/repro/kernels/msgs_decode.py),
// which is jax.vjp of msgs_decode_ref: the exact gradient of the decode
// sampling over the once-staged layout vp (B, H/G, N_rows, G*Dh).
//
// With t1 = x - floor(x), t0 = y - floor(y), the corner weights w_c of
// Eq. 4 in the order (0,0) (1,0) (0,1) (1,1) (floor has zero gradient),
// v_c the row of corner c (int8 codes dequantised by the per-channel
// scale) and g the item's output gradient:
//
//   d_vp[row_c] += p w_c g             d_p = sum_c w_c <v_c, g>
//   d_x = p sum_c dw_c/dt1 <v_c, g>    d_y = p sum_c dw_c/dt0 <v_c, g>
//   d_scale[ch] += sum p w_c code_c[ch] g[ch]     (int8 tables only)
//
// over the valid corners only. A pruned pixel's corner reaches the zero
// sentinel row through the remap, and that row receives its gradient, as
// jax.vjp gives it.
//
// Layout as the forward kernel: one warp per (b, layer, q, h) item, lane =
// channel. The warp walks the item's points with shuffles, re-gathers the
// 4 corner rows of each point, reduces the 4 dot products <v_c, g> with
// butterfly shuffles (so every branch stays warp-uniform) and scatters the
// table gradient with float32 atomicAdd into a zeroed float32 buffer (the
// wrapper casts it for a bf16 table). The atomics make the summation
// order, and so the last bits of d_vp, vary from run to run. The int8
// scale gradient is summed per lane in registers over the item's points
// and added with one atomic per lane per warp: every query of a head group
// hits the same scale row, so one atomic per point would serialise there.
// A point whose probability is exactly 0 (PAP-pruned) adds nothing to
// d_vp, d_scale, d_x or d_y and skips those stores warp-uniformly; its
// d_p, the sum of w_c <v_c, g>, is not zero and is computed like any other
// point's, since the probability's gradient flows on to the attention
// logits through the fake-quant's straight-through estimator.
//
// What bounds it on the H100: at the 512 px decoder shape (B = 2, 300
// queries, 8 heads, K = 4, Dh = 32, staged table 2 x 2 x 13,057 x 128)
// the dense float32 d_vp (13.4 MB) has to be zeroed and written, against
// about 2 MB of touched rows, points and g_out: the call is bound by bytes
// (a few microseconds at 3.35 TB/s), and this first design by the launch
// and the zero fill. Later work: one launch for the six layers' backward,
// a sparse (touched-rows) table gradient, shared-memory accumulation of
// rows that several points of a warp hit.
#include "eq4.cuh"

namespace repro_torch {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kWarpsPerBlock)
msgs_decode_backward_kernel(const T* __restrict__ vp, const float* __restrict__ x,
                            const float* __restrict__ y, const int* __restrict__ st,
                            const int* __restrict__ wl, const int* __restrict__ hl,
                            const float* __restrict__ probs,
                            const int* __restrict__ remap,
                            const float* __restrict__ scale,
                            const float* __restrict__ g_out, float* __restrict__ d_vp,
                            float* __restrict__ d_scale, float* __restrict__ d_x,
                            float* __restrict__ d_y, float* __restrict__ d_p, int B,
                            int L, int Nq, int H, int K, int Dh, int G,
                            int64_t n_rows, int64_t n_pix) {
  const int lane = threadIdx.x % kWarp;
  const int64_t item = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + threadIdx.x / kWarp;
  if (item >= static_cast<int64_t>(B) * L * Nq * H) return;   // whole warp
  const int h = static_cast<int>(item % H);
  const int b = static_cast<int>(item / H / Nq / L);
  const int n_groups = H / G;
  const int gi = h / G;
  const int j = h % G;
  const int64_t gdh = static_cast<int64_t>(G) * Dh;
  const int64_t group = static_cast<int64_t>(b) * n_groups + gi;
  const int64_t lanes0 = group * n_rows * gdh + static_cast<int64_t>(j) * Dh;
  const T* rows = vp + lanes0;
  float* drows = d_vp != nullptr ? d_vp + lanes0 : nullptr;
  const int64_t sc0 = group * gdh + static_cast<int64_t>(j) * Dh;
  const float* sc = scale != nullptr ? scale + sc0 : nullptr;
  const int* rm = remap != nullptr ? remap + static_cast<int64_t>(b) * n_pix : nullptr;

  // the item's output gradient; gs pairs it with the int8 scale so that
  // sum code * gs is the dot product with the dequantised row
  float g[kMaxChannelsPerLane], gs[kMaxChannelsPerLane], ds[kMaxChannelsPerLane];
#pragma unroll
  for (int i = 0; i < kMaxChannelsPerLane; ++i) {
    const int ch = lane + kWarp * i;
    g[i] = ch < Dh ? g_out[item * Dh + ch] : 0.f;
    gs[i] = (ch < Dh && sc != nullptr) ? g[i] * sc[ch] : g[i];
    ds[i] = 0.f;
  }

  const int64_t pt = item * K;
  for (int k0 = 0; k0 < K; k0 += kWarp) {
    const int kk = k0 + lane;
    float lx = 0.f, ly = 0.f, lp = 0.f;
    int lst = 0, lwl = 1, lhl = 1;
    if (kk < K) {
      lx = x[pt + kk];
      ly = y[pt + kk];
      lp = probs[pt + kk];
      lst = st[pt + kk];
      lwl = wl[pt + kk];
      lhl = hl[pt + kk];
    }
    float rdx = 0.f, rdy = 0.f, rdp = 0.f;         // lane kk's results
    const int n = min(kWarp, K - k0);
    for (int jj = 0; jj < n; ++jj) {
      const float p = __shfl_sync(kFullMask, lp, jj);
      const float px = __shfl_sync(kFullMask, lx, jj);
      const float py = __shfl_sync(kFullMask, ly, jj);
      const int pst = __shfl_sync(kFullMask, lst, jj);
      const int pwl = __shfl_sync(kFullMask, lwl, jj);
      const int phl = __shfl_sync(kFullMask, lhl, jj);
      const float x0 = floorf(px);
      const float y0 = floorf(py);
      const float t1 = px - x0;
      const float t0 = py - y0;
      const int x0i = static_cast<int>(x0);
      const int y0i = static_cast<int>(y0);
      const float w[4] = {(1.f - t1) * (1.f - t0), t1 * (1.f - t0), (1.f - t1) * t0, t1 * t0};
      const float dw_dt1[4] = {-(1.f - t0), 1.f - t0, -t0, t0};
      const float dw_dt0[4] = {-(1.f - t1), -t1, 1.f - t1, t1};
      int64_t off[4];
      bool valid[4];
      float sp = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int cx = x0i + (c & 1);
        const int cy = y0i + (c >> 1);
        valid[c] = cx >= 0 && cx < pwl && cy >= 0 && cy < phl;   // warp-uniform
        off[c] = 0;
        if (valid[c]) {
          int idx = pst + cy * pwl + cx;
          if (rm != nullptr) idx = rm[idx];
          off[c] = static_cast<int64_t>(idx) * gdh;
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < kMaxChannelsPerLane; ++i) {
            const int ch = lane + kWarp * i;
            if (ch < Dh) part += to_f32(rows[off[c] + ch]) * gs[i];
          }
          const float dot = warp_sum(part);
          sp += w[c] * dot;
          sx += dw_dt1[c] * dot;
          sy += dw_dt0[c] * dot;
        }
      }
      if (lane == jj) {
        rdp = sp;
        rdx = p * sx;
        rdy = p * sy;
      }
      if (p == 0.f) continue;                      // warp-uniform
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (!valid[c]) continue;
        const float pw = p * w[c];
#pragma unroll
        for (int i = 0; i < kMaxChannelsPerLane; ++i) {
          const int ch = lane + kWarp * i;
          if (ch >= Dh) continue;
          if (drows != nullptr) atomicAdd(drows + off[c] + ch, pw * g[i]);
          if (sc != nullptr) ds[i] += pw * to_f32(rows[off[c] + ch]) * g[i];
        }
      }
    }
    if (kk < K) {
      d_x[pt + kk] = rdx;
      d_y[pt + kk] = rdy;
      d_p[pt + kk] = rdp;
    }
  }
  if (d_scale != nullptr) {
#pragma unroll
    for (int i = 0; i < kMaxChannelsPerLane; ++i) {
      const int ch = lane + kWarp * i;
      if (ch < Dh && ds[i] != 0.f) atomicAdd(d_scale + sc0 + ch, ds[i]);
    }
  }
}

}  // namespace repro_torch

// table_dtype: 0 float32, 1 bfloat16, 2 int8 codes with a (B, H/G, G*Dh)
// f32 scale. g_out (B, L, Nq, H, Dh) is float32. d_vp (float32, the
// staged table's shape, zeroed; null to skip the table gradient) is for
// float tables, d_scale (float32, the scale's shape, zeroed) for int8
// tables; d_x, d_y, d_p take the points' shape and are fully written.
// Returns cudaGetLastError() after the launch.
extern "C" int msgs_decode_backward(int table_dtype, const void* vp, const void* x,
                                    const void* y, const void* st, const void* wl,
                                    const void* hl, const void* probs,
                                    const void* remap, const void* scale,
                                    const void* g_out, void* d_vp, void* d_scale,
                                    void* d_x, void* d_y, void* d_p, int B, int L,
                                    int Nq, int H, int K, int Dh, int G,
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
  const auto* go = static_cast<const float*>(g_out);
  auto* dv = static_cast<float*>(d_vp);
  auto* ds = static_cast<float*>(d_scale);
  auto* dx = static_cast<float*>(d_x);
  auto* dy = static_cast<float*>(d_y);
  auto* dp = static_cast<float*>(d_p);
  switch (table_dtype) {
    case 0:
      msgs_decode_backward_kernel<float><<<blocks, threads, 0, s>>>(
          static_cast<const float*>(vp), xf, yf, sti, wli, hli, pf, rm, nullptr, go,
          dv, nullptr, dx, dy, dp, B, L, Nq, H, K, Dh, G, n_rows, n_pix);
      break;
    case 1:
      msgs_decode_backward_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(vp), xf, yf, sti, wli, hli, pf, rm,
          nullptr, go, dv, nullptr, dx, dy, dp, B, L, Nq, H, K, Dh, G, n_rows, n_pix);
      break;
    case 2:
      msgs_decode_backward_kernel<int8_t><<<blocks, threads, 0, s>>>(
          static_cast<const int8_t*>(vp), xf, yf, sti, wli, hli, pf, rm, sc, go,
          nullptr, ds, dx, dy, dp, B, L, Nq, H, K, Dh, G, n_rows, n_pix);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
