// Eq. 4 corner gather + factorised bilinear sample + probability-weighted
// aggregation for K2: only the persistent-cache decode kernel
// (msgs_decode.cu) still runs eq4_sample_agg, and K2's backward
// (msgs_decode_bwd.cu) shares the constants and widening helpers. The
// encoder kernels K1 and K3 run the gather engine of msgs_gather.cuh.
//
// One warp serves one (batch, query, head) item; lane j holds channel j
// (and j + 32, j + 64, j + 96 when Dh > 32; lanes >= Dh idle when
// Dh < 32). Lane k loads point k's operands once and the warp walks the
// points with shuffles, so every branch on a point is warp-uniform. Per
// point the corner indices are computed once, clipped to the level,
// validity-masked and sent through the optional FWP pixel -> slot remap;
// each corner is then one coalesced row load (128 B for f32, Dh = 32).
// Eq. 4 runs in f32 whatever the table type: int8 codes and bf16 values
// are widened before the corner differences (int8 differences reach
// +-254). A point whose probability is exactly 0 (PAP-pruned) is skipped
// and so contributes exactly nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro_torch {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxChannelsPerLane = 4;   // Dh <= 128
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// The K point operands of one item, each K consecutive values.
struct PointRefs {
  const float* x;
  const float* y;
  const float* p;
  const int* st;
  const int* wl;
  const int* hl;
};

// acc[i] += p * S(channel lane + 32 i) for one point, S from Eq. 4:
//   S = N0 + (N2 - N0) t0 + [(N1 - N0) + (N3 - N2 - N1 + N0) t0] t1
// Corner c (order (0,0) (1,0) (0,1) (1,1)) is the row at rows + off[c],
// or zero when valid[c] is false (that row is never loaded).
template <typename T>
__device__ __forceinline__ void eq4_point(const T* __restrict__ rows,
                                          const int64_t off[4],
                                          const bool valid[4], float t0,
                                          float t1, float p, int dh, int lane,
                                          float acc[kMaxChannelsPerLane]) {
#pragma unroll
  for (int i = 0; i < kMaxChannelsPerLane; ++i) {
    const int ch = lane + kWarp * i;
    if (ch < dh) {
      float nv[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) nv[c] = valid[c] ? to_f32(rows[off[c] + ch]) : 0.f;
      const float s = nv[0] + (nv[2] - nv[0]) * t0 +
                      ((nv[1] - nv[0]) + (nv[3] - nv[2] - nv[1] + nv[0]) * t0) * t1;
      acc[i] += p * s;
    }
  }
}

// acc[i] <- sum_k p_k * S_k(channel lane + 32 i), S from Eq. 4:
//   S = N0 + (N2 - N0) t0 + [(N1 - N0) + (N3 - N2 - N1 + N0) t0] t1
// `rows` points at (row 0, channel 0) of this item's head; row r starts at
// rows + r * row_stride. `remap` is the batch's pixel -> row map or null.
template <typename T>
__device__ __forceinline__ void eq4_sample_agg(const PointRefs pts, int K,
                                               const int* __restrict__ remap,
                                               const T* __restrict__ rows,
                                               int64_t row_stride, int dh,
                                               int lane,
                                               float acc[kMaxChannelsPerLane]) {
#pragma unroll
  for (int i = 0; i < kMaxChannelsPerLane; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kWarp) {
    const int kk = k0 + lane;
    float lx = 0.f, ly = 0.f, lp = 0.f;
    int lst = 0, lwl = 1, lhl = 1;
    if (kk < K) {
      lx = pts.x[kk];
      ly = pts.y[kk];
      lp = pts.p[kk];
      lst = pts.st[kk];
      lwl = pts.wl[kk];
      lhl = pts.hl[kk];
    }
    const int n = min(kWarp, K - k0);
    for (int j = 0; j < n; ++j) {
      const float p = __shfl_sync(kFullMask, lp, j);
      if (p == 0.f) continue;                      // warp-uniform
      const float x = __shfl_sync(kFullMask, lx, j);
      const float y = __shfl_sync(kFullMask, ly, j);
      const int st = __shfl_sync(kFullMask, lst, j);
      const int wl = __shfl_sync(kFullMask, lwl, j);
      const int hl = __shfl_sync(kFullMask, lhl, j);
      const float x0 = floorf(x);
      const float y0 = floorf(y);
      const float t1 = x - x0;                     // frac along x
      const float t0 = y - y0;                     // frac along y
      const int x0i = static_cast<int>(x0);
      const int y0i = static_cast<int>(y0);
      int64_t off[4];
      bool valid[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {                // (0,0) (1,0) (0,1) (1,1)
        const int cx = x0i + (c & 1);
        const int cy = y0i + (c >> 1);
        valid[c] = cx >= 0 && cx < wl && cy >= 0 && cy < hl;
        off[c] = 0;
        if (valid[c]) {
          int idx = st + cy * wl + cx;
          if (remap != nullptr) idx = remap[idx];
          off[c] = static_cast<int64_t>(idx) * row_stride;
        }
      }
      eq4_point<T>(rows, off, valid, t0, t1, p, dh, lane, acc);
    }
  }
}

}  // namespace repro_torch
