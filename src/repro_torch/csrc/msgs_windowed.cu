// Windowed multi-scale-parallel MSGS + aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernel msgs_windowed_msp_pallas
// (src/repro/kernels/msgs_windowed.py, body _make_msp_kernel). Its grid
// (batch x head-group x query-tile) becomes one block per
// (tile, group, batch); inside a block one warp serves one
// (query, head) item at a time, lane = channel, as in K1 (eq4.cuh).
// Every point is sampled against its own level's window only: a corner
// outside the tile's pixel window [pstart, pstart + wp), or whose row
// (the compact slot, or the pixel in a dense table) lies outside the
// tile's row window [s_lo, s_lo + wv), contributes zero, exactly as the
// TPU kernel drops the corners it did not stage. The L level sums meet
// in one accumulator and the int8 scale multiplies once at the end.
// Tiles never straddle a query level and read the raster-ordered points
// in place (tile_first, tile_count come from the host geometry).
//
// What bounds it on the H100: memory traffic. At the 1024 px bucket one
// encoder block at B = 2 (87,040 raster queries, 8 heads, K = 4 PAP-kept
// points, Dh = 32, int8 compact table) must move its point operands
// (about 89 MB), its f32 output (178 MB) and the table rows the points
// touch (tens of MB): about 0.1 ms at 3.35 TB/s. Eq. 4's 13 flops per
// channel and point are far below the f32 rate.
//
// What the design does about the TPU's staging: the TPU kernel stages
// every level's value window in VMEM. At 1024 px one tile's value windows
// hold 22,624 pixel rows, 724 KB per head even as int8 codes, which no
// block's shared memory (227 KB) holds. So the value rows are gathered
// from global memory and L2 (the compact int8 table of both images is
// about 7 MB and stays in the 50 MB L2); only the tile's pix2slot window
// slices (4 B per window pixel, 90,496 B at 1024 px) are staged in dynamic
// shared memory. That takes the first of K1's two dependent global round
// trips per corner (remap, then row) off every corner. Staging the value
// windows, 2-D query tiles and TMA are later work.
#include "eq4.cuh"

namespace repro_torch {

constexpr int kMaxLevels = 8;
constexpr int kWinWarps = 16;   // 512 threads; two blocks fit an SM at 1024 px

struct Levels {
  int n;
  int h[kMaxLevels];
  int w[kMaxLevels];
  int st[kMaxLevels];     // flat start of the level
  int wp[kMaxLevels];     // pixel window (w_pix_levels)
  int wv[kMaxLevels];     // row window (w_rows_v)
  int soff[kMaxLevels];   // start of the level's pix2slot slice in shared memory
};

template <typename T, typename O>
__global__ void __launch_bounds__(kWarp * kWinWarps, 2)
msgs_windowed_kernel(const T* __restrict__ v, const float* __restrict__ x,
                     const float* __restrict__ y, const int* __restrict__ lvl,
                     const float* __restrict__ probs, const int* __restrict__ remap,
                     const int* __restrict__ pstart, const int* __restrict__ vstart,
                     const int* __restrict__ tile_first,
                     const int* __restrict__ tile_count,
                     const float* __restrict__ scale, O* __restrict__ out, int Nq,
                     int H, int K, int Dh, int G, int n_tiles, int64_t n_rows,
                     int64_t n_pix, const Levels levels) {
  extern __shared__ int win[];               // per-level pix2slot slices
  __shared__ Levels lv;                      // indexed by a point's level
  __shared__ int p_lo[kMaxLevels];
  __shared__ int s_lo[kMaxLevels];
  const int t = blockIdx.x;
  const int gi = blockIdx.y;
  const int b = blockIdx.z;
  if (threadIdx.x == 0) lv = levels;
  if (threadIdx.x < levels.n) {
    const int l = threadIdx.x;
    p_lo[l] = pstart[t * levels.n + l];
    s_lo[l] = vstart != nullptr ? vstart[(static_cast<int64_t>(b) * n_tiles + t) * levels.n + l]
                                : p_lo[l];     // dense: row space = pixel space
  }
  if (remap != nullptr) {
    const int* rb = remap + static_cast<int64_t>(b) * n_pix;
#pragma unroll
    for (int l = 0; l < kMaxLevels; ++l) {     // constant indices into the params
      if (l >= levels.n) break;
      const int* src = rb + pstart[t * levels.n + l];
      for (int i = threadIdx.x; i < levels.wp[l]; i += blockDim.x)
        win[levels.soff[l] + i] = src[i];
    }
  }
  __syncthreads();

  const int lane = threadIdx.x % kWarp;
  const int q0 = tile_first[t];
  const int items = tile_count[t] * G;
  const int64_t row_stride = static_cast<int64_t>(H) * Dh;
  for (int item = threadIdx.x / kWarp; item < items; item += kWinWarps) {
    const int q = q0 + item / G;
    const int h = gi * G + item % G;
    const int64_t base = (static_cast<int64_t>(b) * Nq + q) * H + h;
    const T* rows = v + static_cast<int64_t>(b) * n_rows * row_stride + static_cast<int64_t>(h) * Dh;
    float acc[kMaxChannelsPerLane];
#pragma unroll
    for (int i = 0; i < kMaxChannelsPerLane; ++i) acc[i] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kWarp) {
      const int kk = k0 + lane;
      float lx = 0.f, ly = 0.f, lp = 0.f;
      int ll = -1;
      if (kk < K) {
        lx = x[base * K + kk];
        ly = y[base * K + kk];
        lp = probs[base * K + kk];
        ll = lvl[base * K + kk];
      }
      const int n = min(kWarp, K - k0);
      for (int j = 0; j < n; ++j) {
        const float p = __shfl_sync(kFullMask, lp, j);
        const int l = __shfl_sync(kFullMask, ll, j);
        if (p == 0.f || l < 0 || l >= lv.n) continue;   // warp-uniform
        const float px = __shfl_sync(kFullMask, lx, j);
        const float py = __shfl_sync(kFullMask, ly, j);
        const float x0 = floorf(px);
        const float y0 = floorf(py);
        const float t1 = px - x0;                        // frac along x
        const float t0 = py - y0;                        // frac along y
        const int x0i = static_cast<int>(x0);
        const int y0i = static_cast<int>(y0);
        const int wl = lv.w[l];
        const int hl = lv.h[l];
        const int lo = s_lo[l];
        int64_t off[4];
        bool valid[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {                    // (0,0) (1,0) (0,1) (1,1)
          const int cx = x0i + (c & 1);
          const int cy = y0i + (c >> 1);
          bool ok = cx >= 0 && cx < wl && cy >= 0 && cy < hl;
          int lrow = 0;
          if (ok) {
            const int pix = lv.st[l] + cy * wl + cx;
            if (remap != nullptr) {
              const int lpix = pix - p_lo[l];
              ok = lpix >= 0 && lpix < lv.wp[l];
              if (ok) lrow = win[lv.soff[l] + lpix] - lo;  // slot-window local
            } else {
              lrow = pix - lo;                             // pixel-window local
            }
            ok = ok && lrow >= 0 && lrow < lv.wv[l];
          }
          valid[c] = ok;
          off[c] = ok ? static_cast<int64_t>(lo + lrow) * row_stride : 0;
        }
        eq4_point<T>(rows, off, valid, t0, t1, p, Dh, lane, acc);
      }
    }
    O* o = out + base * Dh;
    const float* sc = scale != nullptr ? scale + (static_cast<int64_t>(b) * H + h) * Dh : nullptr;
#pragma unroll
    for (int i = 0; i < kMaxChannelsPerLane; ++i) {
      const int ch = lane + kWarp * i;
      if (ch < Dh) store_out(o + ch, sc != nullptr ? acc[i] * sc[ch] : acc[i]);
    }
  }
}

template <typename T, typename O>
int launch(const void* v, const float* x, const float* y, const int* lvl,
           const float* probs, const int* remap, const int* pstart,
           const int* vstart, const int* tile_first, const int* tile_count,
           const float* scale, void* out, int B, int Nq, int H, int K, int Dh,
           int G, int n_tiles, int64_t n_rows, int64_t n_pix, const Levels& lv,
           size_t smem, cudaStream_t s) {
  auto* kernel = msgs_windowed_kernel<T, O>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(H / G),
                  static_cast<unsigned>(B));
  kernel<<<grid, kWarp * kWinWarps, smem, s>>>(
      static_cast<const T*>(v), x, y, lvl, probs, remap, pstart, vstart, tile_first,
      tile_count, scale, static_cast<O*>(out), Nq, H, K, Dh, G, n_tiles, n_rows, n_pix, lv);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro_torch

// table_dtype: 0 float32 (out float32), 1 bfloat16 (out bfloat16),
// 2 int8 codes with a (B, H/G, G, Dh) f32 scale (out float32).
// remap (B, n_pix) and vstart (B, T, L) are both null for a dense table.
// level_geo: 5 * L host ints — heights, widths, flat starts, pixel
// windows, row windows. Returns the launch's CUDA error code.
extern "C" int msgs_windowed_forward(int table_dtype, const void* v, const void* x,
                                     const void* y, const void* lvl,
                                     const void* probs, const void* remap,
                                     const void* pstart, const void* vstart,
                                     const void* tile_first,
                                     const void* tile_count, const void* scale,
                                     void* out, int B, int Nq, int H, int K,
                                     int Dh, int G, int n_tiles, int L,
                                     long long n_rows, long long n_pix,
                                     const int* level_geo, void* stream) {
  using namespace repro_torch;
  if (L < 1 || L > kMaxLevels || G < 1 || H % G != 0 || Dh > kWarp * kMaxChannelsPerLane)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || n_tiles == 0) return 0;
  Levels lv{};
  lv.n = L;
  int soff = 0;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = level_geo[l];
    lv.w[l] = level_geo[L + l];
    lv.st[l] = level_geo[2 * L + l];
    lv.wp[l] = level_geo[3 * L + l];
    lv.wv[l] = level_geo[4 * L + l];
    lv.soff[l] = soff;
    soff += lv.wp[l];
  }
  const size_t smem = remap != nullptr ? static_cast<size_t>(soff) * sizeof(int) : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  const auto* li = static_cast<const int*>(lvl);
  const auto* pf = static_cast<const float*>(probs);
  const auto* rm = static_cast<const int*>(remap);
  const auto* ps = static_cast<const int*>(pstart);
  const auto* vs = static_cast<const int*>(vstart);
  const auto* tf = static_cast<const int*>(tile_first);
  const auto* tc = static_cast<const int*>(tile_count);
  const auto* sc = static_cast<const float*>(scale);
  switch (table_dtype) {
    case 0:
      return launch<float, float>(v, xf, yf, li, pf, rm, ps, vs, tf, tc, sc, out, B, Nq, H,
                                  K, Dh, G, n_tiles, n_rows, n_pix, lv, smem, s);
    case 1:
      return launch<__nv_bfloat16, __nv_bfloat16>(v, xf, yf, li, pf, rm, ps, vs, tf, tc, sc,
                                                  out, B, Nq, H, K, Dh, G, n_tiles, n_rows,
                                                  n_pix, lv, smem, s);
    case 2:
      return launch<int8_t, float>(v, xf, yf, li, pf, rm, ps, vs, tf, tc, sc, out, B, Nq, H,
                                   K, Dh, G, n_tiles, n_rows, n_pix, lv, smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
