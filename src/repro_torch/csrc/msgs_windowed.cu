// K3: windowed multi-scale-parallel MSGS + aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernel msgs_windowed_msp_pallas
// (src/repro/kernels/msgs_windowed.py, body _make_msp_kernel). Every
// point is sampled against its own level's window only: a corner outside
// its query tile's pixel window [pstart, pstart + wp), or whose row (the
// compact slot, or the pixel in a dense table) lies outside the tile's
// row window [vstart, vstart + wv), contributes zero, exactly as the TPU
// kernel drops the corners it did not stage. The L level sums meet in one
// accumulator and the int8 scale multiplies once at the end.
//
// What bounds it on the H100: the gather, not HBM. At the 1024 px bucket
// one encoder block at B = 2 (87,040 raster queries, 8 heads, K = 4
// PAP-kept points, Dh = 32, int8 compact table of 52,225 rows per image,
// 26.7 MB for both images, so it stays in the 50 MB L2) must move its
// point operands (89 MB), its f32 output (178 MB) and the rows it touches:
// 0.086 ms at 3.35 TB/s. Its 1,392,640 items gather 16 corner rows of
// 32 B each (668 MB of L2 sectors) and widen 16 int8 channels per lane.
//
// What the design does: it is K1's gather engine (msgs_gather.cuh), so a
// point's terms are summed in K1's order, with the windows as arithmetic.
// The first version of this kernel staged each tile's pix2slot windows
// (90,496 B) in shared memory in every block; that staging measured
// 0.086 ms of its 2.2 ms, and reading pix2slot from global memory instead
// made it slower: its time went to one point after another with 32 B per
// warp load (PERF.md, section 6). Here a
// warp serves 16 consecutive (q, h) items of int8 Dh 32 rows, 2 lanes of
// 16 B per row, all 16 corner rows of every item in flight; blocks need
// not align to tiles. A query's tile comes from a per-query table built
// with the window geometry; the pixel -> slot entry (the remap is 0.7 MB
// and stays in L2) and the tile's two window starts (one 8 B load) go out
// in the same round trip.
#include "msgs_gather.cuh"

namespace repro_torch {

struct Levels {
  int4 geo[gather::kMaxLevels];       // flat start, width, height, pixel window
  int wv[gather::kMaxLevels];         // row window (w_rows_v)
  int n;
};

struct WindowedSource {
  const float* x;
  const float* y;
  const float* p;
  const int* lvl;
  const int* remap;      // (B, n_pix) pixel -> slot; null for a dense table
  const int* qtile;      // (Nq,) the tile of each raster query
  const int2* starts;    // (B, T, L): pixel-window start, row-window start
  int64_t starts_batch;  // T * L, or 0 when one set serves every batch
  const Levels* lv;      // the kernel's __grid_constant__ parameter
  int64_t n_pix;

  struct Operands {
    float x, y, p;
    int l;
  };
  struct Info {          // per item: its query's tile
    int t;
  };

  static __device__ Operands dead() { return {0.f, 0.f, 0.f, -1}; }
  static __device__ Info shfl(const Info& i, int lane) {
    return {__shfl_sync(kFullMask, i.t, lane)};
  }

  __device__ Info info(int q) const { return {__ldg(qtile + q)}; }

  __device__ Operands load(int64_t pt) const {
    return {gather::load_once(x + pt), gather::load_once(y + pt), gather::load_once(p + pt),
            gather::load_once(lvl + pt)};
  }

  // Branch-free: a dead point (pruned, or on no level) loads nothing and
  // keeps p = 0. A dense table has no remap (the row is the pixel) and
  // one window, so its two checks are the same check.
  __device__ gather::PointRec resolve(const Operands& o, int b, const Info& it) const {
    const Levels& g = *lv;
    const bool live = o.p != 0.f && static_cast<unsigned>(o.l) < static_cast<unsigned>(g.n);
    const int l = live ? o.l : 0;
    const int2 lo = live ? __ldg(starts + b * starts_batch + it.t * g.n + l) : make_int2(0, 0);
    const int4 geo = g.geo[l];
    const gather::Corners cr = gather::corners(o.x, o.y, geo.x, geo.y, geo.z);
    const unsigned wp = static_cast<unsigned>(geo.w);
    const unsigned wv = static_cast<unsigned>(g.wv[l]);
    const int* rm = remap + static_cast<int64_t>(b) * n_pix;
    gather::PointRec r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool ok = live && cr.in[c];
      const int row = ok && remap != nullptr ? __ldg(rm + cr.pix[c]) : cr.pix[c];
      const bool in_window = static_cast<unsigned>(cr.pix[c] - lo.x) < wp &&
                             static_cast<unsigned>(row - lo.y) < wv;
      r.row[c] = ok && in_window ? row : -1;
    }
    r.t0 = cr.t0;
    r.t1 = cr.t1;
    r.p = live ? o.p : 0.f;
    r.pad = 0.f;
    return r;
  }
};

struct Args {
  const float* x;
  const float* y;
  const float* probs;
  const int* lvl;
  const int* remap;
  const int* qtile;
  const int2* starts;
  int64_t starts_batch;
  const void* v;
  const float* scale;
  void* out;
  int B;
  int64_t n_pix;
};

template <typename T, typename O, int VEC>
__global__ void __launch_bounds__(kWarp * gather::kWarps, gather::kMinBlocks)
msgs_windowed_kernel(const Args a, const __grid_constant__ Levels levels,
                     const gather::Shape sh, int b0, const gather::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  const WindowedSource src{a.x,     a.y,      a.probs,        a.lvl,   a.remap,
                           a.qtile, a.starts, a.starts_batch, &levels, a.n_pix};
  gather::gather_items<T, O, VEC>(src, static_cast<const T*>(a.v), a.scale,
                                  static_cast<O*>(a.out), sh, b0, plan,
                                  reinterpret_cast<gather::PointRec*>(smem));
}

// One launch per kMaxGridY batches (grid y is the batch).
template <typename T, typename O, int VEC>
int launch(const Args& a, const Levels& lv, const gather::Shape& sh, const gather::Plan& plan,
           int group_lanes, cudaStream_t s) {
  if constexpr (VEC < static_cast<int>(sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    for (int b0 = 0; b0 < a.B; b0 += gather::kMaxGridY) {
      const dim3 grid(gather::grid_blocks(sh.per_batch, group_lanes),
                      static_cast<unsigned>(std::min(a.B - b0, gather::kMaxGridY)));
      msgs_windowed_kernel<T, O, VEC><<<grid, kWarp * gather::kWarps,
                                        gather::smem_bytes(group_lanes), s>>>(a, lv, sh, b0,
                                                                             plan);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  }
}

template <typename T, typename O>
int launch_vec(int vec, const Args& a, const Levels& lv, const gather::Shape& sh,
               const gather::Plan& plan, int group_lanes, cudaStream_t s) {
  switch (vec) {
    case 16: return launch<T, O, 16>(a, lv, sh, plan, group_lanes, s);
    case 8: return launch<T, O, 8>(a, lv, sh, plan, group_lanes, s);
    case 4: return launch<T, O, 4>(a, lv, sh, plan, group_lanes, s);
    case 2: return launch<T, O, 2>(a, lv, sh, plan, group_lanes, s);
    case 1: return launch<T, O, 1>(a, lv, sh, plan, group_lanes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro_torch

// table_dtype: 0 float32 (out float32), 1 bfloat16 (out bfloat16),
// 2 int8 codes with a (B, H/G, G, Dh) f32 scale (out float32).
// remap (B, n_pix) is null for a dense table. qtile (Nq,) int32: the
// tile of each raster query. starts (B, T, L, 2) int32:
// the pixel-window and row-window start of each (batch, tile, level);
// starts_batch its batch stride in pairs (0: one set for every batch).
// level_geo: 5 * L host ints — heights, widths, flat starts, pixel
// windows, row windows. vec_bytes, group_lanes, lanes_per_row and row_chunks are the
// wrapper's gather_plan(). Returns the launch's CUDA error code.
extern "C" int msgs_windowed_forward(int table_dtype, const void* v, const void* x,
                                     const void* y, const void* lvl,
                                     const void* probs, const void* remap,
                                     const void* qtile, const void* starts,
                                     const void* scale, void* out, int B, int Nq, int H,
                                     int K, int Dh, int L, long long n_rows,
                                     long long n_pix, long long starts_batch,
                                     const int* level_geo, int vec_bytes, int group_lanes,
                                     int lanes_per_row, int row_chunks, void* stream) {
  using namespace repro_torch;
  static const int kItemsize[3] = {4, 2, 1};
  const int64_t per_batch = static_cast<int64_t>(Nq) * H;
  if (L < 1 || L > gather::kMaxLevels || table_dtype < 0 || table_dtype > 2 ||
      !gather::plan_ok(vec_bytes, kItemsize[table_dtype], H, Dh, v, group_lanes,
                       lanes_per_row, row_chunks, per_batch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (per_batch == 0 || B == 0) return 0;
  Levels lv{};
  lv.n = L;
  for (int l = 0; l < L; ++l) {
    lv.geo[l] = make_int4(level_geo[2 * L + l], level_geo[L + l], level_geo[l],
                          level_geo[3 * L + l]);
    lv.wv[l] = level_geo[4 * L + l];
  }
  const Args a{static_cast<const float*>(x), static_cast<const float*>(y),
               static_cast<const float*>(probs), static_cast<const int*>(lvl),
               static_cast<const int*>(remap), static_cast<const int*>(qtile),
               static_cast<const int2*>(starts),
               starts_batch, v, static_cast<const float*>(scale), out, B, n_pix};
  const gather::Shape sh{static_cast<unsigned>(per_batch), H, K, Dh, n_rows};
  const gather::Plan plan{gather::log2_int(group_lanes), lanes_per_row, row_chunks};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_dtype) {
    case 0:
      return launch_vec<float, float>(vec_bytes, a, lv, sh, plan, group_lanes, s);
    case 1:
      return launch_vec<__nv_bfloat16, __nv_bfloat16>(vec_bytes, a, lv, sh, plan, group_lanes, s);
    default:
      return launch_vec<int8_t, float>(vec_bytes, a, lv, sh, plan, group_lanes, s);
  }
}
