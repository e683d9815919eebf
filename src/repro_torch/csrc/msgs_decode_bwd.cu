// K2: persistent-cache decode MSGS + aggregation for Hopper (sm_90a),
// backward.
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
// over the valid corners only. A pruned pixel's corner reaches the zero sentinel row through the remap,
// and that row receives its gradient, as jax.vjp gives it. A point whose
// probability is exactly 0 (PAP-pruned) adds nothing to d_vp, d_scale,
// d_x or d_y; its d_p is computed like any other point's, since the
// probability's gradient flows on to the attention logits through the
// fake-quant's straight-through estimator.
//
// Every output is deterministic: each value is summed by one thread in a
// fixed order, and no float is added with an atomic. Two launches:
//
//   * msgs_decode_bwd_points_kernel: a block takes a tile of one (b, h)
//     plane's items (32 (layer, query) items at f32 Dh 32, at most 512
//     corners). The gather engine of msgs_gather.cuh resolves every point
//     of a warp's items (pruned points included: d_p needs their rows) and
//     has all 16 corner rows of an item in flight, with g's channels in
//     the lanes that hold the rows' channels; it writes d_x, d_y and d_p.
//     For a float table's gradient the block then sorts the tile's live
//     corners by row (CUB's block radix sort, stable, so slot order within
//     a row), sums each row's entries in slot order from g staged in
//     shared memory, and writes one partial per row, with per bin of
//     table rows the index of the bin's first row. For an int8 table it
//     writes the tile's scale gradient, its items in order.
//   * msgs_decode_bwd_table_kernel (float tables): block (bin of 128 rows,
//     plane) adds, for tile 0, 1, ... in order, the tiles' partials of its
//     rows into a float32 accumulator (a lane group's next two partials
//     loaded at once) and writes every row of the bin once,
//     in the table's dtype straight from the float32 sum; a row no tile
//     reached is written zero. No zero fill, no separate cast.
//     msgs_decode_bwd_scale_kernel (int8 tables): d_scale as the ordered
//     sum of the tiles' partials.
//
// So d_vp[row] = sum over tiles t in order of (sum over the tile's corners
// at row, in slot order, of (p w_c) g): a row that many items reach (the
// train step's operands put up to 290 corners of one (b, h) plane on one
// row) has one partial per tile, and no thread waits on a long chain.
//
// What bounds it on the H100: at the 512 px decoder shape (B = 2, 300
// queries, 8 heads, K = 4, Dh = 32, staged table 2 x 2 x 13,057 x 128)
// the dense float32 d_vp (26.7 MB) must be written: 0.0080 ms at
// 3.35 TB/s of the 0.0085 ms bound, against about 1.8 MB of touched rows,
// points and g. Measured on the train step's first backward call (PERF.md,
// section 6; NVIDIA H100 80GB HBM3, 700 W): the points kernel 0.0171 ms
// (0.0066 ms without the table gradient's tile sort and sums), the table
// kernel 0.0163 ms (its zero-and-write part alone 0.0094 ms; a fill of
// the same bytes 0.0076 ms): 0.0334 ms for the call, against 0.0270 ms
// for the first design (one warp per item walking its points, float32
// atomicAdd into a buffer that torch.zeros filled first, whose sums
// changed from run to run). What keeps it there: the tile sort and the
// per-row sums of level 1, and the table kernel's pass per tile, each a
// chain of shared- and global-memory round trips inside one block.
#include <cub/block/block_radix_sort.cuh>

#include "msgs_gather.cuh"

namespace repro_torch {
namespace bwd {

constexpr int kThreads = 256;        // both kernels: 8 warps a block
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kMinBlocks = 2;        // at most 128 registers a thread
constexpr int kSortItems = 2;
constexpr int kTileCap = kThreads * kSortItems;   // corners one block sorts: 512
constexpr int kAccFloats = 8192;     // a table block's float32 rows: 32 KB
constexpr int kRounds = 2;           // tile partials a table lane group loads at once
constexpr int kScaleThreads = 128;

using GradSource = gather::PointSource<true>;
using TileSort = cub::BlockRadixSort<unsigned, kThreads, kSortItems, int>;
// a tile's sort storage, reused for its sorted rows and slots
constexpr size_t kSortBytes = sizeof(TileSort::TempStorage) > 2 * kTileCap * sizeof(int)
                                  ? sizeof(TileSort::TempStorage)
                                  : 2 * kTileCap * sizeof(int);

// The tile's keys, then (once sorted) two scan totals and the row heads.
constexpr int kKeyWords = kTileCap + 2 * kWarpsPerBlock + 16;

// Bytes of the tile's g rows and then its sorted rows (one word per row
// at most kTileCap), rounded up to 16.
__host__ __device__ inline size_t g_rows_bytes(int tile, int Dh) {
  return (sizeof(float) * (static_cast<size_t>(tile) * Dh + kTileCap) + 15) / 16 * 16;
}

// Items of one tile: the block's warps' items, at most kTileCap / (4 K).
__host__ __device__ inline int tile_items(int group_lanes, int K) {
  const int all = kWarpsPerBlock * (kWarp / group_lanes);
  const int fit = kTileCap / (4 * K);
  return all < fit ? all : fit;
}

__host__ __device__ inline int ceil_div(int64_t a, int64_t b) {
  return static_cast<int>((a + b - 1) / b);
}

struct Args {
  const float* g;        // (B, L, Nq, H, Dh)
  float* d_x;            // (B, L, Nq, H, K), and d_y, d_p
  float* d_y;
  float* d_p;
  // a float table's gradient, level 1: per (b, h, tile) the rows its live
  // corners add to, sorted, each with its partial sum (Dh floats), and per
  // bin of bin_rows rows the index of the bin's first row in that list
  int* part_row;         // (B, H, tiles, cap)
  float* part_vec;       // (B, H, tiles, cap, Dh)
  int* part_bin;         // (B, H, tiles, bins + 1)
  float* ds_part;        // int8: (B, H, tiles, Dh) scale partials, or null
  int n_lq;              // L * Nq
  int tiles, tile, cap;  // tiles per plane, items per tile, cap = 4 K tile
  int bins, bin_rows;    // the table kernel's blocks along the rows
};

// Rows of one (b, h) plane a table block owns: 128, or fewer when its
// float32 accumulator (rows x Dh) would outgrow kAccFloats.
__host__ __device__ inline int bin_rows(int Dh) {
  const int r = kAccFloats / Dh;
  return r < 128 ? (r > 0 ? r : 1) : 128;
}

// Corner weight w_c of Eq. 4, the x factor times the y factor as
// corner_data() computes it, and its derivatives along t1 (x) and t0 (y);
// corner order (0,0) (1,0) (0,1) (1,1).
__device__ __forceinline__ float weight(int c, float t0, float t1) {
  const float fx = (c & 1) ? t1 : __fsub_rn(1.f, t1);
  const float fy = (c >> 1) ? t0 : __fsub_rn(1.f, t0);
  return __fmul_rn(fx, fy);
}
__device__ __forceinline__ float weight_dt1(int c, float t0) {
  const float fy = (c >> 1) ? t0 : __fsub_rn(1.f, t0);
  return (c & 1) ? fy : -fy;
}
__device__ __forceinline__ float weight_dt0(int c, float t1) {
  const float fx = (c & 1) ? t1 : __fsub_rn(1.f, t1);
  return (c >> 1) ? fx : -fx;
}

// N floats from global or shared memory: vector loads where the address
// allows.
template <int N>
__device__ __forceinline__ void load_row(const float* s, float (&out)[N]) {
  if constexpr (N == 4) {
    if ((reinterpret_cast<uintptr_t>(s) & 15u) == 0) {
      const float4 f = *reinterpret_cast<const float4*>(s);
      out[0] = f.x; out[1] = f.y; out[2] = f.z; out[3] = f.w;
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = s[i];
}

template <int N>
__device__ __forceinline__ void store_row(float* o, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
  } else {
    *o = v[0];
  }
}

template <int N>
__device__ __forceinline__ void store_row(__nv_bfloat16* o, const float (&v)[N]) {
  if constexpr (N == 4) {
    *reinterpret_cast<uint2*>(o) =
        make_uint2(gather::pack_bf16x2(v[0], v[1]), gather::pack_bf16x2(v[2], v[3]));
  } else if constexpr (N == 2) {
    *reinterpret_cast<unsigned int*>(o) = gather::pack_bf16x2(v[0], v[1]);
  } else {
    *o = __float2bfloat16_rn(v[0]);
  }
}

// Exclusive prefix sum over the block's threads of one value each; *total
// gets the sum. Integer, so exact in any order. tmp: kWarpsPerBlock ints.
__device__ __forceinline__ int block_exclusive(int v, int* tmp, int* total) {
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  int x = v;
#pragma unroll
  for (int off = 1; off < kWarp; off <<= 1) {
    const int y = __shfl_up_sync(kFullMask, x, off);
    if (lane >= off) x += y;
  }
  if (lane == kWarp - 1) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarpsPerBlock ? tmp[lane] : 0;
#pragma unroll
    for (int off = 1; off < kWarpsPerBlock; off <<= 1) {
      const int y = __shfl_up_sync(kFullMask, w, off);
      if (lane >= off) w += y;
    }
    if (lane < kWarpsPerBlock) tmp[lane] = w;
  }
  __syncthreads();
  const int excl = (warp > 0 ? tmp[warp - 1] : 0) + x - v;
  *total = tmp[kWarpsPerBlock - 1];
  __syncthreads();
  return excl;
}

// Phase A for the tile's items: PointRec of point kp * kPass + kk of item
// m of the warp, at recs[kk * ng + m]; the items (b, lq, h), lq = lq0 + m.
__device__ __forceinline__ void resolve_tile_pass(const GradSource& src, int b, int h, int H,
                                                  int K, int n_lq, int lq0, int lq_end, int kp,
                                                  int ng, gather::PointRec* recs, int lane) {
  using gather::kPass;
  using gather::kSlotsPerLane;
  GradSource::Operands op[kSlotsPerLane];
#pragma unroll
  for (int s = 0; s < kSlotsPerLane; ++s) {
    const int j = lane + kWarp * s;
    const int m = j / kPass;
    const int k = kp * kPass + j % kPass;
    const bool live = m < ng && lq0 + m < lq_end && k < K;
    op[s] = live ? src.load(((static_cast<int64_t>(b) * n_lq + lq0 + m) * H + h) * K + k)
                 : GradSource::dead();
  }
  gather::PointRec rec[kSlotsPerLane];
#pragma unroll
  for (int s = 0; s < kSlotsPerLane; ++s) {
    if (kWarp * s >= ng * kPass) break;            // no point of the warp left: uniform
    rec[s] = src.resolve(op[s], b, GradSource::Info{});
  }
#pragma unroll
  for (int s = 0; s < kSlotsPerLane; ++s) {
    const int j = lane + kWarp * s;
    const int m = j / kPass;
    if (m < ng) recs[(j % kPass) * ng + m] = rec[s];
  }
}

// Block (tile, plane): items (b, lq, h) of one plane, lq in [tile * T, +T).
// Phase A resolves every point of a warp's items (pruned points included:
// d_p needs their rows); phase B has all 16 corner rows of an item in
// flight, with g's channels in the lanes that hold the rows' channels.
// Writes d_x, d_y and d_p. For a float table's gradient it then sorts the
// tile's live corners by row (stable: slot order within a row) and writes
// one partial per row, its entries summed in slot order; for an int8 table
// the tile's scale gradient, its items in order.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
msgs_decode_bwd_points_kernel(const GradSource src, const T* __restrict__ vp,
                              const float* __restrict__ scale, const Args a,
                              const gather::Shape sh, int p0, const gather::Plan plan,
                              const gather::Plan gp) {
  using gather::kPass;
  constexpr int kCh = VEC / static_cast<int>(sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid % kWarp;
  const int warp = tid / kWarp;
  const int gs = plan.group_shift;
  const int group_lanes = 1 << gs;
  const int ng = kWarp >> gs;
  const int plane = p0 + static_cast<int>(blockIdx.y);
  const int b = plane / sh.H;
  const int h = plane - b * sh.H;
  const int Dh = sh.Dh;
  const int K = sh.K;
  const int lq_first = static_cast<int>(blockIdx.x) * a.tile;
  const int lq_end = min(a.n_lq, lq_first + a.tile);
  // shared memory: recs | ds_items (int8) or keys, coefs, g rows, sort
  auto* recs = reinterpret_cast<gather::PointRec*>(smem);
  unsigned char* rest = smem + sizeof(gather::PointRec) * kWarpsPerBlock * ng * kPass;
  float* ds_items = reinterpret_cast<float*>(rest);                 // [tile][Dh]
  unsigned* key_s = reinterpret_cast<unsigned*>(rest);              // [kKeyWords]
  float* coef_s = reinterpret_cast<float*>(key_s + kKeyWords);      // [kTileCap]
  float* g_s = coef_s + kTileCap;                                   // [tile][Dh]
  unsigned char* sort_s = reinterpret_cast<unsigned char*>(g_s) + g_rows_bytes(a.tile, Dh);
  const bool table = a.part_row != nullptr;
  const unsigned dead = static_cast<unsigned>(sh.n_rows);

  gather::PointRec* wrec = recs + warp * ng * kPass;
  const int lq0 = lq_first + warp * ng;            // the warp's first item
  const int g = lane >> gs;
  const int i = lane & (group_lanes - 1);
  const int m_tile = warp * ng + g;                // the item within the tile
  const bool item_ok = m_tile < a.tile && lq0 + g < lq_end;
  const int lq = item_ok ? lq0 + g : lq_first;
  const int64_t item = (static_cast<int64_t>(b) * a.n_lq + lq) * sh.H + h;
  const int row_bytes = sh.G * Dh * static_cast<int>(sizeof(T));
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(vp) +
                            gather::row_base(sh, b, h) * sizeof(T);
  const float* gi = a.g + item * Dh;
  const float* sc = scale != nullptr ? scale + (static_cast<int64_t>(b) * sh.H + h) * Dh : nullptr;
  float* dsi = ds_items + m_tile * Dh;             // this item's scale gradient (int8)
  const bool warp_on = warp * ng < a.tile;         // uniform per warp
  if (table) {
    for (int e = tid; e < kTileCap; e += kThreads) key_s[e] = dead;
  }
  if (warp_on) {
    for (int r = 0; r < plan.row_chunks; ++r) {
      const int chunk = i + (r << gs);
      if (!item_ok || chunk >= plan.lanes_per_row) continue;
      float gv[kCh];
      gather::load_floats<kCh>(gi + chunk * kCh, gv);
#pragma unroll
      for (int c = 0; c < kCh; ++c) {
        if (sc != nullptr) dsi[chunk * kCh + c] = 0.f;
        if (table) g_s[m_tile * Dh + chunk * kCh + c] = gv[c];
      }
    }
  }
  __syncthreads();                                 // key_s filled before the keys below
  const int n_pass = (K + kPass - 1) / kPass;
  for (int kp = 0; warp_on && kp < n_pass; ++kp) {
    __syncwarp();
    resolve_tile_pass(src, b, h, sh.H, K, a.n_lq, lq0, min(lq_end, lq_first + a.tile), kp, ng,
                      wrec, lane);
    __syncwarp();
    float dot[kPass][4];
#pragma unroll
    for (int kk = 0; kk < kPass; ++kk)
#pragma unroll
      for (int c = 0; c < 4; ++c) dot[kk][c] = 0.f;
    for (int r = 0; r < plan.row_chunks; ++r) {
      const int chunk = i + (r << gs);
      const bool act = item_ok && chunk < plan.lanes_per_row;
      float gv[kCh], gsv[kCh];
      if (act) {
        gather::load_floats<kCh>(gi + chunk * kCh, gv);
      } else {
#pragma unroll
        for (int c = 0; c < kCh; ++c) gv[c] = 0.f;
      }
      if (sc != nullptr && act) {   // <code, g * scale> is <dequantised row, g>
        float s[kCh];
        gather::load_floats<kCh>(sc + chunk * kCh, s);
#pragma unroll
        for (int c = 0; c < kCh; ++c) gsv[c] = __fmul_rn(gv[c], s[c]);
      } else {
#pragma unroll
        for (int c = 0; c < kCh; ++c) gsv[c] = gv[c];
      }
      gather::Raw<VEC> raw[kPass][4];
#pragma unroll
      for (int kk = 0; kk < kPass; ++kk) {
        const gather::PointRec rc = wrec[kk * ng + g];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (act && rc.row[c] >= 0)
            gather::load_raw<VEC>(vb + static_cast<int64_t>(rc.row[c]) * row_bytes + chunk * VEC,
                                  raw[kk][c]);
          else
            gather::zero_raw<VEC>(raw[kk][c]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kPass; ++kk) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float part = 0.f;
#pragma unroll
          for (int ch = 0; ch < kCh; ++ch) {
            const float val =
                __fsub_rn(gather::Widen<T>::get(raw[kk][c].w, ch), gather::Widen<T>::kBias);
            part = __fmaf_rn(val, gsv[ch], part);
          }
          dot[kk][c] = __fadd_rn(dot[kk][c], part);
        }
      }
      if (sc != nullptr && act) {   // d_scale: sum_k sum_c (p w_c code_c) g, k and c in order
        float coef[kPass][4];
#pragma unroll
        for (int kk = 0; kk < kPass; ++kk) {
          const gather::PointRec rc = wrec[kk * ng + g];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            coef[kk][c] = rc.row[c] >= 0 && rc.p != 0.f
                              ? __fmul_rn(weight(c, rc.t0, rc.t1), rc.p) : 0.f;
        }
#pragma unroll
        for (int ch = 0; ch < kCh; ++ch) {
          float ds = dsi[chunk * kCh + ch];
#pragma unroll
          for (int kk = 0; kk < kPass; ++kk) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float code =
                  __fsub_rn(gather::Widen<T>::get(raw[kk][c].w, ch), gather::Widen<T>::kBias);
              ds = __fmaf_rn(__fmul_rn(coef[kk][c], code), gv[ch], ds);
            }
          }
          dsi[chunk * kCh + ch] = ds;
        }
      }
    }
    // every lane of the group gets the full dot products
    for (int off = group_lanes >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int kk = 0; kk < kPass; ++kk) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          dot[kk][c] = __fadd_rn(dot[kk][c], __shfl_xor_sync(kFullMask, dot[kk][c], off));
      }
    }
#pragma unroll
    for (int kk = 0; kk < kPass; ++kk) {
      const int k = kp * kPass + kk;
      if (!item_ok || k >= K || (kk & (group_lanes - 1)) != i) continue;
      const gather::PointRec rc = wrec[kk * ng + g];
      float sp = 0.f, sx = 0.f, sy = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool valid = rc.row[c] >= 0;
        const float d = valid ? dot[kk][c] : 0.f;
        const float w = weight(c, rc.t0, rc.t1);
        sp = __fmaf_rn(w, d, sp);
        sx = __fmaf_rn(weight_dt1(c, rc.t0), d, sx);
        sy = __fmaf_rn(weight_dt0(c, rc.t1), d, sy);
        if (table) {
          const int slot = (m_tile * K + k) * 4 + c;
          const bool live = valid && rc.p != 0.f;
          key_s[slot] = live ? static_cast<unsigned>(rc.row[c]) : dead;
          coef_s[slot] = live ? __fmul_rn(w, rc.p) : 0.f;
        }
      }
      const int64_t pt = item * K + k;
      a.d_p[pt] = sp;
      a.d_x[pt] = __fmul_rn(rc.p, sx);
      a.d_y[pt] = __fmul_rn(rc.p, sy);
    }
  }
  if (sc != nullptr) {           // uniform: the tile's partial of d_scale
    __syncthreads();
    const int n_here = lq_end - lq_first;
    float* part = a.ds_part + (static_cast<int64_t>(plane) * a.tiles + blockIdx.x) * Dh;
    for (int ch = tid; ch < Dh; ch += kThreads) {
      float acc = 0.f;
      for (int m = 0; m < n_here; ++m) acc = __fadd_rn(acc, ds_items[m * Dh + ch]);
      part[ch] = acc;
    }
  }
  if (!table) return;            // uniform

  // level 1: the tile's live corners sorted by (row, slot)
  __syncthreads();
  unsigned key[kSortItems];
  int val[kSortItems];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    key[j] = key_s[tid * kSortItems + j];
    val[j] = tid * kSortItems + j;
  }
  TileSort(*reinterpret_cast<typename TileSort::TempStorage*>(sort_s))
      .Sort(key, val, 0, 32 - __clz(static_cast<int>(dead)));
  __syncthreads();
  unsigned* srow = reinterpret_cast<unsigned*>(sort_s);
  int* sslot = reinterpret_cast<int*>(srow + kTileCap);
  int n_mine = 0;
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    srow[tid * kSortItems + j] = key[j];
    sslot[tid * kSortItems + j] = val[j];
    n_mine += key[j] != dead;
  }
  int* tmp = reinterpret_cast<int*>(key_s);       // the keys are sorted now
  int n_live;
  block_exclusive(n_mine, tmp, &n_live);
  // sorted order: each entry's item within the tile and coefficient (the
  // coefficients move from slot order to sorted order in place)
  float cf[kSortItems];
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int q = tid * kSortItems + j;
    cf[j] = q < n_live ? coef_s[val[j]] : 0.f;
    sslot[q] = val[j] / (4 * K);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) coef_s[tid * kSortItems + j] = cf[j];
  // the rows: a head per row's first entry, its index among the heads
  int n_head = 0;
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int q = tid * kSortItems + j;
    n_head += q < n_live && (q == 0 || srow[q - 1] != srow[q]);
  }
  int n_rows_tile;
  int u = block_exclusive(n_head, tmp + kWarpsPerBlock, &n_rows_tile);
  int* heads = tmp + 2 * kWarpsPerBlock;           // [n_rows_tile + 1]: first entry of each row
  unsigned* urow = reinterpret_cast<unsigned*>(g_s) + a.tile * Dh;   // the rows, in order
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const int q = tid * kSortItems + j;
    if (q < n_live && (q == 0 || srow[q - 1] != srow[q])) {
      urow[u] = srow[q];
      heads[u++] = q;
    }
  }
  if (tid == 0) heads[n_rows_tile] = n_live;
  __syncthreads();
  const int64_t tile_id = static_cast<int64_t>(plane) * a.tiles + blockIdx.x;
  int* prow = a.part_row + tile_id * a.cap;
  float* pvec = a.part_vec + tile_id * a.cap * Dh;
  int* pbin = a.part_bin + tile_id * (a.bins + 1);
  // each row's entries summed in slot order by one lane group
  constexpr int kGCh = 4;                          // g channels a lane sums per pass
  const int ggs = gp.group_shift;
  const int ggrp = tid >> ggs;
  const int ggi = tid & ((1 << ggs) - 1);
  const int n_groups = kThreads >> ggs;
  for (int ur = ggrp; ur < n_rows_tile; ur += n_groups) {
    const int q0 = heads[ur];
    const int q1 = heads[ur + 1];
    if (ggi == 0) prow[ur] = static_cast<int>(urow[ur]);
    for (int ch0 = ggi * kGCh; ch0 < Dh; ch0 += (1 << ggs) * kGCh) {
      float s[kGCh] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int q = q0; q < q1; ++q) {
        const float c_q = coef_s[q];
        const float* gr = g_s + sslot[q] * Dh;
#pragma unroll
        for (int c = 0; c < kGCh; ++c)
          if (ch0 + c < Dh) s[c] = __fadd_rn(s[c], __fmul_rn(c_q, gr[ch0 + c]));
      }
#pragma unroll
      for (int c = 0; c < kGCh; ++c)
        if (ch0 + c < Dh) pvec[static_cast<int64_t>(ur) * Dh + ch0 + c] = s[c];
    }
  }
  // per bin of bin_rows rows: the index of its first row among the tile's
  for (int k = tid; k <= a.bins; k += kThreads) {
    const unsigned bound = static_cast<unsigned>(min(static_cast<int64_t>(k) * a.bin_rows,
                                                     sh.n_rows));
    int lo = 0, hi = n_rows_tile;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (urow[mid] < bound) lo = mid + 1; else hi = mid;
    }
    pbin[k] = lo;
  }
}

__global__ void __launch_bounds__(kScaleThreads)
msgs_decode_bwd_scale_kernel(const float* __restrict__ ds_part, float* __restrict__ d_scale,
                             int planes, int tiles, int Dh) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<int64_t>(planes) * Dh) return;
  const int64_t plane = e / Dh;
  const int64_t ch = e - plane * Dh;
  float acc = 0.f;
  for (int t = 0; t < tiles; ++t)
    acc = __fadd_rn(acc, __ldg(ds_part + (plane * tiles + t) * Dh + ch));
  d_scale[e] = acc;
}

struct TableArgs {
  const int* part_row;
  const float* part_vec;
  const int* part_bin;
  void* d_vp;
  int H, G, Dh, tiles, cap, bins, bin_rows;
  int64_t n_rows;
};

// Block (bin, plane (b, h)): rows [bin * R, +R) of the plane, level 2.
// For tile 0, 1, ... in order, the tile's partials of the bin's rows
// (distinct rows within a tile) are added into a float32 accumulator,
// a lane group an entry and its lanes the row's channels; then every row
// of the bin is written once, in the table's dtype: zero where no tile
// reached it.
template <typename O, int GVEC>
__global__ void __launch_bounds__(kThreads)
msgs_decode_bwd_table_kernel(const TableArgs a, int p0, const gather::Plan gp) {
  constexpr int kCh = GVEC / static_cast<int>(sizeof(float));
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dh = a.Dh;
  float* acc = reinterpret_cast<float*>(smem);      // [R][Dh]
  int* range = reinterpret_cast<int*>(acc + a.bin_rows * Dh);   // [tiles][2]
  int* pre = range + 2 * a.tiles;                   // [tiles + 1], then scan scratch
  const int tid = threadIdx.x;
  const int plane = p0 + static_cast<int>(blockIdx.y);
  const int b = plane / a.H;
  const int h = plane - b * a.H;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * a.bin_rows;
  const int nr = static_cast<int>(min(static_cast<int64_t>(a.bin_rows), a.n_rows - r0));
  for (int e = tid; e < nr * Dh; e += kThreads) acc[e] = 0.f;
  for (int t = tid; t < a.tiles; t += kThreads) {
    const int* pb = a.part_bin + (static_cast<int64_t>(plane) * a.tiles + t) * (a.bins + 1);
    range[2 * t] = __ldg(pb + blockIdx.x);
    range[2 * t + 1] = __ldg(pb + blockIdx.x + 1);
  }
  __syncthreads();
  const int gs = gp.group_shift;
  const int grp = tid >> gs;
  const int gi = tid & ((1 << gs) - 1);
  const int n_groups = kThreads >> gs;
  // the block's tile partials as one list in tile order; a batch of
  // kRounds entries a lane group has every load in flight at once, then
  // its entries are added tile by tile (a row's partials in tile order)
  int n_all = 0;
  for (int t0 = 0; t0 < a.tiles; t0 += kThreads) {
    const int t = t0 + tid;
    const int n = t < a.tiles ? range[2 * t + 1] - range[2 * t] : 0;
    int total;
    const int excl = block_exclusive(n, pre + a.tiles + 1, &total);
    if (t < a.tiles) pre[t] = n_all + excl;
    n_all += total;
  }
  if (tid == 0) pre[a.tiles] = n_all;
  __syncthreads();
  auto tile_of = [&](int e) {                       // the tile of list entry e
    int lo = 0, hi = a.tiles;
    while (hi - lo > 1) {
      const int mid = (lo + hi) / 2;
      if (pre[mid] <= e) lo = mid; else hi = mid;
    }
    return lo;
  };
  const int64_t tile0 = static_cast<int64_t>(plane) * a.tiles;
  for (int base = 0; base < n_all; base += kRounds * n_groups) {
    const int end = min(n_all, base + kRounds * n_groups);
    const int t_last = tile_of(end - 1);
    for (int rc = 0; rc < gp.row_chunks; ++rc) {
      const int chunk = gi + (rc << gs);
      int tile[kRounds], row[kRounds];
      float v[kRounds][kCh];
#pragma unroll
      for (int u = 0; u < kRounds; ++u) {
        const int e = base + u * n_groups + grp;
        tile[u] = -1;
        if (e < end) {
          const int t = tile_of(e);
          const int64_t at = (tile0 + t) * a.cap + range[2 * t] + e - pre[t];
          tile[u] = t;
          row[u] = (__ldg(a.part_row + at) - static_cast<int>(r0)) * Dh;
          if (chunk < gp.lanes_per_row) load_row<kCh>(a.part_vec + at * Dh + chunk * kCh, v[u]);
        }
      }
      for (int t = tile_of(base); t <= t_last; ++t) {
#pragma unroll
        for (int u = 0; u < kRounds; ++u) {
          if (tile[u] != t || chunk >= gp.lanes_per_row) continue;
#pragma unroll
          for (int c = 0; c < kCh; ++c) {
            float* dst = acc + row[u] + chunk * kCh + c;
            *dst = __fadd_rn(*dst, v[u][c]);
          }
        }
        __syncthreads();
      }
    }
  }
  const int group = h / a.G;
  O* out = static_cast<O*>(a.d_vp) +
           ((static_cast<int64_t>(b) * (a.H / a.G) + group) * a.n_rows * a.G + (h - group * a.G)) *
               Dh +
           r0 * a.G * Dh;
  for (int r = grp; r < nr; r += n_groups) {
    for (int rc = 0; rc < gp.row_chunks; ++rc) {
      const int chunk = gi + (rc << gs);
      if (chunk >= gp.lanes_per_row) continue;
      float v[kCh];
      load_row<kCh>(acc + r * Dh + chunk * kCh, v);
      store_row<kCh>(out + r * static_cast<int64_t>(a.G) * Dh + chunk * kCh, v);
    }
  }
}

// Bytes of the backward's scratch, carved in this order. A float table's
// gradient: part_row (planes * tiles * cap ints), part_vec (* Dh floats),
// part_bin (planes * tiles * (bins + 1) ints). An int8 table: the scale
// partials (planes * tiles * Dh floats).
struct Scratch {
  int* part_row;
  float* part_vec;
  int* part_bin;
  float* ds_part;
  int tiles, tile, cap, bins, bin_rows;
  int64_t bytes;
};

inline Scratch carve(void* base, bool int8, bool table, int B, int L, int Nq, int H, int K, int Dh,
                     int G, int64_t n_rows, int group_lanes) {
  Scratch sc{};
  sc.tile = tile_items(group_lanes, K);
  sc.tiles = ceil_div(static_cast<int64_t>(L) * Nq, sc.tile);
  sc.cap = 4 * K * sc.tile;
  sc.bin_rows = bin_rows(Dh);
  sc.bins = ceil_div(n_rows, sc.bin_rows);
  const int64_t n_tiles = static_cast<int64_t>(B) * H * sc.tiles;
  int64_t off = 0;
  auto take = [&](int64_t words) {
    unsigned char* p = base == nullptr ? nullptr : static_cast<unsigned char*>(base) + off;
    off += (words * 4 + 15) / 16 * 16;
    return p;
  };
  if (int8) {
    sc.ds_part = reinterpret_cast<float*>(take(n_tiles * Dh));
  } else if (table) {
    sc.part_row = reinterpret_cast<int*>(take(n_tiles * sc.cap));
    sc.part_vec = reinterpret_cast<float*>(take(n_tiles * sc.cap * Dh));
    sc.part_bin = reinterpret_cast<int*>(take(n_tiles * (sc.bins + 1)));
  }
  sc.bytes = off;
  return sc;
}

inline size_t points_smem_bytes(bool int8, bool table, int group_lanes, int tile, int Dh) {
  const size_t recs = sizeof(gather::PointRec) * kWarpsPerBlock * (kWarp / group_lanes) *
                      gather::kPass;
  if (int8) return recs + sizeof(float) * tile * Dh;
  if (!table) return recs;
  return recs + sizeof(int) * (kKeyWords + kTileCap) + g_rows_bytes(tile, Dh) + kSortBytes;
}

template <typename T, int VEC>
int launch_points(const GradSource& src, const void* vp, const float* scale, const Args& a,
                  int planes, const gather::Shape& sh, const gather::Plan& plan, int group_lanes,
                  const gather::Plan& gp, cudaStream_t s) {
  if constexpr (VEC < static_cast<int>(sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const size_t smem = points_smem_bytes(scale != nullptr, a.part_row != nullptr, group_lanes,
                                          a.tile, sh.Dh);
    cudaError_t err = cudaFuncSetAttribute(msgs_decode_bwd_points_kernel<T, VEC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    for (int p0 = 0; p0 < planes; p0 += gather::kMaxGridY) {
      const dim3 grid(a.tiles, static_cast<unsigned>(std::min(planes - p0, gather::kMaxGridY)));
      msgs_decode_bwd_points_kernel<T, VEC><<<grid, kThreads, smem, s>>>(
          src, static_cast<const T*>(vp), scale, a, sh, p0, plan, gp);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  }
}

template <typename T>
int points_vec(int vec, const GradSource& src, const void* vp, const float* scale,
               const Args& a, int planes, const gather::Shape& sh, const gather::Plan& plan,
               int group_lanes, const gather::Plan& gp, cudaStream_t s) {
  switch (vec) {
    case 16: return launch_points<T, 16>(src, vp, scale, a, planes, sh, plan, group_lanes, gp, s);
    case 8: return launch_points<T, 8>(src, vp, scale, a, planes, sh, plan, group_lanes, gp, s);
    case 4: return launch_points<T, 4>(src, vp, scale, a, planes, sh, plan, group_lanes, gp, s);
    case 2: return launch_points<T, 2>(src, vp, scale, a, planes, sh, plan, group_lanes, gp, s);
    case 1: return launch_points<T, 1>(src, vp, scale, a, planes, sh, plan, group_lanes, gp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// One launch per kMaxGridY planes (grid y is the (b, h) plane).
template <typename O, int GVEC>
int launch_table(const TableArgs& a, int planes, const gather::Plan& gp, cudaStream_t s) {
  const size_t smem =
      sizeof(float) * a.bin_rows * a.Dh + sizeof(int) * (3 * a.tiles + 1 + kWarpsPerBlock);
  cudaError_t err = cudaFuncSetAttribute(msgs_decode_bwd_table_kernel<O, GVEC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int p0 = 0; p0 < planes; p0 += gather::kMaxGridY) {
    const dim3 grid(a.bins, static_cast<unsigned>(std::min(planes - p0, gather::kMaxGridY)));
    msgs_decode_bwd_table_kernel<O, GVEC><<<grid, kThreads, smem, s>>>(a, p0, gp);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename O>
int table_vec(int gvec, const TableArgs& a, int groups, const gather::Plan& gp, cudaStream_t s) {
  switch (gvec) {
    case 16: return launch_table<O, 16>(a, groups, gp, s);
    case 8: return launch_table<O, 8>(a, groups, gp, s);
    case 4: return launch_table<O, 4>(a, groups, gp, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace bwd
}  // namespace repro_torch

// The scratch msgs_decode_backward needs for these shapes, in bytes, into
// *bytes: table_grad 0 (or an int8 table) skips the table gradient's part.
// group_lanes is the table's gather_plan().
extern "C" int msgs_decode_backward_scratch(int table_dtype, int B, int L, int Nq, int H, int K,
                                            int Dh, int G, long long n_rows, int group_lanes,
                                            int table_grad, long long* bytes) {
  using namespace repro_torch;
  if (table_dtype < 0 || table_dtype > 2 || group_lanes < 1 || K < 1 || G < 1 || n_rows < 0)
    return 1;
  *bytes = bwd::carve(nullptr, table_dtype == 2, table_grad != 0, B, L, Nq, H, K, Dh, G, n_rows,
                      group_lanes).bytes;
  return 0;
}

// table_dtype: 0 float32, 1 bfloat16, 2 int8 codes with a (B, H/G, G*Dh)
// f32 scale. g_out (B, L, Nq, H, Dh) is float32; d_x, d_y, d_p take the
// points' shape. A float table gets d_vp (its own shape and dtype; null to
// skip the table gradient), an int8 table d_scale (the scale's shape).
// scratch: msgs_decode_backward_scratch() bytes, 16-byte aligned. Every
// output is written in full. vec_bytes .. row_chunks: gather_plan() for
// the table rows; g_vec_bytes .. g_row_chunks: gather_plan() for g's
// float32 rows (the lanes over a row of d_vp). Launches the points kernel,
// then the table kernel (a float table's gradient) or the scale kernel
// (an int8 table). Returns the first CUDA error of the launches, or 0.
extern "C" int msgs_decode_backward(int table_dtype, const void* vp, const void* x,
                                    const void* y, const void* st, const void* wl,
                                    const void* hl, const void* probs,
                                    const void* remap, const void* scale,
                                    const void* g_out, void* d_vp, void* d_scale,
                                    void* d_x, void* d_y, void* d_p, void* scratch, int B,
                                    int L, int Nq, int H, int K, int Dh, int G,
                                    long long n_rows, long long n_pix, int vec_bytes,
                                    int group_lanes, int lanes_per_row, int row_chunks,
                                    int g_vec_bytes, int g_group_lanes, int g_lanes_per_row,
                                    int g_row_chunks, void* stream) {
  using namespace repro_torch;
  static const int kItemsize[3] = {4, 2, 1};
  const int64_t per_batch = static_cast<int64_t>(L) * Nq * H;
  const bool int8 = table_dtype == 2;
  const bool table = d_vp != nullptr;
  if (table_dtype < 0 || table_dtype > 2 || (int8 && table) || K < 1 ||
      4 * K > bwd::kTileCap || int8 != (scale != nullptr && d_scale != nullptr) ||
      !gather::plan_ok(vec_bytes, kItemsize[table_dtype], H, G, Dh, vp, group_lanes,
                       lanes_per_row, row_chunks, per_batch) ||
      !gather::plan_ok(g_vec_bytes, 4, H, 1, Dh, g_out, g_group_lanes, g_lanes_per_row,
                       g_row_chunks, per_batch) ||
      (table && reinterpret_cast<uintptr_t>(d_vp) % 16 != 0) ||
      n_rows >= (int64_t{1} << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (per_batch == 0 || B == 0) return 0;
  const bwd::Scratch sc = bwd::carve(scratch, int8, table, B, L, Nq, H, K, Dh, G, n_rows,
                                     group_lanes);
  if (sc.bytes != 0 && (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const bwd::GradSource src{static_cast<const float*>(x), static_cast<const float*>(y),
                            static_cast<const float*>(probs), static_cast<const int*>(st),
                            static_cast<const int*>(wl), static_cast<const int*>(hl),
                            static_cast<const int*>(remap), n_pix};
  const gather::Shape sh{static_cast<unsigned>(per_batch), H, K, Dh, G, n_rows};
  const gather::Plan plan{gather::log2_int(group_lanes), lanes_per_row, row_chunks};
  const gather::Plan gp{gather::log2_int(g_group_lanes), g_lanes_per_row, g_row_chunks};
  const bwd::Args a{static_cast<const float*>(g_out), static_cast<float*>(d_x),
                    static_cast<float*>(d_y), static_cast<float*>(d_p), sc.part_row,
                    sc.part_vec, sc.part_bin, sc.ds_part, L * Nq, sc.tiles, sc.tile, sc.cap,
                    sc.bins, sc.bin_rows};
  const int planes = B * H;
  const auto* scl = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (table_dtype) {
    case 0:
      err = bwd::points_vec<float>(vec_bytes, src, vp, scl, a, planes, sh, plan, group_lanes, gp, s);
      break;
    case 1:
      err = bwd::points_vec<__nv_bfloat16>(vec_bytes, src, vp, scl, a, planes, sh, plan,
                                           group_lanes, gp, s);
      break;
    default:
      err = bwd::points_vec<int8_t>(vec_bytes, src, vp, scl, a, planes, sh, plan, group_lanes, gp,
                                    s);
  }
  if (err != 0) return err;
  if (int8) {
    const int64_t n = static_cast<int64_t>(planes) * Dh;
    bwd::msgs_decode_bwd_scale_kernel<<<static_cast<unsigned>((n + bwd::kScaleThreads - 1) /
                                                              bwd::kScaleThreads),
                                        bwd::kScaleThreads, 0, s>>>(
        sc.ds_part, static_cast<float*>(d_scale), planes, sc.tiles, Dh);
    return static_cast<int>(cudaGetLastError());
  }
  if (!table) return 0;
  const bwd::TableArgs ta{sc.part_row, sc.part_vec, sc.part_bin, d_vp, H, G, Dh, sc.tiles,
                          sc.cap, sc.bins, sc.bin_rows, n_rows};
  if (table_dtype == 0) return bwd::table_vec<float>(g_vec_bytes, ta, planes, gp, s);
  return bwd::table_vec<__nv_bfloat16>(g_vec_bytes, ta, planes, gp, s);
}
