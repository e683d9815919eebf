// The gather engine of K1 (msgs_fused.cu), K2 (msgs_decode.cu) and K3
// (msgs_windowed.cu) for Hopper (sm_90a): Eq. 4 bilinear sampling of
// table rows plus the probability-weighted sum over an item's points.
//
// Replaces the body shared by the TPU kernels msgs_fused_pallas,
// msgs_fused_packed_pallas, msgs_windowed_msp_pallas and
// _decode_pallas_call (src/repro/kernels/msgs_fused.py _eq4_sample_agg,
// msgs_windowed.py _make_msp_kernel, msgs_decode.py _make_decode_kernel):
// per item, sum over its K points of p_k times the factorised bilinear
// sample of 4 corner rows. An item is (b, q, h) for K1 and K3 and
// (b, layer, q, h) for K2. The table is (B, H/G, N_rows, G*Dh): head h
// reads the rows of head group h / G at lane offset (h % G) * Dh. K1's
// and K3's (B, N_rows, H, Dh) is that layout with G = H, K2's staged
// table that layout with G = head_pack.
//
// What bounds it on the H100: not HBM. The tables fit the 50 MB L2 and
// the unique bytes take 0.03-0.09 ms at 3.35 TB/s, but every item gathers
// 16 corner rows from scattered addresses (about 630-670 MB of 32 B L2
// sectors per call at both encoder paths), and each row must be widened
// and combined per channel. Measured on the card (PERF.md, section 6): the
// time follows the instructions issued per item and the latency of the
// dependent loads, and L1 reuse of neighbouring queries' rows matters
// (reading rows past L1 triples the int8 gather). A decoder layer (K2,
// 4,800 items at B = 2) is too small to fill the card: its time is the
// length of one warp's chain of dependent loads.
//
// What the design does:
//   * A warp serves 32 / group_lanes consecutive items of one batch (grid
//     y is the batch). A group of group_lanes lanes serves one item; lane
//     i of a group loads 16-byte vector i of a row (f32 Dh 32: 8 lanes per
//     128 B row, 4 items per warp; int8 Dh 32: 2 lanes per 32 B row, 16
//     items per warp). A row whose bytes or table pointer do not allow
//     16 B takes a narrower vector (the VEC template parameter;
//     gather_plan() in kernels/msgs_fused.py picks it).
//   * Phase A resolves kPass points of every item of the warp at once:
//     the operands of the warp's points are contiguous and load as whole
//     lines, then each lane issues the remap (and K3's window start)
//     loads of its points' 4 corners together, branch-free, and writes one
//     PointRec per point to shared memory. Phase B issues all 4 x kPass
//     corner-row loads of its item before it uses any: the chain is point
//     operands -> remap -> rows, 3 round trips per pass (one pass for
//     K <= 4), with 8 KB of row loads in flight per warp and 32 warps per
//     SM (256 KB). Measured (PERF.md, section 6): 32 warps at 64
//     registers, spilling about 150 B a thread, beat 16 warps at 128
//     registers without spills (K1 0.12 -> 0.09 ms, K3 0.30 -> 0.25 ms).
//   * Few instructions per channel: 32-bit row offsets and item indices,
//     int8 codes widened by one byte permute.
//   * Eq. 4 stays factorised and in f32 per channel, written with explicit
//     round-to-nearest operations so that no compiler contraction differs
//     between the kernels, and the sum over k runs k = 0, 1, ... in one
//     register per channel. K1, K2 and K3 therefore give bitwise-equal
//     outputs on the same points and rows (K3 wherever its windows drop
//     no corner).
//   * The output is stored as vectors of the lane's channels, the int8
//     scale multiplied once after the sum; operands and output stream past
//     L2 (evict-first) so that the table rows stay there.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace repro_torch {

constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

namespace gather {

constexpr int kWarps = 4;          // warps per block
constexpr int kMinBlocks = 8;      // per SM: 32 warps, at most 64 registers a thread
constexpr int kPass = 4;           // points of an item whose rows are in flight together
constexpr int kSlotsPerLane = 4;   // phase A: at most 32 items x kPass points per warp
constexpr int kMaxLevels = 8;

// One point after phase A: the table row of each corner (order (0,0)
// (1,0) (0,1) (1,1)) or -1 where the corner is dropped, the fractions and
// the probability (0 for a pruned point, which then loads nothing).
struct alignas(16) PointRec {
  int row[4];
  float t0, t1, p, pad;
};

// How lanes cover a row: 2^group_shift lanes per item, lanes_per_row
// vectors per row, row_chunks passes over a row when it has more vectors
// than the group has lanes.
struct Plan {
  int group_shift;
  int lanes_per_row;
  int row_chunks;
};

template <int VEC>
struct Raw {
  uint32_t w[VEC >= 4 ? VEC / 4 : 1];
};

template <int VEC>
__device__ __forceinline__ void load_raw(const unsigned char* p, Raw<VEC>& r) {
  if constexpr (VEC == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    r.w[0] = u.x; r.w[1] = u.y; r.w[2] = u.z; r.w[3] = u.w;
  } else if constexpr (VEC == 8) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    r.w[0] = u.x; r.w[1] = u.y;
  } else if constexpr (VEC == 4) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else if constexpr (VEC == 2) {
    r.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  } else {
    r.w[0] = __ldg(p);
  }
}

template <int VEC>
__device__ __forceinline__ void zero_raw(Raw<VEC>& r) {
#pragma unroll
  for (int i = 0; i < (VEC >= 4 ? VEC / 4 : 1); ++i) r.w[i] = 0u;
}

// Channel c of a loaded vector widened to f32, plus Widen<T>::kBias; exact
// for every type. An int8 code q becomes the float 2^23 + 128 + q with one
// byte permute (bits 0x4B0000 | (q ^ 0x80)) instead of an integer to float
// conversion; the corner differences of Eq. 4 cancel the bias exactly and
// only N0 subtracts it. A zero vector (a dropped corner) reads as code 0.
template <typename T>
struct Widen;
template <>
struct Widen<float> {
  static constexpr float kBias = 0.f;
  static __device__ __forceinline__ float get(const uint32_t* w, int c) {
    return __uint_as_float(w[c]);
  }
};
template <>
struct Widen<__nv_bfloat16> {
  static constexpr float kBias = 0.f;
  static __device__ __forceinline__ float get(const uint32_t* w, int c) {
    const uint32_t u = w[c >> 1];
    return __uint_as_float((c & 1) ? (u & 0xffff0000u) : (u << 16));
  }
};
template <>
struct Widen<int8_t> {
  static constexpr float kBias = 8388736.f;      // 2^23 + 128
  static __device__ __forceinline__ float get(const uint32_t* w, int c) {
    return __uint_as_float(__byte_perm(w[c >> 2] ^ 0x80808080u, 0x4b000000u, 0x7540u | (c & 3)));
  }
};

// Eq. 4 on widened corners f = N + bias. For int8 every partial sum below
// is an exact integer, so the result is Eq. 4 on the codes themselves:
//   S = N0 + (N2 - N0) t0 + [(N1 - N0) + (N3 - N2 - N1 + N0) t0] t1
template <typename T>
__device__ __forceinline__ float eq4(float f0, float f1, float f2, float f3, float t0,
                                     float t1) {
  const float a = __fadd_rn(__fsub_rn(__fsub_rn(f3, f2), f1), f0);
  const float b = __fmaf_rn(a, t0, __fsub_rn(f1, f0));
  float n0 = f0;
  if constexpr (Widen<T>::kBias != 0.f) n0 = __fsub_rn(f0, Widen<T>::kBias);
  return __fmaf_rn(b, t1, __fmaf_rn(__fsub_rn(f2, f0), t0, n0));
}

// What the engine needs of the call: the batch's items (Nq * H, or
// L * Nq * H for K2, counted in 32 bits), H, K, Dh, the heads G of one
// table row group (H for K1 and K3) and the table's rows.
struct Shape {
  unsigned per_batch;
  int H, K, Dh, G;
  int64_t n_rows;
};

template <int N>
__device__ __forceinline__ void load_floats(const float* s, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
    if ((reinterpret_cast<uintptr_t>(s) & 15u) == 0) {
#pragma unroll
      for (int i = 0; i < N / 4; ++i) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(s) + i);
        out[4 * i] = f.x; out[4 * i + 1] = f.y; out[4 * i + 2] = f.z; out[4 * i + 3] = f.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = __ldg(s + i);
}

// Bytes that are touched once (the point operands in, the output out)
// stream past L2 (evict-first), so the table rows the gathers reuse stay
// there: the 1024 px output alone (178 MB) is more than three L2s.
template <typename T>
__device__ __forceinline__ T load_once(const T* p) {
  return __ldcs(p);
}

template <typename T>
__device__ __forceinline__ void store_once(T* p, const T& v) {
  __stcs(p, v);
}

template <int N>
__device__ __forceinline__ void store_chunk(float* o, const float (&v)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i)
      store_once(reinterpret_cast<float4*>(o) + i,
                 make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]));
  } else if constexpr (N == 2) {
    store_once(reinterpret_cast<float2*>(o), make_float2(v[0], v[1]));
  } else {
    store_once(o, v[0]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int N>
__device__ __forceinline__ void store_chunk(__nv_bfloat16* o, const float (&v)[N]) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i)
      store_once(reinterpret_cast<uint4*>(o) + i,
                 make_uint4(pack_bf16x2(v[8 * i], v[8 * i + 1]),
                            pack_bf16x2(v[8 * i + 2], v[8 * i + 3]),
                            pack_bf16x2(v[8 * i + 4], v[8 * i + 5]),
                            pack_bf16x2(v[8 * i + 6], v[8 * i + 7])));
  } else if constexpr (N == 4) {
    store_once(reinterpret_cast<uint2*>(o),
               make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3])));
  } else if constexpr (N == 2) {
    store_once(reinterpret_cast<unsigned int*>(o), pack_bf16x2(v[0], v[1]));
  } else {
    store_once(reinterpret_cast<unsigned short*>(o), __bfloat16_as_ushort(__float2bfloat16(v[0])));
  }
}

// The corners of a live point: fractions, and for each corner its flat
// pixel and whether it lies inside the level.
struct Corners {
  float t0, t1;
  int pix[4];
  bool in[4];
};

__device__ __forceinline__ Corners corners(float x, float y, int st, int wl, int hl) {
  Corners cr;
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  cr.t1 = x - x0;                                  // frac along x
  cr.t0 = y - y0;                                  // frac along y
  const int x0i = static_cast<int>(x0);
  const int y0i = static_cast<int>(y0);
#pragma unroll
  for (int c = 0; c < 4; ++c) {                    // (0,0) (1,0) (0,1) (1,1)
    const int cx = x0i + (c & 1);
    const int cy = y0i + (c >> 1);
    cr.in[c] = cx >= 0 && cx < wl && cy >= 0 && cy < hl;
    cr.pix[c] = cr.in[c] ? st + cy * wl + cx : 0;
  }
  return cr;
}

// Element offset of (row 0, channel 0) of head h of batch b in the
// (B, H/G, N_rows, G*Dh) table; rows follow at G * Dh elements.
__device__ __forceinline__ int64_t row_base(const Shape& sh, int b, int h) {
  const int group = h / sh.G;
  return ((static_cast<int64_t>(b) * (sh.H / sh.G) + group) * sh.n_rows * sh.G + (h - group * sh.G)) *
         sh.Dh;
}

// K1's and K2's points: per point x, y, the probability and the level's
// flat start, width and height; the optional remap sends pruned pixels to
// the zero sentinel row. Branch-free: a corner outside the level loads
// nothing, nor does a pruned point (p 0) unless kKeepPruned (K2's
// backward needs its rows for d_probs).
template <bool kKeepPruned = false>
struct PointSource {
  const float* x;
  const float* y;
  const float* p;
  const int* st;
  const int* wl;
  const int* hl;
  const int* remap;        // (B, n_pix) pixel -> row, or null
  int64_t n_pix;

  struct Operands {
    float x, y, p;
    int st, wl, hl;
  };
  struct Info {};          // nothing per item beyond its batch

  // no corner lies in a 0 x 0 level
  static __device__ Operands dead() { return {0.f, 0.f, 0.f, 0, 0, 0}; }
  static __device__ Info shfl(const Info&, int) { return {}; }
  __device__ Info info(int) const { return {}; }

  __device__ Operands load(int64_t pt) const {
    return {load_once(x + pt), load_once(y + pt), load_once(p + pt),
            load_once(st + pt), load_once(wl + pt), load_once(hl + pt)};
  }

  __device__ PointRec resolve(const Operands& o, int b, const Info&) const {
    const Corners cr = corners(o.x, o.y, o.st, o.wl, o.hl);
    const int* rm = remap + b * n_pix;
    PointRec r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool ok = (kKeepPruned || o.p != 0.f) && cr.in[c];
      const int row = ok && remap != nullptr ? __ldg(rm + cr.pix[c]) : cr.pix[c];
      r.row[c] = ok ? row : -1;
    }
    r.t0 = cr.t0;
    r.t1 = cr.t1;
    r.p = o.p;
    r.pad = 0.f;
    return r;
  }
};

// A source (PointSource above, WindowedSource in msgs_windowed.cu)
// supplies its point Operands and dead(); load(point);
// per-item Info with info(q) and shfl(info, lane); and resolve(operands,
// b, info), which turns one point into its PointRec.
//
// Phase A for pass kp: PointRec of point kp * kPass + kk of every item
// m of the warp, at recs[kk * ng + m]. Operands first, then every
// dependent load of the lane's points, then the shared-memory writes.
// `info` is the Src's per-item data of the lane's own item; slot items
// take it from the lanes of their group.
template <typename Src>
__device__ __forceinline__ void resolve_pass(const Src& src, int b, int64_t item0,
                                             unsigned first, const Shape& sh, int kp, int ng,
                                             int group_shift, const typename Src::Info& info,
                                             PointRec* recs, int lane) {
  typename Src::Operands op[kSlotsPerLane];
#pragma unroll
  for (int s = 0; s < kSlotsPerLane; ++s) {
    const int j = lane + kWarp * s;
    const int m = j / kPass;
    const int k = kp * kPass + j % kPass;
    const bool live = m < ng && first + m < sh.per_batch && k < sh.K;
    op[s] = live ? src.load((item0 + m) * sh.K + k) : Src::dead();
  }
  PointRec rec[kSlotsPerLane];
#pragma unroll
  for (int s = 0; s < kSlotsPerLane; ++s) {
    if (kWarp * s >= ng * kPass) break;            // no point of the warp left: uniform
    const int m = (lane + kWarp * s) / kPass;
    const typename Src::Info im = Src::shfl(info, m < ng ? m << group_shift : 0);
    rec[s] = src.resolve(op[s], b, im);
  }
#pragma unroll
  for (int s = 0; s < kSlotsPerLane; ++s) {
    const int j = lane + kWarp * s;
    const int m = j / kPass;
    if (m < ng) recs[(j % kPass) * ng + m] = rec[s];
  }
}

// The engine. Batch b = b0 + blockIdx.y; warp w of block bx serves the
// batch's items [(bx * kWarps + w) * ng, + ng) of its (Nq, H) item axis,
// ng = 32 >> group_shift. `scale` (B, H, Dh) f32 multiplies the sum (int8
// tables) or is null.
template <typename T, typename O, int VEC, typename Src>
__device__ __forceinline__ void gather_items(const Src& src, const T* __restrict__ v,
                                             const float* __restrict__ scale,
                                             O* __restrict__ out, const Shape sh, int b0,
                                             const Plan plan, PointRec* recs) {
  constexpr int kCh = VEC / static_cast<int>(sizeof(T));   // channels per vector
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int ng = kWarp >> plan.group_shift;
  const unsigned first = (blockIdx.x * kWarps + warp) * ng;
  if (first >= sh.per_batch) return;               // whole warp
  const int b = b0 + static_cast<int>(blockIdx.y);
  const int64_t item0 = static_cast<int64_t>(b) * sh.per_batch + first;
  PointRec* wrec = recs + warp * ng * kPass;
  const int g = lane >> plan.group_shift;
  const int i = lane & ((1 << plan.group_shift) - 1);
  const bool item_ok = first + g < sh.per_batch;
  const unsigned mine = item_ok ? first + g : first;
  const unsigned q = mine / static_cast<unsigned>(sh.H);
  const int h = static_cast<int>(mine - q * sh.H);
  const typename Src::Info info = src.info(static_cast<int>(q));
  const int H = sh.H;
  const int Dh = sh.Dh;
  const int row_bytes = sh.G * Dh * static_cast<int>(sizeof(T));   // below 2 GB: plan_ok
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(v) + row_base(sh, b, h) * sizeof(T);
  const int n_pass = (sh.K + kPass - 1) / kPass;
  for (int r = 0; r < plan.row_chunks; ++r) {
    const int chunk = i + (r << plan.group_shift);   // vector index within the row
    const bool act = item_ok && chunk < plan.lanes_per_row;
    float acc[kCh];
#pragma unroll
    for (int c = 0; c < kCh; ++c) acc[c] = 0.f;
    for (int kp = 0; kp < n_pass; ++kp) {
      if (r == 0 || n_pass > 1) {                  // one pass: resolved once
        __syncwarp();
        resolve_pass(src, b, item0, first, sh, kp, ng, plan.group_shift, info, wrec, lane);
        __syncwarp();
      }
      Raw<VEC> raw[kPass][4];
      float t0[kPass], t1[kPass], p[kPass];
#pragma unroll
      for (int kk = 0; kk < kPass; ++kk) {
        const PointRec rc = wrec[kk * ng + g];
        t0[kk] = rc.t0;
        t1[kk] = rc.t1;
        p[kk] = rc.p;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (act && rc.row[c] >= 0)
            load_raw<VEC>(vb + static_cast<int64_t>(rc.row[c]) * row_bytes + chunk * VEC,
                          raw[kk][c]);
          else
            zero_raw<VEC>(raw[kk][c]);
        }
      }
#pragma unroll
      for (int kk = 0; kk < kPass; ++kk) {         // k = 0, 1, ... in order
#pragma unroll
        for (int c = 0; c < kCh; ++c) {
          const float s = eq4<T>(Widen<T>::get(raw[kk][0].w, c), Widen<T>::get(raw[kk][1].w, c),
                                 Widen<T>::get(raw[kk][2].w, c), Widen<T>::get(raw[kk][3].w, c),
                                 t0[kk], t1[kk]);
          acc[c] = __fmaf_rn(p[kk], s, acc[c]);
        }
      }
    }
    if (act) {
      if (scale != nullptr) {
        float sc[kCh];
        load_floats<kCh>(scale + (static_cast<int64_t>(b) * H + h) * Dh + chunk * kCh, sc);
#pragma unroll
        for (int c = 0; c < kCh; ++c) acc[c] = __fmul_rn(acc[c], sc[c]);
      }
      store_chunk<kCh>(out + (item0 + g) * Dh + chunk * kCh, acc);
    }
  }
}

// Dynamic shared memory of one block: the warps' PointRecs.
inline size_t smem_bytes(int group_lanes) {
  return static_cast<size_t>(kWarps) * (kWarp / group_lanes) * kPass * sizeof(PointRec);
}

// Blocks along x for one batch.
inline unsigned grid_blocks(int64_t per_batch, int group_lanes) {
  const int64_t ng = kWarp / group_lanes;
  const int64_t warps = (per_batch + ng - 1) / ng;
  return static_cast<unsigned>((warps + kWarps - 1) / kWarps);
}

constexpr int kMaxGridY = 65535;

// Checks the host plan against the row: a vector width that divides the
// head's row, the row group's stride G * Dh and the table pointer (so every
// row of every head starts on a vector), lanes_per_row vectors per row, a
// power-of-two group of at most 32 lanes and enough chunks to cover the
// row; G dividing H; and a batch of fewer than 2^31 items and a row group
// below 2 GB, which the engine counts in 31 bits.
inline bool plan_ok(int vec, int itemsize, int H, int G, int Dh, const void* v, int group_lanes,
                    int lanes_per_row, int row_chunks, int64_t per_batch) {
  const int row = Dh * itemsize;
  if (G < 1 || H % G != 0) return false;
  if (vec < itemsize || vec > 16 || (vec & (vec - 1)) != 0 || row % vec != 0) return false;
  if ((static_cast<int64_t>(G) * row) % vec != 0) return false;
  if (reinterpret_cast<uintptr_t>(v) % vec != 0) return false;
  if (lanes_per_row != row / vec) return false;
  if (group_lanes < 1 || group_lanes > kWarp || (group_lanes & (group_lanes - 1)) != 0)
    return false;
  if (per_batch + kWarps * kWarp >= (int64_t{1} << 31)) return false;
  if (static_cast<int64_t>(G) * row >= (int64_t{1} << 31)) return false;
  return row_chunks == (lanes_per_row + group_lanes - 1) / group_lanes;
}

inline int log2_int(int x) {
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

}  // namespace gather
}  // namespace repro_torch
