// K1: fused MSGS (bilinear grid-sampling) + aggregation for Hopper (sm_90a).
//
// Replaces the TPU kernels msgs_fused_pallas and msgs_fused_packed_pallas
// (src/repro/kernels/msgs_fused.py, bodies _make_kernel and
// _make_kernel_packed, math _eq4_sample_agg). The packed form is a TPU
// lane layout (128 / Dh heads side by side in one 128-lane row); here
// both entry points are this one kernel over the (B, N_rows, H, Dh) table.
// The TPU kernel stages a head's whole table in VMEM; nothing is staged
// here: the compact f32 table of the 512 px path is 13.4 MB per image, so
// both images' tables stay in the 50 MB L2.
//
// What bounds it on the H100: the gather, not HBM. An encoder block of
// the 512 px detector at B = 2 (21,760 raster queries, 8 heads, K = 4
// PAP-kept points, Dh = 32, f32) moves about 100 MB of unique bytes
// (0.030 ms at 3.35 TB/s) but gathers 348,160 items x 16 corner rows of
// 128 B (626 MB of L2 sectors for the in-level corners).
//
// The design is the gather engine of msgs_gather.cuh (shared with K3, so
// both sum each point's terms in the same order): per point, x, y, the
// probability and the level's flat start, width and height; the optional
// remap sends pruned pixels to the zero sentinel row. f32 Dh 32: 8 lanes
// per 128 B row, 4 items per warp, all 16 corner rows of an item in
// flight at once.
#include "msgs_gather.cuh"

namespace repro_torch {

struct FusedSource {
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

  static __device__ Operands dead() { return {0.f, 0.f, 0.f, 0, 1, 1}; }
  static __device__ Info shfl(const Info&, int) { return {}; }
  __device__ Info info(int) const { return {}; }

  __device__ Operands load(int64_t pt) const {
    return {gather::load_once(x + pt), gather::load_once(y + pt), gather::load_once(p + pt),
            gather::load_once(st + pt), gather::load_once(wl + pt), gather::load_once(hl + pt)};
  }

  // Branch-free: a pruned point (p 0) or a corner outside the level
  // loads nothing.
  __device__ gather::PointRec resolve(const Operands& o, int b, const Info&) const {
    const gather::Corners cr = gather::corners(o.x, o.y, o.st, o.wl, o.hl);
    const int* rm = remap + b * n_pix;
    gather::PointRec r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool ok = o.p != 0.f && cr.in[c];
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

template <typename T, typename O, int VEC>
__global__ void __launch_bounds__(kWarp * gather::kWarps, gather::kMinBlocks)
msgs_fused_kernel(const FusedSource src, const T* __restrict__ v,
                  const float* __restrict__ scale, O* __restrict__ out,
                  const gather::Shape sh, int b0, const gather::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  gather::gather_items<T, O, VEC>(src, v, scale, out, sh, b0, plan,
                                  reinterpret_cast<gather::PointRec*>(smem));
}

// One launch per kMaxGridY batches (grid y is the batch).
template <typename T, typename O, int VEC>
int launch(const FusedSource& src, const void* v, const float* scale, void* out, int B,
           const gather::Shape& sh, const gather::Plan& plan, int group_lanes,
           cudaStream_t s) {
  if constexpr (VEC < static_cast<int>(sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    for (int b0 = 0; b0 < B; b0 += gather::kMaxGridY) {
      const dim3 grid(gather::grid_blocks(sh.per_batch, group_lanes),
                      static_cast<unsigned>(std::min(B - b0, gather::kMaxGridY)));
      msgs_fused_kernel<T, O, VEC><<<grid, kWarp * gather::kWarps,
                                     gather::smem_bytes(group_lanes), s>>>(
          src, static_cast<const T*>(v), scale, static_cast<O*>(out), sh, b0, plan);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  }
}

template <typename T, typename O>
int launch_vec(int vec, const FusedSource& src, const void* v, const float* scale, void* out,
               int B, const gather::Shape& sh, const gather::Plan& plan, int group_lanes,
               cudaStream_t s) {
  switch (vec) {
    case 16: return launch<T, O, 16>(src, v, scale, out, B, sh, plan, group_lanes, s);
    case 8: return launch<T, O, 8>(src, v, scale, out, B, sh, plan, group_lanes, s);
    case 4: return launch<T, O, 4>(src, v, scale, out, B, sh, plan, group_lanes, s);
    case 2: return launch<T, O, 2>(src, v, scale, out, B, sh, plan, group_lanes, s);
    case 1: return launch<T, O, 1>(src, v, scale, out, B, sh, plan, group_lanes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro_torch

// table_dtype: 0 float32 (out float32), 1 bfloat16 (out bfloat16),
// 2 int8 codes with a (B, 1, H, Dh) f32 scale (out float32). vec_bytes,
// group_lanes, lanes_per_row and row_chunks are the wrapper's
// gather_plan(); a plan that does not fit the row or the table pointer is
// refused. Returns cudaGetLastError() after the launch.
extern "C" int msgs_fused_forward(int table_dtype, const void* v, const void* x,
                                  const void* y, const void* st, const void* wl,
                                  const void* hl, const void* probs,
                                  const void* remap, const void* scale, void* out,
                                  int B, int Nq, int H, int K, int Dh,
                                  long long n_rows, long long n_pix, int vec_bytes,
                                  int group_lanes, int lanes_per_row, int row_chunks,
                                  void* stream) {
  using namespace repro_torch;
  static const int kItemsize[3] = {4, 2, 1};
  const int64_t per_batch = static_cast<int64_t>(Nq) * H;
  if (table_dtype < 0 || table_dtype > 2 ||
      !gather::plan_ok(vec_bytes, kItemsize[table_dtype], H, Dh, v, group_lanes,
                       lanes_per_row, row_chunks, per_batch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (per_batch == 0 || B == 0) return 0;
  const FusedSource src{static_cast<const float*>(x), static_cast<const float*>(y),
                        static_cast<const float*>(probs), static_cast<const int*>(st),
                        static_cast<const int*>(wl), static_cast<const int*>(hl),
                        static_cast<const int*>(remap), n_pix};
  const gather::Shape sh{static_cast<unsigned>(per_batch), H, K, Dh, n_rows};
  const gather::Plan plan{gather::log2_int(group_lanes), lanes_per_row, row_chunks};
  const auto* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_dtype) {
    case 0:
      return launch_vec<float, float>(vec_bytes, src, v, sc, out, B, sh, plan, group_lanes, s);
    case 1:
      return launch_vec<__nv_bfloat16, __nv_bfloat16>(vec_bytes, src, v, sc, out, B, sh, plan,
                                                      group_lanes, s);
    default:
      return launch_vec<int8_t, float>(vec_bytes, src, v, sc, out, B, sh, plan, group_lanes, s);
  }
}
