// K2: persistent-cache decode MSGS + aggregation for Hopper (sm_90a),
// forward.
//
// Replaces the TPU kernel _decode_pallas_call (src/repro/kernels/
// msgs_decode.py, body _make_decode_kernel), behind msgs_decode_pallas
// (one layer) and msgs_decode_layers_pallas (L stacked layers, one
// launch). It samples the once-staged table vp (B, H/G, N_rows, G*Dh):
// head h reads lane group h % G of row group h / G. An item is one
// (b, layer, q, h) of the stacked (B, L, Nq, H, K) points, so the stacked
// entry point is one launch too. Its backward is msgs_decode_bwd.cu.
//
// The TPU kernel keeps the staged table resident in VMEM across its
// (query-tile x layer) sweep. No explicit staging is needed here: the
// compact table of the 512 px path is 13.4 MB per image (26.7 MB for
// both) and stays in the H100's 50 MB L2 across the six decoder layers.
//
// What bounds it on the H100: a decoder layer at B = 2 (300 queries,
// 8 heads, K = 4 points, Dh = 32) moves about 1.7 MB (0.0005 ms at
// 3.35 TB/s), but its 4,800 items fill only 1,200 warps: the time is one
// warp's chain of dependent loads plus the launch. The first design (one
// warp per item, lane = channel, points walked one after another, each
// one's remap load and then its 4 row loads) measured 0.0094 ms, about
// 9 dependent round trips per warp.
//
// What the design does: it is the gather engine of msgs_gather.cuh with
// K1's PointSource, over the staged layout (the engine's table with
// G = head_pack): point operands -> remap -> all 16 corner rows of an
// item in flight, 3 round trips per warp, 4 items per warp at f32 Dh 32.
// Measured (PERF.md, section 6; NVIDIA H100 80GB HBM3, 700 W): 0.0037 ms
// on the 512 px path's first decoder call, 0.0059 ms on the 1024 px path's
// (int8 table). Eq. 4 and the sum over k are the engine's, so K2 and K1
// give bitwise equal outputs on the same points and rows.
#include "msgs_gather.cuh"

namespace repro_torch {

using DecodeSource = gather::PointSource<>;

template <typename T, typename O, int VEC>
__global__ void __launch_bounds__(kWarp * gather::kWarps, gather::kMinBlocks)
msgs_decode_kernel(const DecodeSource src, const T* __restrict__ vp,
                   const float* __restrict__ scale, O* __restrict__ out,
                   const gather::Shape sh, int b0, const gather::Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  gather::gather_items<T, O, VEC>(src, vp, scale, out, sh, b0, plan,
                                  reinterpret_cast<gather::PointRec*>(smem));
}

// One launch per kMaxGridY batches (grid y is the batch).
template <typename T, typename O, int VEC>
int launch(const DecodeSource& src, const void* vp, const float* scale, void* out, int B,
           const gather::Shape& sh, const gather::Plan& plan, int group_lanes,
           cudaStream_t s) {
  if constexpr (VEC < static_cast<int>(sizeof(T))) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    for (int b0 = 0; b0 < B; b0 += gather::kMaxGridY) {
      const dim3 grid(gather::grid_blocks(sh.per_batch, group_lanes),
                      static_cast<unsigned>(std::min(B - b0, gather::kMaxGridY)));
      msgs_decode_kernel<T, O, VEC><<<grid, kWarp * gather::kWarps,
                                      gather::smem_bytes(group_lanes), s>>>(
          src, static_cast<const T*>(vp), scale, static_cast<O*>(out), sh, b0, plan);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
  }
}

template <typename T, typename O>
int launch_vec(int vec, const DecodeSource& src, const void* vp, const float* scale, void* out,
               int B, const gather::Shape& sh, const gather::Plan& plan, int group_lanes,
               cudaStream_t s) {
  switch (vec) {
    case 16: return launch<T, O, 16>(src, vp, scale, out, B, sh, plan, group_lanes, s);
    case 8: return launch<T, O, 8>(src, vp, scale, out, B, sh, plan, group_lanes, s);
    case 4: return launch<T, O, 4>(src, vp, scale, out, B, sh, plan, group_lanes, s);
    case 2: return launch<T, O, 2>(src, vp, scale, out, B, sh, plan, group_lanes, s);
    case 1: return launch<T, O, 1>(src, vp, scale, out, B, sh, plan, group_lanes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace repro_torch

// table_dtype: 0 float32 (out float32), 1 bfloat16 (out bfloat16),
// 2 int8 codes with a (B, H/G, G*Dh) f32 scale (out float32). vec_bytes,
// group_lanes, lanes_per_row and row_chunks are the wrapper's
// gather_plan(); a plan that does not fit the row, the row group or the
// table pointer is refused. Returns cudaGetLastError() after the launch.
extern "C" int msgs_decode_forward(int table_dtype, const void* vp, const void* x,
                                   const void* y, const void* st, const void* wl,
                                   const void* hl, const void* probs,
                                   const void* remap, const void* scale, void* out,
                                   int B, int L, int Nq, int H, int K, int Dh, int G,
                                   long long n_rows, long long n_pix, int vec_bytes,
                                   int group_lanes, int lanes_per_row, int row_chunks,
                                   void* stream) {
  using namespace repro_torch;
  static const int kItemsize[3] = {4, 2, 1};
  const int64_t per_batch = static_cast<int64_t>(L) * Nq * H;
  if (table_dtype < 0 || table_dtype > 2 ||
      !gather::plan_ok(vec_bytes, kItemsize[table_dtype], H, G, Dh, vp, group_lanes,
                       lanes_per_row, row_chunks, per_batch))
    return static_cast<int>(cudaErrorInvalidValue);
  if (per_batch == 0 || B == 0) return 0;
  const DecodeSource src{static_cast<const float*>(x), static_cast<const float*>(y),
                         static_cast<const float*>(probs), static_cast<const int*>(st),
                         static_cast<const int*>(wl), static_cast<const int*>(hl),
                         static_cast<const int*>(remap), n_pix};
  const gather::Shape sh{static_cast<unsigned>(per_batch), H, K, Dh, G, n_rows};
  const gather::Plan plan{gather::log2_int(group_lanes), lanes_per_row, row_chunks};
  const auto* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (table_dtype) {
    case 0:
      return launch_vec<float, float>(vec_bytes, src, vp, sc, out, B, sh, plan, group_lanes, s);
    case 1:
      return launch_vec<__nv_bfloat16, __nv_bfloat16>(vec_bytes, src, vp, sc, out, B, sh, plan,
                                                      group_lanes, s);
    default:
      return launch_vec<int8_t, float>(vec_bytes, src, vp, sc, out, B, sh, plan, group_lanes, s);
  }
}
