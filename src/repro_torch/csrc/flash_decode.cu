// One-token GQA flash-decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel flash_decode_pallas (src/repro/kernels/
// flash_decode.py, body _kernel). For each sequence b and query head h it
// computes softmax(q_h . K / sqrt(Dh)) . V over a (B, W, Hkv, Dh) KV cache
// with a per-slot validity mask, and matches the TPU kernel's arithmetic:
//   * query head h reads KV head h / n_rep with n_rep = ceil(Hq / Hkv),
//     unless the caller hands a head table (below);
//   * a score is the dot product rounded to the input dtype, then widened
//     to float32 and scaled by 1/sqrt(Dh); invalid slots score -1e30;
//   * the online max and sum start at -1e30 and 0, P.V is summed in
//     float32, and the denominator is clamped at 1e-20;
//   * the TPU kernel pads W to a multiple of its chunk with invalid zero
//     slots. They change only a row with no valid slot, whose softmax
//     is then uniform over real and padded slots alike: sum V / (W + pad)
//     (argument `pad`).
//
// The head table. A model maps its query heads to KV heads in ways the TPU
// kernel's h / n_rep does not cover: padded query heads clamp to the last
// KV head, and a tensor-parallel rank's query heads may start inside a KV
// group and read KV heads from the middle of the cache row. So the kernel
// takes a table of entries (KV head g, first query head h0, count nh):
// query heads h0 .. h0 + nh - 1 all read KV head g, and every query head
// appears in exactly one entry. kernels/flash_decode.py builds it from the
// model's map, one entry per run of query heads on one KV head, a run cut
// at the width of the split pass that serves the call: kMmaRows = 16
// query heads on the tensor-core pass, kMaxRep = 4 on the CUDA-core pass.
// g indexes the heads STORED in the cache row: Hkv is the row's head count
// (its stride is Hkv * Dh), so a rank reads its block of a cache that
// holds more heads in place. The table travels by value in the launch's
// parameters (no device memory, so a CUDA graph holds it). The wrapper's
// default map, g = h / n_rep, is the TPU kernel's.
//
// Design: a split pass and a merge pass. The split pass runs a block per
// (b, table entry, split of W), the entries of one split next to each
// other in the grid, so that the blocks in flight together read whole
// cache rows (every KV head of the same slots) rather than one head's
// slice of each. kernels/flash_decode.py's decode_splits picks the split
// length (a multiple of 32, at most kMaxSplit) so that at least four
// blocks per SM run (at the LM's decode shape: 128 slots, 1,024 blocks).
// A block reads the K and V rows of its split's valid slots, each once
// for all the query heads of its entry. Two versions of the split pass:
//   * flash_decode_mma_kernel, bf16 with Dh % 32 == 0 (every served LM
//     call): an entry holds up to 16 query heads, the rows of one
//     mma.sync m16n8k16 tile, so one block reads a KV head once for a GQA
//     group of up to 16 (hymba-1.5b's 25 heads over 5 KV heads: 5
//     entries). A warp takes 16 slots per step through its own ring of
//     shared-memory stages, sized by Dh (MmaPlan). A split whose slots are
//     all valid (a block-wide vote over its mask says so: every split of a
//     full cache) streams its K and V rows as TMA tiles, each stage
//     completing on the warp's mbarrier; a split with holes compacts its
//     valid slots' indices (__ballot_sync / __popc per 32 mask bytes) and
//     gathers those rows with cp.async into the same swizzled layout. The
//     scores and P.V are tensor-core products, see the note at the kernel;
//   * flash_decode_split_kernel, float32 and the other bf16 shapes: it
//     compacts every split and gathers through a warp-private cp.async
//     ring; a row goes to a group of `lpr` lanes, each holding 16 bytes
//     (8 bf16 or 4 float32 channels; rows that 16-byte copies cannot
//     address are read element by element), kUnroll slots per step, dot
//     products reduced by warp shuffles. Its per-head registers keep its
//     entries at kMaxRep = 4 query heads.
// Each warp (or lane group) keeps its own online-softmax state per query
// head in registers (one rescale per step); the block merges them through
// shared memory into a partial (m, l, acc[Dh]) per (b, h, split), plus
// the split's valid-slot count. flash_decode_merge_kernel then merges each
// (b, h)'s splits: a block per (b, h, 32 channels) whose 16 warps each
// sum a fixed range of splits in split order, the warps' sums then added
// in warp order (no float atomics: the result does not depend on block
// timing). A separate launch rather than a last-block merge inside the
// split pass: that would need a standing counter per (b, entry) in device
// memory, shared by every call on every stream, for a launch the CUDA
// graphs of the decode steps already hide.
//
// The partial mode (out32 and lse given, out not): the merge writes each
// row's float32 output, not rounded to the input dtype, and its
// log-sum-exp lse = m + log(l) over the slots it saw, so that a caller
// holding the cache split over several ranks merges the ranks' rows
// itself (kernels/flash_decode.py merge_rank_partials): row r weighs
// exp(lse_r - max lse). A row with no valid slot then carries no weight:
// lse = -inf and a zero output, where the normal mode averages V.
//
// Why skipping invalid slots is exact: in a row with at least one valid
// slot, an invalid slot weighs exp(-1e30 - m) = 0 once m is finite, and
// whatever was summed before the first valid slot is wiped by the
// exp(m_old - m_new) = 0 factor. So dropping them changes only the float32
// summation order. The exception is a row with no valid slot at all,
// where the TPU kernel averages V over its W real slots and its padded
// zero slots; the merge sees a total count of 0 and computes exactly that,
// reading V itself. The served path never has such a row (the token's own
// slot is valid).
//
// What bounds it on the H100: memory. At minitron-4b's decode shape
// (B = 4, Hq = 24, Hkv = 8, Dh = 128, W = 4096, bf16) a full cache's K and
// V rows are 67.1 MB, 20 us at 3.35 TB/s; the served first decode call
// needs only its 981 valid slots' rows (4.0 MB, 1.2 us). A long_500k
// rank's call of hymba-1.5b's global layer, q (1, 25, 64) over K / V
// (1, 131,072, 5, 64), all valid, needs 167.8 MB: 50 us. The operations
// (4 per channel, query head and slot) are far below the rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "tma.cuh"

namespace repro_torch {

using tma::smem_u32;

constexpr int kWarp = 32;
constexpr int kWarps = 4;           // warps per split block
constexpr int kMaxRep = 4;          // query heads per entry on the CUDA-core pass
constexpr int kMmaRows = 16;        // query heads per entry on the tensor-core pass
constexpr int kMaxDh = 128;
constexpr int kMaxSplit = 512;      // slots per split, at most
constexpr int kUnroll = 4;          // slots a lane group loads before it computes
constexpr int kStages = 3;          // steps in a warp's cp.async ring (CUDA-core pass)
constexpr int kBlocksPerSm = 4;     // split blocks resident per SM (registers, smem)
constexpr int kMergeWarps = 16;
constexpr int kMaxMergeSplits = 1024;   // splits a call may have (the part buffer's bound)
constexpr int kMaxEntries = 512;    // head-table entries (2 KiB of launch parameters)
constexpr float kNeg = -1e30f;

// An entry packs (g << 16) | (h0 << 4) | (nh mod 16): g < 65536,
// h0 < 4096, 1 <= nh <= 16 (16 is stored as 0).
struct HeadTable {
  int n;
  uint32_t e[kMaxEntries];
};

__host__ __device__ __forceinline__ int entry_kv(uint32_t e) {
  return static_cast<int>(e >> 16);
}
__host__ __device__ __forceinline__ int entry_h0(uint32_t e) {
  return static_cast<int>((e >> 4) & 0xfffu);
}
__host__ __device__ __forceinline__ int entry_nh(uint32_t e) {
  return static_cast<int>(((e & 0xfu) + 15u) % 16u) + 1;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }

// a float32 sum rounded to the input dtype, as the TPU kernel's einsum
template <typename T> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) { return x; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// VEC channels of one row from `p` (channel ch0 of the row) into r,
// element by element up to `left` channels; zeros when !in. The path for
// rows that 16-byte loads cannot address.
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float (&r)[VEC], bool in, int left) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) r[i] = (in && i < left) ? widen(p[i]) : 0.f;
}

// 16 bytes global -> shared without a register stop; zero-filled when !ok
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

template <typename T, int VEC>
__device__ __forceinline__ void unpack16(const uint4& raw, float (&r)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < VEC; ++i) r[i] = widen(e[i]);
}

// Where a split block sits: blockIdx.x is the (b, head-table entry),
// blockIdx.y the split; its heads are h0 .. h0 + nh - 1, all reading the
// stored KV head g; its slots are [w0, w_end).
struct SplitBlock {
  int b, entry, g, h0, nh, split, n_splits, w0, w_end;
};

__device__ __forceinline__ SplitBlock split_block(const HeadTable& table, int W, int split_len) {
  SplitBlock p;
  p.entry = blockIdx.x % table.n;
  p.b = blockIdx.x / table.n;
  const uint32_t e = table.e[p.entry];
  p.g = entry_kv(e);
  p.h0 = entry_h0(e);
  p.nh = entry_nh(e);
  p.split = blockIdx.y;
  p.n_splits = gridDim.y;
  p.w0 = p.split * split_len;
  p.w_end = min(W, p.w0 + split_len);
  return p;
}

// The indices of the split's valid slots, in slot order, into `slots`
// (__ballot_sync / __popc over 32 mask bytes at a time); returns their
// count. Block-wide: every thread calls it, and sees `slots` on return.
__device__ __forceinline__ int compact_split(const uint8_t* ok_b, const SplitBlock& p,
                                             int* slots) {
  __shared__ uint32_t ballots[kMaxSplit / kWarp];
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int n_chunks = (p.w_end - p.w0 + kWarp - 1) / kWarp;
  for (int c = warp; c < n_chunks; c += n_warps) {
    const int w = p.w0 + c * kWarp + lane;
    const uint32_t bal = __ballot_sync(0xffffffffu, w < p.w_end && ok_b[w] != 0);
    if (lane == 0) ballots[c] = bal;
  }
  __syncthreads();
  int n_valid = 0;
  for (int c = 0; c < n_chunks; ++c) n_valid += __popc(ballots[c]);
  for (int c = warp; c < n_chunks; c += n_warps) {
    int base = 0;
    for (int c2 = 0; c2 < c; ++c2) base += __popc(ballots[c2]);
    const uint32_t bal = ballots[c];
    if ((bal >> lane) & 1u)
      slots[base + __popc(bal & ((1u << lane) - 1u))] = p.w0 + c * kWarp + lane;
  }
  __syncthreads();
  return n_valid;
}

// The block's partial (m, l, acc[Dh]) for each of its heads, merged from
// `groups` online-softmax states in shared memory: head r, state i has
// its max at sm_m[r * m_stride + i], its sum at sm_l[...], and channel ch
// at sm_acc[r * acc_r + i * acc_i + ch].
__device__ __forceinline__ void write_partials(const SplitBlock& p, const float* sm_m,
                                               const float* sm_l, int m_stride, int groups,
                                               const float* sm_acc, int acc_r, int acc_i,
                                               int Hq, int Dh, float* part) {
  for (int e = threadIdx.x; e < p.nh * Dh; e += blockDim.x) {
    const int r = e / Dh;
    const int ch = e % Dh;
    float mx = kNeg;
    for (int i = 0; i < groups; ++i) mx = fmaxf(mx, sm_m[r * m_stride + i]);
    float den = 0.f, num = 0.f;
    for (int i = 0; i < groups; ++i) {
      const float c = expf(sm_m[r * m_stride + i] - mx);
      den += sm_l[r * m_stride + i] * c;
      num += sm_acc[r * acc_r + i * acc_i + ch] * c;
    }
    float* dst = part + ((static_cast<int64_t>(p.b) * Hq + p.h0 + r) * p.n_splits + p.split) *
                            (Dh + 2);
    if (ch == 0) {
      dst[0] = mx;
      dst[1] = den;
    }
    dst[2 + ch] = num;
  }
}

// Dynamic shared memory of one split block: the warps' cp.async rings on
// the 16-byte-load path (kStages steps of kUnroll slots, K and V, 16 bytes
// per lane), which the lane groups' accumulators reuse after the loop.
template <typename T, int VEC, bool kVecLoad>
constexpr int split_smem_bytes() {
  return kVecLoad && kWarps * kStages * kUnroll * 2 * kWarp * 16 >
                         kMaxRep * kWarps * kWarp * VEC * 4
             ? kWarps * kStages * kUnroll * 2 * kWarp * 16
             : kMaxRep * kWarps * kWarp * VEC * 4;
}

template <typename T, int VEC, bool kVecLoad>
__global__ void __launch_bounds__(kWarp * kWarps, kBlocksPerSm)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const uint8_t* __restrict__ valid,
                          float* __restrict__ part, int* __restrict__ counts, int Hq, int Hkv,
                          int Dh, int W, int split_len, int lpr, float scale,
                          const HeadTable table) {
  __shared__ int slots[kMaxSplit];
  __shared__ float sm_m[kMaxRep][kWarps * kWarp];
  __shared__ float sm_l[kMaxRep][kWarps * kWarp];
  extern __shared__ uint4 dyn[];
  // the accumulators after the loop: [kMaxRep][kWarps * kWarp * VEC]
  float* sm_acc = reinterpret_cast<float*>(dyn);

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const SplitBlock pos = split_block(table, W, split_len);
  const int b = pos.b, g = pos.g, h0 = pos.h0, nh = pos.nh;

  // lane groups of lpr lanes, one slot each; lane lig holds channels
  // ch0 .. ch0 + VEC - 1. q is loaded first: its latency overlaps the
  // compaction.
  const int lig = lane % lpr;
  const int spw = kWarp / lpr;
  const int gsub = lane / lpr;
  const int groups = kWarps * spw;
  const int gid = warp * spw + gsub;
  const int ch0 = lig * VEC;
  const bool ch_in = ch0 < Dh;

  float qr[kMaxRep][VEC];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int ch = ch0 + i;
      qr[r][i] = (r < nh && ch < Dh)
                     ? widen(q[(static_cast<int64_t>(b) * Hq + h0 + r) * Dh + ch]) : 0.f;
    }

  const int n_valid = compact_split(valid + static_cast<int64_t>(b) * W, pos, slots);
  if (pos.entry == 0 && threadIdx.x == 0)
    counts[static_cast<int64_t>(b) * pos.n_splits + pos.split] = n_valid;

  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][VEC];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = kNeg;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < VEC; ++i) acc[r][i] = 0.f;
  }

  // One step: kUnroll slots per lane group (slot u of group gsub in this
  // warp's step `base` is compacted index base + gsub + u * groups); one
  // max over them per head, so the online softmax rescales once per step.
  // Every lane of the warp runs every step: the shuffles need all 32.
  // load_k(u, r) / load_v(u, r) fetch slot u's channels of this lane.
  auto consume = [&](auto&& load_k, auto&& load_v, const bool (&have)[kUnroll]) {
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= nh) break;                    // block-uniform
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float kr[VEC];
        load_k(u, kr);
        s[u] = 0.f;
#pragma unroll
        for (int i = 0; i < VEC; ++i) s[u] += qr[r][i] * kr[i];
      }
      for (int off = lpr / 2; off > 0; off /= 2) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
      }
      float m_new = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = round_to<T>(s[u]) * scale;
        if (have[u]) m_new = fmaxf(m_new, s[u]);
      }
      const float corr = expf(m[r] - m_new);
      l[r] *= corr;
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[r][i] *= corr;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float pw = have[u] ? expf(s[u] - m_new) : 0.f;
        float vr[VEC];
        load_v(u, vr);
        l[r] += pw;
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[r][i] += pw * vr[i];
      }
      m[r] = m_new;
    }
  };

  const int64_t row = static_cast<int64_t>(Hkv) * Dh;
  const T* kb = k + static_cast<int64_t>(b) * W * row + static_cast<int64_t>(g) * Dh + ch0;
  const T* vb = v + static_cast<int64_t>(b) * W * row + static_cast<int64_t>(g) * Dh + ch0;
  const int step_slots = groups * kUnroll;
  const int first = warp * spw;              // this warp's first compacted index
  const int n_steps = n_valid > first ? (n_valid - first + step_slots - 1) / step_slots : 0;
  if constexpr (kVecLoad) {
    // a warp-private ring of kStages steps: each lane copies its own 16
    // bytes of K and V per slot and reads back only those, so the lane's
    // own cp.async.wait_group is the only synchronisation needed
    uint4* ring = dyn + warp * kStages * kUnroll * 2 * kWarp;
    auto issue = [&](int step) {
      uint4* st = ring + (step % kStages) * kUnroll * 2 * kWarp;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = first + step * step_slots + gsub + u * groups;
        const bool ok = p < n_valid && ch_in;
        const int64_t w = ok ? slots[p] : 0;
        cp_async16(st + (2 * u) * kWarp + lane, kb + w * row, ok);
        cp_async16(st + (2 * u + 1) * kWarp + lane, vb + w * row, ok);
      }
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_steps) issue(i);
      cp_async_commit();                     // empty groups keep the count
    }
    for (int step = 0; step < n_steps; ++step) {
      if (step + kStages - 1 < n_steps) issue(step + kStages - 1);
      cp_async_commit();
      cp_async_wait<kStages - 1>();          // this step's copies have landed
      const uint4* st = ring + (step % kStages) * kUnroll * 2 * kWarp;
      bool have[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        have[u] = first + step * step_slots + gsub + u * groups < n_valid;
      consume([&](int u, float (&r)[VEC]) { unpack16<T, VEC>(st[(2 * u) * kWarp + lane], r); },
              [&](int u, float (&r)[VEC]) { unpack16<T, VEC>(st[(2 * u + 1) * kWarp + lane], r); },
              have);
    }
    cp_async_wait<0>();
  } else {
    for (int step = 0; step < n_steps; ++step) {
      float kr[kUnroll][VEC], vr[kUnroll][VEC];
      bool have[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = first + step * step_slots + gsub + u * groups;
        have[u] = p < n_valid;
        const int64_t w = have[u] ? slots[p] : 0;
        load_row<T, VEC>(kb + w * row, kr[u], have[u] && ch_in, Dh - ch0);
        load_row<T, VEC>(vb + w * row, vr[u], have[u] && ch_in, Dh - ch0);
      }
      consume([&](int u, float (&r)[VEC]) {
#pragma unroll
                for (int i = 0; i < VEC; ++i) r[i] = kr[u][i];
              },
              [&](int u, float (&r)[VEC]) {
#pragma unroll
                for (int i = 0; i < VEC; ++i) r[i] = vr[u][i];
              },
              have);
    }
  }

  // merge the lane groups' states into the block's partial for each head
  // (sm_acc reuses the rings: every warp is past its loop first)
  __syncthreads();
  const int width = lpr * VEC;               // >= Dh
  const int acc_row = kWarps * kWarp * VEC;
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (lig == 0) {
      sm_m[r][gid] = m[r];
      sm_l[r][gid] = l[r];
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) sm_acc[r * acc_row + gid * width + ch0 + i] = acc[r][i];
  }
  __syncthreads();
  write_partials(pos, &sm_m[0][0], &sm_l[0][0], kWarps * kWarp, groups, sm_acc, acc_row, width,
                 Hq, Dh, part);
}

// Sum (or max) over the block's threads, in a fixed order: the result
// does not depend on timing. Every thread gets it.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float x, float* scratch) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off /= 2) {
    const float y = __shfl_xor_sync(0xffffffffu, x, off);
    x = kMax ? fmaxf(x, y) : x + y;
  }
  __syncthreads();                           // scratch is free again
  if (threadIdx.x % kWarp == 0) scratch[threadIdx.x / kWarp] = x;
  __syncthreads();
  x = scratch[0];
  for (int w = 1; w < kMergeWarps; ++w) x = kMax ? fmaxf(x, scratch[w]) : x + scratch[w];
  return x;
}

// A block per (b, h) and 32 channels (blockIdx.y), a lane per channel: the
// splits' partials merged; a row with no valid slot at all is the TPU
// kernel's uniform average over its W real and `pad` padded slots. First a
// thread per split: the counts' sum and the maxima's max over the block,
// each split's weight exp(m_s - max) into shared memory and the weighted
// sums l_s of the denominator reduced over the block. Then warp w sums its
// fixed range of splits' channels in split order, loads that depend on
// nothing before them, and the warps' sums are added in warp order. With
// out32 (the partial mode) the row goes to out32 in float32 and its
// log-sum-exp to lse; a row with no valid slot gets a zero output and
// lse = -inf.
template <typename T>
__global__ void __launch_bounds__(kWarp * kMergeWarps)
flash_decode_merge_kernel(const float* __restrict__ part, const int* __restrict__ counts,
                          const T* __restrict__ v, T* __restrict__ out, float* __restrict__ out32,
                          float* __restrict__ lse, int Hq, int Hkv, int Dh, int W, int n_splits,
                          int pad, const HeadTable table) {
  __shared__ float scratch[kMergeWarps];
  __shared__ float weight[kMaxMergeSplits];
  __shared__ float sm_num[kMergeWarps][kWarp];
  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int h = bh % Hq;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int ch = blockIdx.y * kWarp + lane;
  const bool ch_in = ch < Dh;
  const int row = Dh + 2;
  const float* src = part + static_cast<int64_t>(bh) * n_splits * row;
  float total = 0.f, mx = kNeg;
  for (int s = threadIdx.x; s < n_splits; s += blockDim.x) {
    total += static_cast<float>(counts[static_cast<int64_t>(b) * n_splits + s]);
    mx = fmaxf(mx, src[s * row]);
  }
  total = block_reduce<false>(total, scratch);
  mx = block_reduce<true>(mx, scratch);
  if (total == 0.f && out32 != nullptr) {   // no weight in a merge of partials
    if (warp == 0 && ch_in) out32[static_cast<int64_t>(bh) * Dh + ch] = 0.f;
    if (blockIdx.y == 0 && threadIdx.x == 0) lse[bh] = __int_as_float(0xff800000);   // -inf
    return;
  }
  if (total == 0.f) {
    int g = 0;                               // the KV head of h's entry
    for (int i = 0; i < table.n; ++i) {
      const uint32_t e = table.e[i];
      if (h >= entry_h0(e) && h < entry_h0(e) + entry_nh(e)) g = entry_kv(e);
    }
    float sum = 0.f;
    if (ch_in) {
#pragma unroll 4
      for (int w = warp; w < W; w += kMergeWarps)
        sum += widen(v[((static_cast<int64_t>(b) * W + w) * Hkv + g) * Dh + ch]);
    }
    sm_num[warp][lane] = sum;
    __syncthreads();
    if (warp == 0 && ch_in) {
      float t = 0.f;
      for (int i = 0; i < kMergeWarps; ++i) t += sm_num[i][lane];
      store(out + static_cast<int64_t>(bh) * Dh + ch,
            t / fmaxf(static_cast<float>(W + pad), 1e-20f));
    }
    return;
  }
  float den = 0.f;
  for (int s = threadIdx.x; s < n_splits; s += blockDim.x) {
    const float c = expf(src[s * row] - mx);
    weight[s] = c;
    den += src[s * row + 1] * c;
  }
  den = block_reduce<false>(den, scratch);   // its barriers also publish `weight`
  const int per = (n_splits + kMergeWarps - 1) / kMergeWarps;
  const int s_end = min(n_splits, (warp + 1) * per);
  float num = 0.f;
  if (ch_in) {
    const float* acc = src + 2 + ch;
#pragma unroll 8
    for (int s = warp * per; s < s_end; ++s) num += acc[static_cast<int64_t>(s) * row] * weight[s];
  }
  sm_num[warp][lane] = num;
  __syncthreads();
  if (warp != 0 || !ch_in) return;
  num = 0.f;
  for (int i = 0; i < kMergeWarps; ++i) num += sm_num[i][lane];
  const float o = num / fmaxf(den, 1e-20f);
  if (out32 != nullptr) {
    out32[static_cast<int64_t>(bh) * Dh + ch] = o;
    if (blockIdx.y == 0 && lane == 0) lse[bh] = mx + logf(den);
  } else {
    store(out + static_cast<int64_t>(bh) * Dh + ch, o);
  }
}

// ---------------------------------------------------------------------------
// bf16 with Dh % 32 == 0: the split pass on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kMmaSlots = 16;            // slots per warp step: P.V's k16 depth
constexpr int kRingBytes = 64 * 1024;    // a block's staging ring, at most: 3 blocks per SM

// The tensor-core pass's shared memory at head dim kDh. A warp step stages
// 16 K rows and 16 V rows, each as kBoxes TMA boxes of kBoxCh channels
// (16 rows x at most 128 bytes, the swizzle's span), box after box. Rows
// lie as TMA's 128-byte swizzle (64-byte for 32-channel boxes) lays them
// out: the 16-byte chunk c of row r at c ^ (r % 8) (c ^ (r / 2 % 4)), so
// that ldmatrix reads 8 rows at one channel offset from 8 bank groups. The
// cp.async gather writes the same layout. A warp's ring holds kStages
// steps: as many as the block's kRingBytes hold, 2 to 4 (4 at Dh 64, 2 at
// Dh 128). After the loop the ring holds the warps' accumulators.
template <int kDh>
struct MmaPlan {
  static constexpr int kBoxCh = kDh % 64 == 0 ? 64 : 32;
  static constexpr int kBoxes = kDh / kBoxCh;
  static constexpr int kBoxBytes = kMmaSlots * kBoxCh * 2;
  static constexpr int kTile = kBoxes * kBoxBytes;      // one step's K (or V) rows
  static constexpr int kStage = 2 * kTile;
  static constexpr int kFit = kRingBytes / (kWarps * kStage);
  static constexpr int kStages = kFit >= 4 ? 4 : (kFit >= 3 ? 3 : 2);
  static constexpr int kSmem = kWarps * kStages * kStage + 1024;   // + alignment slack
  static_assert(kMmaRows * kWarps * kDh * 4 <= kWarps * kStages * kStage,
                "the accumulators must fit in the ring");

  // byte offset of channel ch (a multiple of 8) of row r in a tile
  static __device__ __forceinline__ int offset(int r, int ch) {
    const int off = (ch / kBoxCh) * kBoxBytes + r * (kBoxCh * 2) + (ch % kBoxCh) * 2;
    return off ^ ((off >> 3) & (kBoxCh == 64 ? 0x70 : 0x30));
  }
};

// c (16 x 8, f32) += a (16 x 16, bf16, row-major) . b (16 x 8, bf16, col-major)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&two);
}

// (x0, x1) as a bf16 pair `hi` and the pair of what hi leaves, `lo`
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&hi);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// The split pass for bf16 rows whose Dh is a multiple of 32, with
// mma.sync m16n8k16 (bf16 in, f32 sums). A block takes one entry's up to
// 16 query heads as the rows of the A tile: a lane's fragment rows are
// gr = lane / 4 and gr + 8, the second only in the kTwoRows instance
// (entries wider than 8). Per warp a step of kMmaSlots consecutive slots
// (all-valid split) or compacted slots (a split with holes), staged as
// MmaPlan says, then:
//   * scores = q (16 rows, zero past nh) . K^T, the K fragments by
//     ldmatrix. Each k16 product starts from zero and the partial sums are
//     added in f32 on the CUDA cores: the tensor cores' own f32
//     accumulation truncates, and a score that lands on the other side of
//     a bf16 rounding boundary than the plain version's moves the output
//     by far more than its rounding step. Each score is then rounded to
//     bf16 and scaled, as in the CUDA-core pass;
//   * the online softmax per head row (a row's 16 scores sit in the four
//     lanes of one lane quad);
//   * P . V with P split into bf16 hi + lo parts (two products), so that
//     P keeps about 16 significant bits where one bf16 would keep 8; the
//     V fragments by ldmatrix.trans; the sums stay in f32.
template <int kDh, bool kTwoRows>
__global__ void __launch_bounds__(kWarp * kWarps, 3)
flash_decode_mma_kernel(const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ valid,
                        float* __restrict__ part, int* __restrict__ counts, int Hq, int Hkv,
                        int W, int split_len, float scale, const HeadTable table) {
  using P = MmaPlan<kDh>;
  constexpr int kRowSets = kTwoRows ? 2 : 1;
  __shared__ int slots[kMaxSplit];
  __shared__ float sm_m[kMmaRows][kWarps];
  __shared__ float sm_l[kMmaRows][kWarps];
  __shared__ uint64_t full[kWarps][P::kStages];   // a warp's TMA stages
  extern __shared__ uint8_t mma_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(mma_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  // the accumulators after the loop: [kMmaRows][kWarps][kDh]
  float* sm_acc = reinterpret_cast<float*>(smem);

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const SplitBlock pos = split_block(table, W, split_len);
  const int b = pos.b, g = pos.g, h0 = pos.h0, nh = pos.nh;
  const int gr = lane / 4;                   // fragment rows gr and gr + 8: query heads
  const int tq = lane % 4;                   // thread in the quad

  if (lane == 0) {
    for (int s = 0; s < P::kStages; ++s) tma::mbar_init(&full[warp][s], 1);
    tma::fence_barrier_init();
  }

  // q as the A fragments of the score product, in register order: row gr
  // channels 16 kk + 2 tq (+1), row gr + 8 the same, then both at + 8
  uint32_t qa[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    qa[kk][0] = qa[kk][1] = qa[kk][2] = qa[kk][3] = 0u;
#pragma unroll
    for (int rs = 0; rs < kRowSets; ++rs) {
      const int r = gr + 8 * rs;
      if (r < nh) {
        const __nv_bfloat16* qr = q + (static_cast<int64_t>(b) * Hq + h0 + r) * kDh + 16 * kk;
        qa[kk][rs] = *reinterpret_cast<const uint32_t*>(qr + 2 * tq);
        qa[kk][2 + rs] = *reinterpret_cast<const uint32_t*>(qr + 8 + 2 * tq);
      }
    }
  }

  // a split whose slots are all valid streams whole tiles; one with holes
  // compacts its valid slots first (the vote also publishes the barriers)
  const uint8_t* ok_b = valid + static_cast<int64_t>(b) * W;
  bool all = true;
  for (int w = pos.w0 + threadIdx.x; w < pos.w_end; w += blockDim.x) all = all && ok_b[w] != 0;
  const bool dense = __syncthreads_and(all);
  const int n_valid = dense ? pos.w_end - pos.w0 : compact_split(ok_b, pos, slots);
  if (pos.entry == 0 && threadIdx.x == 0)
    counts[static_cast<int64_t>(b) * pos.n_splits + pos.split] = n_valid;

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};   // rows gr, gr + 8; l is this lane's share
  float acc[kDh / 8][4];                     // O fragments: row gr (0, 1), row gr + 8 (2, 3)
#pragma unroll
  for (int nt = 0; nt < kDh / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  const int64_t row = static_cast<int64_t>(Hkv) * kDh;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(b) * W * row + static_cast<int64_t>(g) * kDh;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(b) * W * row + static_cast<int64_t>(g) * kDh;
  uint8_t* ring = smem + warp * P::kStages * P::kStage;
  const int n_steps_all = (n_valid + kMmaSlots - 1) / kMmaSlots;
  const int n_steps = n_steps_all > warp ? (n_steps_all - warp + kWarps - 1) / kWarps : 0;
  // step i of this warp covers (compacted) slots (warp + i kWarps) kMmaSlots + 0..15 of the
  // split; the gather commits a cp.async group per step, empty past the last
  auto issue = [&](int i) {
    uint8_t* st = ring + (i % P::kStages) * P::kStage;
    const int p0 = (warp + i * kWarps) * kMmaSlots;
    if (dense) {
      if (i < n_steps && lane == 0) {
        uint64_t* bar = &full[warp][i % P::kStages];
        tma::mbar_expect_tx(bar, P::kStage);
#pragma unroll
        for (int bx = 0; bx < P::kBoxes; ++bx) {
          const int c0 = g * kDh + bx * P::kBoxCh;
          tma::load_3d(st + bx * P::kBoxBytes, &k_map, bar, c0, pos.w0 + p0, b);
          tma::load_3d(st + P::kTile + bx * P::kBoxBytes, &v_map, bar, c0, pos.w0 + p0, b);
        }
      }
      return;
    }
    if (i < n_steps) {
      for (int e = lane; e < kMmaSlots * (kDh / 8); e += kWarp) {
        const int r = e / (kDh / 8), c = e % (kDh / 8);
        const bool ok = p0 + r < n_valid;
        const int64_t w = ok ? slots[p0 + r] : 0;
        const int off = P::offset(r, 8 * c);
        cp_async16(st + off, kb + w * row + 8 * c, ok);
        cp_async16(st + P::kTile + off, vb + w * row + 8 * c, ok);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < P::kStages; ++i) issue(i);
  for (int i = 0; i < n_steps; ++i) {
    if (dense)
      tma::mbar_wait(&full[warp][i % P::kStages], (i / P::kStages) & 1);
    else
      cp_async_wait<P::kStages - 1>();       // this lane's copies of step i are in
    __syncwarp();                            // and every lane's
    const uint8_t* ks = ring + (i % P::kStages) * P::kStage;
    const uint8_t* vs = ks + P::kTile;
    const int p0 = (warp + i * kWarps) * kMmaSlots;

    // scores: two n-tiles of 8 slots; ldmatrix x4 gives two k16 steps
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int pp = 0; pp < kDh / 32; ++pp) {
        uint32_t bf[4];
        ldmatrix_x4(bf, ks + P::offset(8 * j + lane % 8, 8 * (4 * pp + lane / 8)));
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(t0, qa[2 * pp], bf[0], bf[1]);
        mma_bf16(t1, qa[2 * pp + 1], bf[2], bf[3]);
#pragma unroll
        for (int e = 0; e < 2 * kRowSets; ++e) sc[j][e] += t0[e] + t1[e];
      }
    }
    // the online softmax of rows gr (+ 8) over this step's 16 slots (slot
    // 8 j + 2 tq + e of row gr + 8 rs sits in sc[j][2 rs + e])
    float p[2][4], corr[2];
#pragma unroll
    for (int rs = 0; rs < kRowSets; ++rs) {
      float s[4];
      bool have[4];
      float mx = m[rs];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * (e / 2) + 2 * tq + e % 2;
        have[e] = p0 + col < n_valid;
        s[e] = round_to<__nv_bfloat16>(sc[e / 2][2 * rs + e % 2]) * scale;
        if (have[e]) mx = fmaxf(mx, s[e]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      corr[rs] = expf(m[rs] - mx);
      l[rs] *= corr[rs];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[rs][e] = have[e] ? expf(s[e] - mx) : 0.f;
        l[rs] += p[rs][e];
      }
      m[rs] = mx;
    }
#pragma unroll
    for (int nt = 0; nt < kDh / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2 * kRowSets; ++e) acc[nt][e] *= corr[e / 2];
    // P (rows gr, gr + 8; 16 slots) as A fragments, hi and lo bf16 parts
    uint32_t hi[4] = {0u, 0u, 0u, 0u}, lo[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int rs = 0; rs < kRowSets; ++rs) {
      split_bf16(p[rs][0], p[rs][1], hi[rs], lo[rs]);
      split_bf16(p[rs][2], p[rs][3], hi[2 + rs], lo[2 + rs]);
    }
    // P . V: ldmatrix.trans x4 gives the k16 fragments of two n-tiles
#pragma unroll
    for (int qq = 0; qq < kDh / 16; ++qq) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, vs + P::offset(lane % 8 + 8 * ((lane / 8) % 2), 8 * (2 * qq + lane / 16)));
      mma_bf16(acc[2 * qq], hi, bf[0], bf[1]);
      mma_bf16(acc[2 * qq], lo, bf[0], bf[1]);
      mma_bf16(acc[2 * qq + 1], hi, bf[2], bf[3]);
      mma_bf16(acc[2 * qq + 1], lo, bf[2], bf[3]);
    }
    __syncwarp();                            // the stage is read before it is refilled
    issue(i + P::kStages);
  }
  cp_async_wait<0>();

  // merge the warps' states: l over the quad first
#pragma unroll
  for (int rs = 0; rs < kRowSets; ++rs) {
    l[rs] += __shfl_xor_sync(0xffffffffu, l[rs], 1);
    l[rs] += __shfl_xor_sync(0xffffffffu, l[rs], 2);
  }
  __syncthreads();                           // sm_acc reuses the rings
#pragma unroll
  for (int rs = 0; rs < kRowSets; ++rs) {
    const int r = gr + 8 * rs;
    if (r < nh) {
      if (tq == 0) {
        sm_m[r][warp] = m[rs];
        sm_l[r][warp] = l[rs];
      }
#pragma unroll
      for (int nt = 0; nt < kDh / 8; ++nt) {
        float* dst = sm_acc + (r * kWarps + warp) * kDh + 8 * nt + 2 * tq;
        dst[0] = acc[nt][2 * rs];
        dst[1] = acc[nt][2 * rs + 1];
      }
    }
  }
  __syncthreads();
  write_partials(pos, &sm_m[0][0], &sm_l[0][0], kWarps, kWarps, sm_acc, kWarps * kDh, kDh, Hq,
                 kDh, part);
}

// Where the merge writes: `out` (the input dtype), or in the partial
// mode `out32` and `lse` (float32; out is null).
struct MergeOut {
  void* out;
  float* out32;
  float* lse;
};

template <typename T>
int launch_merge(const float* part, const int* counts, const void* v, const MergeOut& o, int B,
                 int Hq, int Hkv, int Dh, int W, int n_splits, int pad, const HeadTable& table,
                 cudaStream_t s) {
  const dim3 grid(B * Hq, (Dh + kWarp - 1) / kWarp);
  flash_decode_merge_kernel<T><<<grid, kWarp * kMergeWarps, 0, s>>>(
      part, counts, static_cast<const T*>(v), static_cast<T*>(o.out), o.out32, o.lse, Hq, Hkv, Dh,
      W, n_splits, pad, table);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC, bool kVecLoad>
int launch(const void* q, const void* k, const void* v, const uint8_t* ok, const MergeOut& out,
           float* part, int* counts, int B, int Hq, int Hkv, int Dh, int W, int pad,
           int split_len, int lpr, float scale, const HeadTable& table, cudaStream_t s) {
  const int n_splits = (W + split_len - 1) / split_len;
  constexpr int smem = split_smem_bytes<T, VEC, kVecLoad>();
  cudaError_t e = cudaFuncSetAttribute(flash_decode_split_kernel<T, VEC, kVecLoad>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * table.n, n_splits);
  flash_decode_split_kernel<T, VEC, kVecLoad><<<grid, kWarp * kWarps, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), ok, part,
      counts, Hq, Hkv, Dh, W, split_len, lpr, scale, table);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_merge<T>(part, counts, v, out, B, Hq, Hkv, Dh, W, n_splits, pad, table, s);
}

// The tensor-core pass at head dim kDh: both passes of one call, the
// split pass's instance by its widest entry.
template <int kDh>
int launch_mma(const CUtensorMap& km, const CUtensorMap& vm, const void* q, const void* k,
               const void* v, const uint8_t* ok, const MergeOut& out, float* part, int* counts,
               int B, int Hq, int Hkv, int W, int pad, int split_len, float scale,
               const HeadTable& table, bool two_rows, cudaStream_t s) {
  const int n_splits = (W + split_len - 1) / split_len;
  auto* kernel = two_rows ? flash_decode_mma_kernel<kDh, true> : flash_decode_mma_kernel<kDh, false>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       MmaPlan<kDh>::kSmem);
  if (e == cudaSuccess)                      // room for 3 blocks: its copies bypass L1
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * table.n, n_splits);
  kernel<<<grid, kWarp * kWarps, MmaPlan<kDh>::kSmem, s>>>(
      km, vm, static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ok, part, counts, Hq, Hkv, W, split_len, scale, table);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return launch_merge<__nv_bfloat16>(part, counts, v, out, B, Hq, Hkv, kDh, W, n_splits, pad,
                                     table, s);
}

// The K or V cache (B, W, Hkv, Dh) bf16 as a 3-D tensor map (channels of a
// row, slots, sequences) with a box of MmaPlan's box channels x 16 slots:
// slots past W read as zero.
bool cache_map(CUtensorMap* map, const void* base, int B, int W, int Hkv, int Dh) {
  const int box_ch = Dh % 64 == 0 ? 64 : 32;
  const cuuint64_t row = static_cast<cuuint64_t>(Hkv) * Dh;
  const cuuint64_t dims[3] = {row, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {row * 2, row * 2 * W};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_ch), kMmaSlots, 1};
  return tma::encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box,
                     box_ch == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B);
}

int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

}  // namespace repro_torch

// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike); valid is one byte
// per slot (torch.bool). out (B, Hq, Dh) of the input dtype; or, in the
// partial mode, out null and out32 (B, Hq, Dh) and lse (B, Hq) float32
// (see the note on the partial mode). Hkv is the number of KV heads the
// cache row stores. table: n_entries packed head-table entries in host
// memory (see the note at HeadTable; kernels/flash_decode.py's
// head_table), each at most 16 query heads on the tensor-core pass (bf16,
// Dh % 32 == 0, K and V 16-byte aligned) and 4 on the CUDA-core pass.
// pad = the TPU kernel's padded slots, (-W) mod min(chunk, W); split_len a
// multiple of 32, at most 512. part: float32 scratch (B, Hq, ceil(W /
// split_len), Dh + 2); counts: int32 scratch (B, ceil(W / split_len)).
// Returns cudaErrorInvalidValue for a table that does not cover each query
// head once with valid KV heads and entries the pass takes, or for a
// tensor map that cannot be encoded, else the first non-zero
// cudaGetLastError() of the two launches.
extern "C" int flash_decode_forward(int dtype, const void* q, const void* k, const void* v,
                                    const void* valid, void* out, void* out32, void* lse,
                                    void* part, void* counts,
                                    int B, int Hq, int Hkv, int Dh, int W, int pad,
                                    int split_len, float scale, const void* table,
                                    int n_entries, void* stream) {
  using namespace repro_torch;
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (Dh < 1 || Dh > kMaxDh || Hkv < 1 || Hq < 1 || Hq >= 4096 || Hkv > 65535 ||
      split_len < kWarp || split_len > kMaxSplit || split_len % kWarp != 0 ||
      (W + split_len - 1) / split_len > kMaxMergeSplits)
    return bad;
  if (table == nullptr || n_entries < 1 || n_entries > kMaxEntries) return bad;
  if ((out == nullptr) == (out32 == nullptr) || (out32 == nullptr) != (lse == nullptr))
    return bad;                              // one mode or the other
  const int elem = dtype == 0 ? 4 : 2;
  const bool vec = (Dh * elem) % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16) == 0;
  const bool mma = dtype == 1 && vec && Dh % 32 == 0;
  const int max_rep = mma ? kMmaRows : kMaxRep;
  const MergeOut mo{out, static_cast<float*>(out32), static_cast<float*>(lse)};
  HeadTable ht;
  ht.n = n_entries;
  const auto* src = static_cast<const uint32_t*>(table);
  int covered = 0, widest = 0;               // entries in query-head order, each head once
  for (int i = 0; i < n_entries; ++i) {
    const uint32_t e = src[i];
    const int nh = entry_nh(e);
    if (nh > max_rep || entry_kv(e) >= Hkv || entry_h0(e) != covered) return bad;
    covered += nh;
    widest = nh > widest ? nh : widest;
    ht.e[i] = e;
  }
  if (covered != Hq) return bad;
  if (static_cast<long long>(B) * ht.n > INT_MAX) return bad;
  if (B == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* ok = static_cast<const uint8_t*>(valid);
  auto* pt = static_cast<float*>(part);
  auto* ct = static_cast<int*>(counts);
  if (mma) {
    CUtensorMap km, vm;
    if (!cache_map(&km, k, B, W, Hkv, Dh) || !cache_map(&vm, v, B, W, Hkv, Dh)) return bad;
    const bool two = widest > 8;
    switch (Dh) {
      case 32:
        return launch_mma<32>(km, vm, q, k, v, ok, mo, pt, ct, B, Hq, Hkv, W, pad, split_len,
                              scale, ht, two, s);
      case 64:
        return launch_mma<64>(km, vm, q, k, v, ok, mo, pt, ct, B, Hq, Hkv, W, pad, split_len,
                              scale, ht, two, s);
      case 96:
        return launch_mma<96>(km, vm, q, k, v, ok, mo, pt, ct, B, Hq, Hkv, W, pad, split_len,
                              scale, ht, two, s);
      default:
        return launch_mma<128>(km, vm, q, k, v, ok, mo, pt, ct, B, Hq, Hkv, W, pad, split_len,
                               scale, ht, two, s);
    }
  }
  const int vec_ch = vec ? 16 / elem : 4;    // channels per lane
  const int lpr = pow2_at_least((Dh + vec_ch - 1) / vec_ch);
  switch (dtype * 2 + (vec ? 1 : 0)) {
    case 0:
      return launch<float, 4, false>(q, k, v, ok, mo, pt, ct, B, Hq, Hkv, Dh, W, pad, split_len,
                                     lpr, scale, ht, s);
    case 1:
      return launch<float, 4, true>(q, k, v, ok, mo, pt, ct, B, Hq, Hkv, Dh, W, pad, split_len,
                                    lpr, scale, ht, s);
    case 2:
      return launch<__nv_bfloat16, 4, false>(q, k, v, ok, mo, pt, ct, B, Hq, Hkv, Dh, W, pad,
                                             split_len, lpr, scale, ht, s);
    case 3:
      return launch<__nv_bfloat16, 8, true>(q, k, v, ok, mo, pt, ct, B, Hq, Hkv, Dh, W, pad,
                                            split_len, lpr, scale, ht, s);
    default:
      return bad;
  }
}
