// Single-query decode attention for Hopper (sm_90a): a contiguous KV
// cache (split-KV across blocks) and a paged one.
//
// Replaces two TPU kernels:
//   * `decode_attention` of src/repro/kernels/decode_attention.py (body
//     `_kernel`): one query per row over a (B,T,K,D) cache, keys at or
//     past lengths[b] masked -> `decode_fwd`;
//   * `paged_decode_attention` of src/repro/kernels/paged_decode_attention.py
//     (body `_kernel`): the same over a global page pool (P,ps,K,D) with
//     per-row block tables (B,n_max); table entries are clamped into
//     [0, P-1] and keys at or past lengths[b] are masked ->
//     `paged_decode_fwd`.
// Both: q (B,H,D), H % K == 0, optional tanh softcap applied before the
// mask, f32 running max / sum / accumulator, a row with no key gives 0.
// Both also take a sliding window, which the TPU kernels lack (the
// reference masks a local layer's decode outside them, with plain ops):
// with window > 0 a row of length n sees keys [max(0, n - window), n),
// the reference's mask kp > qp - window at qp = n - 1, and no key or
// page below that span is read.
//
// What bounds them here: each call reads every live key and value once.
// internvl2-1b's solo decode (B=1, K=2, D=64, ~300 keys, f32) moves
// 0.3 MB (0.09 us at 3.35 TB/s); zamba2-7b's (B=1, K=32, D=112, ~400
// keys) 11.5 MB (3.4 us); internvl2-1b's paged tick (4 rows of ~270
// keys) 0.7 MB (0.2 us).  The FLOPs (2*H*D per key and side) are
// smaller still.  So bytes bound them, and at these sizes the latency of
// a few dependent memory round trips and of the launch sets the time;
// what a kernel can do is put every SM to work on the bytes at once.
//
// `decode_fwd`: split-KV (flash-decoding).  A one-block-per-(kv-head,
// row) grid runs 2 blocks at internvl2-1b (B=1, K=2) and 32 at zamba2-7b,
// each walking ~300-400 keys; so the grid is (n_split, K, B * ceil(G/8))
// and each block takes its share of [0, lengths[b]) on the device
// (`split_lo`), reading lengths itself: no split range comes from the
// host and nothing syncs with it.  n_split is chosen on the host from
// static shapes and the SM count (kernels.ops.decode_splits).  In a
// block of 8 warps each warp serves one q-head of the GQA group; when
// G < 8 the warps of one q-head split the block's keys (at G = 1 all 8
// do), and their states merge through shared memory.  Inside a warp
// each quad of 4 lanes takes one key: a lane reads a quarter of the
// key's row in 16-byte loads (8-byte for bf16), forms four independent
// partial dot products, and the quad sums them with two shuffles; each
// quad keeps its own running (m, l, acc) and the 8 quads merge by
// shuffles at the end.  Each block writes its partial (m, l, acc[D]) per
// q-head to an f32 workspace slot (b, h, split) that the wrapper
// allocates.  The merge is done by the last block of each (row, kv-head,
// head group) to finish (an atomic ticket after a __threadfence), not by
// a second kernel: the call is launch-bound, and a second launch would
// add its own launch latency and host enqueue time to every decode step.
// The ticket counters reset themselves, so one zeroed buffer per device
// serves every call on a stream.  The last block issues its reads of the
// splits' accumulators before it turns their (m, l) into weights, so the
// merge costs one round trip to L2 (on an H100 it took 4.3 of 9.0 us at
// internvl2-1b's shape with the reads in turn, 2.8 of 7.6 us so).  The
// log-sum-exp merge gives a split or row with no live key weight 0, so a
// row of length 0 gives 0.  Under a window the splits share the live span
// [start, n), not [0, n): n_split comes from min(T, window) keys
// (kernels.ops.decode_splits), so at T >> window no split idles.
//
// Head dims 128 and 256 (llama3-8b, gemma2-9b): a quad's lane would hold
// a quarter of the row, 32 and 64 floats each of q-sized k, v and acc,
// past the 128 registers that two blocks an SM allow.  So there 8 lanes
// share a key (LK = 8, three shuffles for the dot product, 4 keys a warp
// at once instead of 8), and each lane holds 16 (D = 128, two keys in
// flight) or 32 (D = 256, one) floats of each.  D <= 112 keeps its quads.
// ptxas (sm_90a, CUDA 12.8): 128 registers at D = 128 and 256, no spill.
// gemma2-9b's solo step over a 4,112-slot cache reads 67 MB (4,096 live
// keys under the window, K = 8): 0.020 ms at 3.35 TB/s, 0.033 ms
// measured on an H100 (chip_smoke.py phase 2).
//
// `paged_decode_fwd`: the same split-KV blocks over a page pool.  One
// block per (kv-head, row, head group), the first design, ran 8 blocks on
// 132 SMs at internvl2-1b's tick (4 rows, K = 2, G = 7), each walking
// ~260-300 keys in turn: latency-bound on one SM's round trips.  Now the grid is decode_fwd's, (n_split, K, B * ceil(G/8)),
// with n_split from static shapes (kernels.ops.decode_splits over the
// table's span n_max * ps: 32 splits, 256 blocks at that tick), so no
// length is read on the host and the launch can be captured in a graph.
// Each block takes its share of [0, min(lengths[b], n_max * ps)); a key's
// page comes from the row's table entry (clamped into [0, P-1]) when the
// lanes fetch it, so no page past a row's length is read and no table
// entry past its pages is looked at.  Same workspace, tickets and
// last-block merge as decode_fwd.
//
// Its tile mode (paged_decode_fwd<T, D, true>, C entry
// paged_decode_attention_tile_fwd): under a mesh the pool is sharded as
// the reference lays it out, pages over the data axes and each page's
// slots over "model" (layers/attention.py::paged_decode_attention_
// shardmap), so a rank holds a tile (P, ps_loc, K, D): pages [p0, p0 +
// P) and slots [s0, s0 + ps_loc) of a pool of n_pages pages of ps.  The
// block walks the tile's candidates u of a row, key t = (u / ps_loc) ps
// + s0 + u % ps_loc, between the candidates below the row's live span's
// ends (tile_candidates: the identity for the whole pool), so the splits
// share the rank's keys, not the pool's; a key's page is tested against
// the tile before its address is formed (tables hold the pool's ids),
// and a key the rank does not hold is masked like one past the length.
// The last block's merge also writes each q-head's log-sum-exp (-inf,
// and o = 0, where the rank holds no live key of the row), which the
// ranks combine with a max and two sums.  The whole-pool launch stays the
// <T, D, false> instance, as before the tile mode.  ptxas (sm_90a, CUDA
// 12.8): at most 128 registers, no spill; the tile's address carries
// K * D and kh * D precomputed and no D, without which <bf16, 256, true>
// spilled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int NW = 8;  // warps per block = q-heads served per block

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Contiguous cache: key t of row b, kv-head kh starts at this element.
struct ContigAddr {
  static constexpr bool kMasks = false;
  int b, Tk, K, kh, D;
  __device__ int64_t operator()(int t) const {
    return ((int64_t)(b * Tk + t) * K + kh) * D;
  }
};

// Paged cache: key t lives in page tables[b, t / ps] (clamped), slot t % ps.
struct PagedAddr {
  static constexpr bool kMasks = false;
  const int* table;  // this row's block-table entries
  int P, ps, K, kh, D;
  __device__ int64_t operator()(int t) const {
    int page = table[t / ps];
    page = min(max(page, 0), P - 1);
    return ((int64_t)page * ps + t % ps) * K * D + (int64_t)kh * D;
  }
};

// A rank's tile of a page pool: pages [p0, p0 + P) of the pool's
// n_pages, slots [s0, s0 + ps_loc) of each page of ps, held as (P,
// ps_loc, K, D).  The block walks candidate u of the row's n_max *
// ps_loc, key t = (u / ps_loc) * ps + s0 + u % ps_loc of the row; its
// page tables[b, u / ps_loc] (a global id, clamped into [0, n_pages - 1])
// is tested against the tile before any address is formed: -1 where the
// rank holds no such page.
template <int D>
struct TileAddr {
  static constexpr bool kMasks = true;
  const int* table;  // this row's block-table entries
  int last, p0, P, ps_loc, KD, head;  // n_pages - 1, ..., K * D, kh * D
  __device__ int64_t operator()(int u) const {
    const int j = u / ps_loc;
    const int page = min(max(table[j], 0), last) - p0;
    if ((unsigned)page >= (unsigned)P) return -1;
    return ((int64_t)page * ps_loc + (u - j * ps_loc)) * KD + head;
  }
};

// The candidates of a tile below key x of a row: whole pages' ps_loc
// each, and the tile's slots of x's page below x's slot.  Monotone in x;
// the identity for the whole pool (s0 = 0, ps_loc = ps).
__device__ __forceinline__ int tile_candidates(int x, int ps, int s0,
                                               int ps_loc) {
  const int j = x / ps;
  return j * ps_loc + min(max(x - j * ps - s0, 0), ps_loc);
}

// ---------------------------------------------------------------------------
// Split-KV (flash-decoding) across blocks, over either cache.
// ---------------------------------------------------------------------------

constexpr int MAX_SPLITS = 256;  // = kernels.ops.DECODE_MAX_SPLITS
constexpr int MERGE_LOADS = 16;  // merge loads a thread keeps in flight

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

// Split i of n_split takes keys [split_lo(i), split_lo(i + 1)) of [0, n)
// of the row's live span (kernels.ops.split_range is the same rule on
// the host).
__device__ __forceinline__ int split_lo(int n, int n_split, int i) {
  return (int)((int64_t)n * i / n_split);
}

// exp(m - m_new), and 0 for a state that has seen no key
__device__ __forceinline__ float rescale(float m, float m_new) {
  return m > NEG_INF / 2 ? expf(m - m_new) : 0.f;
}

// How a warp's lanes share the keys at head dim D: LK lanes a key, each
// holding NC float4 chunks of its row (lane ql of a group holds chunks
// ql + LK c); a warp takes KPW = 32 / LK keys at once, U times over with
// every load in flight before any is used: two keys a group at D <= 64
// and D = 128, one at D = 112 and 256 (the register cap of two blocks an
// SM).
template <int D>
struct KeyLanes {
  static constexpr int LK = D >= 128 ? 8 : 4;
  static constexpr int NC = D / (4 * LK);
  static constexpr int KPW = 32 / LK;
  static constexpr int U = NC <= 4 ? 2 : 1;
  static_assert(NC * 4 * LK == D, "head dim splits over the key's lanes");
};

// One block: keys of split `split` of the live span [start, start +
// n_keys) of row b, kv-head kh, for q-heads [h_base, h_base + NW) of the
// group; then, if it is the last block of its (row, kv-head, head group)
// to finish, the merge of every split, which also writes each q-head's
// log-sum-exp to `lse` (B, H) where it is not null (-inf for a row with
// no key).  `addr(t)` gives the element offset of key t; where
// Addr::kMasks, a negative offset marks a key the block does not hold.
template <typename T, int D, class Addr>
__device__ void split_block(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, T* __restrict__ o,
                            float* __restrict__ lse,
                            float* __restrict__ ws, int* counter, int B,
                            int b, int H, int G, int kh, int h_base,
                            int start, int n_keys, int split, int n_split,
                            float scale, float softcap, const Addr& addr) {
  using KL = KeyLanes<D>;
  constexpr int LK = KL::LK, NC = KL::NC, KPW = KL::KPW, U = KL::U;
  __shared__ float4 sm_q[NW][D / 4];
  __shared__ float sm_acc[NW][D];
  __shared__ float sm_m[NW], sm_l[NW];
  __shared__ float sm_w[NW][MAX_SPLITS];  // merge: per q-head and split,
  __shared__ float sm_lw[NW][MAX_SPLITS]; // the max, then the weight; l
  __shared__ float4 sm_part[NW * 32];     // merge: partial sums
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LK, ql = lane % LK;
  const int HG = min(G - h_base, NW);   // q-heads in this block
  const int slices = max(1, NW / HG);   // warps per q-head
  const int g = warp / slices, slice = warp % slices;
  const bool busy = g < HG;             // warp-uniform
  const int64_t row0 = (int64_t)b * H + kh * G + h_base;  // (b, h) of g=0

  // this block's keys, then this warp's slice of them
  const int lo = start + split_lo(n_keys, n_split, split);
  const int hi = start + split_lo(n_keys, n_split, split + 1);
  const int w_lo = lo + (int)((int64_t)(hi - lo) * slice / slices);
  const int w_hi = lo + (int)((int64_t)(hi - lo) * (slice + 1) / slices);

  // the group's keys t0 + grp + KPW u: every load issued before any is used
  float4 kr[U][NC], vr[U][NC];
  bool live[U];
  auto fetch = [&](int t0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + grp + KPW * u;
      bool ok = t < w_hi;
      int64_t off = ok ? addr(t) : 0;
      if constexpr (Addr::kMasks) {
        ok = ok && off >= 0;
        off = ok ? off : 0;
      }
      live[u] = ok;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int e = 4 * (ql + LK * c);
        kr[u][c] = ok ? load4(k + off + e) : make_float4(0.f, 0.f, 0.f, 0.f);
        vr[u][c] = ok ? load4(v + off + e) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  };
  if (busy && w_lo < w_hi) fetch(w_lo);  // in flight while q is staged
  for (int i = tid; i < HG * (D / 4); i += blockDim.x) {
    const int gg = i / (D / 4), c = i - gg * (D / 4);
    sm_q[gg][c] = load4(q + (row0 + gg) * D + 4 * c);
  }
  __syncthreads();

  // each group walks its own keys with a running (m, l, acc); its lanes
  // hold the same m and l and 1/LK of the D columns
  float m = NEG_INF, l = 0.f;
  float4 acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (busy) {
    for (int t0 = w_lo; t0 < w_hi; t0 += KPW * U) {  // warp-uniform trips
      if (t0 > w_lo) fetch(t0);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // four independent partial sums, then the group's LK lanes
        float px = 0.f, py = 0.f, pz = 0.f, pw = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 qv = sm_q[g][ql + LK * c];
          px = fmaf(qv.x, kr[u][c].x, px);
          py = fmaf(qv.y, kr[u][c].y, py);
          pz = fmaf(qv.z, kr[u][c].z, pz);
          pw = fmaf(qv.w, kr[u][c].w, pw);
        }
        float dot = (px + py) + (pz + pw);
#pragma unroll
        for (int o2 = 1; o2 < LK; o2 <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o2);
        if (live[u]) {
          float x = dot * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          const float m_new = fmaxf(m, x);
          const float alpha = rescale(m, m_new);
          const float p = expf(x - m_new);
          l = l * alpha + p;
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            acc[c].x = fmaf(p, vr[u][c].x, acc[c].x * alpha);
            acc[c].y = fmaf(p, vr[u][c].y, acc[c].y * alpha);
            acc[c].z = fmaf(p, vr[u][c].z, acc[c].z * alpha);
            acc[c].w = fmaf(p, vr[u][c].w, acc[c].w * alpha);
          }
          m = m_new;
        }
      }
    }
  }
  // merge the warp's KPW groups (every group ends with the merged state)
#pragma unroll
  for (int off = LK; off < 32; off <<= 1) {
    const float mo = __shfl_xor_sync(0xffffffffu, m, off);
    const float lo_ = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, mo);
    const float a = rescale(m, m_new), ao = rescale(mo, m_new);
    l = l * a + lo_ * ao;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      acc[c].x = acc[c].x * a + __shfl_xor_sync(0xffffffffu, acc[c].x, off) * ao;
      acc[c].y = acc[c].y * a + __shfl_xor_sync(0xffffffffu, acc[c].y, off) * ao;
      acc[c].z = acc[c].z * a + __shfl_xor_sync(0xffffffffu, acc[c].z, off) * ao;
      acc[c].w = acc[c].w * a + __shfl_xor_sync(0xffffffffu, acc[c].w, off) * ao;
    }
    m = m_new;
  }
  if (grp == 0) {
#pragma unroll
    for (int c = 0; c < NC; ++c)
      *reinterpret_cast<float4*>(&sm_acc[warp][4 * (ql + LK * c)]) = acc[c];
    if (ql == 0) {
      sm_m[warp] = m;
      sm_l[warp] = l;
    }
  }
  __syncthreads();

  // the block's partial (m, l, acc) per q-head: the warps of one q-head
  // merged, written to the workspace slot (b, h, split)
  const int64_t n_slots = (int64_t)B * H * n_split;
  float* ws_acc = ws;                 // [B*H][n_split][D]
  float* ws_ml = ws + n_slots * D;    // [B*H][n_split][2]
  for (int i = tid; i < HG * D; i += blockDim.x) {
    const int gg = i / D, d = i - gg * D;
    float mm = NEG_INF;
    for (int s = 0; s < slices; ++s) mm = fmaxf(mm, sm_m[gg * slices + s]);
    float ll = 0.f, aa = 0.f;
    for (int s = 0; s < slices; ++s) {
      const int w = gg * slices + s;
      const float a = rescale(sm_m[w], mm);
      ll += a * sm_l[w];
      aa += a * sm_acc[w][d];
    }
    const int64_t slot = (row0 + gg) * n_split + split;
    ws_acc[slot * D + d] = aa;
    if (d == 0) {
      ws_ml[2 * slot] = mm;
      ws_ml[2 * slot + 1] = ll;
    }
  }
  __threadfence();  // partials visible device-wide before the ticket
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(counter, 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // last block: log-sum-exp merge of the splits, read through L2.  The
  // HG * D/4 output float4s are taken W at a time: NP threads share one,
  // each over every NP-th split, when the block has threads to spare
  // (W = HG * D/4 <= blockDim.x, one pass: always at D <= 128); else one
  // thread an element, in passes (D = 256 with more than 4 q-heads a
  // block).  The first pass's first MERGE_LOADS accumulator loads are
  // issued before the weights, which do not depend on them, so both
  // reads share one round trip.
  constexpr int D4 = D / 4;
  constexpr bool PASSES = D4 > 32;  // HG * D4 can pass NW * 32 threads
  const int n_el = HG * D4;
  const int NP = max(1, (int)blockDim.x / n_el);
  const int W = PASSES && NP == 1 ? (int)blockDim.x : n_el;
  const int p = tid / W;
  float4 x[MERGE_LOADS];
  auto fetch_acc = [&](int base, int s0) {
    const int e = base + tid % W;
    const bool has_el = p < NP && e < n_el;
    const int gg = e / D4, d4 = e - gg * D4;
    const float4* src = reinterpret_cast<const float4*>(
        ws_acc + (row0 + gg) * n_split * D) + d4;
#pragma unroll
    for (int u = 0; u < MERGE_LOADS; ++u) {
      const int s = s0 + p + u * NP;
      x[u] = has_el && s < n_split ? __ldcg(src + s * D4)
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  fetch_acc(0, 0);
  // warp w turns q-head w's (m, l) per split into weights exp(m - max) / L
  // (0 for a split with no key, all 0 for a row with none)
  if (warp < HG) {
    const float2* ml = reinterpret_cast<const float2*>(ws_ml) +
                       (row0 + warp) * n_split;
    float mm = NEG_INF;
    for (int s = lane; s < n_split; s += 32) {
      const float2 y = __ldcg(ml + s);
      sm_w[warp][s] = y.x;
      sm_lw[warp][s] = y.y;
      mm = fmaxf(mm, y.x);
    }
    mm = warp_max(mm);
    float ll = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float a = rescale(sm_w[warp][s], mm);
      ll += a * sm_lw[warp][s];
      sm_w[warp][s] = a;
    }
    ll = warp_sum(ll);
    const float inv = ll > 0.f ? 1.f / ll : 0.f;
    for (int s = lane; s < n_split; s += 32) sm_w[warp][s] *= inv;
    if (lse != nullptr && lane == 0)
      lse[row0 + warp] = ll > 0.f ? mm + logf(ll)
                                   : __int_as_float(0xff800000);  // -inf
  }
  __syncthreads();
  auto merge_pass = [&](int base) {
    const int e = base + tid % W;
    const bool has_el = p < NP && e < n_el;
    const int gg = e / D4, d4 = e - gg * D4;
    if (base > 0) fetch_acc(base, 0);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0;;) {
#pragma unroll
      for (int u = 0; u < MERGE_LOADS; ++u) {
        const int s = s0 + p + u * NP;
        if (has_el && s < n_split) {
          const float w = sm_w[gg][s];
          a.x = fmaf(w, x[u].x, a.x);
          a.y = fmaf(w, x[u].y, a.y);
          a.z = fmaf(w, x[u].z, a.z);
          a.w = fmaf(w, x[u].w, a.w);
        }
      }
      s0 += MERGE_LOADS * NP;
      if (s0 >= n_split) break;
      fetch_acc(base, s0);
    }
    if (NP > 1) {
      if (has_el) sm_part[tid] = a;
      __syncthreads();
      if (tid < n_el) {
        for (int q2 = 1; q2 < NP; ++q2) {
          const float4 y = sm_part[q2 * n_el + tid];
          a.x += y.x;
          a.y += y.y;
          a.z += y.z;
          a.w += y.w;
        }
      }
    }
    if (tid < W && e < n_el) {
      T* out = o + (row0 + gg) * D + 4 * d4;
      store(out, a.x);
      store(out + 1, a.y);
      store(out + 2, a.z);
      store(out + 3, a.w);
    }
  };
  if constexpr (PASSES) {
    for (int base = 0; base < n_el; base += W) merge_pass(base);
  } else {
    merge_pass(0);
  }
  if (tid == 0) *counter = 0;  // ready for the next launch
}

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32, 2)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ lengths,
           T* __restrict__ o, float* __restrict__ ws, int* counters, int H,
           int K, int Tk, int n_split, int n_hg, int window, float scale,
           float softcap) {
  const int split = blockIdx.x, kh = blockIdx.y;
  const int b = blockIdx.z / n_hg, hg = blockIdx.z % n_hg;
  const int B = gridDim.z / n_hg;
  const int len = lengths[b];
  const int start = window > 0 ? max(len - window, 0) : 0;
  const int end = min(max(len, 0), Tk);
  split_block<T, D>(q, k, v, o, nullptr, ws, counters + blockIdx.z * K + kh,
                    B, b, H, H / K, kh, hg * NW, start, max(end - start, 0),
                    split, n_split, scale, softcap,
                    ContigAddr{b, Tk, K, kh, D});
}

// TILE: the pool is a rank's tile (TileAddr); the row's live keys
// [start, end) are walked as the tile's candidates between
// tile_candidates(start) and tile_candidates(end), which also reads lse.
// Without it (p0 = s0 = 0, P = n_pages, ps_loc = ps) the whole pool, as
// before the tile mode, and lse is null.
template <typename T, int D, bool TILE>
__global__ void __launch_bounds__(NW * 32, 2)
paged_decode_fwd(const T* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int* __restrict__ tables,
                 const int* __restrict__ lengths, T* __restrict__ o,
                 float* __restrict__ lse, float* __restrict__ ws,
                 int* counters, int H, int K, int n_pages, int p0, int P,
                 int ps, int s0, int ps_loc, int n_max, int n_split,
                 int n_hg, int window, float scale, float softcap) {
  const int split = blockIdx.x, kh = blockIdx.y;
  const int b = blockIdx.z / n_hg, hg = blockIdx.z % n_hg;
  const int B = gridDim.z / n_hg;
  const int len = lengths[b];
  const int start = window > 0 ? max(len - window, 0) : 0;
  const int end = min(max(len, 0), n_max * ps);
  const int* table = tables + (int64_t)b * n_max;
  int* counter = counters + blockIdx.z * K + kh;
  if constexpr (TILE) {
    const int lo = tile_candidates(start, ps, s0, ps_loc);
    const int hi = tile_candidates(max(end, start), ps, s0, ps_loc);
    split_block<T, D>(q, kp, vp, o, lse, ws, counter, B, b, H, H / K, kh,
                      hg * NW, lo, hi - lo, split, n_split, scale, softcap,
                      TileAddr<D>{table, n_pages - 1, p0, P, ps_loc, K * D,
                                  kh * D});
  } else {
    split_block<T, D>(q, kp, vp, o, nullptr, ws, counter, B, b, H, H / K,
                      kh, hg * NW, start, max(end - start, 0), split,
                      n_split, scale, softcap,
                      PagedAddr{table, n_pages, ps, K, kh, D});
  }
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* lengths, void* o, float* ws,
                          int* counters, int B, int H, int K, int Tk,
                          int n_split, int window, float softcap,
                          cudaStream_t stream) {
  const int n_hg = (H / K + NW - 1) / NW;
  const dim3 grid(n_split, K, B * n_hg);
  decode_fwd<T, D><<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), ws, counters, H,
      K, Tk, n_split, n_hg, window, 1.f / sqrtf((float)D), softcap);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp,
                         const int* tables, const int* lengths, void* o,
                         float* lse, float* ws, int* counters, int B, int H,
                         int K, int n_pages, int p0, int P, int ps, int s0,
                         int ps_loc, int n_max, int n_split, int window,
                         float softcap, cudaStream_t stream) {
  const int n_hg = (H / K + NW - 1) / NW;
  const dim3 grid(n_split, K, B * n_hg);
  const bool tile = lse != nullptr;
  auto kernel = tile ? paged_decode_fwd<T, D, true>
                     : paged_decode_fwd<T, D, false>;
  kernel<<<grid, NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), tables, lengths, static_cast<T*>(o), lse,
      ws, counters, H, K, n_pages, p0, P, ps, s0, ps_loc, n_max, n_split,
      n_hg, window, 1.f / sqrtf((float)D), softcap);
  return cudaGetLastError();
}

// The tile mode's launch at head dim D: out[0] threads a block, out[1]
// the blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor
// at that block, no dynamic shared memory), out[2] its static shared
// memory; what analysis/kernel_check.py's plan is held to.
template <typename T, int D>
int tile_info(int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, paged_decode_fwd<T, D, true>);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, paged_decode_fwd<T, D, true>, NW * 32, 0);
  if (e != cudaSuccess) return e;
  out[0] = NW * 32;
  out[1] = blocks;
  out[2] = (int)attr.sharedSizeBytes;
  return cudaSuccess;
}

// head dims: the smoke configs (16), internvl2-1b (64), zamba2-7b (112),
// llama3-8b (128), gemma2-9b (256)
#define DISPATCH_D(D_, FN, T_, ...)                        \
  switch (D_) {                                            \
    case 16: return FN<T_, 16>(__VA_ARGS__);               \
    case 64: return FN<T_, 64>(__VA_ARGS__);               \
    case 112: return FN<T_, 112>(__VA_ARGS__);             \
    case 128: return FN<T_, 128>(__VA_ARGS__);             \
    case 256: return FN<T_, 256>(__VA_ARGS__);             \
    default: return cudaErrorInvalidValue;                 \
  }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  ws: B*H*n_split*(D+2) floats of
// scratch; counters: B*ceil(H/K/8)*K ints, zero before the launch and
// left zero by it; window: 0 for none.  Returns the launch's cudaError_t.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, void* ws, void* counters, int B,
                                    int H, int K, int D, int T, int n_split,
                                    int window, int dtype, float softcap,
                                    void* stream) {
  if (B <= 0) return cudaSuccess;
  if (n_split < 1 || n_split > MAX_SPLITS || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (dtype == 0) {
    DISPATCH_D(D, launch_decode, float, q, k, v, len, o, w, cnt, B, H, K, T,
               n_split, window, softcap, s)
  }
  if (dtype == 1) {
    DISPATCH_D(D, launch_decode, __nv_bfloat16, q, k, v, len, o, w, cnt, B,
               H, K, T, n_split, window, softcap, s)
  }
  return cudaErrorInvalidValue;
}

// The paged twin: k/v pages (P, ps, K, D), tables (B, n_max) int32, the
// same workspace and counters as decode_attention_fwd.
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* kp, const void* vp, const void* tables,
    const void* lengths, void* o, void* ws, void* counters, int B, int H,
    int K, int D, int P, int ps, int n_max, int n_split, int window,
    int dtype, float softcap, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (n_split < 1 || n_split > MAX_SPLITS || P < 1 || ps < 1 || window < 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (dtype == 0) {
    DISPATCH_D(D, launch_paged, float, q, kp, vp, tbl, len, o, nullptr, w,
               cnt, B, H, K, P, 0, P, ps, 0, ps, n_max, n_split, window,
               softcap, s)
  }
  if (dtype == 1) {
    DISPATCH_D(D, launch_paged, __nv_bfloat16, q, kp, vp, tbl, len, o,
               nullptr, w, cnt, B, H, K, P, 0, P, ps, 0, ps, n_max, n_split,
               window, softcap, s)
  }
  return cudaErrorInvalidValue;
}

// The tile mode: k/v hold a rank's tile (P, ps_loc, K, D) of a pool of
// n_pages pages of ps slots, pages [p0, p0 + P) and slots [s0, s0 +
// ps_loc); tables hold the pool's page ids.  Writes the rank's
// normalised o (B, H, D) and its log-sum-exp lse (B, H) float32 (-inf,
// and o = 0, where the tile holds no live key of a row).
extern "C" int paged_decode_attention_tile_fwd(
    const void* q, const void* kp, const void* vp, const void* tables,
    const void* lengths, void* o, void* lse, void* ws, void* counters,
    int B, int H, int K, int D, int n_pages, int p0, int P, int ps, int s0,
    int ps_loc, int n_max, int n_split, int window, int dtype,
    float softcap, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (n_split < 1 || n_split > MAX_SPLITS || P < 1 || p0 < 0 ||
      p0 + P > n_pages || ps_loc < 1 || s0 < 0 || s0 + ps_loc > ps ||
      window < 0 || lse == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  float* l = static_cast<float*>(lse);
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (dtype == 0) {
    DISPATCH_D(D, launch_paged, float, q, kp, vp, tbl, len, o, l, w, cnt, B,
               H, K, n_pages, p0, P, ps, s0, ps_loc, n_max, n_split, window,
               softcap, s)
  }
  if (dtype == 1) {
    DISPATCH_D(D, launch_paged, __nv_bfloat16, q, kp, vp, tbl, len, o, l, w,
               cnt, B, H, K, n_pages, p0, P, ps, s0, ps_loc, n_max, n_split,
               window, softcap, s)
  }
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16; int[3] out (tile_info).
extern "C" int paged_decode_tile_info(int D, int dtype, void* out) {
  int* o = static_cast<int*>(out);
  if (dtype == 0) {
    DISPATCH_D(D, tile_info, float, o)
  }
  if (dtype == 1) {
    DISPATCH_D(D, tile_info, __nv_bfloat16, o)
  }
  return cudaErrorInvalidValue;
}
