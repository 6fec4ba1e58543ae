// Absorbed Multi-head Latent Attention decode over a paged latent pool,
// for Hopper (sm_90a), float32.
//
// Replaces no TPU kernel: the JAX package computes MLA as plain products
// (src/repro/layers/mla.py) and has no paged layout for it.  The port
// pages MLA's latent cache (models/api.py, layers/mla.py::
// mla_decode_paged) and decodes it in the absorbed form, which no other
// kernel computes: 128 query heads share one key per token, ckv (512
// wide, normed) || k_rope (64 wide), and one value, ckv itself.  For a
// row b of length n and a head h with latent query q_lat (512) and rotary
// query q_pe (64):
//
//   s_t = scale * (q_lat . ckv_t + q_pe . kr_t)     t < n
//   o   = sum_t softmax(s)_t ckv_t                   (512 wide)
//
// with key t on page tables[b][t / ps] (clamped into [0, P - 1]) at slot
// t % ps; a row with no key gives 0.  W_uk (into q_lat), W_uv and W_o
// (after o) are plain products outside the kernel.
//
// What bounds it: a key is 2,304 bytes (576 floats) and serves every
// head of its row, 2 * 128 * (576 + 512) = 278,528 FLOPs: 121 FLOPs a
// byte, above the H100's 20 float32 FLOPs a byte of HBM.  So the FMA
// units bound it (exact float32, no tensor cores), and what the design
// has to spend around the FMAs is shared-memory bandwidth, issue slots
// and waits.
//
// Grid (n_split, ceil(H / 32), B), 256 threads, one block an SM (225 KiB
// of shared memory, 254 registers, no spills); H % 32 == 16 leaves the
// last block 16 heads, whose upper four warps only stage tiles.  A block
// holds 32 heads' 576 query floats (72 KiB) and walks its split's share
// of the row's keys [lo, hi) in tiles of 32 keys through a ring of two
// tile buffers (72 KiB each): tile i + 1 arrives by 16-byte cp.async
// (the zero-filled tail past hi included) while tile i is computed, so
// no load is waited on once the first tile is in.  Each key tile serves
// 32 heads, and each key is fetched by 4 head-group blocks.  A tile is
// three phases:
//   (1) the 32 x 32 scores as register-blocked outer products: a lane a
//       4 heads x 8 keys micro-tile over an eighth of the 576-float
//       reduction (eight lanes, consecutive float4 columns), 12 16-byte
//       shared reads for 128 FMAs; the four lane groups of a warp share
//       its 8 keys (broadcast reads); the eight partial sums
//       reduce-scatter in three shuffle rounds (28 shuffles a lane, not
//       96), each lane keeping 4 scores of one head;
//   (2) the online softmax: warp w owns heads 4w .. 4w + 3 for the whole
//       walk, so their running max and sum live in its registers; it
//       writes the tile's probabilities (one 16-byte store a lane) and
//       the rescale factors;
//   (3) P.V: a thread 16 heads x 4 columns (64 accumulators), a key's 16
//       probabilities as four 16-byte broadcasts and its 4 values as one
//       16-byte load: 64 FMAs for five shared reads.
// With one split the block writes o itself; with more, each split that
// holds a key writes (m, l, acc) to a float32 workspace and a second
// kernel (paged_mla_merge) combines them per (row, head), skipping the
// empty splits (lengths and the split rule are read again there), so a
// dead row's blocks write nothing.  n_split comes from static shapes on
// the host (kernels.ops.mla_splits), so nothing is read back and a CUDA
// graph holds both launches.
//
// Its bound at dots-vlm1.ocr's tick shape (64 rows of which 36 hold
// 1,100-3,200 keys, tables of 200 pages of 16; chip_smoke.py's row
// paged_mla_decode_ocr): 21.56 GFLOP at the H100's 67 TFLOP/s of float32
// FMA, 0.322 ms.  Measured there on an H100 (700 W): 0.786 ms with its
// merge, 41 % of that bound, at the 5 splits mla_splits plans (4 to 10
// splits all within 2.5 % of it; 1 split 1.21 ms).  A block of 16 heads
// with its tiles loaded synchronously between barriers, two blocks an
// SM, took 1.436 ms there (22 %).  At a 4-row tick of 10-15 keys the
// call is latency-bound: 0.014 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int R = 512;          // kv_lora_rank: ckv's width and o's
constexpr int RP = 64;          // qk_rope_dim
constexpr int QW = R + RP;      // a key's (and a query's) floats
constexpr int Q4 = QW / 4;      // ... in float4
constexpr int HB = 32;          // heads a block
constexpr int BK = 32;          // keys a tile
constexpr int NT = 256;         // threads a block
constexpr int SS = BK + 4;      // a head's row of scores in shared memory
constexpr int PS = HB + 4;      // a key's row of probabilities
constexpr int SMEM_FLOATS = HB * QW + 2 * BK * QW + HB * SS + BK * PS
                            + 2 * HB;
static_assert(HB * Q4 % NT == 0 && BK * Q4 % NT == 0, "copy loops");
static_assert(NT == 8 * 32 && HB == 32 && BK == 32, "the warp layouts");

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

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // src-size 0 zero-fills the 16 bytes without reading src
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One round of a reduce-scatter over lanes that differ in bit MASK: of
// v[0 .. 2 HALF) the lane keeps the half its bit names, summed with its
// partner's, in v[0 .. HALF).
template <int HALF, int MASK>
__device__ __forceinline__ void scatter_round(float (&v)[32], int kq) {
  const bool up = kq & MASK;
#pragma unroll
  for (int r = 0; r < HALF; ++r) {
    const float send = up ? v[r] : v[r + HALF];
    const float keep = up ? v[r + HALF] : v[r];
    v[r] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
  }
}

// The pool slot of key kt of the row (table entry clamped into the pool),
// or 0 past hi: a lane's key of a tile, shuffled to the copying lanes.
__device__ __forceinline__ int key_slot(const int* __restrict__ tab, int kt,
                                        int hi, int P, int ps) {
  if (kt >= hi) return 0;
  const int page = min(max(__ldg(tab + kt / ps), 0), P - 1);
  return page * ps + kt % ps;
}

// Stage the tile of nt keys whose slots lanes 0 .. 31 of each warp hold
// (key t in lane t) into dst, ckv || kr a row; rows at or past nt zero.
__device__ __forceinline__ void stage_tile(float* dst, const float* ckv,
                                           const float* kr, int slot,
                                           int nt) {
#pragma unroll
  for (int j = 0; j < BK * Q4 / NT; ++j) {
    const int i = threadIdx.x + NT * j, t = i / Q4, c4 = i - t * Q4;
    const long long s = __shfl_sync(0xffffffffu, slot, t);
    const float* src = c4 < R / 4 ? ckv + s * R + 4 * c4
                                  : kr + s * RP + 4 * (c4 - R / 4);
    cp_async16(dst + t * QW + 4 * c4, src, t < nt);
  }
}

__global__ void __launch_bounds__(NT, 1)
paged_mla_decode_kernel(const float* __restrict__ q_lat,
                        const float* __restrict__ q_pe,
                        const float* __restrict__ ckv,
                        const float* __restrict__ kr,
                        const int* __restrict__ tables,
                        const int* __restrict__ lengths,
                        float* __restrict__ o, float* __restrict__ ws_acc,
                        float* __restrict__ ws_ml, int H, int P, int ps,
                        int n_max, int n_split, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                     // [HB][QW]
  float* kbuf = qs + HB * QW;           // [2][BK][QW]
  float* ss = kbuf + 2 * BK * QW;       // [HB][SS] the tile's scores
  float* pt = ss + HB * SS;             // [BK][PS] its probabilities
  float* ah = pt + BK * PS;             // [HB] the tile's rescale
  float* lh = ah + HB;                  // [HB] the final sums

  const int split = blockIdx.x, h0 = blockIdx.y * HB, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nh = min(HB, H - h0);  // the block's heads: 32, or 16 at the end
  const int n = max(0, min(lengths[b], n_max * ps));
  const int lo = (int)((long long)n * split / n_split);
  const int hi = (int)((long long)n * (split + 1) / n_split);
  // (3)'s tile: heads hq .. hq + 15, columns cq .. cq + 3
  const int hq = (warp >> 2) * 16, cq = (warp & 3) * 128 + 4 * lane;
  // the warp's heads exist (in all three phases, warps 4 .. 7 hold heads
  // 16 .. 31): a block of 16 heads leaves its upper warps at the barriers
  const bool mine = hq < nh;

  if (lo >= hi) {  // an empty split; the merge skips it
    if (n_split == 1 && mine)
      for (int h = 0; h < 16; ++h)
        *reinterpret_cast<float4*>(o + ((long long)b * H + h0 + hq + h) * R
                                   + cq) = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  // the block's heads' queries (q_lat then q_pe, 576 floats a head; a
  // missing head's zero) and the first tile, one cp.async group
  const long long row0 = (long long)b * H + h0;
#pragma unroll
  for (int j = 0; j < HB * Q4 / NT; ++j) {
    const int i = tid + NT * j, h = i / Q4, c4 = i - h * Q4;
    const int hs = min(h, nh - 1);
    const float* src = c4 < R / 4 ? q_lat + (row0 + hs) * R + 4 * c4
                                  : q_pe + (row0 + hs) * RP + 4 * (c4 - R / 4);
    cp_async16(qs + h * QW + 4 * c4, src, h < nh);
  }
  const int* tab = tables + (long long)b * n_max;
  stage_tile(kbuf, ckv, kr, key_slot(tab, lo + lane, hi, P, ps),
             min(BK, hi - lo));
  cp_async_commit();
  int next_slot = key_slot(tab, lo + BK + lane, hi, P, ps);

  // (1)'s micro-tile: heads sh .. sh + 3, keys st .. st + 7, float4
  // columns kq, kq + 8, ...
  const int kq = lane & 7;
  const int sh = (warp >> 2) * 16 + (lane >> 3) * 4, st = (warp & 3) * 8;
  // (2)'s running max and sum of heads 4 warp + i
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
  }
  float acc[16][4];
#pragma unroll
  for (int h = 0; h < 16; ++h)
    acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;

  for (int start = lo, it = 0; start < hi; start += BK, ++it) {
    const int nt = min(BK, hi - start);
    const float* ks = kbuf + (it & 1) * BK * QW;
    cp_async_wait_all();
    __syncthreads();  // this tile is in; every warp is done with the last
    if (start + BK < hi) {  // the next tile into the other buffer
      stage_tile(kbuf + ((it + 1) & 1) * BK * QW, ckv, kr, next_slot,
                 min(BK, hi - start - BK));
      cp_async_commit();
      next_slot = key_slot(tab, start + 2 * BK + lane, hi, P, ps);
    }

    // (1) scores
    if (mine) {
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      const float4* q4 = reinterpret_cast<const float4*>(qs) + sh * Q4;
      const float4* k4 = reinterpret_cast<const float4*>(ks) + st * Q4;
#pragma unroll 2
      for (int c = kq; c < Q4; c += 8) {
        float4 q[4], k[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) q[i] = q4[i * Q4 + c];
#pragma unroll
        for (int j = 0; j < 8; ++j) k[j] = k4[j * Q4 + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            s[i][j] = fmaf(q[i].x, k[j].x, s[i][j]);
            s[i][j] = fmaf(q[i].y, k[j].y, s[i][j]);
            s[i][j] = fmaf(q[i].z, k[j].z, s[i][j]);
            s[i][j] = fmaf(q[i].w, k[j].w, s[i][j]);
          }
      }
      // reduce-scatter over the 8 lanes of the reduction: v[r] is score
      // (r / 8, r % 8); each round halves the values a lane holds, which
      // end as v[0 .. 3] = head sh + kq / 2, keys st + 4 (kq % 2) + 0..3
      float v[32];
#pragma unroll
      for (int r = 0; r < 32; ++r) v[r] = s[r / 8][r % 8];
      scatter_round<16, 4>(v, kq);
      scatter_round<8, 2>(v, kq);
      scatter_round<4, 1>(v, kq);
      const int t0 = st + 4 * (kq & 1);
      float4 w;
      w.x = t0 < nt ? v[0] * scale : NEG_INF;
      w.y = t0 + 1 < nt ? v[1] * scale : NEG_INF;
      w.z = t0 + 2 < nt ? v[2] * scale : NEG_INF;
      w.w = t0 + 3 < nt ? v[3] * scale : NEG_INF;
      *reinterpret_cast<float4*>(ss + (sh + (kq >> 1)) * SS + t0) = w;
    }
    __syncthreads();
    // (2) the online softmax of heads 4 warp + i, lane = key
    if (mine) {
      float p[4], a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = ss[(4 * warp + i) * SS + lane];
        const float m_new = fmaxf(m[i], warp_max(s));
        p[i] = s > 0.5f * NEG_INF ? __expf(s - m_new) : 0.f;
        a[i] = m[i] > 0.5f * NEG_INF ? __expf(m[i] - m_new) : 0.f;
        l[i] = l[i] * a[i] + warp_sum(p[i]);
        m[i] = m_new;
      }
      *reinterpret_cast<float4*>(pt + lane * PS + 4 * warp) =
          make_float4(p[0], p[1], p[2], p[3]);
      if (lane == 0)
        *reinterpret_cast<float4*>(ah + 4 * warp) =
            make_float4(a[0], a[1], a[2], a[3]);
    }
    __syncthreads();
    // (3) acc = acc * alpha + P.V
    if (mine) {
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float4 a = reinterpret_cast<const float4*>(ah + hq)[g];
        const float al[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[4 * g + i][c] *= al[i];
      }
#pragma unroll 2
      for (int t = 0; t < nt; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(ks + t * QW + cq);
        const float4* p4 = reinterpret_cast<const float4*>(pt + t * PS + hq);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 p = p4[g];
          const float pp[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[4 * g + i][0] = fmaf(pp[i], v.x, acc[4 * g + i][0]);
            acc[4 * g + i][1] = fmaf(pp[i], v.y, acc[4 * g + i][1]);
            acc[4 * g + i][2] = fmaf(pp[i], v.z, acc[4 * g + i][2]);
            acc[4 * g + i][3] = fmaf(pp[i], v.w, acc[4 * g + i][3]);
          }
        }
      }
    }
  }

  if (n_split == 1) {
    if (lane == 0)
      *reinterpret_cast<float4*>(lh + 4 * warp) =
          make_float4(l[0], l[1], l[2], l[3]);
    __syncthreads();
    if (!mine) return;
#pragma unroll
    for (int h = 0; h < 16; ++h) {
      const float lt = lh[hq + h];
      const float inv = lt > 0.f ? 1.f / lt : 0.f;
      *reinterpret_cast<float4*>(o + (row0 + hq + h) * R + cq) =
          make_float4(acc[h][0] * inv, acc[h][1] * inv, acc[h][2] * inv,
                      acc[h][3] * inv);
    }
    return;
  }
  if (!mine) return;
#pragma unroll
  for (int h = 0; h < 16; ++h) {
    const long long e = (row0 + hq + h) * n_split + split;
    *reinterpret_cast<float4*>(ws_acc + e * R + cq) =
        make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (lane == i) {
      const long long e = (row0 + 4 * warp + i) * n_split + split;
      ws_ml[2 * e] = m[i];
      ws_ml[2 * e + 1] = l[i];
    }
}

// One (head, row) a block, 128 threads of 4 columns: the partial
// softmaxes of the splits that hold a key (the kernel's split rule over
// the row's length) combined by their maxima; a row with no key gives 0.
__global__ void __launch_bounds__(128)
paged_mla_merge_kernel(const float* __restrict__ ws_acc,
                       const float* __restrict__ ws_ml,
                       const int* __restrict__ lengths,
                       float* __restrict__ o, int H, int n_keys,
                       int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, c4 = threadIdx.x;
  const long long e0 = ((long long)b * H + h) * n_split;
  const long long n = max(0, min(lengths[b], n_keys));
  float m = NEG_INF;
  for (int s = 0; s < n_split; ++s)
    if (n * (s + 1) / n_split > n * s / n_split)
      m = fmaxf(m, ws_ml[2 * (e0 + s)]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_split; ++s) {
    if (n * (s + 1) / n_split <= n * s / n_split) continue;
    const float w = __expf(ws_ml[2 * (e0 + s)] - m);
    l += ws_ml[2 * (e0 + s) + 1] * w;
    const float4 a =
        reinterpret_cast<const float4*>(ws_acc + (e0 + s) * R)[c4];
    acc.x = fmaf(a.x, w, acc.x);
    acc.y = fmaf(a.y, w, acc.y);
    acc.z = fmaf(a.z, w, acc.z);
    acc.w = fmaf(a.w, w, acc.w);
  }
  const float inv = l > 0.f ? 1.f / l : 0.f;
  reinterpret_cast<float4*>(o + ((long long)b * H + h) * R)[c4] =
      make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
}

// The kernel's dynamic shared memory above 48 KiB, set once: the eager
// step that precedes a graph's capture sets it, so the capture makes no
// such call.
cudaError_t allow_smem() {
  static cudaError_t err = cudaFuncSetAttribute(
      paged_mla_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_FLOATS * (int)sizeof(float));
  return err;
}

}  // namespace

extern "C" {

// q_lat (B, H, 512), q_pe (B, H, 64), ckv pages (P, ps, 512), kr pages
// (P, ps, 64), tables (B, n_max) int32, lengths (B,) int32, o (B, H,
// 512); ws: B * H * n_split * 514 floats where n_split > 1.  H % 16 == 0:
// the last block of an H % 32 == 16 holds 16 heads.
// Returns the launch's CUDA error (0 on success).
int paged_mla_decode_fwd(const float* q_lat, const float* q_pe,
                         const float* ckv, const float* kr,
                         const int* tables, const int* lengths, float* o,
                         float* ws, int B, int H, int r, int rope, int P,
                         int ps, int n_max, int n_split, float scale,
                         void* stream) {
  if (r != R || rope != RP || H % (HB / 2) || n_split < 1) return 1;
  if (B == 0) return 0;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws_acc = ws;
  float* ws_ml = ws + (long long)B * H * n_split * R;
  dim3 grid(n_split, (H + HB - 1) / HB, B);
  paged_mla_decode_kernel<<<grid, NT, smem, s>>>(
      q_lat, q_pe, ckv, kr, tables, lengths, o, ws_acc, ws_ml, H, P, ps,
      n_max, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  paged_mla_merge_kernel<<<dim3(H, B), R / 4, 0, s>>>(
      ws_acc, ws_ml, lengths, o, H, n_max * ps, n_split);
  return (int)cudaGetLastError();
}

// int[3] out: threads a block, dynamic shared-memory bytes, and the
// blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor):
// what analysis/kernel_check.py's plan reads, held to the kernel by
// chip_smoke.py phase 10
int paged_mla_decode_info(int* out) {
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, paged_mla_decode_kernel, NT, smem);
  out[0] = NT;
  out[1] = smem;
  out[2] = blocks;
  return (int)err;
}

}  // extern "C"
