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
// units bound it, and the design keeps each key in shared memory while
// a block's 16 heads use it, and each head's query and partial sums on
// chip while the block walks its keys.
//
// Grid (n_split, H / 16, B), 256 threads.  A block holds 16 heads' 576
// query floats (36 KiB) and walks its split's share of the row's keys
// [lo, hi) in tiles of 32 keys (32 x 580 floats, 74 KiB): (1) the
// tile's keys from their pages into shared memory, 16 bytes a load; (2)
// the 16 x 32 scores in 4 x 4 micro-tiles, a quarter warp each, its 8
// lanes each an eighth of the 576-float reduction (a lane's 8 reads a
// step, 4 query rows and 4 key rows, serve 64 FMAs; the 8 lanes read 8
// consecutive float4 of a row, one wavefront) and three shuffle steps
// to sum them; (3) per head a warp's online softmax over the tile
// (running max m, sum l, the rescale alpha); (4) the 16 heads x 512
// accumulators, a thread 4 columns of 8 heads (32 registers), each
// key's 8 probabilities read as two 16-byte broadcasts and its 4 values
// as one 16-byte load: 32 FMAs for three shared-memory reads.  115,456 bytes of shared memory: two blocks an
// SM.  With one split the block writes o itself; with more, each split
// writes (m, l, acc) to a float32 workspace and a second kernel
// (paged_mla_merge) combines them per (row, head).  n_split comes from
// static shapes on the host (kernels.ops.mla_splits), so nothing is read
// back and a CUDA graph can hold both launches.  ptxas (sm_90a, CUDA
// 12.8): 122 registers, no spill; two blocks an SM.  On an H100 at 64
// rows of which 28 hold 1,100-2,400 keys (one layer of dots-vlm1.ocr's
// tick): 0.96 ms at 8 splits, 22 % of the operations' bound; the first
// design (a thread one head and two keys in (2), two columns of 16 heads
// in (4)) took 1.50 ms: its score reads, three 16-byte loads for 8 FMAs,
// held the FMA units to a fifth.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int R = 512;          // kv_lora_rank: ckv's width and o's
constexpr int RP = 64;          // qk_rope_dim
constexpr int QW = R + RP;      // a key's (and a query's) floats
constexpr int KS = QW + 4;      // a key row's stride in shared memory
constexpr int HG = 16;          // heads a block
constexpr int BK = 32;          // keys a tile
constexpr int NT = 256;         // threads a block
constexpr int SMEM_FLOATS = HG * QW + BK * KS + HG * (BK + 1) + BK * HG
                            + 3 * HG;

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

__global__ void __launch_bounds__(NT, 2)
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
  float* qs = smem;                     // [HG][QW]
  float* ks = qs + HG * QW;             // [BK][KS]
  float* ss = ks + BK * KS;             // [HG][BK + 1]
  float* pt = ss + HG * (BK + 1);       // [BK][HG]
  float* mh = pt + BK * HG;             // [HG] running max
  float* lh = mh + HG;                  // [HG] running sum
  float* ah = lh + HG;                  // [HG] the tile's rescale

  const int split = blockIdx.x, h0 = blockIdx.y * HG, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = min(lengths[b], n_max * ps);
  const int lo = (int)((long long)n * split / n_split);
  const int hi = (int)((long long)n * (split + 1) / n_split);

  // the 16 heads' queries: q_lat then q_pe, 576 floats a head
  for (int i = tid; i < HG * (QW / 4); i += NT) {
    const int h = i / (QW / 4), c4 = i % (QW / 4);
    const long long row = (long long)b * H + h0 + h;
    const float4 v = c4 < R / 4
        ? __ldg(reinterpret_cast<const float4*>(q_lat + row * R) + c4)
        : __ldg(reinterpret_cast<const float4*>(q_pe + row * RP) + c4 - R / 4);
    reinterpret_cast<float4*>(qs + h * QW)[c4] = v;
  }
  if (tid < HG) {
    mh[tid] = NEG_INF;
    lh[tid] = 0.f;
  }
  // (4)'s accumulators: heads hq .. hq + 7, columns cq .. cq + 3
  const int hq = (tid >> 7) * 8, cq = (tid & 127) * 4;
  float acc[8][4];
#pragma unroll
  for (int h = 0; h < 8; ++h)
    acc[h][0] = acc[h][1] = acc[h][2] = acc[h][3] = 0.f;
  // (2)'s micro-tile: heads sh .. sh + 3, keys st .. st + 3, the
  // reduction's float4 columns kq, kq + 8, ...
  const int mt = warp * 4 + (lane >> 3), kq = lane & 7;
  const int sh = (mt >> 3) * 4, st = (mt & 7) * 4;

  const int* tab = tables + (long long)b * n_max;
  for (int start = lo; start < hi; start += BK) {
    const int nt = min(BK, hi - start);
    __syncthreads();   // the previous tile's reads of ks and pt are done
    // (1) the tile's keys: ckv || kr, 144 float4 a key
    for (int i = tid; i < BK * (QW / 4); i += NT) {
      const int t = i / (QW / 4), c4 = i % (QW / 4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (t < nt) {
        const int kt = start + t;
        const int page = min(max(tab[kt / ps], 0), P - 1);
        const long long slot = (long long)page * ps + kt % ps;
        v = c4 < R / 4
            ? __ldg(reinterpret_cast<const float4*>(ckv + slot * R) + c4)
            : __ldg(reinterpret_cast<const float4*>(kr + slot * RP) + c4
                    - R / 4);
      }
      *reinterpret_cast<float4*>(ks + t * KS + 4 * c4) = v;
    }
    __syncthreads();
    // (2) scores: a quarter warp a 4 x 4 micro-tile, its 8 lanes each an
    // eighth of the 576-float reduction (8 consecutive float4 of a row:
    // one wavefront a read), then summed by shuffles
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll 2
      for (int c = kq; c < QW / 4; c += 8) {
        float4 q[4], k[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          q[i] = reinterpret_cast<const float4*>(qs + (sh + i) * QW)[c];
          k[i] = reinterpret_cast<const float4*>(ks + (st + i) * KS)[c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(q[i].x, k[j].x, s[i][j]);
            s[i][j] = fmaf(q[i].y, k[j].y, s[i][j]);
            s[i][j] = fmaf(q[i].z, k[j].z, s[i][j]);
            s[i][j] = fmaf(q[i].w, k[j].w, s[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int o = 1; o < 8; o <<= 1)
            s[i][j] += __shfl_xor_sync(0xffffffffu, s[i][j], o);
        }
      // lane kq writes scores 2 kq and 2 kq + 1 of the 16
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 2 * kq + e, i = idx >> 2, j = idx & 3;
        float v = 0.f;
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            if (ii == i && jj == j) v = s[ii][jj];
        ss[(sh + i) * (BK + 1) + st + j] = st + j < nt ? v * scale : NEG_INF;
      }
    }
    __syncthreads();
    // (3) the online softmax: warp w takes heads 2w and 2w + 1
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int h = 2 * warp + j;
      const float s = ss[h * (BK + 1) + lane];
      const float m_old = mh[h];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = s > 0.5f * NEG_INF ? __expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      pt[lane * HG + h] = p;
      if (lane == 0) {
        const float alpha = m_old > 0.5f * NEG_INF ? __expf(m_old - m_new)
                                                   : 0.f;
        ah[h] = alpha;
        mh[h] = m_new;
        lh[h] = lh[h] * alpha + sum;
      }
    }
    __syncthreads();
    // (4) acc[h][0..3]: 8 heads' 4 columns, each key's 8 probabilities
    // read as two 16-byte broadcasts and its 4 values as one 16-byte load
    {
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const float4 a = reinterpret_cast<const float4*>(ah + hq)[g];
        const float al[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[4 * g + i][c] *= al[i];
      }
      for (int t = 0; t < nt; ++t) {
        const float4 v = *reinterpret_cast<const float4*>(ks + t * KS + cq);
        const float4* p4 = reinterpret_cast<const float4*>(pt + t * HG + hq);
#pragma unroll
        for (int g = 0; g < 2; ++g) {
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
  __syncthreads();
  if (n_split == 1) {
#pragma unroll
    for (int h = 0; h < 8; ++h) {
      const float l = lh[hq + h];
      const float inv = l > 0.f ? 1.f / l : 0.f;
      *reinterpret_cast<float4*>(o + ((long long)b * H + h0 + hq + h) * R
                                 + cq) =
          make_float4(acc[h][0] * inv, acc[h][1] * inv, acc[h][2] * inv,
                      acc[h][3] * inv);
    }
    return;
  }
#pragma unroll
  for (int h = 0; h < 8; ++h) {
    const long long e = ((long long)b * H + h0 + hq + h) * n_split + split;
    *reinterpret_cast<float4*>(ws_acc + e * R + cq) =
        make_float4(acc[h][0], acc[h][1], acc[h][2], acc[h][3]);
  }
  if (tid < HG) {
    const long long e = ((long long)b * H + h0 + tid) * n_split + split;
    ws_ml[2 * e] = mh[tid];
    ws_ml[2 * e + 1] = lh[tid];
  }
}

// One (head, row) a block, 128 threads of 4 columns: the splits' partial
// softmaxes combined by their maxima; a row with no key gives 0.
__global__ void __launch_bounds__(128)
paged_mla_merge_kernel(const float* __restrict__ ws_acc,
                       const float* __restrict__ ws_ml,
                       float* __restrict__ o, int H, int n_split) {
  const int h = blockIdx.x, b = blockIdx.y, c4 = threadIdx.x;
  const long long e0 = ((long long)b * H + h) * n_split;
  float m = NEG_INF;
  for (int s = 0; s < n_split; ++s) m = fmaxf(m, ws_ml[2 * (e0 + s)]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < n_split; ++s) {
    const float ms = ws_ml[2 * (e0 + s)];
    const float w = ms > 0.5f * NEG_INF ? __expf(ms - m) : 0.f;
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
// 512); ws: B * H * n_split * 514 floats where n_split > 1.  H % 16 == 0.
// Returns the launch's CUDA error (0 on success).
int paged_mla_decode_fwd(const float* q_lat, const float* q_pe,
                         const float* ckv, const float* kr,
                         const int* tables, const int* lengths, float* o,
                         float* ws, int B, int H, int r, int rope, int P,
                         int ps, int n_max, int n_split, float scale,
                         void* stream) {
  if (r != R || rope != RP || H % HG || n_split < 1) return 1;
  if (B == 0) return 0;
  const int smem = SMEM_FLOATS * (int)sizeof(float);
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws_acc = ws;
  float* ws_ml = ws + (long long)B * H * n_split * R;
  dim3 grid(n_split, H / HG, B);
  paged_mla_decode_kernel<<<grid, NT, smem, s>>>(
      q_lat, q_pe, ckv, kr, tables, lengths, o, ws_acc, ws_ml, H, P, ps,
      n_max, n_split, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return (int)err;
  paged_mla_merge_kernel<<<dim3(H, B), R / 4, 0, s>>>(ws_acc, ws_ml, o, H,
                                                      n_split);
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
