// Flash attention forward for Hopper (sm_90a), f32 or bf16 in, f32 math:
// a float32 instance on the FMA units (flash_fwd) and a bfloat16 instance
// on the tensor cores (flash_fwd_mma, below the float32 notes).
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (body `_kernel`): streaming-softmax
// attention of q (B,S,H,D) over k/v (B,T,K,D), H % K == 0 (GQA: q-head h
// reads kv-head h / (H/K)), with causal masking, an optional sliding
// window, an optional tanh logit softcap (applied before the mask), and
// the rule that a row with every key masked gives 0.  Positions are the
// trivial arange on both sides, as in the TPU kernel.
//
// What bounds it here.  zamba2-7b's shared attention (batch-1 prefill of
// 383 tokens, H = K = 32, D = 112, causal) is 1.05 GFLOP over the visible
// pairs: 15.7 us at the 67 TFLOP/s f32 (non-tensor-core) peak, against
// 6.6 us for its 22 MB of q/k/v/o at 3.35 TB/s, so operations bound it.
// internvl2-1b's prefill (S = 267, H = 14, K = 2, D = 64) is 0.13 GFLOP,
// 1.9 us: there the few hundred rows must still be spread over the 132
// SMs.  f32 stays on the FMA units: the path is held to 2e-4, which TF32
// tensor-core products do not meet.
//
// The float32 instance's design (it replaces a one-thread-per-row kernel
// whose every score was a chain of D dependent FMAs, each waiting on a
// shared-memory load, on 2-warp blocks too few to fill the card):
//
// * A block of NT = 128 threads owns BQ query rows of one (batch, q-head)
//   and walks the keys in tiles of BK.  Threads form a TY x TX grid:
//   thread (ty, tx) owns the RQ = 4 rows ty + TY*i and, in Q.K^T, the RK
//   keys tx + TX*j of each tile, an RQ x RK micro-tile of independent
//   accumulators, so every float4 read from shared memory feeds several
//   FMAs.  In P.V the same thread owns its RQ rows x D/TX columns (in
//   pairs where D allows).  The TX threads sharing a row are adjacent
//   lanes of one warp: the row max and sum combine by warp shuffles, and
//   P passes from Q.K^T to P.V through shared memory with no block
//   barrier.  Scores are kept in log2 units, so the softmax is exp2.
// * Q, one K tile, one V tile and P live in dynamic shared memory (44 KB
//   at D = 64, five blocks an SM; 83 KB at D = 112, two).  f32 K and V tiles
//   arrive by 16-byte cp.async: the next tile's K loads while this tile's
//   P.V runs, and its V while its Q.K^T runs, so each load overlaps the
//   other half's math in one K and one V buffer (two full K/V stages
//   would halve the blocks an SM holds).  Rows are padded by 4 floats so
//   that the float4 reads of 8 lanes fall in 8 distinct bank groups.
// * The grid is (H, B, q-tiles) with the q-tile slowest, and under a
//   causal mask the heaviest q-tiles (the last rows) are launched first.
//   Tiles per head dim were chosen on an H100 among 16-64 rows x 32-64
//   keys: D = 64 takes 16 x 64 (238 blocks at internvl2-1b), D = 112
//   32 x 64 (384 blocks at zamba2-7b); 64-row tiles left the causal
//   grid unbalanced.  D = 128 and 256 (llama3-8b, gemma2-9b) were timed
//   by an earlier tools/kernel_sweep.py --parts flash, which swept the
//   float32 tiles, at a 4,100-token prefill (H =
//   32 / 16, K = 8; NVIDIA H100 80GB HBM3, 700 W): D = 128 takes 64 x 32
//   (4.26 ms; 32 x 64 4.46, 32 x 32 4.47, 16 x 64 5.68), D = 256 32 x 32
//   (4.87 ms, 104 KB, two blocks an SM; 16 x 32 6.25, 32 x 64 6.29 at
//   176 KB and one block, 16 x 64 7.57).  At D = 256 a thread holds 4
//   rows x 16 output columns of P.V.  KV tiles wholly outside the causal
//   diagonal or the window are never loaded; ragged S and T are masked in
//   the kernel.
// * ptxas (sm_90a, CUDA 12.8), f32: D = 256 and 128 168 registers, D =
//   112 168, D = 64 80, D = 16 128; no instance spills (chip_smoke.py
//   prints these lines).
//
// The bfloat16 instance (flash_fwd_mma) computes the same function as the
// TPU kernel does for bf16 inputs: q, k and v widened to f32, s and p in
// f32, p @ v with f32 p, the output rounded to bf16.  A bf16 x bf16
// product is exact in f32, so Q.K^T and P.V run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate) and match the f32 math up
// to summation order, as long as P keeps f32 precision and O is summed
// by float adds: P is split into three bf16 terms, hi = bf16(P), mid =
// bf16(P - hi), lo = bf16(P - hi - mid), which hold it to ~24 bits, all
// three go through one fresh f32 accumulator a k16 step, and that is
// added to O (a single bf16 P, as FlashAttention keeps it, would be
// another function).  The row sum l adds the f32 P.
//
// What bounds it here.  internvl2-1b's prefill (S = 267, H = 14, K = 2,
// D = 64, causal) moves 1.09 MB (0.33 us at 3.35 TB/s) and does 0.13
// GFLOP (0.13 us at the 989 TFLOP/s bf16 peak): bytes; zamba2-7b's shared
// attention at S = 200 (H = K = 32, D = 112) 5.7 MB (1.71 us) against
// 0.29 GFLOP; both are a few hundred q rows to spread over 132 SMs, so
// latency and grid fill set the time.  gemma2-9b's local layer at
// S = 4,100 (D = 256, window 4,096) is 137 GFLOP: 0.139 ms at the bf16
// peak, operations (and the split makes P.V's mma work three times its
// FLOPs).
//
// Design:
// * A warp owns 16 q rows of one (batch, q-head) and BK keys of each
//   tile; a block owns BQ rows (BQ / 16 row groups) and walks the keys in
//   tiles of KW x BK, KW warps on each row group's keys.  At the served
//   shapes a warp's tiles are a serial chain (mma, shuffle and exp2
//   latencies with one or two warps an SM sub-partition), so splitting the
//   keys over KW warps shortens the chain; after the last tile the KW - 1
//   warps' (acc, m, l) pass through shared memory to the row group's
//   first warp, rescaled to the joint max.  The grid, the tiles it skips
//   (outside the diagonal or the window, from kv_begin) and the in-kernel
//   masks of ragged S and T are the float32 instance's; a warp also skips
//   a tile none of its own rows can see.
// * Q, K and V stay bf16 in shared memory and arrive by 16-byte
//   cp.async.cg: K and V in a ring of two tiles, the next tile's loads
//   in flight under this tile's math, one block barrier a tile.  A thread
//   copies one 16-byte column of every few rows.  Rows are padded by 8
//   bf16 (16 bytes), so the 8 row addresses of an ldmatrix fall in 8
//   distinct 16-byte bank groups at every D here.
// * S = Q K^T: A from Q by ldmatrix, B from K by ldmatrix (K's rows are
//   B's columns).  Up to D = 128, Q's A fragments are loaded once into
//   registers (D / 4 a thread); at D = 256 O's accumulators take 128
//   registers a thread, so Q is read again by ldmatrix for each tile.
// * The online softmax runs in registers, in log2 units with the softcap
//   before the mask: a thread holds 2 rows (r and r + 8) of the m16n8
//   accumulators, whose max and sum combine by shuffles over the 4 lanes
//   of a quad; no shared memory, no block barrier.  The mask is evaluated
//   only on tiles that cross the diagonal, the window's edge or T.
// * O += P V: the accumulators of two adjacent n8 key tiles are the A
//   fragment of one k16 step, so P never leaves registers; V's B
//   fragments come by ldmatrix.trans.  Each of P's terms takes one mma,
//   the small ones first, into fresh accumulators for one k16 step and
//   one column pair, which a float add takes into O.  The tensor cores
//   truncate the sum they write, one way, by up to ~2^-24 of it: with O
//   itself as the mma's accumulator (the first design) that error grew
//   with the keys, and at S = 4,100 (256 k16 steps) 0.37 % (D = 256) and
//   0.36 % (D = 128) of the bf16 outputs differed from exact attention
//   rounded to bf16, against 0.060 / 0.057 % for the plain version; with
//   fresh accumulators 0.040 / 0.028 % (tools/kernel_sweep.py --parts
//   flash_ab, the first design as an --alt-flash copy).  They cost 4 %
//   at D = 64 and 7 % at D = 112 (0.00897 -> 0.00933, 0.01168 -> 0.01249
//   ms), ~15 % at D = 256.  A __syncwarp after each column pair keeps
//   ptxas from overlapping the pairs (D = 112 ran 3 % slower without it).
// * The output goes through the warp's own Q rows in shared memory and
//   leaves in 16-byte rows.
// * Tiles per head dim (MmaTiles) were chosen on an H100 (NVIDIA H100
//   80GB HBM3, 700 W) by tools/kernel_sweep.py --parts flash among BQ in
//   {32, 64} x BK in {16, 32, 64} x KW in {1, 2, 4} (8 warps a block at
//   most; an instance that spills is not taken; BQ = 16 trailed in an
//   earlier sweep), device ms at each head dim's call: D = 64
//   (internvl2-1b, S = 267) takes 32 x 32 x 4 (0.00924; 32 x 16 x 4
//   0.00961, 32 x 32 x 2 0.01024; the best KW = 1 trails 1.5x), D = 112
//   (zamba2-7b, S = 200) 64 x 32 x 2 (0.01255; 64 x 64 x 2 0.01310, 32 x
//   32 x 2 0.01341), D = 128 (S = 4,100, H = 32, K = 8) 64 x 32 x 1
//   (1.1558; 64 x 64 x 1 1.1989, 64 x 32 x 2 1.2998), D = 256 (gemma2-9b's
//   local layer, S = 4,100) 64 x 16 x 1 (1.5342; 32 x 16 x 1 1.7388; BK
//   >= 32 spills: O's 128 accumulators a thread and a 32-key S leave no
//   room), D = 16 (the mini-clip tower, S = 16) 32 x 16 x 1 (0.00218; 64
//   x 16 x 1 0.00219).  Splitting the keys (KW > 1) pays where a warp's
//   chain is the time, at the served prefills; at S = 4,100 the card is
//   full and it only adds the combine.  A ring of 3 or 4 tiles instead
//   of 2 did not speed up the served shapes when it was tried (at KW =
//   1): the loads are not what a warp's chain waits on.
// * P's three terms: with two (hi + bf16(P - hi), ~17 bits) 0.18 % of the
//   bf16 outputs flip at D = 64 and 112 and 0.23 % at D = 128 and 256,
//   with three 0.013-0.040 %, the plain version 0.019-0.060 % (flash_ab);
//   the third term costs 6 % of the device time at D = 64, 14 % at D =
//   112.  One bf16 P, as FlashAttention keeps it, would be another
//   function.
// * ptxas (sm_90a, CUDA 12.8), bf16: D = 16 72 registers, D = 64 143,
//   D = 112 202, D = 128 189, D = 256 176; no instance spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int NT = 128;  // threads per block
constexpr int RQ = 4;    // q rows per thread

// q rows and keys per tile of the float32 instance, by head dim
template <int D> struct Tiles;
template <> struct Tiles<16> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tiles<64> { static constexpr int BQ = 16, BK = 64; };
template <> struct Tiles<112> { static constexpr int BQ = 32, BK = 64; };
template <> struct Tiles<128> { static constexpr int BQ = 64, BK = 32; };
template <> struct Tiles<256> { static constexpr int BQ = 32, BK = 32; };

template <int D, int BQ, int BK>
struct Geom {
  static constexpr int TY = BQ / RQ;  // row groups
  static constexpr int TX = NT / TY;  // lanes sharing one row group
  static constexpr int RK = BK / TX;  // keys per thread per tile
  // P.V columns per thread: pairs 2(tx + TX c) where D allows, else
  // single columns tx + TX c
  static constexpr int VW = D % (2 * TX) == 0 ? 2 : 1;
  static constexpr int DC = D / (VW * TX);
  static constexpr int LD = D + 4;    // padded q/k/v row, floats
  static constexpr int LP = BQ + 4;   // padded P row (one key), floats
  static constexpr int Q_FLOATS = BQ * LD;
  static constexpr int KV_FLOATS = BK * LD;
  static constexpr int P_FLOATS = BK * LP;
  // q, one k tile, one v tile, p
  static constexpr int SMEM_BYTES =
      (Q_FLOATS + 2 * KV_FLOATS + P_FLOATS) * (int)sizeof(float);
  static_assert(TY * TX == NT && 32 % TX == 0, "row group within a warp");
  static_assert(BK % TX == 0 && D % TX == 0 && D % 4 == 0, "tiling");
};

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage rows [0, n_rows) of a tile into dst (row pitch LD floats); row r
// is src + r * stride elements, rows at or past `valid` become zeros.
template <int D, int LD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int64_t stride, int n_rows,
                                           int valid) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < n_rows * C; i += NT) {
    const int r = i / C, c = i - r * C;
    const bool ok = r < valid;
    cp_async16(dst + r * LD + 4 * c, src + (ok ? r * stride : 0) + 4 * c, ok);
  }
}
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(NT)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int Tk, int H,
          int K, float scale_log2, int causal, int window, float softcap,
          int n_qt) {
  using G = Geom<D, BQ, BK>;
  constexpr int TX = G::TX, TY = G::TY, RK = G::RK, DC = G::DC, VW = G::VW;
  constexpr int LD = G::LD, LP = G::LP;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + G::Q_FLOATS;
  float* sV = sK + G::KV_FLOATS;
  float* sP = sV + G::KV_FLOATS;  // P[key][row slot], row slot ty*RQ+i

  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * BQ;
  const int kh = h / (H / K);

  // keys this q-tile can see: [kv_begin, kv_end)
  const int q_last = min(S, q0 + BQ) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  // scores are kept in log2 units: s * log2(e), so exp2 gives the softmax
  float acc[RQ][DC][VW];
  float m[RQ], l[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int w = 0; w < VW; ++w) acc[i][c][w] = 0.f;
  }

  // One k buffer and one v buffer: the next tile's k loads while this
  // tile's P.V runs, and its v while its Q.K^T runs.
  const int64_t kv_stride = (int64_t)K * D;  // elements from key t to t+1
  const T* kb = k + ((int64_t)b * Tk * K + kh) * D;
  const T* vb = v + ((int64_t)b * Tk * K + kh) * D;
  if (n_tiles > 0) {
    stage_rows<D, LD>(sQ, q + (((int64_t)b * S + q0) * H + h) * D,
                      (int64_t)H * D, BQ, S - q0);
    stage_rows<D, LD>(sK, kb + kv_begin * kv_stride, kv_stride, BK,
                      Tk - kv_begin);
    cp_async_commit();
    stage_rows<D, LD>(sV, vb + kv_begin * kv_stride, kv_stride, BK,
                      Tk - kv_begin);
    cp_async_commit();
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = kv_begin + it * BK;
    const bool more = it + 1 < n_tiles;
    cp_async_wait<1>();  // q and this tile's k landed (v may be in flight)
    __syncthreads();

    // S = Q K^T on the RQ x RK micro-tile
    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      float4 qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sQ + (ty + TY * i) * LD + d);
#pragma unroll
      for (int j = 0; j < RK; ++j)
        kv[j] = *reinterpret_cast<const float4*>(sK + (tx + TX * j) * LD + d);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RK; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    __syncthreads();  // every warp is done with this k tile
    if (more) {
      const int t1 = t0 + BK;
      stage_rows<D, LD>(sK, kb + t1 * kv_stride, kv_stride, BK, Tk - t1);
      cp_async_commit();
    }

    // softcap, mask, online softmax; P = 2^(s - m) into s
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + TY * i;
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int t = t0 + tx + TX * j;
        const bool ok = row < S && t < Tk && (!causal || t <= row) &&
                        (window <= 0 || t > row - window);
        float x = s[i][j] * scale_log2;
        if (softcap > 0.f)
          x = softcap * LOG2E * tanhf(x / (softcap * LOG2E));
        s[i][j] = ok ? x : NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = m[i] > NEG_INF / 2 ? exp2f(m[i] - m_new) : 0.f;
      m[i] = m_new;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int w = 0; w < VW; ++w) acc[i][c][w] *= alpha;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = s[i][j] > NEG_INF / 2 ? exp2f(s[i][j] - m_new) : 0.f;
        l[i] += p;
        s[i][j] = p;
      }
    }
    __syncwarp();  // this warp's reads of the previous P are done
#pragma unroll
    for (int j = 0; j < RK; ++j)
      *reinterpret_cast<float4*>(sP + (tx + TX * j) * LP + ty * RQ) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    if (more)
      cp_async_wait<1>();  // this tile's v landed (the next k may not)
    else
      cp_async_wait<0>();
    __syncthreads();  // v visible to all; P visible to its warp

    // O += P V on RQ rows x DC column groups
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(sP + j * LP + ty * RQ);
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        float x[VW];
        if constexpr (VW == 2) {
          const float2 x2 = *reinterpret_cast<const float2*>(
              sV + j * LD + 2 * (tx + TX * c));
          x[0] = x2.x;
          x[1] = x2.y;
        } else {
          x[0] = sV[j * LD + tx + TX * c];
        }
#pragma unroll
        for (int w = 0; w < VW; ++w) {
          acc[0][c][w] = fmaf(p.x, x[w], acc[0][c][w]);
          acc[1][c][w] = fmaf(p.y, x[w], acc[1][c][w]);
          acc[2][c][w] = fmaf(p.z, x[w], acc[2][c][w]);
          acc[3][c][w] = fmaf(p.w, x[w], acc[3][c][w]);
        }
      }
    }
    __syncthreads();  // every warp is done with this v tile
    if (more) {
      const int t1 = t0 + BK;
      stage_rows<D, LD>(sV, vb + t1 * kv_stride, kv_stride, BK, Tk - t1);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int row = q0 + ty + TY * i;
    if (row < S) {
      const float inv = lt > 0.f ? 1.f / lt : 0.f;
      T* out = o + (((int64_t)b * S + row) * H + h) * D;
#pragma unroll
      for (int c = 0; c < DC; ++c)
#pragma unroll
        for (int w = 0; w < VW; ++w)
          store(out + VW * (tx + TX * c) + w, acc[i][c][w] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// The bfloat16 instance: Q.K^T and P.V on the tensor cores (notes above)

// q rows and keys per warp tile of the bfloat16 instance, and the warps
// that split a tile's keys, by head dim (tools/kernel_sweep.py --parts
// flash builds copies of this file with other values on these lines)
template <int D> struct MmaTiles;
template <> struct MmaTiles<16> { static constexpr int BQ = 32, BK = 16, KW = 1; };
template <> struct MmaTiles<64> { static constexpr int BQ = 32, BK = 32, KW = 4; };
template <> struct MmaTiles<112> { static constexpr int BQ = 64, BK = 32, KW = 2; };
template <> struct MmaTiles<128> { static constexpr int BQ = 64, BK = 32, KW = 1; };
template <> struct MmaTiles<256> { static constexpr int BQ = 64, BK = 16, KW = 1; };

template <int D, int BQ, int BK, int KW>
struct MmaGeom {
  static constexpr int RW = BQ / 16;         // row groups: 16 q rows each
  static constexpr int WARPS = RW * KW;      // and KW warps on each
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BT = KW * BK;         // keys a block tile
  static constexpr int LD = D + 8;           // padded q/k/v row, bf16
  static constexpr int ROW_BYTES = 2 * LD;
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int KV_ELEMS = BT * LD;   // one K or one V tile
  static constexpr int KS = D / 16;  // k16 steps of Q.K^T
  static constexpr int NK = BK / 8;  // n8 key tiles of a warp's S
  static constexpr int ND = D / 8;   // n8 column tiles of O
  // q, then two (K tile, V tile) stages; after the keys the ring holds
  // the partial (acc, m, l) of the KW - 1 warps that combine into the
  // first of each row group: ND + 1 float4 a lane
  static constexpr int SMEM_BYTES =
      (Q_ELEMS + 4 * KV_ELEMS) * (int)sizeof(__nv_bfloat16);
  static constexpr int COMBINE_BYTES = (KW - 1) * RW * (ND + 1) * 32 * 16;
  // Q's A fragments stay in registers (D / 4 a thread) up to D = 128
  static constexpr bool Q_REGS = D <= 128;
  static_assert(BQ % 16 == 0 && BK % 16 == 0 && D % 16 == 0, "mma tiling");
  static_assert(COMBINE_BYTES <= 4 * KV_ELEMS * 2,
                "the combine fits in the ring");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           bool pred) {
  // src-size 0 zero-fills the 16 bytes without reading src
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// Stage rows [0, n_rows) of a bf16 tile into dst (row pitch LD); row r
// is src + r * stride elements, rows at or past `valid` become zeros.  A
// thread copies one 16-byte column c of every RP-th row: indexing the
// chunks i / C, i % C instead cost ~80 registers at D = 256 (ptxas kept
// each chunk's offsets across the key loop) and spilled.
template <int D, int LD, int NTH>
__device__ __forceinline__ void stage_rows_bf16(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int64_t stride, int n_rows,
                                                int valid) {
  constexpr int C = D / 8, RP = NTH / C;  // 16-byte chunks a row; rows a pass
  const int c = threadIdx.x % C;
  if (threadIdx.x < RP * C)
    for (int r = threadIdx.x / C; r < n_rows; r += RP) {
      const bool ok = r < valid;
      cp_async16(dst + r * LD + 8 * c, src + (ok ? r * stride : 0) + 8 * c,
                 ok);
    }
}

// four 8x8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; .trans hands each lane a column pair instead
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c += a b on one m16n8k16 tile: bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const unsigned*>(&x);
}

// (x0, x1) as three bf16 pairs, hi = bf16(x), mid = bf16(x - hi) and lo =
// bf16(x - hi - mid), x0 in the low halves (an A fragment's element
// order): hi + mid + lo holds x to ~24 bits, float32's precision
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi,
                                           unsigned& mid, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float r0 = x0 - __low2float(h), r1 = x1 - __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(r0, r1);
  hi = bits(h);
  mid = bits(m);
  lo = bits(__floats2bfloat162_rn(r0 - __low2float(m), r1 - __high2float(m)));
}

template <int D, int BQ, int BK, int KW>
__global__ void __launch_bounds__(MmaGeom<D, BQ, BK, KW>::THREADS)
flash_fwd_mma(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              __nv_bfloat16* __restrict__ o, int S, int Tk, int H, int K,
              float scale_log2, int causal, int window, float softcap,
              int n_qt) {
  using G = MmaGeom<D, BQ, BK, KW>;
  constexpr int LD = G::LD, RB = G::ROW_BYTES, KS = G::KS, NK = G::NK,
                ND = G::ND, NTH = G::THREADS, BT = G::BT;
  constexpr float LOG2E = 1.4426950408889634f;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem4);
  __nv_bfloat16* sKV = sQ + G::Q_ELEMS;  // stage s: K tile, then V tile

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // warp (rw, kw): row group rw, keys [kw BK, (kw + 1) BK) of each tile
  const int rw = warp % G::RW, kw = warp / G::RW;
  // accumulator rows gq and gq + 8, column pair 2 tq of each n8 tile
  const int gq = lane / 4, tq = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = causal ? n_qt - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int q0 = qt * BQ;
  const int w0 = q0 + 16 * rw;  // this warp's first row
  const int kh = h / (H / K);

  // keys this q-tile can see: [kv_begin, kv_end)
  const int q_last = min(S, q0 + BQ) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BT - 1) / BT : 0;

  const int64_t kv_stride = (int64_t)K * D;  // elements from key t to t+1
  const __nv_bfloat16* kb = k + ((int64_t)b * Tk * K + kh) * D;
  const __nv_bfloat16* vb = v + ((int64_t)b * Tk * K + kh) * D;
  // tile it into stage it % 2, one commit group a tile
  auto stage_kv = [&](int it) {
    if (it < n_tiles) {
      const int t0 = kv_begin + it * BT;
      __nv_bfloat16* sK = sKV + (it & 1) * 2 * G::KV_ELEMS;
      stage_rows_bf16<D, LD, NTH>(sK, kb + t0 * kv_stride, kv_stride, BT,
                                  Tk - t0);
      stage_rows_bf16<D, LD, NTH>(sK + G::KV_ELEMS, vb + t0 * kv_stride,
                                  kv_stride, BT, Tk - t0);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) {
    stage_rows_bf16<D, LD, NTH>(sQ, q + (((int64_t)b * S + q0) * H + h) * D,
                                (int64_t)H * D, BQ, S - q0);
    stage_kv(0);
  }

  // ldmatrix addresses of lane `lane`: Q's A fragments (row lane % 16,
  // column 8 (lane / 16) of the k16 step), K's B fragments for two n8 key
  // tiles (key lane % 8 + 8 (lane / 16), column 8 ((lane / 8) % 2)), V's
  // B fragments for two n8 column tiles by .trans (key lane % 16, column
  // 8 (lane / 16))
  const unsigned q_addr =
      smem_addr(sQ + (16 * rw + lane % 16) * LD + (lane / 16) * 8);
  const unsigned k_off =
      (lane % 8 + 8 * (lane / 16)) * RB + ((lane / 8) % 2) * 16;
  const unsigned v_off = (lane % 16) * RB + (lane / 16) * 16;
  const unsigned kv_addr = smem_addr(sKV) + kw * BK * RB;  // this warp's

  unsigned qf[G::Q_REGS ? KS : 1][4];
  float acc[ND][4];
#pragma unroll
  for (int c = 0; c < ND; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[c][e] = 0.f;
  // scores are kept in log2 units: s * log2(e), so exp2 gives the softmax
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<0>();  // this tile (and q) landed
    __syncthreads();     // ... for every warp; all are done with tile it - 1
    stage_kv(it + 1);    // into tile it - 1's stage
    if constexpr (G::Q_REGS) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) ldsm_x4(qf[ks], q_addr + 32 * ks);
      }
    }
    const int t0 = kv_begin + it * BT + kw * BK;  // this warp's first key
    // a tile none of this warp's rows sees: past the last row's diagonal,
    // before the first row's window, or rows past S only
    if (w0 >= S || (causal && t0 > w0 + 15) ||
        (window > 0 && t0 + BK - 1 <= w0 - window))
      continue;
    const unsigned sk = kv_addr + (it & 1) * 2 * G::KV_ELEMS * 2;
    const unsigned sv = sk + G::KV_ELEMS * 2;

    // S = Q K^T: NK n8 tiles of 16 rows
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned a[4];
      if constexpr (G::Q_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[ks][e];
      } else {
        ldsm_x4(a, q_addr + 32 * ks);
      }
#pragma unroll
      for (int jj = 0; jj < NK / 2; ++jj) {
        unsigned kf[4];
        ldsm_x4(kf, sk + k_off + jj * 16 * RB + 32 * ks);
        mma_bf16(s[2 * jj], a, kf[0], kf[1]);
        mma_bf16(s[2 * jj + 1], a, kf[2], kf[3]);
      }
    }

    // softcap, mask (on tiles crossing the diagonal, the window's edge or
    // T), online softmax; P = 2^(s - m) into s.  Element e of n8 tile j
    // is row w0 + gq + 8 (e / 2), key t0 + 8 j + 2 tq + e % 2.
    const bool edge = t0 + BK > Tk || (causal && t0 + BK - 1 > w0) ||
                      (window > 0 && t0 <= w0 + 15 - window);
    float mt[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (softcap > 0.f)
          x = softcap * LOG2E * tanhf(x / (softcap * LOG2E));
        if (edge) {
          const int row = w0 + gq + 8 * (e / 2);
          const int t = t0 + 8 * j + 2 * tq + e % 2;
          const bool ok = t < Tk && (!causal || t <= row) &&
                          (window <= 0 || t > row - window);
          x = ok ? x : NEG_INF;
        }
        s[j][e] = x;
        mt[e / 2] = fmaxf(mt[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      const float alpha = m[r] > NEG_INF / 2 ? exp2f(m[r] - m_new) : 0.f;
      m[r] = m_new;
      l[r] *= alpha;
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        acc[c][2 * r] *= alpha;
        acc[c][2 * r + 1] *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e];
        const float p = x > NEG_INF / 2 ? exp2f(x - m[e / 2]) : 0.f;
        l[e / 2] += p;
        s[j][e] = p;
      }

    // O += P V, k16 step kk over keys 16 kk.. of the tile: its A fragment
    // is n8 tiles 2 kk and 2 kk + 1 of S, split hi + mid + lo, the small
    // terms first, into fresh accumulators that a float add takes into O
    // (the tensor cores truncate what they add to an accumulator, which
    // over thousands of keys drifts O by ~2^-16)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned ph[4], pm[4], pl[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pm[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pm[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pm[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pm[3], pl[3]);
#pragma unroll
      for (int dd = 0; dd < ND / 2; ++dd) {
        unsigned vf[4];
        ldsm_x4_trans(vf, sv + v_off + kk * 16 * RB + 32 * dd);
        float t[2][4] = {};
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          mma_bf16(t[n], pl, vf[2 * n], vf[2 * n + 1]);
          mma_bf16(t[n], pm, vf[2 * n], vf[2 * n + 1]);
          mma_bf16(t[n], ph, vf[2 * n], vf[2 * n + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[2 * dd + n][e] += t[n][e];
        }
        __syncwarp();  // one column pair at a time (notes above)
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (KW > 1) {
    // warps kw > 0 leave their (acc, m, l) in the ring; warp 0 of each row
    // group takes them in, each rescaled to the joint max
    float4* part = reinterpret_cast<float4*>(sKV);
    __syncthreads();  // every warp is done with the ring
    if (kw > 0) {
      float4* mine = part + (rw * (KW - 1) + kw - 1) * (ND + 1) * 32 + lane;
#pragma unroll
      for (int c = 0; c < ND; ++c)
        mine[32 * c] = make_float4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
      mine[32 * ND] = make_float4(m[0], m[1], l[0], l[1]);
    }
    __syncthreads();
    if (kw > 0) return;
#pragma unroll
    for (int j = 1; j < KW; ++j) {
      const float4* theirs =
          part + (rw * (KW - 1) + j - 1) * (ND + 1) * 32 + lane;
      const float4 ml = theirs[32 * ND];
      const float mj[2] = {ml.x, ml.y}, lj[2] = {ml.z, ml.w};
      float a[2], bj[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], mj[r]);
        a[r] = m[r] > NEG_INF / 2 ? exp2f(m[r] - m_new) : 0.f;
        bj[r] = mj[r] > NEG_INF / 2 ? exp2f(mj[r] - m_new) : 0.f;
        m[r] = m_new;
        l[r] = l[r] * a[r] + lj[r] * bj[r];
      }
#pragma unroll
      for (int c = 0; c < ND; ++c) {
        const float4 x = theirs[32 * c];
        acc[c][0] = acc[c][0] * a[0] + x.x * bj[0];
        acc[c][1] = acc[c][1] * a[0] + x.y * bj[0];
        acc[c][2] = acc[c][2] * a[1] + x.z * bj[1];
        acc[c][3] = acc[c][3] * a[1] + x.w * bj[1];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] > 0.f ? 1.f / l[r] : 0.f;
  // O / l in bf16 through this warp's own q rows, then out in 16-byte rows
  __syncwarp();
  __nv_bfloat16* sO = sQ + 16 * rw * LD;
#pragma unroll
  for (int c = 0; c < ND; ++c) {
    *reinterpret_cast<__nv_bfloat162*>(sO + gq * LD + 8 * c + 2 * tq) =
        __floats2bfloat162_rn(acc[c][0] * l[0], acc[c][1] * l[0]);
    *reinterpret_cast<__nv_bfloat162*>(sO + (gq + 8) * LD + 8 * c + 2 * tq) =
        __floats2bfloat162_rn(acc[c][2] * l[1], acc[c][3] * l[1]);
  }
  __syncwarp();
  constexpr int C = D / 8;
  for (int i = lane; i < 16 * C; i += 32) {
    const int r = i / C, c = i - r * C;
    if (w0 + r < S)
      *reinterpret_cast<uint4*>(o + (((int64_t)b * S + w0 + r) * H + h) * D +
                                8 * c) =
          *reinterpret_cast<const uint4*>(sO + r * LD + 8 * c);
  }
}

// Lets kern take `bytes` of dynamic shared memory on the current device.
// The attribute is per device: ready[dev] (one array a kernel) records
// that it was set there.
template <class Kernel>
cudaError_t allow_smem(Kernel kern, int bytes, bool (&ready)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (ready[dev] || bytes <= 48 * 1024) return cudaSuccess;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  ready[dev] = e == cudaSuccess;
  return e;
}

// the float32 instance on Tiles<D>
template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int K, int causal,
                   int window, float softcap, cudaStream_t stream) {
  constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  constexpr int SMEM = Geom<D, BQ, BK>::SMEM_BYTES;
  auto kern = flash_fwd<float, D, BQ, BK>;
  static bool ready[64] = {};
  cudaError_t e = allow_smem(kern, SMEM, ready);
  if (e != cudaSuccess) return e;
  const int n_qt = (S + BQ - 1) / BQ;
  const dim3 grid(H, B, n_qt);
  kern<<<grid, NT, SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Tk, H, K,
      1.4426950408889634f / sqrtf((float)D), causal, window, softcap, n_qt);
  return cudaGetLastError();
}

// the bfloat16 instance on MmaTiles<D>: BQ x BK warp tiles, KW warps on a
// row group's keys
template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Tk, int H, int K, int causal,
                       int window, float softcap, cudaStream_t stream) {
  constexpr int BQ = MmaTiles<D>::BQ, BK = MmaTiles<D>::BK,
                KW = MmaTiles<D>::KW;
  using G = MmaGeom<D, BQ, BK, KW>;
  auto kern = flash_fwd_mma<D, BQ, BK, KW>;
  static bool ready[64] = {};
  cudaError_t e = allow_smem(kern, G::SMEM_BYTES, ready);
  if (e != cudaSuccess) return e;
  const int n_qt = (S + BQ - 1) / BQ;
  kern<<<dim3(H, B, n_qt), G::THREADS, G::SMEM_BYTES, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S,
      Tk, H, K, 1.4426950408889634f / sqrtf((float)D), causal, window,
      softcap, n_qt);
  return cudaGetLastError();
}

// the float32 (dtype 0) or the bfloat16 instance at head dim D
template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k,
                         const void* v, void* o, int B, int S, int Tk, int H,
                         int K, int causal, int window, float softcap,
                         cudaStream_t stream) {
  if (dtype == 0)
    return launch<D>(q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
  return launch_mma<D>(q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
}

cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int Tk, int H, int K, int D, int dtype,
                     int causal, int window, float softcap,
                     cudaStream_t stream) {
  switch (D) {
    // the smoke configs (16), internvl2-1b (64), zamba2-7b's shared
    // attention block (112), llama3-8b (128), gemma2-9b (256)
    case 16: return launch_dtype<16>(dtype, q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
    case 64: return launch_dtype<64>(dtype, q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
    case 112: return launch_dtype<112>(dtype, q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
    case 128: return launch_dtype<128>(dtype, q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
    case 256: return launch_dtype<256>(dtype, q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
int plan(int dtype, int* out) {
  if (dtype == 0) {
    constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
    out[0] = BQ;
    out[1] = BK;
    out[2] = NT;
    out[3] = Geom<D, BQ, BK>::SMEM_BYTES;
  } else {
    using G = MmaGeom<D, MmaTiles<D>::BQ, MmaTiles<D>::BK, MmaTiles<D>::KW>;
    out[0] = MmaTiles<D>::BQ;
    out[1] = MmaTiles<D>::BK;
    out[2] = G::THREADS;
    out[3] = G::SMEM_BYTES;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32 (flash_fwd), 1 = bfloat16 (flash_fwd_mma).  Returns
// the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int T, int H, int K, int D, int dtype,
                                   int causal, int window, float softcap,
                                   void* stream) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  if (B <= 0 || S <= 0) return cudaSuccess;
  return dispatch(q, k, v, o, B, S, T, H, K, D, dtype, causal, window,
                  softcap, static_cast<cudaStream_t>(stream));
}

// The launch plan of head dim D for dtype (0 = float32, 1 = bfloat16):
// out = {BQ, BK, threads, dynamic shared memory bytes}.  Returns 0, or
// cudaErrorInvalidValue for another D or dtype.
extern "C" int flash_attention_plan(int D, int dtype, int* out) {
  if (dtype != 0 && dtype != 1) return cudaErrorInvalidValue;
  switch (D) {
    case 16: return plan<16>(dtype, out);
    case 64: return plan<64>(dtype, out);
    case 112: return plan<112>(dtype, out);
    case 128: return plan<128>(dtype, out);
    case 256: return plan<256>(dtype, out);
    default: return cudaErrorInvalidValue;
  }
}
