// Mamba2 SSD intra-chunk kernel for Hopper (sm_90a), f32 or bf16 in,
// f32 math and f32 out.
//
// Replaces the TPU kernel `ssd_intra_chunk` of
// src/repro/kernels/ssd_scan.py (body `_kernel`).  Per (batch, chunk,
// head), with a = -exp(A_log[h]) and cum the running sum of dt*a over
// the chunk's L steps:
//   M[t][s]  = C_t.B_s * exp(cum_t - cum_s) * dt_s   for s <= t, else 0
//   y_intra  = M @ x                                  (L, P)
//   S_loc    = sum_s exp(cum_L - cum_s) dt_s B_s (x) x_s   (N, P)
//   Lam      = exp(cum_L)                             the chunk's decay
// The inter-chunk recurrence that consumes S_loc and Lam stays outside,
// in torch, as the reference keeps it outside its Pallas call.
//
// What bounds it here: on the serving path (zamba2-7b prefill) a call is
// B = 1, nc = 1 (L = 126), 2 or 3 chunks of L = 128, H = 112 heads, P = N
// = 64.  The causal work is L(L+1)/2 (N + P) + L N P FMAs per (chunk,
// head), ~1.6 M: 0.35 GFLOP a chunk, ~5.3 us a chunk at the 67 TFLOP/s
// f32 (non-tensor-core) peak, against ~4 MB of inputs and outputs a
// chunk (~1.2 us at 3.35 TB/s).  So operations bound it.  f32 stays on
// FMA units, not TF32 tensor cores, because the port is held to the
// reference at 2e-4.
//
// What held the first design back (one 256-thread block per (chunk,
// head), ~166 KB of shared memory each): 112 blocks a chunk on 132 SMs,
// one block an SM, so 1-3 thin waves with 8 warps an SM; the whole L x L
// C.B^T computed and then masked, and M@x over all L keys for every row
// (~2.6 M FMAs per (chunk, head) for ~1.6 M of causal work); B and C
// read with t as the fastest index (256 B apart across a warp); 12
// shared loads for 32 FMAs in the y product; w_end multiplied inside the
// S_loc loop; cudaFuncSetAttribute on every launch.
//
// This design tiles the query rows.  Each (chunk, head) gets
//  * n_y = ceil(L / TR) y tiles: tile i owns rows [i TR, i TR + TR) and
//    streams keys s < min(i TR + TR, L) through shared memory in staged
//    blocks of KB = 64 (the next block's B is copied in while this
//    block's M @ x runs).  It computes C.B^T for those keys only, rounded
//    up to 16, in column chunks of 64, 32 and 16, so no block computes a
//    key block wholly above the diagonal; the diagonal tile is masked;
//  * n_s = ceil(N / NS) S_loc tiles: tile j owns state rows [j NS, j NS +
//    NS) and computes (B w_end)^T @ x over all L, both key blocks of a
//    128-step chunk requested at once, w_end folded into B in shared
//    memory once a block; tile 0 writes Lam.
// The grid is 1-D, (n_y + n_s) * H * BC blocks, tile rank outermost: the
// n_heavy heaviest y tiles of every (chunk, head), its S_loc tiles, then
// its other y tiles, heaviest first.  kernels.ops.ssd_plan picks what
// tools/kernel_sweep.py timed best at zamba2-7b's prefills: up to three
// waves (one or two chunks), one S_loc tile of all 64 state rows behind
// the two heaviest y tiles (560 blocks at one chunk of 112 heads, ~69 KB
// of shared memory, three blocks an SM); past that, two S_loc tiles of 32
// rows first (~53 KB, four blocks an SM).  A block is 128 threads at TR =
// 32, with at most 128 registers a thread.  Each block scans cum itself
// (one warp, L floats), its dt and A_log loads issued before its bulk
// copies and used only after them, so no warp waits on them first.  cum
// is kept in log2 units and the decay stays exp2(cum_t - cum_s) per
// element: cum reaches -100s over a chunk, so exp(-cum_s) alone would
// overflow.  The scan sums in float64 and stores cum relative to the
// block's last key: a float32 running sum at -100s carries an error of
// a few of its ulps into every cum_t - cum_s, 2-4x the plain version's
// distance from float64 in y_intra (tools/ssd_precision.py), while the
// pairs that weigh in y (s near t) now subtract two small numbers.  Loads put consecutive threads on consecutive n or p with
// 16-byte cp.async copies (f32) or 8-byte loads (bf16) where the rows
// allow it; shared rows are padded so that the products read them
// without bank conflicts.  The products are register tiles of 4 rows x
// 16 keys (C.B^T, float4 along n), 4 rows x 4 or 8 columns (M @ x) and 4
// or 8 state rows x 4 or 8 columns (S_loc).  Ragged L, N and P (down to
// the smoke shape L = 8, P = N = 16) are zero-padded in shared memory and
// masked on the store.
//
// Measured on an H100 (tools/kernel_sweep.py --parts ssd; PERF.md): 2.0x
// (nc = 1) to 2.5x (nc = 3) faster than the first design, 20-25 % of
// the FMA bound.  The rest is not the FMA count (a version whose warps
// skipped the diagonal's key groups above their rows moved nothing), nor
// the bytes (dropping the S_loc tiles' copies made it slower): it is
// per-warp latency and, at one chunk, the fixed start-up and tail of a
// one-wave grid (~8.5 us of ~26).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use
constexpr int TX = 16;            // threads along a tile's columns
constexpr int KB = 64;            // keys (steps) a staged block holds

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Shared-memory layout of both tile kinds (floats), shared with
// kernels.ops.ssd_layout.  Row strides: ldn = N4 + 4 and ldp = P4 + 4
// (B, C and x rows; 4 mod 32 banks when N4, P4 are multiples of 32),
// ldm = KB + 16 (M rows, 16 mod 32 banks), ldw = NS + 4.
struct Layout {
  int L16, ldn, ldp, ldm, ldw;
  __host__ __device__ Layout(int L, int P, int N, int NS)
      : L16((L + 15) / 16 * 16),
        ldn((N + 3) / 4 * 4 + 4),
        ldp((P + 3) / 4 * 4 + 4),
        ldm(KB + 16),
        ldw(NS + 4) {}
  // y tile: C [TR][ldn], B [KB][ldn], x [KB][ldp], M [TR][ldm],
  // cum [L16], dt [L16]
  __host__ __device__ int y_floats(int TR) const {
    return TR * ldn + KB * ldn + KB * ldp + TR * ldm + 2 * L16;
  }
  // S_loc tile: B w_end [2][KB][ldw], x [2][KB][ldp] (two staged key
  // blocks, all of a 128-step chunk), cum [L16], dt [L16]
  __host__ __device__ int s_floats() const {
    return 2 * (KB * ldw + KB * ldp) + 2 * L16;
  }
};

size_t smem_bytes(int L, int P, int N, int TR, int NS) {
  const Layout g(L, P, N, NS);
  const int y = g.y_floats(TR), s = g.s_floats();
  return sizeof(float) * (size_t)(y > s ? y : s);
}

// 4 consecutive elements of a row, those at index >= n_valid zero; one
// 16-byte (f32) or 8-byte (bf16) load when vec and all 4 are valid.
__device__ __forceinline__ float4 load4(const float* p, int n_valid,
                                        bool vec) {
  if (vec && n_valid >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n_valid > 0) v.x = p[0];
  if (n_valid > 1) v.y = p[1];
  if (n_valid > 2) v.z = p[2];
  if (n_valid > 3) v.w = p[3];
  return v;
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int n_valid,
                                        bool vec) {
  if (vec && n_valid >= 4) {
    const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n_valid > 0) v.x = to_f32(p[0]);
  if (n_valid > 1) v.y = to_f32(p[1]);
  if (n_valid > 2) v.z = to_f32(p[2]);
  if (n_valid > 3) v.w = to_f32(p[3]);
  return v;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// dst[r][c] (row stride ldd) = src[r * stride + c] for r < rows, c <
// cols4 (a multiple of 4), zero where r >= valid_rows or c >= valid_cols.
// Consecutive threads take consecutive 4-element groups of a row.  f32
// rows that allow 16-byte loads go by cp.async (zero-filled where
// invalid; the caller commits and waits), so every copy of the block is
// in flight at once; other rows go through registers, 8 loads in flight
// a thread before their stores.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ldd, int rows,
                                      int cols4, const T* src, size_t stride,
                                      int valid_rows, int valid_cols,
                                      bool vec) {
  const int per_row = cols4 / 4, total = rows * per_row;
  if constexpr (sizeof(T) == 4) {
    if (vec) {  // thread i takes groups i, i + blockDim.x, ...
      const int dr = blockDim.x / per_row, dq = blockDim.x - dr * per_row;
      int r = threadIdx.x / per_row, q = threadIdx.x - r * per_row;
      while (r < rows) {
        const int c = 4 * q;
        const bool ok = r < valid_rows && c < valid_cols;
        cp_async16(dst + r * ldd + c, ok ? src + r * stride + c : src, ok);
        r += dr;
        q += dq;
        if (q >= per_row) {
          q -= per_row;
          ++r;
        }
      }
      return;
    }
  }
  constexpr int BATCH = 8;
  for (int i0 = threadIdx.x; i0 < total; i0 += BATCH * blockDim.x) {
    float4 v[BATCH];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * blockDim.x;
      const int r = i / per_row, c = 4 * (i - r * per_row);
      v[b] = i < total && r < valid_rows
                 ? load4(src + r * stride + c, valid_cols - c, vec)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const int i = i0 + b * blockDim.x;
      const int r = i / per_row, c = 4 * (i - r * per_row);
      if (i < total) *reinterpret_cast<float4*>(dst + r * ldd + c) = v[b];
    }
  }
}

// With c_i = a * (dts[0] + ... + dts[i]) summed in float64, cum[i] =
// c_i - c_{n-1} for i < n <= 128 (so cum[n - 1] = 0), by warp 0; returns
// c_{n-1} to warp 0 (the kernel passes a in log2 units, so cum is too)
__device__ __forceinline__ float scan_cum(const float* dts, float* cum, int n,
                                          double a) {
  const int lane = threadIdx.x;
  if (lane >= 32) return 0.f;
  const int E = (n + 31) / 32;
  double loc[4], run = 0.0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = lane * E + e;
    run += (e < E && i < n) ? (double)dts[i] * a : 0.0;
    loc[e] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const double total = __shfl_sync(0xffffffffu, incl, 31);
  const double excl = incl - run - total;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int i = lane * E + e;
    if (e < E && i < n) cum[i] = (float)(excl + loc[e]);
  }
  return (float)total;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One column chunk of a y tile's scores: keys k0 + c for c in [c0, c0 +
// 16 RN) of the staged key block that starts at step k0 (B row c of Bb,
// M column c of Mb).  Thread (ty, tx) owns rows ty + TY i (i < 4) and
// columns c0 + tx + 16 j (j < RN); it writes M = C_t.B_s exp(cum_t -
// cum_s) dt_s for s <= t < L, else 0 (cum in log2 units, so exp2; the
// thread's cum_t, cum_s and dt_s come into registers once).  C and B
// rows are read as float4 along n: a warp reads 2 C rows (broadcast) and
// 16 consecutive B rows (ldn = 4 mod 32 banks), 12 wavefronts per 64
// FMAs at RN = 4.
template <int TY, int RN>
__device__ __forceinline__ void score_chunk(const float* Cs, const float* Bb,
                                            float* Mb, const float* cum,
                                            const float* dts, int ldn,
                                            int ldm, int N4, int t0, int L,
                                            int k0, int c0) {
  const int ty = threadIdx.x / TX, tx = threadIdx.x % TX;
  float acc[4][RN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;
  const float* Cr = Cs + ty * ldn;
  const float* Br = Bb + (c0 + tx) * ldn;
#pragma unroll 2
  for (int k = 0; k < N4; k += 4) {
    float4 a[4], b[RN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(Cr + i * TY * ldn + k);
#pragma unroll
    for (int j = 0; j < RN; ++j)
      b[j] = *reinterpret_cast<const float4*>(Br + j * TX * ldn + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = dot4(a[i], b[j], acc[i][j]);
  }
  float cs[RN], ds[RN];
#pragma unroll
  for (int j = 0; j < RN; ++j) {
    const int s = k0 + c0 + tx + TX * j;
    cs[j] = cum[s];
    ds[j] = dts[s];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + TY * i, t = t0 + r;
    const float ct = t < L ? cum[t] : 0.f;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = c0 + tx + TX * j, s = k0 + c;
      float m = 0.f;
      if (t < L && s <= t) m = acc[i][j] * exp2f(ct - cs[j]) * ds[j];
      Mb[r * ldm + c] = m;
    }
  }
}

// acc[i][4 g + c] += a[i] * xr[64 g + c]: one step of the x side of both
// products, float4 along p (16 consecutive float4 a warp row, two
// wavefronts).  ok[g]: the column group lies inside P4.
template <int RM, int PV>
__device__ __forceinline__ void x_fma(float (&acc)[RM][4 * PV],
                                      const float (&a)[RM], const float* xr,
                                      const bool (&ok)[PV]) {
#pragma unroll
  for (int g = 0; g < PV; ++g) {
    if (!ok[g]) continue;
    const float4 v = *reinterpret_cast<const float4*>(xr + 64 * g);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      acc[i][4 * g + 0] = fmaf(a[i], v.x, acc[i][4 * g + 0]);
      acc[i][4 * g + 1] = fmaf(a[i], v.y, acc[i][4 * g + 1]);
      acc[i][4 * g + 2] = fmaf(a[i], v.z, acc[i][4 * g + 2]);
      acc[i][4 * g + 3] = fmaf(a[i], v.w, acc[i][4 * g + 3]);
    }
  }
}

// out[(r0 + dr i) * ld + 4 tx + 64 g + c] = acc[i][4 g + c] for the
// thread's rows below n_rows and columns below P; float4 when vec.
template <int RM, int PV>
__device__ __forceinline__ void store_rows(float* out, size_t ld, int r0,
                                           int dr, int n_rows, int P,
                                           bool vec,
                                           const float (&acc)[RM][4 * PV]) {
  const int tx = threadIdx.x % TX;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = r0 + dr * i;
    if (r >= n_rows) continue;
#pragma unroll
    for (int g = 0; g < PV; ++g) {
      const int p = 4 * tx + 64 * g;
      float* o = out + r * ld + p;
      if (vec && p + 4 <= P) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (p + c < P) o[c] = acc[i][4 * g + c];
      }
    }
  }
}

// vec bits: which rows take vector loads / stores
constexpr int VEC_BC = 1, VEC_X = 2, VEC_OUT = 4;

// The block's dt of steps s < n (n <= 128, at least 64 threads): two
// loads a thread at most, into registers, issued before the block's bulk
// copies so that they do not queue behind them; then dts, and cum by warp
// 0, ending on a barrier.
struct DtRegs {
  float v[2];
};
template <typename T>
__device__ __forceinline__ DtRegs load_dt(const T* dt, size_t row0, int H,
                                          int h, int n) {
  DtRegs d;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int s = threadIdx.x + e * blockDim.x;
    d.v[e] = s < n ? to_f32(dt[(row0 + s) * H + h]) : 0.f;
  }
  return d;
}
// a = -exp(A_log) in log2 units, so that cum is too
__device__ __forceinline__ double dt_a(float a_log) {
  return -exp((double)a_log) * 1.4426950408889634;
}
// dts[s] = dt_s and cum (see scan_cum) for s < n; returns the chunk's
// sum of dt_s a to warp 0
__device__ __forceinline__ float scan_dt(const DtRegs& d, int n, double a,
                                         float* dts, float* cum) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int s = threadIdx.x + e * blockDim.x;
    if (s < n) dts[s] = d.v[e];
  }
  __syncthreads();
  const float total = scan_cum(dts, cum, n, a);
  __syncthreads();
  return total;
}

// TR query rows a y tile (4 TR threads: a TR/4 x 16 grid); PV float4
// column groups a thread (P <= 64 PV); RMS state rows a thread in an
// S_loc tile, NS = (TR / 4) RMS.  Registers are capped at 128 so that
// 512 threads (four TR = 32 blocks) fit on an SM; at P > 64 shared memory
// holds two blocks an SM, so the cap is 255.
template <typename T, int TR, int PV, int RMS>
__global__ void __launch_bounds__(4 * TR, (PV == 1 ? 128 : 64) / TR)
ssd_tile_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const T* __restrict__ dt,
                const float* __restrict__ A_log, float* __restrict__ y,
                float* __restrict__ s_loc, float* __restrict__ lam, int BC,
                int L, int H, int P, int N, int n_heavy, int vec) {
  constexpr int TY = TR / 4, NS = TY * RMS;
  extern __shared__ __align__(16) float smem[];
  const Layout g(L, P, N, NS);
  const int tid = threadIdx.x, ty = tid / TX, tx = tid % TX;
  const int per = BC * H, rank = blockIdx.x / per;
  const int rem = blockIdx.x - rank * per, h = rem % H, bc = rem / H;
  const int n_y = (L + TR - 1) / TR, n_s = (N + NS - 1) / NS;
  const int N4 = (N + 3) / 4 * 4, P4 = (P + 3) / 4 * 4;
  // A_log[h] is loaded here and used only at the scan, so no warp waits
  // on it before it has issued its dt loads and bulk copies
  const float a_log = A_log[h];
  const size_t row0 = (size_t)bc * L;            // the chunk's first row
  const size_t xrow = (size_t)H * P;             // x's row stride
  const T* xh = x + row0 * xrow + (size_t)h * P;  // x row 0 of head h
  const bool vbc = (vec & VEC_BC) != 0, vx = (vec & VEC_X) != 0;
  bool ok[PV];
#pragma unroll
  for (int q = 0; q < PV; ++q) ok[q] = 4 * tx + 64 * q < P4;

  if (rank >= n_heavy && rank < n_heavy + n_s) {
    // ---- S_loc tile: state rows [n0, n0 + NS) over all L steps, in
    // staged blocks of KB steps -----------------------------------------
    const int n0 = (rank - n_heavy) * NS;
    const int nblk = (L + KB - 1) / KB;
    const int sw = KB * g.ldw, sx = KB * g.ldp;   // floats a stage
    float* ws = smem;                  // [2][KB][ldw]  B, then B w_end
    float* xs = ws + 2 * sw;           // [2][KB][ldp]
    float* cum = xs + 2 * sx;          // [L16]
    float* dts = cum + g.L16;          // [L16], then w_end
    auto stage_s = [&](int kb, int buf) {
      const int k1 = kb * KB, n1 = min(KB, L - k1);
      stage(ws + buf * sw, g.ldw, n1, NS, Bm + (row0 + k1) * N + n0, N, n1,
            N - n0, vbc);
      stage(xs + buf * sx, g.ldp, n1, P4, xh + k1 * xrow, xrow, n1, P, vx);
      cp_async_commit();
    };
    const DtRegs dv = load_dt(dt, row0, H, h, L);
    stage_s(0, 0);                     // both blocks of a 128-step chunk
    if (nblk > 1) stage_s(1, 1);       // at once
    // cum is relative to step L - 1: w_end = exp2(-cum_s) dt_s
    const float total = scan_dt(dv, L, dt_a(a_log), dts, cum);
    for (int s = tid; s < L; s += blockDim.x)
      dts[s] *= exp2f(-cum[s]);
    if (n0 == 0 && tid == 0) lam[(size_t)bc * H + h] = exp2f(total);
    // thread (ty, tx): state rows n0 + RMS ty + i, columns 4 tx + 64 q
    float acc[RMS][4 * PV];
#pragma unroll
    for (int i = 0; i < RMS; ++i)
#pragma unroll
      for (int c = 0; c < 4 * PV; ++c) acc[i][c] = 0.f;
    for (int kb = 0; kb < nblk; ++kb) {
      const int k0 = kb * KB, nk = min(KB, L - k0), buf = kb % 2;
      float* wb = ws + buf * sw;
      if (kb + 1 < nblk)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();
      for (int i = tid; i < nk * NS; i += blockDim.x) {  // fold in w_end
        const int s = i / NS;
        wb[s * g.ldw + (i - s * NS)] *= dts[k0 + s];
      }
      __syncthreads();
      const float* wr = wb + RMS * ty;
      const float* xr = xs + buf * sx + 4 * tx;
#pragma unroll 4
      for (int s = 0; s < nk; ++s) {
        float w[RMS];
#pragma unroll
        for (int i = 0; i < RMS; i += 4) {
          const float4 v = *reinterpret_cast<const float4*>(wr + s * g.ldw + i);
          w[i] = v.x;
          w[i + 1] = v.y;
          w[i + 2] = v.z;
          w[i + 3] = v.w;
        }
        x_fma<RMS, PV>(acc, w, xr + s * g.ldp, ok);
      }
      if (kb + 2 < nblk) {
        __syncthreads();               // every thread is done with buf
        stage_s(kb + 2, buf);
      }
    }
    float* sb = s_loc + ((size_t)bc * H + h) * N * P + (size_t)n0 * P;
    store_rows<RMS, PV>(sb, P, RMS * ty, 1, N - n0, P,
                        (vec & VEC_OUT) != 0, acc);
    return;
  }

  // ---- y tile: rows [t0, t0 + TR), keys [0, S) in staged blocks of KB
  const int yi = rank < n_heavy ? n_y - 1 - rank : n_y - 1 - (rank - n_s);
  const int t0 = yi * TR, S = min(t0 + TR, L);
  float* Cs = smem;                        // [TR][ldn]
  float* Bb = Cs + TR * g.ldn;             // [KB][ldn]  B rows k0 + c
  float* xb = Bb + KB * g.ldn;             // [KB][ldp]  x rows k0 + c
  float* Mb = xb + KB * g.ldp;             // [TR][ldm]  M columns k0 + c
  float* cum = Mb + TR * g.ldm;            // [L16]
  float* dts = cum + g.L16;                // [L16]
  // B rows up to 16 past the block's last key (zero) feed the scores;
  // x rows up to 4 past it (zero) feed the y product
  auto stage_b = [&](int k0) {
    const int nk = min(KB, S - k0);
    stage(Bb, g.ldn, (nk + 15) / 16 * 16, N4, Bm + (row0 + k0) * N, N, nk,
          N, vbc);
  };
  auto stage_x = [&](int k0) {
    const int nk = min(KB, S - k0);
    stage(xb, g.ldp, (nk + 3) / 4 * 4, P4, xh + k0 * xrow, xrow, nk, P, vx);
  };
  const DtRegs dv = load_dt(dt, row0, H, h, S);
  stage(Cs, g.ldn, TR, N4, Cm + (row0 + t0) * N, N, L - t0, N, vbc);
  stage_b(0);
  cp_async_commit();
  stage_x(0);
  cp_async_commit();
  scan_dt(dv, S, dt_a(a_log), dts, cum);

  float acc[4][4 * PV];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * PV; ++c) acc[i][c] = 0.f;
  const float* mr = Mb + ty * g.ldm;
  const float* xr = xb + 4 * tx;
  for (int k0 = 0; k0 < S; k0 += KB) {
    const int nk = min(KB, S - k0), nk16 = (nk + 15) / 16 * 16;
    cp_async_wait<1>();                    // C and this block's B
    __syncthreads();
    // scores in column chunks of 64, 32 and 16 keys: none lies wholly
    // above the diagonal
    for (int c0 = 0; c0 < nk16;) {
      const int left = nk16 - c0;
      if (left >= 64) {
        score_chunk<TY, 4>(Cs, Bb, Mb, cum, dts, g.ldn, g.ldm, N4, t0, L, k0,
                           c0);
        c0 += 64;
      } else if (left >= 32) {
        score_chunk<TY, 2>(Cs, Bb, Mb, cum, dts, g.ldn, g.ldm, N4, t0, L, k0,
                           c0);
        c0 += 32;
      } else {
        score_chunk<TY, 1>(Cs, Bb, Mb, cum, dts, g.ldn, g.ldm, N4, t0, L, k0,
                           c0);
        c0 += 16;
      }
    }
    cp_async_wait<0>();                    // this block's x
    __syncthreads();
    const bool more = k0 + KB < S;
    if (more) {                            // the next B lands meanwhile
      stage_b(k0 + KB);
      cp_async_commit();
    }
    // y += M @ x over the block's keys: thread rows ty + TY i, columns
    // 4 tx + 64 q; M read as float4 along s (2 rows a warp, ldm = 16 mod
    // 32 banks)
#pragma unroll 2
    for (int c = 0; c < nk; c += 4) {
      float4 m[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        m[i] = *reinterpret_cast<const float4*>(mr + i * TY * g.ldm + c);
      float m0[4], m1[4], m2[4], m3[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        m0[i] = m[i].x;
        m1[i] = m[i].y;
        m2[i] = m[i].z;
        m3[i] = m[i].w;
      }
      x_fma<4, PV>(acc, m0, xr + (c + 0) * g.ldp, ok);
      x_fma<4, PV>(acc, m1, xr + (c + 1) * g.ldp, ok);
      x_fma<4, PV>(acc, m2, xr + (c + 2) * g.ldp, ok);
      x_fma<4, PV>(acc, m3, xr + (c + 3) * g.ldp, ok);
    }
    if (more) {
      __syncthreads();                     // every thread is done with xb
      stage_x(k0 + KB);
      cp_async_commit();
    }
  }
  float* yb = y + (row0 + t0) * xrow + (size_t)h * P;
  store_rows<4, PV>(yb, xrow, ty, TY, S - t0, P, (vec & VEC_OUT) != 0, acc);
}

// Dynamic shared memory up to the block limit and the largest shared
// carveout (three or four blocks an SM), set once per instantiation on
// each device.
template <typename T, int TR, int PV, int RMS>
cudaError_t configure() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  auto kern = ssd_tile_kernel<T, TR, PV, RMS>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           MAX_SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(kern,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  ready[dev] = true;
  return cudaSuccess;
}

struct Args {
  const void *x, *Bm, *Cm, *dt;
  const float* A_log;
  float *y, *s_loc, *lam;
  int BC, L, H, P, N, n_heavy, vec, smem;
  cudaStream_t stream;
};

template <typename T, int TR, int PV, int RMS>
cudaError_t launch(const Args& a) {
  cudaError_t e = configure<T, TR, PV, RMS>();
  if (e != cudaSuccess) return e;
  constexpr int NS = TR / 4 * RMS;
  const int tiles = (a.L + TR - 1) / TR + (a.N + NS - 1) / NS;
  ssd_tile_kernel<T, TR, PV, RMS>
      <<<tiles * a.BC * a.H, 4 * TR, a.smem, a.stream>>>(
          static_cast<const T*>(a.x), static_cast<const T*>(a.Bm),
          static_cast<const T*>(a.Cm), static_cast<const T*>(a.dt), a.A_log,
          a.y, a.s_loc, a.lam, a.BC, a.L, a.H, a.P, a.N, a.n_heavy, a.vec);
  return cudaGetLastError();
}

// The instances: TR = 32 (the planner's) with both S_loc splits, P <= 64
// and <= 128, both dtypes; TR = 16 and 64 for f32, P <= 64 (experiments).
template <typename T, int TR, int PV>
cudaError_t by_rms(const Args& a, int RMS) {
  switch (RMS) {
    case 4: return launch<T, TR, PV, 4>(a);
    case 8: return launch<T, TR, PV, 8>(a);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const Args& a, int TR, int RMS) {
  const bool wide = a.P > 64;
  if (TR == 32)
    return wide ? by_rms<T, 32, 2>(a, RMS) : by_rms<T, 32, 1>(a, RMS);
  if constexpr (sizeof(T) == 4) {
    if (!wide && TR == 16) return by_rms<T, 16, 1>(a, RMS);
    if (!wide && TR == 64) return by_rms<T, 64, 1>(a, RMS);
  }
  return cudaErrorInvalidValue;
}

// A plan the kernel takes: L, P, N in [1, 128], TR in {16, 32, 64}, NS =
// TR / 4 * RMS with RMS in {4, 8}; the RMS it implies, or 0.
int plan_rms(int L, int P, int N, int TR, int NS) {
  if (L < 1 || L > 128 || P < 1 || P > 128 || N < 1 || N > 128) return 0;
  if (TR != 16 && TR != 32 && TR != 64) return 0;
  const int TY = TR / 4;
  if (NS % TY) return 0;
  const int rms = NS / TY;
  if (rms != 4 && rms != 8) return 0;
  if (smem_bytes(L, P, N, TR, NS) > (size_t)MAX_SMEM) return 0;
  return rms;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// x (BC, L, H, P), Bm/Cm (BC, L, N), dt (BC, L, H) with BC = batch *
// chunks, all contiguous; A_log (H,) f32.  Outputs, f32: y (BC, L, H,
// P), s_loc (BC, H, N, P), lam (BC, H).  The plan (kernels.ops.ssd_plan):
// TR query rows a y tile, NS state rows an S_loc tile, n_heavy y tiles
// before the S_loc tiles in the grid, threads and dynamic shared bytes a
// block (checked against the kernel's own).  dtype: 0 = float32, 1 =
// bfloat16.  Returns the launch's cudaError_t.
extern "C" int ssd_intra_chunk_fwd(const void* x, const void* Bm,
                                   const void* Cm, const void* dt,
                                   const void* A_log, void* y, void* s_loc,
                                   void* lam, int BC, int L, int H, int P,
                                   int N, int TR, int NS, int n_heavy,
                                   int threads, int smem, int dtype,
                                   void* stream) {
  if (BC <= 0 || H <= 0) return cudaSuccess;
  const int rms = plan_rms(L, P, N, TR, NS);
  if (!rms || threads != 4 * TR || n_heavy < 0 ||
      n_heavy > (L + TR - 1) / TR ||
      (size_t)smem != smem_bytes(L, P, N, TR, NS))
    return cudaErrorInvalidValue;
  const int el = dtype == 0 ? 16 : 8;   // bytes of one 4-element load
  Args a{x, Bm, Cm, dt, static_cast<const float*>(A_log),
         static_cast<float*>(y), static_cast<float*>(s_loc),
         static_cast<float*>(lam), BC, L, H, P, N, n_heavy, 0, smem,
         static_cast<cudaStream_t>(stream)};
  if (N % 4 == 0 && aligned(Bm, el) && aligned(Cm, el)) a.vec |= VEC_BC;
  if (P % 4 == 0 && aligned(x, el)) a.vec |= VEC_X;
  if (P % 4 == 0 && aligned(y, 16) && aligned(s_loc, 16)) a.vec |= VEC_OUT;
  if (dtype == 0) return dispatch<float>(a, TR, rms);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, TR, rms);
  return cudaErrorInvalidValue;
}

// A plan on this card: out[0] its dynamic shared-memory bytes, out[1]
// its threads a block, out[2] how many such blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, f32 instance).
extern "C" int ssd_intra_chunk_info(int L, int P, int N, int TR, int NS,
                                    int* out) {
  const int rms = plan_rms(L, P, N, TR, NS);
  if (!rms || (TR != 32 && P > 64)) return cudaErrorInvalidValue;
  const int smem = (int)smem_bytes(L, P, N, TR, NS);
  int n = 0;
  cudaError_t e = cudaErrorInvalidValue;
#define SSD_OCC(TR_, PV_, RMS_)                                              \
  if (TR == TR_ && (P > 64 ? 2 : 1) == PV_ && rms == RMS_) {                 \
    e = configure<float, TR_, PV_, RMS_>();                                  \
    if (e == cudaSuccess)                                                    \
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                     \
          &n, ssd_tile_kernel<float, TR_, PV_, RMS_>, 4 * TR_, smem);        \
  }
  SSD_OCC(32, 1, 4) SSD_OCC(32, 1, 8) SSD_OCC(32, 2, 4) SSD_OCC(32, 2, 8)
  SSD_OCC(16, 1, 4) SSD_OCC(16, 1, 8) SSD_OCC(64, 1, 4) SSD_OCC(64, 1, 8)
#undef SSD_OCC
  if (e != cudaSuccess) return e;
  out[0] = smem;
  out[1] = 4 * TR;
  out[2] = n;
  return cudaSuccess;
}
