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
// What bounds it here: on the serving path (zamba2-7b prefill) a call
// is B=1, nc=3 chunks of L=128, H=112 heads, P=64, N=64.  The three
// products (C.B^T, M@x, B^T@x) are ~2.5 M FMAs per (chunk, head), about
// 1.7 GFLOP in all: ~26 us at the 67 TFLOP/s f32 (non-tensor-core)
// peak, against ~12 MB of inputs and outputs (~4 us at 3.35 TB/s).  So
// the bound is operations.  f32 stays on FMA units, not TF32 tensor
// cores, because the port is held to the reference at 2e-4.
//
// Design: one block of 256 threads per (batch*chunk, head), the TPU
// grid.  The block stages x (L,P), B^T and C^T (N,L) as f32 in dynamic
// shared memory (~166 KB at the path shape, above the 48 KB static
// limit, so the launch raises the block's limit with
// cudaFuncSetAttribute), one warp scans cum, and the whole (L,L) score
// tile M is built in shared memory, decay and causal mask applied as it
// is written.  Each product is a register-tiled loop: the 256 threads
// form a 16x16 grid and each owns a strided (up to 8x8) patch of the
// output, so one shared-memory load feeds up to 8 FMAs.  Ragged sizes
// (L, N, P up to 128, not multiples of 16) are masked in the loops.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;           // threads per block, a 16 x 16 grid
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// out[r][c] = sum_k a_at(k, r) * b_at(k, c) for r < ni, c < nj; thread
// (ty, tx) of the 16x16 grid owns rows ty + 16 i and columns tx + 16 j.
template <int TI, int TJ, class FA, class FB, class FO>
__device__ __forceinline__ void tile_product(int ni, int nj, int nk,
                                             FA a_at, FB b_at, FO emit) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[TI][TJ];
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < nk; ++k) {
    float a[TI], b[TJ];
#pragma unroll
    for (int i = 0; i < TI; ++i) {
      const int r = ty + 16 * i;
      a[i] = r < ni ? a_at(k, r) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const int c = tx + 16 * j;
      b[j] = c < nj ? b_at(k, c) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < TI; ++i)
#pragma unroll
      for (int j = 0; j < TJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TI; ++i)
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
      const int r = ty + 16 * i, c = tx + 16 * j;
      if (r < ni && c < nj) emit(r, c, acc[i][j]);
    }
}

size_t smem_bytes(int L, int P, int N) {
  // x (L,P), B^T and C^T (N,L), M (L, L+1), cum / dt / w_end (L)
  return sizeof(float) *
         ((size_t)L * P + 2 * (size_t)N * L + (size_t)L * (L + 1) + 3 * L);
}

// TNP: 16-wide tiles over N and P (4 for N, P <= 64; 8 up to 128).
template <typename T, int TNP>
__global__ void __launch_bounds__(NT)
ssd_intra_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, const T* __restrict__ dt,
                 const float* __restrict__ A_log, float* __restrict__ y,
                 float* __restrict__ s_loc, float* __restrict__ lam, int L,
                 int H, int P, int N) {
  extern __shared__ float smem[];
  const int bc = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int LD = L + 1;               // padded row of M
  float* xs = smem;                   // [L][P]
  float* bT = xs + L * P;             // [N][L]
  float* cT = bT + N * L;             // [N][L]
  float* Ms = cT + N * L;             // [L][LD]
  float* cum = Ms + L * LD;           // [L]
  float* dts = cum + L;               // [L]
  float* wend = dts + L;              // [L]

  const float a = -expf(A_log[h]);
  for (int i = tid; i < L * P; i += NT) {
    const int t = i / P, p = i - t * P;
    xs[i] = to_f32(x[((size_t)(bc * L + t) * H + h) * P + p]);
  }
  for (int i = tid; i < N * L; i += NT) {
    const int n = i / L, t = i - n * L;  // t fastest: conflict-free stores
    const size_t g = (size_t)(bc * L + t) * N + n;
    bT[i] = to_f32(Bm[g]);
    cT[i] = to_f32(Cm[g]);
  }
  for (int t = tid; t < L; t += NT)
    dts[t] = to_f32(dt[(size_t)(bc * L + t) * H + h]);
  __syncthreads();

  if (tid < 32) {  // one warp: inclusive scan of dt*a, 4 steps a lane
    const int E = (L + 31) / 32;
    float loc[4], run = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = tid * E + e;
      run += (e < E && i < L) ? dts[i] * a : 0.f;
      loc[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, o);
      if (tid >= o) incl += up;
    }
    const float excl = incl - run;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = tid * E + e;
      if (e < E && i < L) cum[i] = excl + loc[e];
    }
  }
  __syncthreads();
  for (int s = tid; s < L; s += NT)
    wend[s] = expf(cum[L - 1] - cum[s]) * dts[s];
  if (tid == 0) lam[(size_t)bc * H + h] = expf(cum[L - 1]);

  // M[t][s] = C_t.B_s exp(cum_t - cum_s) dt_s, causal
  tile_product<8, 8>(
      L, L, N, [&](int n, int t) { return cT[n * L + t]; },
      [&](int n, int s) { return bT[n * L + s]; },
      [&](int t, int s, float g) {
        Ms[t * LD + s] = s <= t ? g * expf(cum[t] - cum[s]) * dts[s] : 0.f;
      });
  __syncthreads();

  // y_intra = M @ x, written as (B, nc, L, H, P)
  float* yb = y + (size_t)bc * L * H * P + (size_t)h * P;
  tile_product<8, TNP>(
      L, P, L, [&](int s, int t) { return Ms[t * LD + s]; },
      [&](int s, int p) { return xs[s * P + p]; },
      [&](int t, int p, float v) { yb[(size_t)t * H * P + p] = v; });

  // S_loc = (B * w_end)^T @ x, written as (B, nc, H, N, P)
  float* sb = s_loc + ((size_t)bc * H + h) * N * P;
  tile_product<TNP, TNP>(
      N, P, L, [&](int s, int n) { return bT[n * L + s] * wend[s]; },
      [&](int s, int p) { return xs[s * P + p]; },
      [&](int n, int p, float v) { sb[n * P + p] = v; });
}

template <typename T, int TNP>
cudaError_t launch(const void* x, const void* Bm, const void* Cm,
                   const void* dt, const float* A_log, float* y,
                   float* s_loc, float* lam, int BC, int L, int H, int P,
                   int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(L, P, N);
  if (smem > MAX_SMEM) return cudaErrorInvalidConfiguration;
  auto kern = ssd_intra_kernel<T, TNP>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(BC, H), NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const T*>(dt), A_log, y, s_loc,
      lam, L, H, P, N);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* Bm, const void* Cm,
                     const void* dt, const float* A_log, float* y,
                     float* s_loc, float* lam, int BC, int L, int H, int P,
                     int N, cudaStream_t stream) {
  if (L < 1 || L > 128 || P < 1 || P > 128 || N < 1 || N > 128)
    return cudaErrorInvalidValue;
  if (P <= 64 && N <= 64)
    return launch<T, 4>(x, Bm, Cm, dt, A_log, y, s_loc, lam, BC, L, H, P, N,
                        stream);
  return launch<T, 8>(x, Bm, Cm, dt, A_log, y, s_loc, lam, BC, L, H, P, N,
                      stream);
}

}  // namespace

// x (BC, L, H, P), Bm/Cm (BC, L, N), dt (BC, L, H) with BC = batch *
// chunks, all contiguous; A_log (H,) f32.  Outputs, f32: y (BC, L, H,
// P), s_loc (BC, H, N, P), lam (BC, H).  dtype: 0 = float32, 1 =
// bfloat16.  Returns the launch's cudaError_t.
extern "C" int ssd_intra_chunk_fwd(const void* x, const void* Bm,
                                   const void* Cm, const void* dt,
                                   const void* A_log, void* y, void* s_loc,
                                   void* lam, int BC, int L, int H, int P,
                                   int N, int dtype, void* stream) {
  if (BC <= 0 || H <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* al = static_cast<const float*>(A_log);
  float* yo = static_cast<float*>(y);
  float* so = static_cast<float*>(s_loc);
  float* lo = static_cast<float*>(lam);
  if (dtype == 0)
    return dispatch<float>(x, Bm, Cm, dt, al, yo, so, lo, BC, L, H, P, N, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, Bm, Cm, dt, al, yo, so, lo, BC, L, H, P,
                                   N, s);
  return cudaErrorInvalidValue;
}
