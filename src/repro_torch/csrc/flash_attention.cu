// Flash attention forward for Hopper (sm_90a), f32 or bf16 in, f32 math.
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
// Design (it replaces a one-thread-per-row kernel whose every score was a
// chain of D dependent FMAs, each waiting on a shared-memory load, on 2-warp
// blocks too few to fill the card):
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
//   would halve the blocks an SM holds).  bf16 inputs are widened to f32
//   as they are staged (8-byte loads, not cp.async).  Rows are padded by 4
//   floats so that the float4 reads of 8 lanes fall in 8 distinct bank
//   groups.
// * The grid is (H, B, q-tiles) with the q-tile slowest, and under a
//   causal mask the heaviest q-tiles (the last rows) are launched first.
//   Tiles per head dim were chosen on an H100 among 16-64 rows x 32-64
//   keys: D = 64 takes 16 x 64 (238 blocks at internvl2-1b), D = 112
//   32 x 64 (384 blocks at zamba2-7b); 64-row tiles left the causal
//   grid unbalanced.  D = 128 and 256 (llama3-8b, gemma2-9b) were timed
//   by tools/kernel_sweep.py --parts flash at a 4,100-token prefill (H =
//   32 / 16, K = 8; NVIDIA H100 80GB HBM3, 700 W): D = 128 takes 64 x 32
//   (4.26 ms; 32 x 64 4.46, 32 x 32 4.47, 16 x 64 5.68), D = 256 32 x 32
//   (4.87 ms, 104 KB, two blocks an SM; 16 x 32 6.25, 32 x 64 6.29 at
//   176 KB and one block, 16 x 64 7.57).  At D = 256 a thread holds 4
//   rows x 16 output columns of P.V.  KV tiles wholly outside the causal diagonal or the
//   window are never loaded; ragged S and T are masked in the kernel.
// * ptxas (sm_90a, CUDA 12.8), f32: D = 256 and 128 168 registers, D =
//   112 168, D = 64 80, D = 16 128; no instance spills (chip_smoke.py
//   prints these lines).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int NT = 128;  // threads per block
constexpr int RQ = 4;    // q rows per thread

// q rows and keys per tile, by head dim (tools/kernel_sweep.py --parts
// flash builds copies of this file with other values on these lines)
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
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
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
template <int D, int LD>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const __nv_bfloat16* src,
                                           int64_t stride, int n_rows,
                                           int valid) {
  constexpr int C = D / 4;
  for (int i = threadIdx.x; i < n_rows * C; i += NT) {
    const int r = i / C, c = i - r * C;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      const uint2 raw = *reinterpret_cast<const uint2*>(src + r * stride + 4 * c);
      x = make_float4(__uint_as_float(raw.x << 16),
                      __uint_as_float(raw.x & 0xffff0000u),
                      __uint_as_float(raw.y << 16),
                      __uint_as_float(raw.y & 0xffff0000u));
    }
    *reinterpret_cast<float4*>(dst + r * LD + 4 * c) = x;
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

template <class Kernel>
cudaError_t allow_smem(Kernel kern, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

// BQ x BK tiles: Tiles<D>'s, unless an experiment names others
template <typename T, int D, int BQ = Tiles<D>::BQ, int BK = Tiles<D>::BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int K, int causal,
                   int window, float softcap, cudaStream_t stream) {
  constexpr int SMEM = Geom<D, BQ, BK>::SMEM_BYTES;
  auto kern = flash_fwd<T, D, BQ, BK>;
  // the attribute is per device: set it once on each
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    e = allow_smem(kern, SMEM);
    if (e != cudaSuccess) return e;
    ready[dev] = true;
  }
  const int n_qt = (S + BQ - 1) / BQ;
  const dim3 grid(H, B, n_qt);
  kern<<<grid, NT, SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, K,
      1.4426950408889634f / sqrtf((float)D), causal, window, softcap, n_qt);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int Tk, int H, int K, int D, int causal,
                     int window, float softcap, cudaStream_t stream) {
  switch (D) {
    // the smoke configs (16), internvl2-1b (64), zamba2-7b's shared
    // attention block (112), llama3-8b (128), gemma2-9b (256)
    case 16: return launch<T, 16>(q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
    case 112: return launch<T, 112>(q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <int D>
int plan(int* out) {
  constexpr int BQ = Tiles<D>::BQ, BK = Tiles<D>::BK;
  out[0] = BQ;
  out[1] = BK;
  out[2] = NT;
  out[3] = Geom<D, BQ, BK>::SMEM_BYTES;
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* o, int B, int S,
                                   int T, int H, int K, int D, int dtype,
                                   int causal, int window, float softcap,
                                   void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, B, S, T, H, K, D, causal, window, softcap, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, S, T, H, K, D, causal, window, softcap, s);
  return cudaErrorInvalidValue;
}

// The launch plan of head dim D: out = {BQ, BK, threads, dynamic shared
// memory bytes}.  Returns 0, or cudaErrorInvalidValue for another D.
extern "C" int flash_attention_plan(int D, int* out) {
  switch (D) {
    case 16: return plan<16>(out);
    case 64: return plan<64>(out);
    case 112: return plan<112>(out);
    case 128: return plan<128>(out);
    case 256: return plan<256>(out);
    default: return cudaErrorInvalidValue;
  }
}
