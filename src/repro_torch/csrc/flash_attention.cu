// Flash attention forward for Hopper (sm_90a), f32 or bf16 in, f32 math.
//
// Replaces the TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (body `_kernel`): streaming-softmax
// attention of q (B,S,H,D) over k/v (B,T,K,D), H % K == 0 (GQA: q-head h
// reads kv-head h / (H/K)), with causal masking, an optional sliding
// window, an optional tanh logit softcap, and the rule that a row with
// every key masked gives 0.  Positions are the trivial arange on both
// sides, as in the TPU kernel.
//
// What bounds it here: on the internvl2-1b path this is batch-1 prefill
// of ~270 tokens at H=14, K=2, D=64 in f32 — about 0.26 GFLOP and ~1 MB of
// q/k/v/o.  The bytes take ~0.3 us at 3.35 TB/s and the FLOPs ~4 us at
// the 67 TFLOP/s f32 (non-tensor-core) peak, so the bound is operations;
// in practice launch latency and the few dozen blocks a 270-token
// sequence yields leave most SMs idle.  f32 stays on FMA units, not TF32
// tensor cores, because the port is held to the reference at 2e-4.
//
// Design: one block per (q-tile of BQ rows, q-head, batch), one thread
// per query row.  The thread keeps its q row and its output accumulator
// in registers and the running max m / sum l as scalars.  KV tiles of BK
// keys are staged through shared memory as f32 (loaded once per block,
// read by all BQ threads as broadcasts); each thread writes its BK
// scores to a [BK][BQ] shared column (conflict-free), takes the tile max,
// rescales its accumulator once per tile and accumulates p * v.  The KV
// loop starts at the first tile a windowed row can see and stops after
// the causal diagonal of the tile's last row, so tiles wholly above the
// diagonal are never loaded.  The ragged last q-tile and kv-tile are
// masked here (S and T need not be multiples of anything).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int BQ = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(BQ)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int S, int Tk, int H,
          int K, float scale, int causal, int window, float softcap) {
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  __shared__ float ss[BK][BQ];

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int row = q0 + tid;
  const bool active = row < S;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = active ? to_f32(q[((size_t)(b * S + row) * H + h) * D + d]) : 0.f;
    acc[d] = 0.f;
  }
  float m = NEG_INF;
  float l = 0.f;

  // keys this q-tile can see: [kv_begin, kv_end)
  const int q_last = min(S, q0 + BQ) - 1;
  int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  kv_begin = (kv_begin / BK) * BK;

  for (int t0 = kv_begin; t0 < kv_end; t0 += BK) {
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < BK * D; i += BQ) {
      const int r = i / D, c = i - r * D;
      const int t = t0 + r;
      float kx = 0.f, vx = 0.f;
      if (t < Tk) {
        const size_t off = ((size_t)(b * Tk + t) * K + kh) * D + c;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      ks[r][c] = kx;
      vs[r][c] = vx;
    }
    __syncthreads();

    float mt = NEG_INF;
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const int t = t0 + j;
      const bool ok = active && t < Tk && (!causal || t <= row) &&
                      (window <= 0 || t > row - window);
      float s = NEG_INF;
      if (ok) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
        s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      ss[j][tid] = s;
      mt = fmaxf(mt, s);
    }

    const float m_new = fmaxf(m, mt);
    const float alpha = m > NEG_INF / 2 ? expf(m - m_new) : 0.f;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float s = ss[j][tid];
      const float p = s > NEG_INF / 2 ? expf(s - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (active) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    T* out = o + ((size_t)(b * S + row) * H + h) * D;
#pragma unroll
    for (int d = 0; d < D; ++d) store(out + d, acc[d] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int S, int Tk, int H, int K, int causal,
                   int window, float softcap, cudaStream_t stream) {
  constexpr int BK = D == 16 ? 64 : 32;  // 24-37 KB of shared memory
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale = 1.f / sqrtf((float)D);
  flash_fwd<T, D, BK><<<grid, BQ, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, Tk, H, K, scale,
      causal, window, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int Tk, int H, int K, int D, int causal,
                     int window, float softcap, cudaStream_t stream) {
  switch (D) {
    // the smoke configs (16), internvl2-1b (64), zamba2-7b's shared
    // attention block (112: qr and acc alone are 224 registers a thread,
    // so this instance spills to local memory)
    case 16: return launch<T, 16>(q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
    case 112: return launch<T, 112>(q, k, v, o, B, S, Tk, H, K, causal, window, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
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
