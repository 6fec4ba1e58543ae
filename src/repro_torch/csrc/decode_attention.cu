// Single-query decode attention for Hopper (sm_90a): a contiguous KV
// cache and a paged one, sharing one device function.
//
// Replaces two TPU kernels:
//   * `decode_attention` of src/repro/kernels/decode_attention.py (body
//     `_kernel`): one query per row over a (B,T,K,D) cache, keys at or
//     past lengths[b] masked;
//   * `paged_decode_attention` of src/repro/kernels/paged_decode_attention.py
//     (body `_kernel`): the same over a global page pool (P,ps,K,D) with
//     per-row block tables (B,n_max); table entries are clamped into
//     [0, P-1] and keys at or past lengths[b] are masked.
// Both: q (B,H,D), H % K == 0, optional tanh softcap applied before the
// mask, f32 running max / sum / accumulator, a row with no key gives 0.
//
// What bounds it here: each call reads every live key and value once —
// on the serving path B=4 rows of ~300 keys, K=2, D=64 in f32, about
// 1.2 MB, well under a microsecond at 3.35 TB/s.  The FLOPs (2*H*D per
// key and side) are smaller still.  So the bound is bytes, and at these
// sizes launch latency dominates whatever the kernel does.
//
// Design: one block per (kv-head, row, group of up to NW q-heads).  The
// TPU grid (B*H, n_max) reads each page once per q-head; here the whole
// block stages a tile of TK keys and values into shared memory once and
// every warp (one per q-head of the GQA group, G = H/K; G = 7 on
// internvl2-1b, so warp NW-1 idles behind a bound check) attends its
// q-head over the staged tile.  Lanes map over keys: each lane keeps its
// own running max / sum / D-wide accumulator over the keys it saw, and
// the 32 partial states merge with warp shuffles at the end (flash-
// decoding within the warp).  Shared rows are padded to D+1 floats so
// lanes reading 32 different keys hit 32 different banks.  The paged
// variant resolves each tile row's page from the block table (clamped)
// before the tile load.  The loop stops at min(length, cache span), so
// pages past a row's length are never read.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int NW = 8;  // warps per block = q-heads served per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
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
  int b, Tk, K, kh, D;
  __device__ int64_t operator()(int t) const {
    return ((int64_t)(b * Tk + t) * K + kh) * D;
  }
};

// Paged cache: key t lives in page tables[b, t / ps] (clamped), slot t % ps.
struct PagedAddr {
  const int* table;  // this row's block-table entries
  int P, ps, K, kh, D;
  __device__ int64_t operator()(int t) const {
    int page = table[t / ps];
    page = min(max(page, 0), P - 1);
    return ((int64_t)page * ps + t % ps) * K * D + (int64_t)kh * D;
  }
};

// One block: q-heads [h_base, h_base + NW) of kv-head kh in row b, over
// keys [0, n_keys).  `addr(t)` gives the element offset of key t.
template <typename T, int D, int TK, class Addr>
__device__ void decode_block(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ o,
                             int b, int H, int G, int kh, int h_base,
                             int n_keys, float scale, float softcap,
                             const Addr& addr) {
  constexpr int DP = D + 1;  // padded shared row
  constexpr int KPL = TK / 32;  // keys per lane per tile
  __shared__ float ks[TK * DP];
  __shared__ float vs[TK * DP];
  __shared__ float qs[NW][D];
  __shared__ int64_t row_off[TK];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = h_base + warp;         // q-head within the GQA group
  const bool head_ok = g < G;
  const int h = kh * G + g;

  for (int i = tid; i < NW * D; i += blockDim.x) {
    const int w = i / D, d = i - w * D;
    const int gg = h_base + w;
    qs[w][d] = gg < G ? to_f32(q[((int64_t)b * H + kh * G + gg) * D + d])
                      : 0.f;
  }

  float m = NEG_INF, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int t0 = 0; t0 < n_keys; t0 += TK) {
    __syncthreads();  // previous tile consumed; qs visible
    if (tid < TK) row_off[tid] = t0 + tid < n_keys ? addr(t0 + tid) : -1;
    __syncthreads();
    for (int i = tid; i < TK * D; i += blockDim.x) {
      const int r = i / D, c = i - r * D;
      const int64_t off = row_off[r];
      ks[r * DP + c] = off >= 0 ? to_f32(k[off + c]) : 0.f;
      vs[r * DP + c] = off >= 0 ? to_f32(v[off + c]) : 0.f;
    }
    __syncthreads();
    if (!head_ok) continue;

    float s[KPL];
    float mt = NEG_INF;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int r = lane + 32 * i;
      s[i] = NEG_INF;
      if (t0 + r < n_keys) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qs[warp][d], ks[r * DP + d], dot);
        float x = dot * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i] = x;
      }
      mt = fmaxf(mt, s[i]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = m > NEG_INF / 2 ? expf(m - m_new) : 0.f;
    l *= alpha;
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] *= alpha;
#pragma unroll
    for (int i = 0; i < KPL; ++i) {
      const int r = lane + 32 * i;
      const float p = s[i] > NEG_INF / 2 ? expf(s[i] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[r * DP + d], acc[d]);
    }
    m = m_new;
  }
  if (!head_ok) return;

  // merge the 32 lane-partial softmax states
  const float m_all = warp_max(m);
  const float w = m > NEG_INF / 2 ? expf(m - m_all) : 0.f;
  const float l_all = warp_sum(l * w);
  const float inv = 1.f / fmaxf(l_all, 1e-30f);
  T* out = o + ((int64_t)b * H + h) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float x = warp_sum(acc[d] * w);
    if ((d & 31) == lane) store(out + d, x * inv);
  }
}

template <typename T, int D, int TK>
__global__ void __launch_bounds__(NW * 32)
decode_fwd(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ lengths,
           T* __restrict__ o, int H, int K, int Tk, float scale,
           float softcap) {
  const int kh = blockIdx.x, b = blockIdx.y, h_base = blockIdx.z * NW;
  const int G = H / K;
  const int n_keys = min(max(lengths[b], 0), Tk);
  decode_block<T, D, TK>(q, k, v, o, b, H, G, kh, h_base, n_keys, scale,
                         softcap, ContigAddr{b, Tk, K, kh, D});
}

template <typename T, int D, int TK>
__global__ void __launch_bounds__(NW * 32)
paged_decode_fwd(const T* __restrict__ q, const T* __restrict__ kp,
                 const T* __restrict__ vp, const int* __restrict__ tables,
                 const int* __restrict__ lengths, T* __restrict__ o, int H,
                 int K, int P, int ps, int n_max, float scale,
                 float softcap) {
  const int kh = blockIdx.x, b = blockIdx.y, h_base = blockIdx.z * NW;
  const int G = H / K;
  const int n_keys = min(max(lengths[b], 0), n_max * ps);
  decode_block<T, D, TK>(
      q, kp, vp, o, b, H, G, kh, h_base, n_keys, scale, softcap,
      PagedAddr{tables + (int64_t)b * n_max, P, ps, K, kh, D});
}

// keys per staged tile: 64 (2 per lane, ~35 KB of shared memory at
// D=64); 32 above D=64, where 64 keys of k and v (58 KB at D=112) would
// pass the 48 KB static shared-memory limit
template <int D>
constexpr int tile_keys() { return D > 64 ? 32 : 64; }

dim3 grid_for(int B, int H, int K) {
  const int G = H / K;
  return dim3(K, B, (G + NW - 1) / NW);
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* lengths, void* o, int B, int H, int K,
                          int Tk, float softcap, cudaStream_t stream) {
  decode_fwd<T, D, tile_keys<D>()><<<grid_for(B, H, K), NW * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), H, K, Tk,
      1.f / sqrtf((float)D), softcap);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp,
                         const int* tables, const int* lengths, void* o,
                         int B, int H, int K, int P, int ps, int n_max,
                         float softcap, cudaStream_t stream) {
  paged_decode_fwd<T, D, tile_keys<D>()>
      <<<grid_for(B, H, K), NW * 32, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(kp),
          static_cast<const T*>(vp), tables, lengths, static_cast<T*>(o), H,
          K, P, ps, n_max, 1.f / sqrtf((float)D), softcap);
  return cudaGetLastError();
}

// head dims: the smoke configs (16), internvl2-1b (64), zamba2-7b (112)
#define DISPATCH_D(D_, FN, T_, ...)                        \
  switch (D_) {                                            \
    case 16: return FN<T_, 16>(__VA_ARGS__);               \
    case 64: return FN<T_, 64>(__VA_ARGS__);               \
    case 112: return FN<T_, 112>(__VA_ARGS__);             \
    default: return cudaErrorInvalidValue;                 \
  }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int decode_attention_fwd(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int B, int H, int K, int D,
                                    int T, int dtype, float softcap,
                                    void* stream) {
  if (B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == 0) {
    DISPATCH_D(D, launch_decode, float, q, k, v, len, o, B, H, K, T, softcap, s)
  }
  if (dtype == 1) {
    DISPATCH_D(D, launch_decode, __nv_bfloat16, q, k, v, len, o, B, H, K, T,
               softcap, s)
  }
  return cudaErrorInvalidValue;
}

extern "C" int paged_decode_attention_fwd(const void* q, const void* kp,
                                          const void* vp, const void* tables,
                                          const void* lengths, void* o,
                                          int B, int H, int K, int D, int P,
                                          int ps, int n_max, int dtype,
                                          float softcap, void* stream) {
  if (B <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* len = static_cast<const int*>(lengths);
  if (dtype == 0) {
    DISPATCH_D(D, launch_paged, float, q, kp, vp, tbl, len, o, B, H, K, P, ps,
               n_max, softcap, s)
  }
  if (dtype == 1) {
    DISPATCH_D(D, launch_paged, __nv_bfloat16, q, kp, vp, tbl, len, o, B, H,
               K, P, ps, n_max, softcap, s)
  }
  return cudaErrorInvalidValue;
}
