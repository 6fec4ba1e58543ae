// sLSTM recurrence for Hopper (sm_90a): one persistent cooperative
// launch walks every time step of a call.  f32 or bf16 gate inputs,
// f32 recurrent weights, state and math.
//
// Replaces the TPU kernel `slstm_scan` of src/repro/kernels/slstm_scan.py
// (body `_kernel`).  Per step t, with rec_g = h R_g (block-diagonal, one
// (hd, hd) block per head) and gates i, f, z, o:
//   gi = pre_i + rec_i ; gf = pre_f + rec_f
//   gz = tanh(pre_z + rec_z) ; go = sigmoid(pre_o + rec_o)
//   m' = max(logsigmoid(gf) + m, gi)
//   c  = exp(logsigmoid(gf) + m - m') c + exp(gi - m') gz
//   n  = exp(logsigmoid(gf) + m - m') n + exp(gi - m')
//   h  = go c / max(n, 1e-6)
// Unlike the TPU kernel, which always starts from (0, 1e-6, 0, 0), it
// takes the state (c, n, h, m) in and leaves the final state out, so one
// kernel serves prefill and decode; and S need not be a block multiple.
//
// What bounds it here: at xlstm-1.3b (d = 2048, H = 4, hd = 512) R is
// 4 * 4 * 512 * 512 f32 = 16 MiB, so it cannot sit in one block's
// 227 KB as the TPU kept it in VMEM, and each step needs the whole
// previous h before any unit can move.  A prefill of S = 383 steps does
// 2 * 4 * d * hd * S = 3.2 GFLOP (~48 us at the 67 TFLOP/s f32 peak) and
// moves ~32 MB (~10 us at 3.35 TB/s), but the steps are sequential: one
// grid-wide barrier per step, and each step's few hundred dependent
// instructions per thread, set its time, not bytes or FLOPs.
//
// Design: a cooperative launch of d/U blocks (U = 16 units: 128 blocks
// at d = 2048, within the 132 SMs, one block per SM by shared memory).
// Block j owns units [jU, jU+U) of one head for all four gates and keeps
// that slice of R, 4 * hd * U f32 = 128 KB, in dynamic shared memory for
// the whole call: R leaves device memory once per call.  Each step, for
// each batch row, the block reads its head's previous h (hd floats,
// through L2) into shared memory; its 256 threads split the 4 * U dot
// products of length hd four ways, reduce through shared memory, and U
// threads apply the cell to their units (c, n, m of a unit belong to one
// thread, kept in the state arrays) and write h to the other half of a
// double buffer.  grid.sync() ends the step.  h crosses blocks through
// L2 (__stcg / __ldcg), never through a stale L1 line.  A grid larger
// than the card can hold at once is refused by the launch, and the
// wrapper raises.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;           // threads per block
constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

size_t smem_bytes(int hd, int U) {
  // R slice [4][hd][U], h of one head [hd], partial sums [NT], gates [4][U]
  return sizeof(float) * (4 * (size_t)hd * U + hd + NT + 4 * U);
}

// U: units per block, 4, 8 or 16 dividing hd (whole float4s of a row of
// R), with 4*U*KP = NT.
template <typename T>
__global__ void __launch_bounds__(NT)
slstm_kernel(const T* __restrict__ pre, const float* __restrict__ R,
             T* __restrict__ y, float* __restrict__ c, float* __restrict__ n,
             float* __restrict__ m, float* __restrict__ hbuf,
             float* __restrict__ h_out, int B, int S, int d, int H, int hd,
             int U) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x;
  const int KP = NT / (4 * U);                  // k-parts of one dot product
  const int per_head = hd / U;                  // blocks per head
  const int head = blockIdx.x / per_head;
  const int u0 = (blockIdx.x % per_head) * U;   // first unit in the head
  const int col0 = head * hd + u0;              // first unit in d
  float* Rs = smem;                             // [4][hd][U]
  float* hs = Rs + 4 * hd * U;                  // [hd]
  float* red = hs + hd;                         // [NT]
  float* gate = red + NT;                       // [4][U]

  // Stage this block's slice of R with 16-byte loads, 8 in flight a
  // thread: one load at a time left the copy latency-bound (0.33 ms for
  // R's 16 MiB over 128 blocks, measured on the card).
  const int U4 = U / 4;                      // float4s per (gate, k) row
  const int n4 = 4 * hd * U4;
  float4* Rs4 = reinterpret_cast<float4*>(Rs);
  for (int base = tid; base < n4; base += 8 * NT) {
    float4 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i = base + j * NT;
      if (i < n4) {
        const int row = i / U4, q = i - row * U4;  // row = g * hd + k
        const int g = row / hd, k = row - g * hd;
        v[j] = __ldg(reinterpret_cast<const float4*>(
                         R + (((size_t)g * H + head) * hd + k) * hd + u0) + q);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (base + j * NT < n4) Rs4[base + j * NT] = v[j];
  }
  // thread -> (gate g, k-part kp, unit u); red[tid] is its partial sum
  const int u = tid % U, kp = (tid / U) % KP, g = tid / (U * KP);
  const float* rg = Rs + (size_t)g * hd * U + u;

  for (int t = 0; t < S; ++t) {
    const float* h_prev = hbuf + (size_t)(t & 1) * B * d;
    float* h_next = hbuf + (size_t)((t + 1) & 1) * B * d;
    for (int b = 0; b < B; ++b) {
      __syncthreads();  // R staged; the previous row's hs/red/gate consumed
      for (int k = tid; k < hd; k += NT)
        hs[k] = __ldcg(h_prev + (size_t)b * d + head * hd + k);
      __syncthreads();
      float acc = 0.f;
      for (int k = kp; k < hd; k += KP) acc = fmaf(hs[k], rg[k * U], acc);
      red[tid] = acc;
      __syncthreads();
      if (tid < 4 * U) {
        const int gg = tid / U, uu = tid - gg * U;
        float s = 0.f;
        for (int q = 0; q < KP; ++q) s += red[(gg * KP + q) * U + uu];
        gate[tid] = s;
      }
      __syncthreads();
      if (tid < U) {
        const int col = col0 + tid;
        const size_t pb = ((size_t)b * S + t) * 4 * d + col;
        const size_t sb = (size_t)b * d + col;
        const float gi = to_f32(pre[pb]) + gate[tid];
        const float gf = to_f32(pre[pb + d]) + gate[U + tid];
        const float gz = tanhf(to_f32(pre[pb + 2 * d]) + gate[2 * U + tid]);
        const float go =
            1.f / (1.f + expf(-(to_f32(pre[pb + 3 * d]) + gate[3 * U + tid])));
        const float logf_ = log_sigmoid(gf);
        const float m_old = m[sb];
        const float m_new = fmaxf(logf_ + m_old, gi);
        const float fp = expf(logf_ + m_old - m_new);
        const float ip = expf(gi - m_new);
        const float c_new = fp * c[sb] + ip * gz;
        const float n_new = fp * n[sb] + ip;
        const float h_new = go * c_new / fmaxf(n_new, 1e-6f);
        c[sb] = c_new;
        n[sb] = n_new;
        m[sb] = m_new;
        __stcg(h_next + sb, h_new);
        store(y + ((size_t)b * S + t) * d + col, h_new);
        if (t == S - 1) h_out[sb] = h_new;
      }
    }
    grid.sync();  // every unit's h of step t is in L2
  }
}

int units_per_block(int hd) {
  for (int U = 16; U >= 4; U >>= 1)
    if (hd % U == 0 && smem_bytes(hd, U) <= MAX_SMEM) return U;
  return 0;
}

template <typename T>
cudaError_t launch(const void* pre, const float* R, void* y, float* c,
                   float* n, float* m, float* hbuf, float* h_out, int B,
                   int S, int d, int H, int hd, cudaStream_t stream) {
  int U = units_per_block(hd);
  if (U == 0 || H * hd != d) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(hd, U);
  auto kern = slstm_kernel<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const T* pre_t = static_cast<const T*>(pre);
  T* y_t = static_cast<T*>(y);
  void* args[] = {&pre_t, &R, &y_t, &c, &n, &m, &hbuf, &h_out,
                  &B, &S, &d, &H, &hd, &U};
  // refused (cudaErrorCooperativeLaunchTooLarge) when d/U blocks cannot
  // all be resident at once
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(d / U), dim3(NT),
                                  args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

// pre (B, S, 4, d) gates i, f, z, o; R (4, H, hd, hd) f32; y (B, S, d) in
// pre's dtype.  c, n, m (B, d) f32 hold the initial state and are
// updated in place; hbuf (2, B, d) f32 scratch whose first half holds
// the initial h; h_out (B, d) receives the final h.  dtype: 0 = float32,
// 1 = bfloat16.  Returns the launch's cudaError_t.
extern "C" int slstm_scan_fwd(const void* pre, const void* R, void* y,
                              void* c, void* n, void* m, void* hbuf,
                              void* h_out, int B, int S, int d, int H,
                              int hd, int dtype, void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(R);
  float *cf = static_cast<float*>(c), *nf = static_cast<float*>(n),
        *mf = static_cast<float*>(m), *hb = static_cast<float*>(hbuf),
        *ho = static_cast<float*>(h_out);
  if (dtype == 0)
    return launch<float>(pre, r, y, cf, nf, mf, hb, ho, B, S, d, H, hd, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(pre, r, y, cf, nf, mf, hb, ho, B, S, d, H,
                                 hd, s);
  return cudaErrorInvalidValue;
}
