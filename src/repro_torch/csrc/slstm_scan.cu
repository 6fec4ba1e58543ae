// sLSTM recurrence for Hopper (sm_90a): a prefill kernel that walks every
// time step of a call on one thread-block cluster per head, and a
// streaming kernel for the one-step (S = 1) decode call.  f32 or bf16
// gate inputs, f32 recurrent weights, state and math.
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
// takes the state (c, n, h, m) in (null pointers: the fresh state) and
// writes the final state to a separate output, so one source serves
// prefill and decode; and S need not be a block multiple.  R comes as
// four gate tensors (r_i, r_f, r_z, r_o), each (H, hd, hd).
//
// What bounds it here, at xlstm-1.3b (d = 2048, H = 4, hd = 512): R is
// 4 * 4 * 512 * 512 f32 = 16 MiB.
//  * Prefill: S = 383 steps do 2 * 4 * d * hd * S = 3.2 GFLOP (48 us at
//    the 67 TFLOP/s f32 peak), but the steps are sequential, and each
//    needs the whole previous h of its head before any unit can move.
//    So latency bounds it: S times one step, which is one pass of the
//    block's R slice out of shared memory (~0.9 us at 128 B a clock on
//    an H100), the warp's reduction and cell, and one exchange of h
//    across the cluster (~0.5 us; one barrier.cluster alone took 0.7 us,
//    1.4 us with the stores before it, on the same card).
//  * Decode (S = 1): R is read once, 16 MiB at 3.35 TB/s = 5.0 us.
//
// `slstm_prefill_kernel`: the recurrence of head j reads only h of head
// j, so each head runs on its own cluster of C blocks (C = 16 at
// hd = 512, a non-portable cluster size; kernels.ops.slstm_plan picks C,
// the register slots and the rows a cluster carries).  Block `rank` of
// the cluster owns UB = hd / C units of its head for all four gates, so
// its slice of R is 4 * hd * UB floats (256 KiB at hd = 512); the k rows
// of the first JS 32-row slots live in dynamic shared memory (192 KiB),
// the last jr slots in registers (32 floats a thread at 512 threads), and
// R leaves device memory once per call.  Warp w owns units 2w, 2w + 1 (8
// columns: 2 units x 4 gates); lane l takes k = l + 32 j, so a shared
// row of R is read as 32 consecutive float4 (no bank conflict) and h as
// 32 consecutive floats.  The 32 k-parts of the 8 columns reduce by 9
// shuffles (reduce-scatter over lane bits 4, 3, 2, then bits 1, 0); each
// of the two 16-lane halves then holds its unit's four gate sums and
// applies the cell (redundantly, so no lane waits for another warp).
// The new h goes to every block of the cluster by st.async: lane p of
// the warp's first half stores the warp's two values (8 bytes) into
// block p's h double buffer and counts them on block p's mbarrier for
// that buffer, which expects nr * hd * 4 bytes a step.  A block waits
// only on its own mbarrier before the next step: no cluster barrier, no
// __syncthreads, and nothing a step waits for but the h it needs.  Each
// half-warp fetches its unit's `pre` two steps ahead and parks it in
// shared memory one step ahead, so that hand-off never leaves the warp.
// The data dependencies order the buffers' reuse: a block's stores of
// step t + 1 follow its receipt of every block's step-t h, which each
// block sends only after it has read the buffer those stores overwrite.
// Clusters are co-scheduled by the hardware, so no cooperative launch is
// needed, and there is no grid-wide barrier.  B > 1 loops the rows (up
// to 4 a cluster) inside the step, reusing R from shared memory and
// registers.
//
// `slstm_step_kernel` (S = 1): an ordinary launch of d / 8 blocks (256 at
// d = 2048, two an SM), each owning 8 units of one head for all four
// gates.  It streams R straight from device memory: each thread keeps 16
// float4 loads of R in flight (k = kslot + 32 s), so the whole 16 MiB is
// requested at once; then the k-parts reduce by shuffles and through
// shared memory, and 8 threads apply the cell, all in one kernel.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_SMEM = 232448;   // bytes of shared memory a block may use
constexpr int MAX_CLUSTER = 16;    // = kernels.ops.SLSTM_MAX_CLUSTER
constexpr int JR_MAX = 4;          // = kernels.ops.SLSTM_REG_SLOTS
constexpr int ROWS_MAX = 4;        // = kernels.ops.SLSTM_MAX_ROWS
constexpr int MAX_HD = 512;        // = kernels.ops.SLSTM_MAX_HEAD_DIM
constexpr int PREFILL_THREADS = 512;
constexpr unsigned FULL = 0xffffffffu;

struct Gates {
  const float* r[4];  // r_i, r_f, r_z, r_o: (H, hd, hd) each
};
struct State {
  const float *c, *n, *h, *m;  // (B, d) each; null: the fresh state
};

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

struct Cell {
  float c, n, h, m;
};

// one step of the cell from the gate pre-activations + recurrent sums
__device__ __forceinline__ Cell cell(float gi, float gf, float gz_, float go_,
                                     float c, float n, float m) {
  const float gz = tanhf(gz_);
  const float go = 1.f / (1.f + expf(-go_));
  const float lf = log_sigmoid(gf);
  const float m_new = fmaxf(lf + m, gi);
  const float fp = expf(lf + m - m_new);
  const float ip = expf(gi - m_new);
  Cell o;
  o.c = fp * c + ip * gz;
  o.n = fp * n + ip;
  o.h = go * o.c / fmaxf(o.n, 1e-6f);
  o.m = m_new;
  return o;
}

// Shared-memory addresses, mbarriers and st.async (PTX; sm_90).
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// the same offset in the shared memory of cluster block `rank`
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
// one arrival that also expects `bytes` of st.async data this phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
// wait for the phase of parity `parity` to complete; acquire at cluster
// scope, so the data the peers' st.async brought is visible after it
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(bar), "r"(parity) : "memory");
}
// store 8 bytes into a cluster peer's shared memory and count them on
// that peer's mbarrier
__device__ __forceinline__ void st_async2(uint32_t addr, float a, float b,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n"
      :: "r"(addr), "f"(a), "f"(b), "r"(bar) : "memory");
}

// Sum each of a lane's 8 column partials over the warp's 32 lanes: three
// reduce-scatter levels (lane bits 4, 3, 2; each lane keeps half of what
// is left and sends the other half) and two butterfly levels (bits 1, 0).
// Returns the full sum of column (lane >> 2) on every lane.
__device__ __forceinline__ float reduce_scatter8(const float (&a)[8],
                                                 int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float v[4], w[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float send = b4 ? a[i] : a[i + 4];
    v[i] = (b4 ? a[i + 4] : a[i]) + __shfl_xor_sync(FULL, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float send = b3 ? v[i] : v[i + 2];
    w[i] = (b3 ? v[i + 2] : v[i]) + __shfl_xor_sync(FULL, send, 8);
  }
  float s = (b2 ? w[1] : w[0]) + __shfl_xor_sync(FULL, b2 ? w[0] : w[1], 4);
  s += __shfl_xor_sync(FULL, s, 2);
  s += __shfl_xor_sync(FULL, s, 1);
  return s;
}

// Shared memory of the prefill kernel (kernels.ops.slstm_plan computes
// the same): two mbarriers (16 B), R slots [NW][JS][2][32] float4, h
// [2][rows][32 J], pre [2][rows][4][UB], cell state c, n, m [rows][UB].
size_t prefill_smem(int hd, int C, int jr, int rows) {
  const int UB = hd / C, NW = UB / 2, J = (hd + 31) / 32, JS = J - jr;
  return 16 + (size_t)NW * JS * 1024 +
         sizeof(float) * (2 * rows * 32 * J + 2 * rows * 4 * UB + 3 * rows * UB);
}

bool prefill_plan_ok(int hd, int C, int jr, int rows) {
  if (C < 1 || C > MAX_CLUSTER || hd < 2 || hd > MAX_HD || hd % C) return false;
  const int UB = hd / C, J = (hd + 31) / 32;
  if (UB % 2 || UB > 32 || jr < 0 || jr > JR_MAX || jr > J) return false;
  if (rows < 1 || rows > ROWS_MAX) return false;
  return prefill_smem(hd, C, jr, rows) <= MAX_SMEM;
}

template <typename T>
__global__ void __launch_bounds__(PREFILL_THREADS, 1)
slstm_prefill_kernel(Gates R, const T* __restrict__ pre, T* __restrict__ y,
                     State st, float* __restrict__ out, int B, int S, int d,
                     int hd, int C, int jr, int rows) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int NT = blockDim.x, NW = NT >> 5, UB = 2 * NW;
  const int J = (hd + 31) >> 5, JS = J - jr, HP = J << 5;
  const int rank = (int)cluster.block_rank();
  const int head = blockIdx.x / C;
  const int ub0 = rank * UB;        // the block's first unit in its head
  const int col0 = head * hd + ub0;  // ... and in d
  const int b0 = blockIdx.y * rows, nr = min(rows, B - b0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);  // h buffer 0, 1
  float4* Rs = reinterpret_cast<float4*>(smem_raw + 16);    // [NW][JS][2][32]
  float* hb = reinterpret_cast<float*>(Rs + (size_t)NW * JS * 64);  // [2][rows][HP]
  float* ps = hb + 2 * rows * HP;                   // [2][rows][4][UB]
  float* cs = ps + 2 * rows * 4 * UB;               // [rows][UB]
  float* ns = cs + rows * UB;
  float* ms = ns + rows * UB;
  const size_t hoff = (size_t)head * hd * hd;

  // R's shared slots, 32 scalar loads in flight a thread; consecutive
  // threads read consecutive units of one row of one gate
  const int n_items = JS * 32 * UB;
  for (int base = tid; base < n_items; base += 8 * NT) {
    float4 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = base + q * NT;
      v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      const int u = e % UB, k = e / UB;  // k = lane + 32 j
      if (e < n_items && k < hd) {
        const size_t off = hoff + (size_t)k * hd + ub0 + u;
        v[q] = make_float4(__ldg(R.r[0] + off), __ldg(R.r[1] + off),
                           __ldg(R.r[2] + off), __ldg(R.r[3] + off));
      }
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = base + q * NT;
      if (e < n_items) {
        const int u = e % UB, k = e / UB;
        Rs[(((u >> 1) * JS + (k >> 5)) * 2 + (u & 1)) * 32 + (k & 31)] = v[q];
      }
    }
  }
  // R's register slots: column ul * 4 + g is unit ul's gate g
  float rr[JR_MAX][8];
  const int uw = ub0 + 2 * warp;  // the warp's first unit in its head
#pragma unroll
  for (int jj = 0; jj < JR_MAX; ++jj) {
    const int k = lane + 32 * (JS + jj);
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      float2 x = make_float2(0.f, 0.f);
      if (jj < jr && k < hd)
        x = __ldg(reinterpret_cast<const float2*>(R.r[g] + hoff +
                                                  (size_t)k * hd + uw));
      rr[jj][g] = x.x;
      rr[jj][4 + g] = x.y;
    }
  }
  // h (zero past hd and in the second buffer) and the cell state
  for (int i = tid; i < rows * HP; i += NT) {
    const int r = i / HP, k = i - r * HP;
    hb[i] = (st.h && r < nr && k < hd)
                ? st.h[(size_t)(b0 + r) * d + head * hd + k] : 0.f;
    hb[rows * HP + i] = 0.f;
  }
  for (int i = tid; i < nr * UB; i += NT) {
    const size_t g = (size_t)(b0 + i / UB) * d + col0 + i % UB;
    cs[i] = st.c ? st.c[g] : 0.f;
    ns[i] = st.n ? st.n[g] : 1e-6f;
    ms[i] = st.m ? st.m[g] : 0.f;
  }
  // lane `peer` of each half-warp fetches gate (peer & 3) of row
  // (peer >> 2) of the half-warp's unit, two steps ahead, and parks it
  // in shared memory one step ahead for the half-warp's cell: the `pre`
  // hand-off never leaves the warp
  const int ul = lane >> 4, peer = lane & 15;
  const int u_loc = 2 * warp + ul;  // this half-warp's unit in the block
  const int pre_r = peer >> 2, pre_g = peer & 3;
  const bool pre_lane = pre_r < nr;
  const T* pre_u = pre + ((size_t)(b0 + pre_r) * S * 4 + pre_g) * d + col0 +
                   u_loc;            // + t * 4 * d: step t
  float* ps_u = ps + (pre_r * 4 + pre_g) * UB + u_loc;  // + buf * rows * 4 * UB
  if (pre_lane) *ps_u = to_f32(pre_u[0]);
  float p_next = pre_lane && S > 1 ? to_f32(pre_u[(size_t)4 * d]) : 0.f;
  const uint32_t bar0 = smem_addr(bars), bar1 = smem_addr(bars + 1);
  if (tid == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every block of the cluster running, staged, armed

  const float4* Rw = Rs + (size_t)warp * JS * 64 + lane;  // + 64 j + 32 ul
  // lane `peer` of the warp's first half sends the warp's two new h
  // values (8 bytes) to cluster block `peer`, h buffer and mbarrier alike
  const bool sender = ul == 0 && peer < C;
  const uint32_t hb_peer = sender ? map_rank(smem_addr(hb), peer) : 0;
  const uint32_t bar0_peer = sender ? map_rank(bar0, peer) : 0;
  const uint32_t bar1_peer = sender ? map_rank(bar1, peer) : 0;
  const uint32_t step_bytes = nr * hd * sizeof(float);  // arriving a step
  for (int t = 0; t < S; ++t) {
    const int cur = t & 1;
    // h of step t: buffer `cur`, filled by every block's step t - 1
    if (t > 0) mbar_wait(cur ? bar1 : bar0, ((t - 1) >> 1) & 1);
    if (tid == 0 && t + 1 < S) mbar_expect(cur ? bar0 : bar1, step_bytes);
    const float p_after =
        pre_lane && t + 2 < S ? to_f32(pre_u[(size_t)(t + 2) * 4 * d]) : 0.f;
    for (int r = 0; r < nr; ++r) {
      const float* hv = hb + (cur * rows + r) * HP + lane;
      float a[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) a[c] = 0.f;
#pragma unroll 4
      for (int j = 0; j < JS; ++j) {
        const float x = hv[32 * j];
        const float4 p = Rw[64 * j], q = Rw[64 * j + 32];
        a[0] = fmaf(x, p.x, a[0]);
        a[1] = fmaf(x, p.y, a[1]);
        a[2] = fmaf(x, p.z, a[2]);
        a[3] = fmaf(x, p.w, a[3]);
        a[4] = fmaf(x, q.x, a[4]);
        a[5] = fmaf(x, q.y, a[5]);
        a[6] = fmaf(x, q.z, a[6]);
        a[7] = fmaf(x, q.w, a[7]);
      }
#pragma unroll
      for (int jj = 0; jj < JR_MAX; ++jj) {
        if (jj < jr) {
          const float x = hv[32 * (JS + jj)];
#pragma unroll
          for (int c = 0; c < 8; ++c) a[c] = fmaf(x, rr[jj][c], a[c]);
        }
      }
      const float sum = reduce_scatter8(a, lane);  // column lane >> 2
      const int src = lane & 16;                   // unit ul's gate 0
      const float ri = __shfl_sync(FULL, sum, src);
      const float rf = __shfl_sync(FULL, sum, src + 4);
      const float rz = __shfl_sync(FULL, sum, src + 8);
      const float ro = __shfl_sync(FULL, sum, src + 12);
      const float* pp = ps + (cur * rows + r) * 4 * UB + u_loc;
      const int si = r * UB + u_loc;
      const Cell o = cell(pp[0] + ri, pp[UB] + rf, pp[2 * UB] + rz,
                          pp[3 * UB] + ro, cs[si], ns[si], ms[si]);
      const float h_odd = __shfl_down_sync(FULL, o.h, 16);  // unit 2w + 1
      __syncwarp();  // every lane has read the state before lane 0 writes
      const size_t sb = (size_t)(b0 + r) * d + col0 + u_loc;
      if (peer == 0) {
        cs[si] = o.c;
        ns[si] = o.n;
        ms[si] = o.m;
        store(y + ((size_t)(b0 + r) * S + t) * d + col0 + u_loc, o.h);
      }
      if (t + 1 < S) {
        if (sender)
          st_async2(hb_peer + sizeof(float) * (((cur ^ 1) * rows + r) * HP +
                                               ub0 + 2 * warp),
                    o.h, h_odd, cur ? bar0_peer : bar1_peer);
      } else if (peer == 0) {
        const size_t plane = (size_t)B * d;
        out[sb] = o.c;
        out[plane + sb] = o.n;
        out[2 * plane + sb] = o.h;
        out[3 * plane + sb] = o.m;
      }
    }
    if (pre_lane && t + 1 < S) ps_u[(cur ^ 1) * rows * 4 * UB] = p_next;
    p_next = p_after;
    __syncwarp();  // step t + 1's `pre` parked for the half-warp's cell
  }
  cluster.sync();  // no block leaves while a peer's stores may be in flight
}

constexpr int STEP_THREADS = 256;
constexpr int STEP_UNITS = 8;   // units of one head a block owns
constexpr int STEP_LOADS = 16;  // k-slots a thread holds: hd <= 512
constexpr int STEP_ROWS = 8;    // batch rows a block carries

template <typename T>
__global__ void __launch_bounds__(STEP_THREADS)
slstm_step_kernel(Gates R, const T* __restrict__ pre, T* __restrict__ y,
                  State st, float* __restrict__ out, int B, int d, int hd) {
  __shared__ float hs[STEP_ROWS][MAX_HD];
  __shared__ float4 red[STEP_ROWS][STEP_THREADS / 32][8];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int unit0 = blockIdx.x * STEP_UNITS;  // first unit in d
  const int head = unit0 / hd, u0 = unit0 - head * hd;
  const int b0 = blockIdx.y * STEP_ROWS, nr = min(STEP_ROWS, B - b0);
  // thread -> (gate g, float4 `half` of the 8 units, k-slot)
  const int g = (tid & 7) >> 1, half = tid & 1, kslot = tid >> 3;
  const int NS = (hd + 31) >> 5;
  const float* rg = R.r[g] + (size_t)head * hd * hd + u0 + 4 * half;
  float4 rv[STEP_LOADS];
#pragma unroll
  for (int s = 0; s < STEP_LOADS; ++s) {
    const int k = kslot + 32 * s;
    rv[s] = s < NS && k < hd
                ? __ldg(reinterpret_cast<const float4*>(rg + (size_t)k * hd))
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int i = tid; i < nr * hd; i += STEP_THREADS) {
    const int r = i / hd, k = i - r * hd;
    hs[r][k] = st.h ? st.h[(size_t)(b0 + r) * d + head * hd + k] : 0.f;
  }
  __syncthreads();
  for (int r = 0; r < nr; ++r) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < STEP_LOADS; ++s) {
      const int k = kslot + 32 * s;
      if (s < NS && k < hd) {
        const float x = hs[r][k];
        a.x = fmaf(x, rv[s].x, a.x);
        a.y = fmaf(x, rv[s].y, a.y);
        a.z = fmaf(x, rv[s].z, a.z);
        a.w = fmaf(x, rv[s].w, a.w);
      }
    }
    // the warp's 4 k-slots of each (gate, half): lanes lane ^ 8, ^ 16
#pragma unroll
    for (int o = 8; o < 32; o <<= 1) {
      a.x += __shfl_xor_sync(FULL, a.x, o);
      a.y += __shfl_xor_sync(FULL, a.y, o);
      a.z += __shfl_xor_sync(FULL, a.z, o);
      a.w += __shfl_xor_sync(FULL, a.w, o);
    }
    if (lane < 8) red[r][warp][lane] = a;
  }
  __syncthreads();
  if (tid >= nr * STEP_UNITS) return;
  const int r = tid / STEP_UNITS, u = tid % STEP_UNITS;
  float rec[4];
#pragma unroll
  for (int gg = 0; gg < 4; ++gg) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < STEP_THREADS / 32; ++w) {
      const float4 v = red[r][w][2 * gg + (u >> 2)];
      const int c = u & 3;
      s += c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
    }
    rec[gg] = s;
  }
  const int col = unit0 + u;
  const size_t sb = (size_t)(b0 + r) * d + col;
  const size_t pb = (size_t)(b0 + r) * 4 * d + col;  // S = 1
  const Cell o = cell(to_f32(pre[pb]) + rec[0], to_f32(pre[pb + d]) + rec[1],
                      to_f32(pre[pb + 2 * d]) + rec[2],
                      to_f32(pre[pb + 3 * d]) + rec[3], st.c ? st.c[sb] : 0.f,
                      st.n ? st.n[sb] : 1e-6f, st.m ? st.m[sb] : 0.f);
  store(y + sb, o.h);
  const size_t plane = (size_t)B * d;
  out[sb] = o.c;
  out[plane + sb] = o.n;
  out[2 * plane + sb] = o.h;
  out[3 * plane + sb] = o.m;
}

// The prefill kernel's attributes, set once per instantiation: dynamic
// shared memory up to the block limit and the non-portable cluster size.
template <typename T>
cudaError_t prefill_configure() {
  static cudaError_t e = [] {
    cudaError_t r = cudaFuncSetAttribute(
        slstm_prefill_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (r != cudaSuccess) return r;
    return cudaFuncSetAttribute(
        slstm_prefill_kernel<T>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  return e;
}

struct PrefillLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
};

void prefill_config(PrefillLaunch& L, int B, int H, int hd, int C, int rows,
                    size_t smem, cudaStream_t stream) {
  L.cfg = {};
  L.cfg.gridDim = dim3(H * C, (B + rows - 1) / rows, 1);
  L.cfg.blockDim = dim3(16 * (hd / C), 1, 1);
  L.cfg.dynamicSmemBytes = smem;
  L.cfg.stream = stream;
  L.attr[0].id = cudaLaunchAttributeClusterDimension;
  L.attr[0].val.clusterDim.x = C;
  L.attr[0].val.clusterDim.y = 1;
  L.attr[0].val.clusterDim.z = 1;
  L.cfg.attrs = L.attr;
  L.cfg.numAttrs = 1;
}

template <typename T>
cudaError_t launch_prefill(const void* pre, Gates R, void* y, State st,
                           float* out, int B, int S, int d, int H, int hd,
                           int C, int jr, int rows, cudaStream_t stream) {
  cudaError_t e = prefill_configure<T>();
  if (e != cudaSuccess) return e;
  PrefillLaunch L;
  prefill_config(L, B, H, hd, C, rows, prefill_smem(hd, C, jr, rows), stream);
  e = cudaLaunchKernelEx(&L.cfg, slstm_prefill_kernel<T>,
                         R, static_cast<const T*>(pre), static_cast<T*>(y),
                         st, out, B, S, d, hd, C, jr, rows);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_step(const void* pre, Gates R, void* y, State st,
                        float* out, int B, int d, int hd,
                        cudaStream_t stream) {
  const dim3 grid(d / STEP_UNITS, (B + STEP_ROWS - 1) / STEP_ROWS);
  slstm_step_kernel<T><<<grid, STEP_THREADS, 0, stream>>>(
      R, static_cast<const T*>(pre), static_cast<T*>(y), st, out, B, d, hd);
  return cudaGetLastError();
}

Gates gates(const void* r_i, const void* r_f, const void* r_z,
            const void* r_o) {
  return Gates{{static_cast<const float*>(r_i), static_cast<const float*>(r_f),
                static_cast<const float*>(r_z),
                static_cast<const float*>(r_o)}};
}

State state(const void* c, const void* n, const void* h, const void* m) {
  return State{static_cast<const float*>(c), static_cast<const float*>(n),
               static_cast<const float*>(h), static_cast<const float*>(m)};
}

}  // namespace

// pre (B, S, 4, d) gates i, f, z, o; r_i, r_f, r_z, r_o (H, hd, hd) f32;
// y (B, S, d) in pre's dtype; c, n, h, m (B, d) f32, all four null for
// the fresh state; state_out (4, B, d) f32 receives the final (c, n, h,
// m).  C, jr, rows: the plan of kernels.ops.slstm_plan (cluster size,
// register slots, rows a cluster carries).  dtype: 0 = float32, 1 =
// bfloat16.  Returns the launch's cudaError_t.
extern "C" int slstm_scan_fwd(const void* pre, const void* r_i,
                              const void* r_f, const void* r_z,
                              const void* r_o, void* y, const void* c,
                              const void* n, const void* h, const void* m,
                              void* state_out, int B, int S, int d, int H,
                              int hd, int C, int jr, int rows, int dtype,
                              void* stream) {
  if (B <= 0 || S <= 0) return cudaSuccess;
  if (H * hd != d || !prefill_plan_ok(hd, C, jr, rows))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Gates R = gates(r_i, r_f, r_z, r_o);
  const State st = state(c, n, h, m);
  float* out = static_cast<float*>(state_out);
  if (dtype == 0)
    return launch_prefill<float>(pre, R, y, st, out, B, S, d, H, hd, C, jr,
                                 rows, s);
  if (dtype == 1)
    return launch_prefill<__nv_bfloat16>(pre, R, y, st, out, B, S, d, H, hd,
                                         C, jr, rows, s);
  return cudaErrorInvalidValue;
}

// The one-step call (S = 1): the same arguments without S and the plan.
extern "C" int slstm_step_fwd(const void* pre, const void* r_i,
                              const void* r_f, const void* r_z,
                              const void* r_o, void* y, const void* c,
                              const void* n, const void* h, const void* m,
                              void* state_out, int B, int d, int H, int hd,
                              int dtype, void* stream) {
  if (B <= 0) return cudaSuccess;
  if (H * hd != d || hd % STEP_UNITS || hd > MAX_HD)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Gates R = gates(r_i, r_f, r_z, r_o);
  const State st = state(c, n, h, m);
  float* out = static_cast<float*>(state_out);
  if (dtype == 0) return launch_step<float>(pre, R, y, st, out, B, d, hd, s);
  if (dtype == 1)
    return launch_step<__nv_bfloat16>(pre, R, y, st, out, B, d, hd, s);
  return cudaErrorInvalidValue;
}

// A prefill plan on this card: out[0] its dynamic shared-memory bytes,
// out[1] its threads a block, out[2] how many clusters of C such blocks
// the card holds at once (cudaOccupancyMaxActiveClusters).
extern "C" int slstm_prefill_info(int hd, int C, int jr, int rows,
                                  int* out) {
  if (!prefill_plan_ok(hd, C, jr, rows)) return cudaErrorInvalidValue;
  cudaError_t e = prefill_configure<float>();
  if (e != cudaSuccess) return e;
  const size_t smem = prefill_smem(hd, C, jr, rows);
  PrefillLaunch L;
  prefill_config(L, rows, 1, hd, C, rows, smem, nullptr);  // one head
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, slstm_prefill_kernel<float>, &L.cfg);
  if (e != cudaSuccess) return e;
  out[0] = (int)smem;
  out[1] = 16 * (hd / C);
  out[2] = n;
  return cudaSuccess;
}
