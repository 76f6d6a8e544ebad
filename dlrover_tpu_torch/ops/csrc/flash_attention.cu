// Flash attention forward and backward for Hopper (sm_90a), bf16 inputs.
//
// Replaces the Pallas kernels of dlrover_tpu/ops/flash_attention.py:
//   fa_fwd      <- _fused_fwd_kernel (:273) and the streaming _fwd_kernel (:77)
//   fa_bwd_dkdv <- _fused_bwd_kernel (:337, its dk/dv half) and _bwd_dkv_kernel (:585)
//   fa_bwd_dq   <- _fused_bwd_kernel (:337, its dq half) and _bwd_dq_kernel (:508)
//
// The TPU's fused kernels keep a whole [T, T] f32 score tile per head in
// VMEM. A Hopper block has 227 KB of shared memory, so every kernel here
// tiles over keys (forward, dq) or queries (dk/dv) in 64-wide tiles with
// the streaming FA2 algebra: the online softmax in the forward, p
// recomputed from the saved lse in the backward. What bounds them on the
// card: at head_dim 64-128 attention does ~T/2 operations per byte read
// (causal), above the H100's ~295 ops/byte ridge for T >= 1024, so the
// tensor cores bound them. This first version issues bf16 WMMA
// (mma.sync) 16x16x16 products with f32 accumulation, four warps per
// block, each warp owning 16 rows of the tile, and stages softmax
// statistics and the forward's output accumulator in shared memory. It
// is written to be right and simple; wgmma, TMA and a producer warp are
// later work (PERF.md holds its times).
//
// Numerics follow the Pallas kernels: NEG_INF = -1e30 is finite, rows
// with no visible key give o = 0 and lse = NEG_INF, p is rounded to bf16
// before each product that consumes it, and in the backward p = 0 on rows
// whose lse is NEG_INF. dq is written in bf16. dk/dv are written in bf16
// when every kv head has one query head; under GQA they are written in f32
// per query head and the caller sums each group and casts (as :818-833
// does).
//
// Each C entry returns cudaGetLastError() of its launch (0 = success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

#define NEG_INF (-1e30f)

constexpr int BQ = 64;         // query rows per tile
constexpr int BK = 64;         // keys per tile
constexpr int NWARPS = 4;      // each warp owns 16 rows of a 64-row tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int WR = 16;
constexpr int LDS = BK + 4;    // f32 [64][64] score tiles, padded
constexpr int LDP = BK + 8;    // bf16 [64][64] probability tiles, padded

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// rows x D bf16 tile, global (dense rows of D) -> shared (rows of LDH),
// 16 bytes per thread per step
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int tid) {
  constexpr int LDH = D + 8;
  constexpr int CPR = D / 8;
  for (int i = tid; i < 64 * CPR; i += NTHREADS) {
    const int r = i / CPR, c = (i % CPR) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDH + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
  }
}

// C[16 x 64] (f32, row stride LDS) = A[16 x D] (row-major, stride LDH) x
// B^T where B is [64 x D] row-major (stride LDH), i.e. A . B^T
template <int D>
__device__ __forceinline__ void warp_abt(float* C, const bf16* A, const bf16* B) {
  constexpr int LDH = D + 8;
  FragC acc[BK / 16];
#pragma unroll
  for (int n = 0; n < BK / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, A + kk, LDH);
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      FragBCol b;
      wmma::load_matrix_sync(b, B + n * 16 * LDH + kk, LDH);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 16; ++n)
    wmma::store_matrix_sync(C + n * 16, acc[n], LDS, wmma::mem_row_major);
}

// acc[D/16] += A[16 x 64] (bf16, stride LDP) x B[64 x D] (row-major, stride LDH)
template <int D>
__device__ __forceinline__ void warp_ab_acc(FragC* acc, const bf16* A, const bf16* B) {
  constexpr int LDH = D + 8;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, A + kk, LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBRow b;
      wmma::load_matrix_sync(b, B + kk * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
}

// a warp's 16 x D accumulator rows -> global rows of D: f32 directly, or
// bf16 through the warp's f32 shared scratch (16 x (D + 4)), since WMMA
// stores accumulators as f32 only
template <int D>
__device__ __forceinline__ void store_rows(float* dst, FragC* acc, float*) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(dst + n * 16, acc[n], D, wmma::mem_row_major);
}

template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, FragC* acc, float* stage) {
  constexpr int LDT = D + 4;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc[n], LDT, wmma::mem_row_major);
  __syncwarp();
  for (int i = threadIdx.x % 32; i < WR * D / 2; i += 32) {
    const int r = 2 * i / D, c = 2 * i % D;
    *reinterpret_cast<__nv_bfloat162*>(dst + r * D + c) =
        __floats2bfloat162_rn(stage[r * LDT + c], stage[r * LDT + c + 1]);
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// forward: one block per (64-row q tile, head, batch)
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t fwd_smem_bytes() {
  return (size_t)3 * 64 * (D + 8) * 2      // Q, K, V tiles
         + (size_t)BQ * LDS * 4            // scores
         + (size_t)BQ * LDP * 2            // probabilities (bf16)
         + (size_t)BQ * (D + 4) * 4        // output accumulator
         + (size_t)2 * BQ * 4;             // running max and sum
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
fa_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ o,
              float* __restrict__ lse, int H, int Hkv, int Tq, int Tk,
              float scale, int causal, int q_off, int k_off) {
  constexpr int LDH = D + 8, LDO = D + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + 64 * LDH;
  bf16* Vs = Ks + 64 * LDH;
  float* Ss = reinterpret_cast<float*>(Vs + 64 * LDH);
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * LDS);
  float* Os = reinterpret_cast<float*>(Ps + BQ * LDP);
  float* Ms = Os + BQ * LDO;
  float* Ls = Ms + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t q_base = (((size_t)b * H + h) * Tq + q0) * D;
  const bf16* kg = k + ((size_t)b * Hkv + hk) * Tk * D;
  const bf16* vg = v + ((size_t)b * Hkv + hk) * Tk * D;

  load_tile<D>(Qs, q + q_base, tid);
  for (int i = tid; i < BQ * D; i += NTHREADS) Os[(i / D) * LDO + i % D] = 0.f;
  if (tid < BQ) {
    Ms[tid] = NEG_INF;
    Ls[tid] = 0.f;
  }

  const int row = warp * WR + lane / 2;  // two lanes per row
  const int half = lane & 1;
  const int qp = q_off + q0 + row;
  const int q_last = q_off + q0 + BQ - 1;
  const int nk = Tk / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = k_off + j * BK;
    // key tiles are in order: once one lies wholly in the future of
    // every query of the tile, so do all later ones
    if (causal && q_last < k0) break;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, kg + (size_t)j * BK * D, tid);
    load_tile<D>(Vs, vg + (size_t)j * BK * D, tid);
    __syncthreads();

    warp_abt<D>(Ss + warp * WR * LDS, Qs + warp * WR * LDH, Ks);
    __syncwarp();

    float* srow = Ss + row * LDS;
    const int c0 = half * (BK / 2);
    float mx = NEG_INF;
    for (int c = c0; c < c0 + BK / 2; ++c) {
      float s = srow[c] * scale;
      if (causal && qp < k0 + c) s = NEG_INF;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_prev = Ms[row];
    const float m_new = fmaxf(m_prev, mx);
    // rows masked so far keep m_new == NEG_INF: exponentiate against 0
    // there so p = exp(NEG_INF) = 0 instead of exp(0) = 1
    const float m_safe = m_new > NEG_INF * 0.5f ? m_new : 0.f;
    const float alpha = expf(m_prev - m_safe);
    float sum = 0.f;
    bf16* prow = Ps + row * LDP;
    for (int c = c0; c < c0 + BK / 2; ++c) {
      const float p = expf(srow[c] - m_safe);
      sum += p;
      prow[c] = __float2bfloat16(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    float* orow = Os + row * LDO;
    for (int d = half * (D / 2); d < (half + 1) * (D / 2); ++d) orow[d] *= alpha;
    __syncwarp();  // both lanes of the row have read Ms before it moves
    if (half == 0) {
      Ms[row] = m_new;
      Ls[row] = Ls[row] * alpha + sum;
    }
    __syncwarp();

    // O_w += P_w . V, the accumulator round-tripping through shared memory
    // (WMMA fragments hide their row mapping, and each row is rescaled)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragC acc;
      float* optr = Os + warp * WR * LDO + n * 16;
      wmma::load_matrix_sync(acc, optr, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        FragA a;
        FragBRow bv;
        wmma::load_matrix_sync(a, Ps + warp * WR * LDP + kk, LDP);
        wmma::load_matrix_sync(bv, Vs + kk * LDH + n * 16, LDH);
        wmma::mma_sync(acc, a, bv, acc);
      }
      wmma::store_matrix_sync(optr, acc, LDO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = tid; i < BQ * D; i += NTHREADS) {
    const int r = i / D, d = i % D;
    const float l = Ls[r];
    const float safe_l = l > 0.f ? l : 1.f;
    o[q_base + (size_t)r * D + d] = __float2bfloat16(Os[r * LDO + d] / safe_l);
  }
  if (tid < BQ) {
    const float l = Ls[tid];
    lse[((size_t)b * H + h) * Tq + q0 + tid] =
        l > 0.f ? Ms[tid] + logf(l) : NEG_INF;
  }
}

// ---------------------------------------------------------------------------
// backward, dk/dv: one block per (64-row k tile, q head, batch); the loop
// runs over q tiles from the causal diagonal on
// ---------------------------------------------------------------------------
template <int D>
constexpr size_t bwd_smem_bytes() {
  return (size_t)4 * 64 * (D + 8) * 2      // two resident tiles + two streamed
         + (size_t)2 * 64 * LDS * 4        // scores, dp
         + (size_t)2 * 64 * LDP * 2        // p, ds (bf16)
         + (size_t)2 * 64 * 4;             // lse, delta of the q tile
}

template <int D, typename OutT>
__global__ void __launch_bounds__(NTHREADS)
fa_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   OutT* __restrict__ dk, OutT* __restrict__ dv, int H,
                   int Hkv, int Tq, int Tk, float scale, int causal,
                   int q_off, int k_off) {
  constexpr int LDH = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + 64 * LDH;
  bf16* Qs = Vs + 64 * LDH;
  bf16* dOs = Qs + 64 * LDH;
  float* Ss = reinterpret_cast<float*>(dOs + 64 * LDH);  // S^T [k][q]
  float* dPs = Ss + 64 * LDS;                             // dP^T [k][q]
  bf16* Ps = reinterpret_cast<bf16*>(dPs + 64 * LDS);
  bf16* dSs = Ps + 64 * LDP;
  float* lse_s = reinterpret_cast<float*>(dSs + 64 * LDP);
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t kv_base = (((size_t)b * Hkv + hk) * Tk + k0) * D;
  const bf16* qg = q + ((size_t)b * H + h) * Tq * D;
  const bf16* dog = dout + ((size_t)b * H + h) * Tq * D;
  const float* lseg = lse + ((size_t)b * H + h) * Tq;
  const float* deltag = delta + ((size_t)b * H + h) * Tq;

  load_tile<D>(Ks, k + kv_base, tid);
  load_tile<D>(Vs, v + kv_base, tid);

  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dk_acc[n], 0.f);
    wmma::fill_fragment(dv_acc[n], 0.f);
  }

  const int row = warp * WR + lane / 2;  // key row of the tile
  const int half = lane & 1;
  const int kp = k_off + k0 + row;
  const int nq = Tq / BQ;
  for (int i = 0; i < nq; ++i) {
    const int qs = q_off + i * BQ;
    if (causal && qs + BQ - 1 < k_off + k0) continue;  // above the diagonal
    __syncthreads();
    load_tile<D>(Qs, qg + (size_t)i * BQ * D, tid);
    load_tile<D>(dOs, dog + (size_t)i * BQ * D, tid);
    if (tid < BQ) {
      lse_s[tid] = lseg[i * BQ + tid];
      delta_s[tid] = deltag[i * BQ + tid];
    }
    __syncthreads();

    warp_abt<D>(Ss + warp * WR * LDS, Ks + warp * WR * LDH, Qs);   // K_w Q^T
    warp_abt<D>(dPs + warp * WR * LDS, Vs + warp * WR * LDH, dOs); // V_w dO^T
    __syncwarp();

    const float* srow = Ss + row * LDS;
    const float* dprow = dPs + row * LDS;
    bf16* prow = Ps + row * LDP;
    bf16* dsrow = dSs + row * LDP;
    for (int c = half * (BQ / 2); c < (half + 1) * (BQ / 2); ++c) {
      float s = srow[c] * scale;
      if (causal && qs + c < kp) s = NEG_INF;
      const float l = lse_s[c];
      // rows with no visible key (lse == NEG_INF) get p = 0, never exp(0)
      const float p = l > NEG_INF * 0.5f ? expf(s - l) : 0.f;
      const float ds = p * (dprow[c] - delta_s[c]) * scale;
      prow[c] = __float2bfloat16(p);
      dsrow[c] = __float2bfloat16(ds);
    }
    __syncwarp();

    warp_ab_acc<D>(dv_acc, Ps + warp * WR * LDP, dOs);  // dV_w += P^T_w dO
    warp_ab_acc<D>(dk_acc, dSs + warp * WR * LDP, Qs);  // dK_w += dS^T_w Q
  }

  // the score tiles are free once every warp has left the loop; each warp
  // stages its rows there (16 x (D + 4) f32 fits in its share of S and dP)
  __syncthreads();
  float* stage = Ss + warp * WR * (D + 4);
  const size_t out_base = (((size_t)b * H + h) * Tk + k0 + warp * WR) * D;
  store_rows<D>(dk + out_base, dk_acc, stage);
  store_rows<D>(dv + out_base, dv_acc, stage);
}

// ---------------------------------------------------------------------------
// backward, dq: one block per (64-row q tile, head, batch); the loop runs
// over k tiles up to the causal diagonal
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
fa_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int H, int Hkv, int Tq, int Tk,
                 float scale, int causal, int q_off, int k_off) {
  constexpr int LDH = D + 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + 64 * LDH;
  bf16* Ks = dOs + 64 * LDH;
  bf16* Vs = Ks + 64 * LDH;
  float* Ss = reinterpret_cast<float*>(Vs + 64 * LDH);
  float* dPs = Ss + 64 * LDS;
  bf16* dSs = reinterpret_cast<bf16*>(dPs + 64 * LDS);
  float* lse_s = reinterpret_cast<float*>(dSs + 2 * 64 * LDP);
  float* delta_s = lse_s + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const size_t q_base = (((size_t)b * H + h) * Tq + q0) * D;
  const bf16* kg = k + ((size_t)b * Hkv + hk) * Tk * D;
  const bf16* vg = v + ((size_t)b * Hkv + hk) * Tk * D;

  load_tile<D>(Qs, q + q_base, tid);
  load_tile<D>(dOs, dout + q_base, tid);
  if (tid < BQ) {
    lse_s[tid] = lse[((size_t)b * H + h) * Tq + q0 + tid];
    delta_s[tid] = delta[((size_t)b * H + h) * Tq + q0 + tid];
  }

  FragC dq_acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(dq_acc[n], 0.f);

  const int row = warp * WR + lane / 2;
  const int half = lane & 1;
  const int qp = q_off + q0 + row;
  const int q_last = q_off + q0 + BQ - 1;
  const int nk = Tk / BK;
  for (int j = 0; j < nk; ++j) {
    const int k0 = k_off + j * BK;
    if (causal && q_last < k0) break;
    __syncthreads();
    load_tile<D>(Ks, kg + (size_t)j * BK * D, tid);
    load_tile<D>(Vs, vg + (size_t)j * BK * D, tid);
    __syncthreads();

    warp_abt<D>(Ss + warp * WR * LDS, Qs + warp * WR * LDH, Ks);    // Q_w K^T
    warp_abt<D>(dPs + warp * WR * LDS, dOs + warp * WR * LDH, Vs);  // dO_w V^T
    __syncwarp();

    const float l = lse_s[row];
    const bool valid = l > NEG_INF * 0.5f;
    const float dl = delta_s[row];
    const float* srow = Ss + row * LDS;
    const float* dprow = dPs + row * LDS;
    bf16* dsrow = dSs + row * LDP;
    for (int c = half * (BK / 2); c < (half + 1) * (BK / 2); ++c) {
      float s = srow[c] * scale;
      if (causal && qp < k0 + c) s = NEG_INF;
      const float p = valid ? expf(s - l) : 0.f;
      dsrow[c] = __float2bfloat16(p * (dprow[c] - dl) * scale);
    }
    __syncwarp();

    warp_ab_acc<D>(dq_acc, dSs + warp * WR * LDP, Ks);  // dQ_w += dS_w K
  }

  __syncthreads();  // as in dk/dv: stage in the freed score tiles
  store_rows<D>(dq + q_base + (size_t)warp * WR * D, dq_acc, Ss + warp * WR * (D + 4));
}

// ---------------------------------------------------------------------------
// C entries (bound with ctypes; pointers and the stream arrive as integers)
// ---------------------------------------------------------------------------
template <int D>
static int launch_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int H, int Hkv, int Tq, int Tk,
                      float scale, int causal, int q_off, int k_off,
                      cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Tq / BQ, H, B);
  fa_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse,
      H, Hkv, Tq, Tk, scale, causal, q_off, k_off);
  return (int)cudaGetLastError();
}

template <int D, typename OutT>
static int launch_dkdv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Hkv, int Tq,
                       int Tk, float scale, int causal, int q_off, int k_off,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dkdv_kernel<D, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Tk / BK, H, B);
  fa_bwd_dkdv_kernel<D, OutT><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (OutT*)dk, (OutT*)dv, H, Hkv,
      Tq, Tk, scale, causal, q_off, k_off);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int Hkv, int Tq, int Tk,
                     float scale, int causal, int q_off, int k_off,
                     cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(Tq / BQ, H, B);
  fa_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, H, Hkv, Tq, Tk,
      scale, causal, q_off, k_off);
  return (int)cudaGetLastError();
}

extern "C" {

int fa_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hkv, int Tq, int Tk, int D, float scale,
           int causal, int q_off, int k_off, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_fwd<64>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, scale, causal, q_off, k_off, s);
  if (D == 128)
    return launch_fwd<128>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, scale, causal, q_off, k_off, s);
  return (int)cudaErrorInvalidValue;
}

// out_bf16: dk/dv in bf16 (H == Hkv), else f32 per query head
int fa_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const void* lse, const void* delta, void* dk, void* dv, int B,
                int H, int Hkv, int Tq, int Tk, int D, float scale, int causal,
                int q_off, int k_off, int out_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define FA_DKDV(DIM, T)                                                        \
  return launch_dkdv<DIM, T>(q, k, v, dout, lse, delta, dk, dv, B, H, Hkv, Tq, \
                             Tk, scale, causal, q_off, k_off, s)
  if (D == 64 && out_bf16) FA_DKDV(64, bf16);
  if (D == 64) FA_DKDV(64, float);
  if (D == 128 && out_bf16) FA_DKDV(128, bf16);
  if (D == 128) FA_DKDV(128, float);
#undef FA_DKDV
  return (int)cudaErrorInvalidValue;
}

int fa_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int H,
              int Hkv, int Tq, int Tk, int D, float scale, int causal,
              int q_off, int k_off, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Tq, Tk,
                         scale, causal, q_off, k_off, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Hkv, Tq, Tk,
                          scale, causal, q_off, k_off, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
