// Flash attention forward and backward for Hopper (sm_90a), bf16 inputs.
//
// Replaces the Pallas kernels of dlrover_tpu/ops/flash_attention.py:
//   fa_fwd      <- _fused_fwd_kernel (:273) and the streaming _fwd_kernel (:77)
//   fa_bwd_dkdv <- _fused_bwd_kernel (:337, its dk/dv half) and _bwd_dkv_kernel (:585)
//   fa_bwd_dq   <- _fused_bwd_kernel (:337, its dq half) and _bwd_dq_kernel (:508)
//
// The TPU's fused kernels keep a whole [T, T] f32 score tile per head in
// VMEM. A Hopper block has 227 KB of shared memory and 64 K registers, so
// every kernel here tiles with the streaming FA2 algebra: the online
// softmax in the forward, p recomputed from the saved lse in the backward.
//
// What bounds them on the card: at head_dim 64-128 causal attention does
// ~T/2 operations per byte read, above the H100's ~295 ops/byte ridge for
// T >= 1024, so the tensor cores bound them (at the gpt2_small shape the
// two bounds are about equal); at head_dim 64 the exponentials (one per
// 256 tensor-core operations, on a unit ~250x slower) cost about as much
// as the products.
//
// All three kernels are designed around what Hopper has:
//   - a block is three warpgroups: two consumers that own 64 rows each
//     (query rows in the forward and in dq, key rows in dk/dv) and one
//     producer, of which a single thread issues every load; setmaxnreg
//     moves the producer's registers to the consumers (24 / 240);
//   - loads are TMA tile copies (cp.async.bulk.tensor, 128-byte swizzle,
//     tensor maps over [B*H, T, D] made on the host per call) into a ring
//     of stages, each stage announced by an mbarrier and handed back by the
//     consumers through a second one, so the tiles of later steps are in
//     flight while the tensor cores work on this one. The block's own rows
//     (Q in the forward; Q and dO in dq; K and V in dk/dv) are loaded once;
//   - products are wgmma (m64nNk16, f32 accumulation). The first products
//     of a step (S = Q K^T; in dq also dP = dO V^T; in dk/dv S^T = K Q^T
//     and dP^T = V dO^T) read both operands from shared memory; their
//     results stay in registers, where the softmax runs (row max and sum
//     are two shuffles inside a quad), and, rounded to bf16, are the
//     register A operand of the next product (O += P V; dQ += dS K;
//     dV += P^T dO, dK += dS^T Q), whose B operand is the [rows, D] tile
//     read MN-major (transpose-B). Scores, probabilities and the
//     accumulators never touch shared memory;
//   - the exponent is exp2 with scale * log2(e) folded into the scores;
//     lse is stored in natural log. The causal mask is evaluated only on
//     tiles the diagonal crosses; tiles wholly in the future are not
//     loaded; heavy (late) query tiles are scheduled first (the forward
//     and dq), early key tiles first (dk/dv);
//   - results leave through shared memory (the warp's own rows of a tile
//     that is no longer read) as 16-byte stores; dk/dv in f32 go straight
//     from registers (a quad writes one 32-byte sector).
//
// Numerics follow the Pallas kernels: NEG_INF = -1e30 is finite, rows
// with no visible key give o = 0 and lse = NEG_INF, p and ds are rounded
// to bf16 before each product that consumes them, and in the backward
// p = 0 on rows whose lse is NEG_INF. dq is written in bf16. dk/dv are
// written in bf16 when every kv head has one query head; under GQA they
// are written in f32 per query head and the caller sums each group and
// casts (as :818-833 does).
//
// Each C entry returns cudaGetLastError() of its launch (0 = success), or
// 10000 + the CUresult if a tensor map could not be made.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define NEG_INF (-1e30f)
#define LOG2E 1.4426950408889634f
#define LN2 0.6931471805599453f

// ===========================================================================
// Hopper building blocks: mbarrier, TMA, wgmma
// ===========================================================================
constexpr int WG = 128;              // threads of a warpgroup
constexpr int FA_THREADS = 3 * WG;   // two consumers and the producer
constexpr int FWD_BM = 128;          // forward: query rows a block
constexpr int FWD_BN = 64;           // forward: keys a tile
constexpr int FWD_STAGES = 4;
constexpr int DQ_STAGES = 4;         // dq: the forward's tiles, K and V ring
constexpr int DKV_BN = 128;          // dk/dv: keys a block
constexpr int DKV_BM = 64;           // dk/dv: query rows a step
constexpr int DKV_STAGES = 3;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// returns once the barrier's phase of this parity has completed. (No
// time limit with a trap here: a trap's exit edge inside the consumers'
// loop makes ptxas serialize the wgmma and spill the accumulators.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one [box rows x 64] bf16 box of a [B*H, T, D] tensor -> shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(row), "r"(bh)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both ends 16-byte aligned)
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving uses of an accumulator across the
// asynchronous products that write it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor for a tile of 128-byte rows under the
// 128-byte swizzle (what TMA writes): 8-row groups 1024 bytes apart (SBO).
// K-major operands (the contraction runs along the 128-byte row) ignore
// LBO; MN-major ones (transpose-B) use it as the distance between two
// 64-element sub-tiles.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo_bytes) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo_bytes >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

#define FA_F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define FA_F16(a, i) FA_F4(a, i), FA_F4(a, i + 4), FA_F4(a, i + 8), FA_F4(a, i + 12)
#define FA_F32(a, i) FA_F16(a, i), FA_F16(a, i + 16)

// d[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, both K-major in shared memory
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FA_F32(d, 0)
      : "l"(da), "l"(db), "r"(acc));
}

// d[64 x 64] += A[64 x 16] (registers) . B[16 x 64] (MN-major in shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : FA_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] (registers) . B[16 x 128] (MN-major, two sub-tiles)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      " %8, %9, %10, %11, %12, %13, %14, %15, "
      " %16, %17, %18, %19, %20, %21, %22, %23, "
      " %24, %25, %26, %27, %28, %29, %30, %31, "
      " %32, %33, %34, %35, %36, %37, %38, %39, "
      " %40, %41, %42, %43, %44, %45, %46, %47, "
      " %48, %49, %50, %51, %52, %53, %54, %55, "
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : FA_F32(d, 0), FA_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x on the special-function unit alone: exp2f() without its scaling of
// results below 2^-126, which flush to 0 here (p that small is 0 in bf16)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__host__ __device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// c[64 x 64] = A[64 x D] . B[64 x D]^T: A at `a`, B at `b`, both tiles of
// D/64 sub-tiles ([rows x 64] bf16, swizzled), `a_sub` / `b_sub` bytes apart
template <int D>
__device__ __forceinline__ void product_abt(float (&c)[32], uint32_t a, uint32_t a_sub,
                                            uint32_t b, uint32_t b_sub) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;  // 16 bf16 along the swizzled row
    wgmma_ss(c, smem_desc(a + (kk / 4) * a_sub + off, 0),
             smem_desc(b + (kk / 4) * b_sub + off, 0), kk > 0);
  }
}

// acc[64 x D] += P[64 x 64] . B[64 x D]: P as bf16 pairs in the A layout
// (the packed accumulator of a 64 x 64 product), B a [64 x D] tile at `b`
template <int D>
__device__ __forceinline__ void product_pb(float (&acc)[D / 2], const uint32_t (&p)[16],
                                           uint32_t b, uint32_t b_sub) {
#pragma unroll
  for (int i = 0; i < 4; ++i)  // 16 rows of B (2048 bytes) a step
    wgmma_rs(acc, p + 4 * i, smem_desc(b + i * 2048, b_sub));
}

// A warpgroup's 64 x D accumulator (wgmma layout: lane l of warp w holds
// rows 16w + l/4 and +8, column pairs 8j + 2(l%4)), its two rows scaled,
// to bf16 rows of D at `dst`. Each warp stages its 16 rows in shared
// memory (sub-tiles of [ROWS x 64] bf16 under the 128-byte swizzle, the
// warpgroup's rows starting at `row0`, a multiple of 8) and writes them
// out 16 bytes a lane, neighbouring lanes on neighbouring addresses.
template <int D, int ROWS>
__device__ __forceinline__ void store_tile_bf16(uint8_t* tile, int row0, const float (&acc)[D / 2],
                                                float sc0, float sc1, bf16* __restrict__ dst,
                                                int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  uint8_t* wrow = tile + (row0 + 16 * warp) * 128;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    uint8_t* p = wrow + (j / 8) * ROWS * 128 + g * 128 + (((j % 8) ^ g) << 4) + t * 4;
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(acc[4 * j] * sc0, acc[4 * j + 1] * sc0);
    *reinterpret_cast<uint32_t*>(p + 8 * 128) =
        pack_bf16(acc[4 * j + 2] * sc1, acc[4 * j + 3] * sc1);
  }
  __syncwarp();
  constexpr int CPR = D / 8;  // 16-byte chunks a row
#pragma unroll
  for (int idx = lane; idx < 16 * CPR; idx += 32) {
    const int r = idx / CPR, c = idx % CPR;
    const uint4 val = *reinterpret_cast<const uint4*>(
        wrow + (c / 8) * ROWS * 128 + r * 128 + (((c % 8) ^ (r % 8)) << 4));
    *reinterpret_cast<uint4*>(dst + (size_t)(16 * warp + r) * D + c * 8) = val;
  }
  __syncwarp();
}

// the same tile in f32, straight from registers: a quad writes 32
// contiguous bytes of a row
template <int D>
__device__ __forceinline__ void store_tile_f32(const float (&acc)[D / 2], float* __restrict__ dst,
                                               int warp, int lane) {
  const int g = lane >> 2, t = lane & 3;
  float* r0 = dst + (size_t)(16 * warp + g) * D + 2 * t;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(r0 + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(r0 + 8 * D + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// ===========================================================================
// forward: one block per (128-row q tile, head, batch)
// ===========================================================================
// where a forward (or dq) block works: its (batch, head), first query row
// and the number of key tiles any of its rows sees. Each role works it out for
// itself after the split, so that nothing but the barriers' addresses
// lives across setmaxnreg.
struct FwdBlock {
  int bh, kv_bh, q0, nk;
  __device__ __forceinline__ FwdBlock(int H, int Hkv, int Tq, int Tk, int causal, int q_off,
                                      int k_off) {
    bh = blockIdx.x;
    kv_bh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
    // late query tiles see the most keys: they go first
    q0 = (causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y) * FWD_BM;
    nk = Tk / FWD_BN;
    if (causal) {
      const int lim = q_off + min(q0 + FWD_BM, Tq) - 1 - k_off;
      nk = lim < 0 ? 0 : min(nk, lim / FWD_BN + 1);
    }
  }
};

template <int D>
constexpr size_t fwd_smem_bytes() {
  return 1024                                        // room to align to the swizzle atom
         + (size_t)FWD_BM * D * 2                    // Q
         + (size_t)FWD_STAGES * 2 * FWD_BN * D * 2   // K and V rings
         + 8 * (1 + 2 * FWD_STAGES);                 // mbarriers
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS, 1)
fa_fwd_kernel(const __grid_constant__ CUtensorMap map_q,
              const __grid_constant__ CUtensorMap map_k,
              const __grid_constant__ CUtensorMap map_v, bf16* __restrict__ o,
              float* __restrict__ lse, int H, int Hkv, int Tq, int Tk,
              float scale_log2, int causal, int q_off, int k_off) {
  constexpr int SUB = D / 64;
  constexpr uint32_t Q_BYTES = FWD_BM * D * 2, KV_BYTES = FWD_BN * D * 2;
  constexpr uint32_t Q_SUB = FWD_BM * 128, KV_SUB = FWD_BN * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u;
  uint8_t* gQ = smem_raw + (sQ - raw);
  const uint32_t sKV = sQ + Q_BYTES;  // stage s: K at sKV + 2 s KV_BYTES, V after it
  const uint32_t bar_q = sKV + FWD_STAGES * 2 * KV_BYTES;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * FWD_STAGES;

  const int tid = threadIdx.x, wg = tid / WG;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);  // a lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 2 * WG) {
      const FwdBlock blk(H, Hkv, Tq, Tk, causal, q_off, k_off);
      const int bh = blk.bh, q0 = blk.q0, nk = blk.nk;
      mbar_expect_tx(bar_q, Q_BYTES);
      for (int s = 0; s < SUB; ++s) tma_load(sQ + s * Q_SUB, &map_q, bar_q, s * 64, q0, bh);
      for (int j = 0; j < nk; ++j) {
        const int st = j % FWD_STAGES;
        mbar_wait(bar_empty + 8 * st, ((j / FWD_STAGES) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * st, sK = sKV + st * 2 * KV_BYTES;
        mbar_expect_tx(full, 2 * KV_BYTES);
        for (int s = 0; s < SUB; ++s) {
          tma_load(sK + s * KV_SUB, &map_k, full, s * 64, j * FWD_BN, blk.kv_bh);
          tma_load(sK + KV_BYTES + s * KV_SUB, &map_v, full, s * 64, j * FWD_BN, blk.kv_bh);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const FwdBlock blk(H, Hkv, Tq, Tk, causal, q_off, k_off);
    const int bh = blk.bh, q0 = blk.q0, nk = blk.nk;
    const int warp = (tid % WG) / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int qw0 = q0 + 64 * wg;        // first row of this warpgroup
    const int qpos = q_off + qw0 - k_off;  // its position relative to key 0
    // tiles this warpgroup sees at all, and those it sees without a mask
    int nk_wg = qw0 < Tq ? nk : 0, n_full = nk_wg;
    if (causal && nk_wg > 0) {
      nk_wg = qpos + 63 < 0 ? 0 : min(nk, (qpos + 63) / FWD_BN + 1);
      n_full = min(nk_wg, max(0, floordiv(qpos - FWD_BN + 1, FWD_BN) + 1));
    }

    float oacc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;  // rows g and g + 8, log2 domain

    mbar_wait(bar_q, 0);
    for (int j = 0; j < nk; ++j) {
      const int st = j % FWD_STAGES;
      mbar_wait(bar_full + 8 * st, (j / FWD_STAGES) & 1);
      if (j < nk_wg) {
        const uint32_t sK = sKV + st * 2 * KV_BYTES;
        float s[32];
        wgmma_fence();
        product_abt<D>(s, sQ + 64 * wg * 128, Q_SUB, sK, KV_SUB);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);

#pragma unroll
        for (int i = 0; i < 32; ++i) s[i] *= scale_log2;
        if (j >= n_full) {  // the diagonal crosses this tile
          const int d0 = qpos + 16 * warp + g - j * FWD_BN - 2 * t;  // row g; row g + 8: d0 + 8
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int c = 8 * (i / 4) + (i & 1);
            if (d0 + ((i & 2) ? 8 : 0) < c) s[i] = NEG_INF;
          }
        }
        float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          mx0 = fmaxf(mx0, fmaxf(s[i], s[i + 1]));
          mx1 = fmaxf(mx1, fmaxf(s[i + 2], s[i + 3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        // rows masked so far keep the max at NEG_INF: exponentiate against
        // 0 there so p = exp2(NEG_INF) = 0 instead of exp2(0) = 1
        const float ms0 = mn0 > NEG_INF * 0.5f ? mn0 : 0.f;
        const float ms1 = mn1 > NEG_INF * 0.5f ? mn1 : 0.f;
        const float a0 = fast_exp2(m0 - ms0), a1 = fast_exp2(m1 - ms1);
        m0 = mn0;
        m1 = mn1;
        float sum0 = 0.f, sum1 = 0.f;
        uint32_t p[16];
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          const float p00 = fast_exp2(s[i] - ms0), p01 = fast_exp2(s[i + 1] - ms0);
          const float p10 = fast_exp2(s[i + 2] - ms1), p11 = fast_exp2(s[i + 3] - ms1);
          sum0 += p00 + p01;
          sum1 += p10 + p11;
          p[i / 2] = pack_bf16(p00, p01);
          p[i / 2 + 1] = pack_bf16(p10, p11);
        }
        l0 = l0 * a0 + sum0;  // this thread's columns; the quad is summed at the end
        l1 = l1 * a1 + sum1;
#pragma unroll
        for (int i = 0; i < D / 2; i += 4) {
          oacc[i] *= a0;
          oacc[i + 1] *= a0;
          oacc[i + 2] *= a1;
          oacc[i + 3] *= a1;
        }
        fence_regs(oacc);
        wgmma_fence();
        product_pb<D>(oacc, p, sK + KV_BYTES, KV_SUB);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(oacc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    if (qw0 < Tq) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const size_t row_base = (size_t)bh * Tq + qw0;
      if (t == 0) {
        float* lrow = lse + row_base + 16 * warp + g;
        lrow[0] = l0 > 0.f ? m0 * LN2 + logf(l0) : NEG_INF;
        lrow[8] = l1 > 0.f ? m1 * LN2 + logf(l1) : NEG_INF;
      }
      // Q's rows of this warpgroup are read by no one else any more
      store_tile_bf16<D, FWD_BM>(gQ, 64 * wg, oacc, l0 > 0.f ? 1.f / l0 : 1.f,
                                 l1 > 0.f ? 1.f / l1 : 1.f, o + row_base * D, warp, lane);
    }
  }
}

// ===========================================================================
// backward, dk/dv: one block per (128-row k tile, q head, batch); the loop
// runs over 64-row q tiles from the causal diagonal on
// ===========================================================================
// where a dk/dv block works (as FwdBlock): its (batch, q head), first key
// row, and the query tiles it walks: from the first with a row at or past
// the block's first key to the last
struct DkvBlock {
  int bh, kv_bh, k0, i_start, n_it;
  __device__ __forceinline__ DkvBlock(int H, int Hkv, int Tq, int causal, int q_off, int k_off) {
    bh = blockIdx.x;
    kv_bh = (bh / H) * Hkv + (bh % H) / (H / Hkv);
    k0 = blockIdx.y * DKV_BN;  // early key tiles see the most queries: they go first
    const int nq = Tq / DKV_BM;
    i_start = causal ? min(nq, max(0, floordiv(k_off + k0 - q_off, DKV_BM))) : 0;
    n_it = nq - i_start;
  }
};

template <int D>
__host__ __device__ constexpr uint32_t dkv_stage_bytes() {
  return 2 * DKV_BM * D * 2 + 1024;  // Q, dO, then lse and delta (256 bytes each)
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return 1024 + (size_t)2 * DKV_BN * D * 2 + (size_t)DKV_STAGES * dkv_stage_bytes<D>() +
         8 * (1 + 2 * DKV_STAGES);
}

template <int D, typename OutT>
__global__ void __launch_bounds__(FA_THREADS, 1)
fa_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   OutT* __restrict__ dk, OutT* __restrict__ dv, int H, int Hkv,
                   int Tq, int Tk, float scale, int causal, int q_off, int k_off) {
  constexpr int SUB = D / 64;
  constexpr uint32_t KV_BYTES = DKV_BN * D * 2, KV_SUB = DKV_BN * 128;
  constexpr uint32_t QD_BYTES = DKV_BM * D * 2, QD_SUB = DKV_BM * 128;
  constexpr uint32_t STAGE = dkv_stage_bytes<D>();
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023u) & ~1023u, sV = sK + KV_BYTES;
  uint8_t* gK = smem_raw + (sK - raw);
  const uint32_t sRing = sV + KV_BYTES;  // stage s: Q, dO, lse, delta
  const uint32_t bar_kv = sRing + DKV_STAGES * STAGE;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_full + 8 * DKV_STAGES;

  const int tid = threadIdx.x, wg = tid / WG;
  if (tid == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 2 * WG) {
      const DkvBlock blk(H, Hkv, Tq, causal, q_off, k_off);
      const int bh = blk.bh, k0 = blk.k0, i_start = blk.i_start, n_it = blk.n_it;
      mbar_expect_tx(bar_kv, 2 * KV_BYTES);
      for (int s = 0; s < SUB; ++s) {
        tma_load(sK + s * KV_SUB, &map_k, bar_kv, s * 64, k0, blk.kv_bh);
        tma_load(sV + s * KV_SUB, &map_v, bar_kv, s * 64, k0, blk.kv_bh);
      }
      const float* lse_g = lse + (size_t)bh * Tq;
      const float* delta_g = delta + (size_t)bh * Tq;
      for (int it = 0; it < n_it; ++it) {
        const int st = it % DKV_STAGES, q0 = (i_start + it) * DKV_BM;
        mbar_wait(bar_empty + 8 * st, ((it / DKV_STAGES) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * st, sQ = sRing + st * STAGE;
        mbar_expect_tx(full, 2 * QD_BYTES + 512);
        for (int s = 0; s < SUB; ++s) {
          tma_load(sQ + s * QD_SUB, &map_q, full, s * 64, q0, bh);
          tma_load(sQ + QD_BYTES + s * QD_SUB, &map_do, full, s * 64, q0, bh);
        }
        bulk_load(sQ + 2 * QD_BYTES, lse_g + q0, 256, full);
        bulk_load(sQ + 2 * QD_BYTES + 256, delta_g + q0, 256, full);
      }
    }
  } else {
    // ---- consumers: 64 key rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const DkvBlock blk(H, Hkv, Tq, causal, q_off, k_off);
    const int bh = blk.bh, k0 = blk.k0, i_start = blk.i_start, n_it = blk.n_it;
    const int warp = (tid % WG) / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int kw0 = k0 + 64 * wg;          // first key row of this warpgroup
    const bool valid = kw0 < Tk;
    const int kpos = k_off + kw0 - q_off;  // its position relative to query 0
    const int dbase = kpos + 16 * warp + g - 2 * t;
    // the first query tile that sees this warpgroup's keys (none if they lie
    // past Tk), and the tile from which on every row sees every one of them
    int i_first = valid ? i_start : INT_MAX, i_full = 0;
    if (causal && valid) {
      i_first = max(i_start, floordiv(kpos, DKV_BM));
      i_full = floordiv(kpos + 63 + DKV_BM - 1, DKV_BM);
    }

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    const float scale_log2 = scale * LOG2E;

    mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_it; ++it) {
      const int st = it % DKV_STAGES, qi = i_start + it;
      mbar_wait(bar_full + 8 * st, (it / DKV_STAGES) & 1);
      if (qi >= i_first) {
        const uint32_t sQ = sRing + st * STAGE, sdO = sQ + QD_BYTES;
        // lse, then delta, of this lane's first query column
        const float* stat = reinterpret_cast<const float*>(gK + (sQ + 2 * QD_BYTES - sK)) + 2 * t;
        const uint32_t sKw = sK + 64 * wg * 128, sVw = sV + 64 * wg * 128;
        float s[32], dp[32];
        wgmma_fence();
        product_abt<D>(s, sKw, KV_SUB, sQ, QD_SUB);     // S^T = K Q^T
        product_abt<D>(dp, sVw, KV_SUB, sdO, QD_SUB);   // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // p = exp(s scale - lse) per query column, 0 where the query has no
        // visible key at all (lse == NEG_INF) or the pair is masked; ds =
        // p (dp - delta) scale; both rounded to bf16 for their products,
        // eight columns at a time, so that the scores' registers are freed
        // as the packed ones fill. Query column c sees key row g iff c >=
        // d0 (row g + 8: d0 + 8).
        const bool masked = qi < i_full;
        const int d0 = dbase - qi * DKV_BM;
        uint32_t p[16], ds[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(stat + 8 * j);
          const float2 dl = *reinterpret_cast<const float2*>(stat + 64 + 8 * j);
          float pv[4], dsv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float lq = (e & 1) ? l.y : l.x;
            const bool vis = lq > NEG_INF * 0.5f &&
                             !(masked && 8 * j + (e & 1) < d0 + ((e & 2) ? 8 : 0));
            pv[e] = vis ? fast_exp2(s[4 * j + e] * scale_log2 - lq * LOG2E) : 0.f;
            dsv[e] = pv[e] * (dp[4 * j + e] - ((e & 1) ? dl.y : dl.x)) * scale;
          }
          p[2 * j] = pack_bf16(pv[0], pv[1]);
          p[2 * j + 1] = pack_bf16(pv[2], pv[3]);
          ds[2 * j] = pack_bf16(dsv[0], dsv[1]);
          ds[2 * j + 1] = pack_bf16(dsv[2], dsv[3]);
          asm volatile("" ::: "memory");  // the next columns' lse and delta are read then
        }
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        wgmma_fence();
        product_pb<D>(dv_acc, p, sdO, QD_SUB);  // dV += P^T dO
        product_pb<D>(dk_acc, ds, sQ, QD_SUB);  // dK += dS^T Q
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    if (valid) {
      const size_t out = ((size_t)bh * Tk + kw0) * D;
      if constexpr (sizeof(OutT) == 2) {
        // this warpgroup's rows of K, then of V, are read by no one else
        store_tile_bf16<D, DKV_BN>(gK, 64 * wg, dk_acc, 1.f, 1.f, (bf16*)dk + out, warp, lane);
        store_tile_bf16<D, DKV_BN>(gK + KV_BYTES, 64 * wg, dv_acc, 1.f, 1.f, (bf16*)dv + out,
                                   warp, lane);
      } else {
        store_tile_f32<D>(dk_acc, (float*)dk + out, warp, lane);
        store_tile_f32<D>(dv_acc, (float*)dv + out, warp, lane);
      }
    }
  }
}

// ===========================================================================
// backward, dq: one block per (128-row q tile, head, batch); the loop runs
// over 64-key tiles up to the causal diagonal, as the forward's does
// ===========================================================================
// The forward's schedule with one more product: Q and dO stay resident,
// K and V stream through the ring, and each step forms S = Q K^T and
// dP = dO V^T, then dQ += dS K with dS as the register A operand and the K
// tile read MN-major (as O += P V reads V). A block's tiles and the
// keys its rows see are FwdBlock's.
template <int D>
constexpr size_t dq_smem_bytes() {
  return 1024                                       // room to align to the swizzle atom
         + (size_t)2 * FWD_BM * D * 2               // Q and dO
         + (size_t)DQ_STAGES * 2 * FWD_BN * D * 2   // K and V rings
         + 8 * (1 + 2 * DQ_STAGES);                 // mbarriers
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS, 1)
fa_bwd_dq_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v,
                 const __grid_constant__ CUtensorMap map_do,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 bf16* __restrict__ dq, int H, int Hkv, int Tq, int Tk, float scale,
                 int causal, int q_off, int k_off) {
  constexpr int SUB = D / 64;
  constexpr uint32_t Q_BYTES = FWD_BM * D * 2, KV_BYTES = FWD_BN * D * 2;
  constexpr uint32_t Q_SUB = FWD_BM * 128, KV_SUB = FWD_BN * 128;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023u) & ~1023u, sdO = sQ + Q_BYTES;
  uint8_t* gQ = smem_raw + (sQ - raw);
  const uint32_t sKV = sdO + Q_BYTES;  // stage s: K at sKV + 2 s KV_BYTES, V after it
  const uint32_t bar_q = sKV + DQ_STAGES * 2 * KV_BYTES;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * DQ_STAGES;

  const int tid = threadIdx.x, wg = tid / WG;
  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < DQ_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 8);  // a lane of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid == 2 * WG) {
      const FwdBlock blk(H, Hkv, Tq, Tk, causal, q_off, k_off);
      const int bh = blk.bh, q0 = blk.q0, nk = blk.nk;
      mbar_expect_tx(bar_q, 2 * Q_BYTES);
      for (int s = 0; s < SUB; ++s) {
        tma_load(sQ + s * Q_SUB, &map_q, bar_q, s * 64, q0, bh);
        tma_load(sdO + s * Q_SUB, &map_do, bar_q, s * 64, q0, bh);
      }
      for (int j = 0; j < nk; ++j) {
        const int st = j % DQ_STAGES;
        mbar_wait(bar_empty + 8 * st, ((j / DQ_STAGES) & 1) ^ 1);
        const uint32_t full = bar_full + 8 * st, sK = sKV + st * 2 * KV_BYTES;
        mbar_expect_tx(full, 2 * KV_BYTES);
        for (int s = 0; s < SUB; ++s) {
          tma_load(sK + s * KV_SUB, &map_k, full, s * 64, j * FWD_BN, blk.kv_bh);
          tma_load(sK + KV_BYTES + s * KV_SUB, &map_v, full, s * 64, j * FWD_BN, blk.kv_bh);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
    const FwdBlock blk(H, Hkv, Tq, Tk, causal, q_off, k_off);
    const int bh = blk.bh, q0 = blk.q0, nk = blk.nk;
    const int warp = (tid % WG) / 32, lane = tid % 32;
    const int g = lane >> 2, t = lane & 3;
    const int qw0 = q0 + 64 * wg;          // first row of this warpgroup
    const int qpos = q_off + qw0 - k_off;  // its position relative to key 0
    int nk_wg = qw0 < Tq ? nk : 0, n_full = nk_wg;  // as in the forward
    if (causal && nk_wg > 0) {
      nk_wg = qpos + 63 < 0 ? 0 : min(nk, (qpos + 63) / FWD_BN + 1);
      n_full = min(nk_wg, max(0, floordiv(qpos - FWD_BN + 1, FWD_BN) + 1));
    }
    // this lane's rows g and g + 8: lse in the exp2 domain and delta, read
    // once. A row with no visible key (lse == NEG_INF) takes lse = 1e30,
    // so that p = exp2(s - 1e30) = 0 there without a test per element.
    float lq0 = 0.f, lq1 = 0.f, dl0 = 0.f, dl1 = 0.f;
    if (qw0 < Tq) {
      const size_t r = (size_t)bh * Tq + qw0 + 16 * warp + g;
      const float l0 = lse[r], l1 = lse[r + 8];
      lq0 = l0 > NEG_INF * 0.5f ? l0 * LOG2E : -NEG_INF;
      lq1 = l1 > NEG_INF * 0.5f ? l1 * LOG2E : -NEG_INF;
      dl0 = delta[r];
      dl1 = delta[r + 8];
    }
    const float scale_log2 = scale * LOG2E;

    float dq_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int j = 0; j < nk; ++j) {
      const int st = j % DQ_STAGES;
      mbar_wait(bar_full + 8 * st, (j / DQ_STAGES) & 1);
      if (j < nk_wg) {
        const uint32_t sK = sKV + st * 2 * KV_BYTES;
        float s[32], dp[32];
        wgmma_fence();
        product_abt<D>(s, sQ + 64 * wg * 128, Q_SUB, sK, KV_SUB);               // S = Q K^T
        product_abt<D>(dp, sdO + 64 * wg * 128, Q_SUB, sK + KV_BYTES, KV_SUB);  // dP = dO V^T
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);

        // p = exp(s scale - lse), 0 where the pair is masked; ds = p (dp -
        // delta) scale, rounded to bf16 for its product, eight columns at
        // a time. Key column c is visible to row g iff c <= d0 (row g + 8:
        // d0 + 8); the mask is tested only on tiles the diagonal crosses.
        const bool masked = j >= n_full;
        const int d0 = qpos + 16 * warp + g - j * FWD_BN - 2 * t;
        uint32_t ds[16];
#pragma unroll
        for (int i = 0; i < 32; i += 4) {
          float dsv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e & 2;
            float x = s[i + e] * scale_log2 - (hi ? lq1 : lq0);
            if (masked && d0 + (hi ? 8 : 0) < 8 * (i / 4) + (e & 1)) x = NEG_INF;
            dsv[e] = fast_exp2(x) * (dp[i + e] - (hi ? dl1 : dl0)) * scale;
          }
          ds[i / 2] = pack_bf16(dsv[0], dsv[1]);
          ds[i / 2 + 1] = pack_bf16(dsv[2], dsv[3]);
        }
        fence_regs(dq_acc);
        wgmma_fence();
        product_pb<D>(dq_acc, ds, sK, KV_SUB);  // dQ += dS K
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq_acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);
    }

    if (qw0 < Tq)  // Q's rows of this warpgroup are read by no one else any more
      store_tile_bf16<D, FWD_BM>(gQ, 64 * wg, dq_acc, 1.f, 1.f,
                                 dq + ((size_t)bh * Tq + qw0) * D, warp, lane);
  }
}

// ===========================================================================
// C entries (bound with ctypes; pointers and the stream arrive as integers)
// ===========================================================================
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda the runtime already loaded
// (nothing links against it)
static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) ==
            cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = (EncodeTiledFn)p;
  }
  return fn;
}

// a map over a contiguous bf16 [BH, T, D] tensor whose box is [rows x 64]
// under the 128-byte swizzle; rows past T read as zeros. 0 = success.
static int make_map(CUtensorMap* map, const void* ptr, int BH, int T, int D, int rows) {
  EncodeTiledFn enc = encode_tiled();
  if (!enc) return 10000 + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 10000 + (int)r;
}

template <int D>
static int launch_fwd(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int H, int Hkv, int Tq, int Tk,
                      float scale, int causal, int q_off, int k_off,
                      cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int e;
  if ((e = make_map(&mq, q, B * H, Tq, D, FWD_BM))) return e;
  if ((e = make_map(&mk, k, B * Hkv, Tk, D, FWD_BN))) return e;
  if ((e = make_map(&mv, v, B * Hkv, Tk, D, FWD_BN))) return e;
  const size_t smem = fwd_smem_bytes<D>();
  cudaError_t ce = cudaFuncSetAttribute(
      fa_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid(B * H, (Tq + FWD_BM - 1) / FWD_BM);
  fa_fwd_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
      mq, mk, mv, (bf16*)o, (float*)lse, H, Hkv, Tq, Tk, scale * LOG2E, causal, q_off, k_off);
  return (int)cudaGetLastError();
}

template <int D, typename OutT>
static int launch_dkdv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int H, int Hkv, int Tq,
                       int Tk, float scale, int causal, int q_off, int k_off,
                       cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int e;
  if ((e = make_map(&mq, q, B * H, Tq, D, DKV_BM))) return e;
  if ((e = make_map(&mk, k, B * Hkv, Tk, D, DKV_BN))) return e;
  if ((e = make_map(&mv, v, B * Hkv, Tk, D, DKV_BN))) return e;
  if ((e = make_map(&mdo, dout, B * H, Tq, D, DKV_BM))) return e;
  const size_t smem = dkv_smem_bytes<D>();
  cudaError_t ce = cudaFuncSetAttribute(
      fa_bwd_dkdv_kernel<D, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid(B * H, (Tk + DKV_BN - 1) / DKV_BN);
  fa_bwd_dkdv_kernel<D, OutT><<<grid, FA_THREADS, smem, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (OutT*)dk, (OutT*)dv, H, Hkv,
      Tq, Tk, scale, causal, q_off, k_off);
  return (int)cudaGetLastError();
}

template <int D>
static int launch_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int B, int H, int Hkv, int Tq, int Tk,
                     float scale, int causal, int q_off, int k_off,
                     cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mdo;
  int e;
  if ((e = make_map(&mq, q, B * H, Tq, D, FWD_BM))) return e;
  if ((e = make_map(&mk, k, B * Hkv, Tk, D, FWD_BN))) return e;
  if ((e = make_map(&mv, v, B * Hkv, Tk, D, FWD_BN))) return e;
  if ((e = make_map(&mdo, dout, B * H, Tq, D, FWD_BM))) return e;
  const size_t smem = dq_smem_bytes<D>();
  cudaError_t ce = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid(B * H, (Tq + FWD_BM - 1) / FWD_BM);
  fa_bwd_dq_kernel<D><<<grid, FA_THREADS, smem, stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)delta, (bf16*)dq, H, Hkv, Tq, Tk,
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
