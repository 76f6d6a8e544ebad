// Embedding row gather and in-place scatter for Hopper (sm_90a), f32 rows.
//
// Replaces the Pallas kernels of dlrover_tpu/ops/embedding/device_tier.py:
//   emb_gather  <- _Kernels._build_gather's kernel (:139):  rows[i] = table[slots[i]]
//   emb_scatter <- _Kernels._build_scatter's kernel (:162): table[slots[i]] = rows[i],
//                  in place (the Pallas call aliases the table to its output)
//
// The TPU kernels move one row per grid step, the slot list scalar-prefetched
// so the BlockSpec index map can address the row. Both are pure memory
// copies: n rows of row_floats f32 read and n written, no arithmetic, so
// HBM bandwidth bounds them on the card. Here each warp moves one whole row
// and loads its own slot (a broadcast read); eight warps a block keep many
// rows in flight. When row_floats is a multiple of 4 and the buffers are
// 16-byte aligned, every lane moves 16 bytes a step (float4), neighbouring
// lanes on neighbouring addresses; otherwise a scalar path moves 4 bytes a
// lane a step. The scatter writes straight into the table tensor: there is
// no table-sized copy.
//
// Contract (the device tier keeps it): slots are int32 in [0, table_rows).
// Padding entries all name the scratch row and carry identical values, so
// their concurrent writes in the scatter race benignly. A slot out of range
// is skipped by the scatter and reads a zero row in the gather, so a bad
// slot can never touch memory outside the table.
//
// Each C entry returns cudaGetLastError() of its launch (0 = success).

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int WARPS = 8;  // rows per block
constexpr int NTHREADS = WARPS * 32;

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS)
emb_gather_kernel(const float* __restrict__ table, long long table_rows,
                  const int* __restrict__ slots, float* __restrict__ out,
                  int n, int row_floats) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const long long s = __ldg(slots + row);
  float* dst = out + (size_t)row * row_floats;
  if (s < 0 || s >= table_rows) {
    for (int c = lane; c < row_floats; c += 32) dst[c] = 0.f;
    return;
  }
  const float* src = table + (size_t)s * row_floats;
  if (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int nv = row_floats >> 2;
#pragma unroll 4
    for (int c = lane; c < nv; c += 32) d4[c] = __ldg(s4 + c);
  } else {
    for (int c = lane; c < row_floats; c += 32) dst[c] = __ldg(src + c);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NTHREADS)
emb_scatter_kernel(float* __restrict__ table, long long table_rows,
                   const int* __restrict__ slots,
                   const float* __restrict__ rows, int n, int row_floats) {
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n) return;
  const long long s = __ldg(slots + row);
  if (s < 0 || s >= table_rows) return;
  const float* src = rows + (size_t)row * row_floats;
  float* dst = table + (size_t)s * row_floats;
  if (VEC) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int nv = row_floats >> 2;
#pragma unroll 4
    for (int c = lane; c < nv; c += 32) d4[c] = __ldg(s4 + c);
  } else {
    for (int c = lane; c < row_floats; c += 32) dst[c] = __ldg(src + c);
  }
}

static bool vec_ok(const void* a, const void* b, int row_floats) {
  return row_floats % 4 == 0 && (reinterpret_cast<uintptr_t>(a) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(b) & 15) == 0;
}

extern "C" {

int emb_gather(const void* table, long long table_rows, const void* slots,
               void* out, int n, int row_floats, void* stream) {
  if (n <= 0 || row_floats <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((n + WARPS - 1) / WARPS);
  const float* t = static_cast<const float*>(table);
  const int* s = static_cast<const int*>(slots);
  float* o = static_cast<float*>(out);
  if (vec_ok(table, out, row_floats))
    emb_gather_kernel<true><<<grid, NTHREADS, 0, st>>>(t, table_rows, s, o, n, row_floats);
  else
    emb_gather_kernel<false><<<grid, NTHREADS, 0, st>>>(t, table_rows, s, o, n, row_floats);
  return (int)cudaGetLastError();
}

int emb_scatter(void* table, long long table_rows, const void* slots,
                const void* rows, int n, int row_floats, void* stream) {
  if (n <= 0 || row_floats <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((n + WARPS - 1) / WARPS);
  float* t = static_cast<float*>(table);
  const int* s = static_cast<const int*>(slots);
  const float* r = static_cast<const float*>(rows);
  if (vec_ok(table, rows, row_floats))
    emb_scatter_kernel<true><<<grid, NTHREADS, 0, st>>>(t, table_rows, s, r, n, row_floats);
  else
    emb_scatter_kernel<false><<<grid, NTHREADS, 0, st>>>(t, table_rows, s, r, n, row_floats);
  return (int)cudaGetLastError();
}

}  // extern "C"
