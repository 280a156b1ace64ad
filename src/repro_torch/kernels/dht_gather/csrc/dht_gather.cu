// Cached gather for the DHT lookup, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dht_gather/kernel.py
// (_dht_gather_kernel, launched by dht_gather_pallas).
//
// Contract, the TPU kernel's (out, hits) with the unsort fused in: keys are
// sorted ascending, -1 is padding, and order[q] is the caller's position of
// sorted key q (the permutation torch.sort returns; null for the identity).
// out[order[q]] = table[min(k, V-1)] for k = keys[q] >= 0 and a zero row
// for k < 0; hits = #{q > 0 : k[q] >= 0 and k[q] == k[q-1]}, which equals
// n_valid - n_distinct_valid (ShardedDHT derives n_unique from it).
//
// Bound: bytes.  The kernel reads Q keys (4 bytes each), Q order entries
// (8 bytes) and at most n_distinct rows, and writes Q rows; it does no
// arithmetic worth counting.  At SASRec's history read (Q 3,276,800, D 50
// f32) that is some 865 MB, 0.26 ms at 3.35 TB/s.
//
// Design: rows are read in sorted order, so each distinct row comes from
// HBM once and its duplicates, side by side, come from L1/L2 (the TPU
// kernel's cache), and each row is written straight to its caller's
// position: no (Q, D) temporary and no second pass to unsort it.  A row's
// bytes are cut into C chunks of W bytes (W = 16, 8, 4 or 2, the widest
// that divides the row and both base addresses; the launcher's caller
// picks it), and thread i of the flattened (Q, C) grid copies chunk i mod C
// of sorted row i / C, so no lane idles at a row's end (D 50 f32: 25
// chunks of 8 bytes).  A CTA takes NT * U consecutive chunks, and each
// thread loads the keys and order entries of its U chunks, then their U
// rows, and stores only after every load is in flight.  One tile a CTA,
// with no cap on the grid, measured faster than a grid-stride loop over
// 8 CTAs an SM.  The TPU grid runs in order, so the TPU kernel carries
// the last key of one block into the next to count hits across block
// edges; here a key is a hit iff its sorted predecessor is the same valid
// key, so the thread with chunk 0 reads the predecessor and nothing is
// carried.  Hits are summed with warp shuffles and one atomicAdd per CTA.
// The rows' writes land in random places of the caller's order, which
// bounds the kernel where most keys are distinct or Q is large.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads a CTA
constexpr int U = 4;               // chunks a thread
constexpr int TILE = NT * U;       // chunks a CTA

template <typename W>
__global__ void __launch_bounds__(NT)
    dht_gather_kernel(const W* __restrict__ table, long long V, int C,
                      const int* __restrict__ keys,
                      const long long* __restrict__ order, long long Q,
                      W* __restrict__ out, int* __restrict__ hits) {
  const long long base = (long long)blockIdx.x * TILE;
  const long long q0 = base / C;
  const int r0 = (int)(base - q0 * C);
  int h = 0;
  long long q[U], dst[U];
  int c[U], k[U];
  // keys and destinations of the U chunks, then their rows
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int n = r0 + u * NT + (int)threadIdx.x;
    const int dq = n / C;
    q[u] = q0 + dq;
    c[u] = n - dq * C;
    k[u] = -1;
    dst[u] = 0;
    if (q[u] < Q) {
      k[u] = keys[q[u]];
      dst[u] = (order ? order[q[u]] : q[u]) * C + c[u];
      if (c[u] == 0 && k[u] >= 0 && q[u] > 0 && keys[q[u] - 1] == k[u])
        h += 1;
    }
  }
  W v[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    v[u] = W{};
    if (q[u] < Q && k[u] >= 0) {
      const long long row = (long long)k[u] < V ? (long long)k[u] : V - 1;
      v[u] = table[row * C + c[u]];
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (q[u] < Q) out[dst[u]] = v[u];

  // CTA sum of the hit count: warp shuffles, then one atomic per CTA
  __shared__ int warp_hits[NT / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) h += __shfl_down_sync(0xffffffffu, h, o);
  if (lane == 0) warp_hits[warp] = h;
  __syncthreads();
  if (warp == 0) {
    h = lane < NT / 32 ? warp_hits[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) h += __shfl_down_sync(0xffffffffu, h, o);
    if (lane == 0 && h) atomicAdd(hits, h);
  }
}

template <typename W>
int launch_typed(const void* table, long long V, long long row_bytes,
                 const int* keys, const long long* order, long long Q,
                 void* out, int* hits, cudaStream_t stream) {
  const long long C = row_bytes / (long long)sizeof(W);
  const long long tiles = (Q * C + TILE - 1) / TILE;
  if (C > 0x7fffffffLL - TILE || tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  dht_gather_kernel<W><<<(unsigned int)tiles, NT, 0, stream>>>(
      static_cast<const W*>(table), V, (int)C, keys, order, Q,
      static_cast<W*>(out), hits);
  return (int)cudaGetLastError();
}

}  // namespace

// table: (V, row_bytes) rows; keys: (Q,) int32 sorted; order: (Q,) int64,
// or null for the identity; out: (Q, row_bytes) in the caller's order;
// hits: one int32 the caller zeroed.  chunk_bytes (16, 8, 4 or 2) divides
// row_bytes and both base addresses.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int dht_gather_launch(const void* table, long long V,
                                 long long row_bytes, int chunk_bytes,
                                 const int* keys, const long long* order,
                                 long long Q, void* out, int* hits,
                                 void* stream) {
  if (Q <= 0) return 0;
  if (V <= 0 || row_bytes <= 0 || chunk_bytes <= 0 ||
      row_bytes % chunk_bytes ||
      ((uintptr_t)table | (uintptr_t)out) % (uintptr_t)chunk_bytes)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunk_bytes) {
    case 16:
      return launch_typed<uint4>(table, V, row_bytes, keys, order, Q, out,
                                 hits, s);
    case 8:
      return launch_typed<uint2>(table, V, row_bytes, keys, order, Q, out,
                                 hits, s);
    case 4:
      return launch_typed<uint32_t>(table, V, row_bytes, keys, order, Q, out,
                                    hits, s);
    case 2:
      return launch_typed<uint16_t>(table, V, row_bytes, keys, order, Q, out,
                                    hits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
