// Cached gather for the DHT lookup, written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/dht_gather/kernel.py
// (_dht_gather_kernel, launched by dht_gather_pallas).
//
// Contract, the same (out, hits) as the TPU kernel's: keys are sorted
// ascending, -1 is padding.  out[q] = table[min(k, V-1)] for k >= 0 and a
// zero row for k < 0; hits = #{q > 0 : k[q] >= 0 and k[q] == k[q-1]}, which
// equals n_valid - n_distinct_valid (ShardedDHT derives n_unique from it).
//
// Bound: bytes.  The kernel reads Q keys (4 bytes each) and at most
// n_distinct rows, and writes Q rows; it does no arithmetic worth counting.
// At the connectivity shape (Q = 8.6M keys, D = 1, int32) that is about
// 100 MB, some 30 us at 3.35 TB/s.
//
// Design: the TPU grid runs in order, so the TPU kernel carries the last key
// of one block into the next to count hits across block edges.  Blocks here
// run in any order; a key is a hit iff its sorted predecessor is the same
// valid key, so each thread reads its predecessor and no carry is needed.
// A duplicate key re-reads its row from L1/L2 rather than skipping the load.
// Threads run along D (up to 32 per key) when rows are wide, and one thread
// takes one key when D == 1.  Rows are copied as raw 2- or 4-byte elements
// (bf16, int32, float32).  Hits are summed with warp shuffles and one
// atomicAdd per block.
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
__global__ void dht_gather_kernel(const T* __restrict__ table, long long V,
                                  long long D, const int* __restrict__ keys,
                                  long long Q, T* __restrict__ out,
                                  int* __restrict__ hits) {
  const long long key_stride = (long long)gridDim.x * blockDim.y;
  int h = 0;
  for (long long q = (long long)blockIdx.x * blockDim.y + threadIdx.y; q < Q;
       q += key_stride) {
    const int k = keys[q];
    T* dst = out + q * D;
    if (k >= 0) {
      const long long row = (long long)k < V ? (long long)k : V - 1;
      const T* src = table + row * D;
      for (long long d = threadIdx.x; d < D; d += blockDim.x) dst[d] = src[d];
      if (threadIdx.x == 0 && q > 0 && keys[q - 1] == k) h += 1;
    } else {
      for (long long d = threadIdx.x; d < D; d += blockDim.x) dst[d] = T(0);
    }
  }

  // block sum of the hit count: warp shuffles, then one atomic per block
  __shared__ int warp_hits[32];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int o = 16; o > 0; o >>= 1) h += __shfl_down_sync(0xffffffffu, h, o);
  if (lane == 0) warp_hits[warp] = h;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = (blockDim.x * blockDim.y + 31) >> 5;
    h = lane < nwarps ? warp_hits[lane] : 0;
    for (int o = 16; o > 0; o >>= 1) h += __shfl_down_sync(0xffffffffu, h, o);
    if (lane == 0 && h) atomicAdd(hits, h);
  }
}

// table: (V, D) rows of elem_bytes-wide elements; keys: (Q,) int32 sorted;
// out: (Q, D); hits: one int32 the caller zeroed.  Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int dht_gather_launch(const void* table, long long V, long long D,
                                 int elem_bytes, const int* keys, long long Q,
                                 void* out, int* hits, void* stream) {
  if (Q <= 0) return 0;
  if (V <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  int tx = 1;
  while (tx < D && tx < 32) tx <<= 1;
  const int ty = 256 / tx;  // 256 threads a block, a multiple of the warp
  // 64 blocks per SM at most; past that each thread row strides over
  // several keys, which spreads the per-block hit reduction over them
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  long long blocks = (Q + ty - 1) / ty;
  const long long max_blocks = (long long)sms * 64;
  if (blocks > max_blocks) blocks = max_blocks;
  const dim3 grid((unsigned int)blocks);
  const dim3 block(tx, ty);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (elem_bytes) {
    case 4:
      dht_gather_kernel<uint32_t><<<grid, block, 0, s>>>(
          static_cast<const uint32_t*>(table), V, D, keys, Q,
          static_cast<uint32_t*>(out), hits);
      break;
    case 2:
      dht_gather_kernel<uint16_t><<<grid, block, 0, s>>>(
          static_cast<const uint16_t*>(table), V, D, keys, Q,
          static_cast<uint16_t*>(out), hits);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
