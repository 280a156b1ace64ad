// Padded-neighbour gather-sum followed by one matmul, written for Hopper
// (sm_90a):
//
//     out[m] = (sum_k x[nbr[m, k]]) @ W       nbr[m, k] == -1 is padding
//
// Replaces the TPU kernel src/repro/kernels/segment_matmul/kernel.py
// (_seg_mm_kernel, launched by segment_matmul_pallas).
//
// Contract, the TPU kernel's: x (N, D) and W (D, F) of one type (f32 or
// bf16), nbr (M, K) int32 with -1 as padding anywhere in a row; indices
// past the last row read row N - 1 (the JAX ref.py clips them).  Neighbour
// rows are summed in f32 in slot order, the product with W is taken in f32
// and rounded once to x's type.  Given a non-null `agg`, the kernel also
// writes the f32 neighbour sum (M, D), which the backward reads for dW.
// Unlike the Pallas wrapper, M needs no multiple of 8: the ragged tail of
// rows is masked here.
//
// Bound: bytes.  At GIN's first layer on a 1024-seed (15, 10) block
// (M = N = 169,984, K = 15, D = 602, F = 64, f32) the kernel must read the
// 168,960 neighbour rows the block's valid slots name (407 MB), nbr
// (10.2 MB) and W, and write out (43.5 MB): some 0.14 ms at 3.35 TB/s,
// against 0.02 ms for the 1.3 GFLOP of the rows that have neighbours at
// the f32 CUDA-core peak.  With `agg` it writes 409 MB more.
//
// Design: the TPU grid runs its 8-row blocks in order and keeps W whole in
// VMEM.  Here one CTA of 256 threads owns a tile of BM = 32 output rows and
// BF = 64 output columns (grid.y walks F past 64) and carries nothing to
// another CTA, so no atomics are needed and the output repeats bit for bit.
// The CTA stages its rows' nbr slice in shared memory and asks whether any
// slot is valid; a tile without one (90% of a sampled block: its last hop
// has no neighbours) writes zeros and skips the gather and the product.
// Otherwise it walks D in chunks of DC = 64 columns: each thread sums 8
// (row, column) entries over the K slots, neighbouring threads on
// neighbouring columns of one neighbour row, so a warp reads 32
// consecutive elements of a row; the chunk of sums goes to shared memory
// (rows padded by one float) beside the matching DC x BF chunk of W, and
// the tile's 32 x 64 product accumulates in registers, 2 rows x 4 columns
// a thread.  W at D 602, F 64 is 154 KB in f32, so it is never staged
// whole.  Offsets are 64-bit.  Loads are scalar: an f32 row of 602 is
// 2,408 bytes and a bf16 one 1,204, so rows are not 16-byte aligned.  This
// is the simple kernel: f32 FMAs on the CUDA cores, no cp.async or TMA
// pipelining of the gathers, no wgmma.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;         // output rows per CTA
constexpr int BF = 64;         // output columns per CTA
constexpr int DC = 64;         // columns of D per chunk
constexpr int NT = 256;        // threads per CTA
constexpr int GR = NT / DC;    // rows gathered at once (4)
constexpr int RG = BM / GR;    // gathered entries per thread (8)
constexpr int RT = BM / 16;    // product rows per thread (2)
constexpr int CT = BF / 16;    // product columns per thread (4)
constexpr int MAX_K = 1024;    // nbr slots a row may have

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

size_t smem_bytes(int K) {
  return sizeof(int) * (size_t)BM * K + sizeof(float) * (size_t)BM * (DC + 1) +
         sizeof(float) * (size_t)DC * BF;
}

template <typename T>
__global__ void __launch_bounds__(NT)
    segment_matmul_kernel(const T* __restrict__ x, long long N, long long D,
                          const int* __restrict__ nbr, long long M, int K,
                          const T* __restrict__ w, long long F,
                          T* __restrict__ out, float* __restrict__ agg) {
  extern __shared__ float smem[];
  int* nbr_s = reinterpret_cast<int*>(smem);              // BM x K
  float* agg_s = smem + (size_t)BM * K;                   // BM x (DC + 1)
  float* w_s = agg_s + BM * (DC + 1);                     // DC x BF

  const int tid = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * BM;
  const long long f0 = (long long)blockIdx.y * BF;
  const bool write_agg = agg != nullptr && blockIdx.y == 0;

  // the tile's nbr slice, clamped to [0, N) or -1, and whether any slot is
  // valid
  int any = 0;
  for (int i = tid; i < BM * K; i += NT) {
    const long long r = row0 + i / K;
    int idx = -1;
    if (r < M) {
      idx = nbr[r * K + i % K];
      if (idx >= 0 && (long long)idx >= N) idx = (int)(N - 1);
    }
    nbr_s[i] = idx;
    any |= idx >= 0;
  }
  any = __syncthreads_or(any);

  const int tx = tid % 16, ty = tid / 16;
  if (!any) {
    for (int i = tid; i < BM * BF; i += NT) {
      const long long r = row0 + i / BF, f = f0 + i % BF;
      if (r < M && f < F) out[r * F + f] = from_f32<T>(0.f);
    }
    if (write_agg)
      for (long long d = tid; d < D; d += NT)
        for (int r = 0; r < BM && row0 + r < M; ++r)
          agg[(row0 + r) * D + d] = 0.f;
    return;
  }

  const int gc = tid % DC, gr = tid / DC;   // gather column, first row
  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  for (long long d0 = 0; d0 < D; d0 += DC) {
    const long long d = d0 + gc;
    // gather-sum: entries (gr + GR e, gc) for e < RG, slot after slot
    float s[RG];
#pragma unroll
    for (int e = 0; e < RG; ++e) s[e] = 0.f;
    if (d < D) {
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int e = 0; e < RG; ++e) {
          const int idx = nbr_s[(gr + GR * e) * K + k];
          if (idx >= 0) s[e] += to_f32(x[(long long)idx * D + d]);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < RG; ++e) {
      const int r = gr + GR * e;
      agg_s[r * (DC + 1) + gc] = s[e];
      if (write_agg && d < D && row0 + r < M) agg[(row0 + r) * D + d] = s[e];
    }
    // the matching chunk of W, zeros past D and F
    for (int i = tid; i < DC * BF; i += NT) {
      const long long dd = d0 + i / BF, f = f0 + i % BF;
      w_s[i] = (dd < D && f < F) ? to_f32(w[dd * F + f]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < DC; ++c) {
      float a[RT], b[CT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = agg_s[(ty + 16 * i) * (DC + 1) + c];
#pragma unroll
      for (int j = 0; j < CT; ++j) b[j] = w_s[c * BF + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const long long r = row0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const long long f = f0 + tx + 16 * j;
      if (r < M && f < F) out[r * F + f] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
int launch_typed(const void* x, long long N, long long D, const int* nbr,
                 long long M, int K, const void* w, long long F, void* out,
                 float* agg, cudaStream_t stream) {
  const size_t smem = smem_bytes(K);
  cudaError_t e = cudaFuncSetAttribute(
      segment_matmul_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned int)((M + BM - 1) / BM),
                  (unsigned int)((F + BF - 1) / BF));
  segment_matmul_kernel<T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), N, D, nbr, M, K, static_cast<const T*>(w), F,
      static_cast<T*>(out), agg);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, D), w: (D, F) and out: (M, F), contiguous, f32 (is_bf16 0) or
// bf16 (1); nbr: (M, K) int32 contiguous; agg: null, or (M, D) f32
// contiguous.  Launches on `stream` and returns cudaGetLastError() (0 on
// success); nothing is launched when M or F is 0.
extern "C" int segment_matmul_launch(const void* x, long long N, long long D,
                                     const int* nbr, long long M, int K,
                                     const void* w, long long F, void* out,
                                     float* agg, int is_bf16, void* stream) {
  if (M <= 0 || F <= 0) return 0;
  if (N <= 0 || D < 0 || K < 0 || K > MAX_K ||
      (M + BM - 1) / BM > 0x7fffffffLL || (F + BF - 1) / BF > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_typed<__nv_bfloat16>(x, N, D, nbr, M, K, w, F, out, agg, s);
  return launch_typed<float>(x, N, D, nbr, M, K, w, F, out, agg, s);
}
