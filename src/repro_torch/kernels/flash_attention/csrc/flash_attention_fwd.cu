// Flash-attention forward (GQA, causal, optional sliding window), written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, launched by flash_attention_fwd).
//
// Contract, the TPU kernel's: q (B, S, H, D) against k, v (B, K, Hkv, D);
// query head h reads kv head h / (H / Hkv).  Query row i sits at absolute
// position i + q_offset (q_offset = K - S, so the last query lines up with
// the last key); with diff = q_pos - k_pos a key is kept iff
// (!causal || diff >= 0) && (window <= 0 || diff < window).  Inputs (bf16 or
// f32) are cast to f32 before both products; the logits are scaled by
// 1/sqrt(D), masked logits are -1e30, P stays f32, and the output is
// acc / max(l, 1e-30) cast to q's type.  Key tiles that the mask leaves
// empty for the whole query tile are skipped, as on the TPU.
//
// Bound: operations.  At the qwen3-4b training shape (B 2, S = K = 4096,
// H 32, Hkv 8, D 128, bf16, causal) the two products need 2.75e11 flops,
// 0.28 ms at the card's dense bf16 tensor-core peak, against 0.05 ms for
// the 168 MB it must read and write.
//
// Design: the TPU grid walks the kv tiles of a query tile in order and
// carries the online-softmax state in VMEM scratch.  Here one CTA of 256
// threads owns one (b, h, 64-row query tile) and loops over the kv tiles
// itself, so nothing is carried between CTAs.  Q, K and V tiles are staged
// in shared memory as f32 (rows padded by one float so that the column
// reads of the QK^T loop hit distinct banks).  Thread (ty, tx) of a 16 x 16
// grid owns query rows ty + 16 i (i < 4), logit columns tx + 16 j (j < 4)
// and output columns tx + 16 c (c < D / 16); a row's max and sum are
// reduced over its 16 threads with warp shuffles.  This is the simple
// kernel: both products are f32 FMAs on the CUDA cores, so it runs far
// from the tensor-core bound; mma/wgmma, TMA and a bf16 P are the redesign.
// Ragged S and K are masked here, not padded by the caller.  The heaviest
// causal query tiles (the last ones) are launched first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per kv tile
constexpr int NT = 256;       // threads per CTA, a 16 x 16 grid
constexpr int RQ = BQ / 16;   // query rows per thread
constexpr int CK = BK / 16;   // logit columns per thread
constexpr float MASKED = -1e30f;

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

// max / sum over the 16 threads that share a row (one half of a warp)
__device__ __forceinline__ float row_max(float x) {
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
          (size_t)BQ * (BK + 1));
}

struct Strides {  // element strides of the b, s and h axes; d is unit
  long long b, s, h;
};

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int S, int K,
                 int G, Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal, int window, int q_offset) {
  constexpr int QP = D + 1;    // padded row stride of the Q and K tiles
  constexpr int PP = BK + 1;   // padded row stride of the P tile
  constexpr int CD = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                // BQ x QP
  float* Ks = Qs + BQ * QP;        // BK x QP
  float* Vs = Ks + BK * QP;        // BK x D
  float* Ps = Vs + BK * D;         // BQ x PP

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nq = (S + BQ - 1) / BQ;
  const int qi = nq - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / G;
  const int q0 = qi * BQ;
  const int q_rows = min(BQ, S - q0);
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D;
    Qs[r * QP + d] = r < q_rows ? to_f32(qb[(q0 + r) * qs.s + d]) : 0.f;
  }

  // kv tiles the mask leaves non-empty for some row of this tile
  const int nk = (K + BK - 1) / BK;
  const int pos_first = q0 + q_offset;
  const int pos_last = q0 + q_rows - 1 + q_offset;
  int t_hi = nk, t_lo = 0;
  if (causal) {
    t_hi = min(nk, pos_last / BK + 1);
    if (window > 0) {
      const int first_key = pos_first - window + 1;
      t_lo = first_key > 0 ? first_key / BK : 0;
    }
  }

  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = MASKED;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    const int k_rows = min(BK, K - k0);
    __syncthreads();  // the last tile's reads of Ks, Vs and Ps are done
    for (int e = tid; e < BK * D; e += NT) {
      const int r = e / D, d = e % D;
      const bool in = r < k_rows;
      Ks[r * QP + d] = in ? to_f32(kb[(k0 + r) * ks.s + d]) : 0.f;
      Vs[r * D + d] = in ? to_f32(vb[(k0 + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = Ks[(tx + 16 * j) * QP + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q_pos = q0 + ty + 16 * i + q_offset;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int col = tx + 16 * j;
        const int diff = q_pos - (k0 + col);
        bool keep = !causal || diff >= 0;
        if (window > 0) keep = keep && diff < window;
        float x = keep ? s[i][j] * scale : MASKED;
        if (col >= k_rows) x = -INFINITY;  // past K: no key, weight 0
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = row_max(mx);
      const float corr = expf(m[i] - mx);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const float p = expf(s[i][j] - mx);
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
        psum += p;
      }
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = mx;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ], vv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* ob = out + b * os.b + h * os.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
    if (r < q_rows) {
      const float den = fmaxf(l[i], 1e-30f);
      T* dst = ob + (q0 + r) * os.s;
#pragma unroll
      for (int c = 0; c < CD; ++c)
        dst[tx + 16 * c] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int K, int H, int Hkv, const long long* st, int causal,
           int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  // the opt-in holds per device, so it is made on every launch (cheap)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_fwd_kernel<D, T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, K, H / Hkv, qs, ks,
      vs, os, scale, causal, window, K - S);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* out,
             int B, int S, int K, int H, int Hkv, const long long* st,
             int causal, int window, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<16, T>(q, k, v, out, B, S, K, H, Hkv, st, causal, window,
                           stream);
    case 32:
      return launch<32, T>(q, k, v, out, B, S, K, H, Hkv, st, causal, window,
                           stream);
    case 64:
      return launch<64, T>(q, k, v, out, B, S, K, H, Hkv, st, causal, window,
                           stream);
    case 128:
      return launch<128, T>(q, k, v, out, B, S, K, H, Hkv, st, causal,
                            window, stream);
    case 256:
      return launch<256, T>(q, k, v, out, B, S, K, H, Hkv, st, causal,
                            window, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, S, H, D), k and v (B, K, Hkv, D), out (B, S, H, D), all of one type:
// bf16 when is_bf16, else f32.  strides: 12 element strides, the (b, s, h)
// strides of q, k, v and out in that order; the d axis is unit-stride.
// Requires B, S, H >= 1, H <= 65535, B <= 65535, H % Hkv == 0 and K >= S when
// causal (every query then has a key), as the Python wrapper checks; a D
// outside {16, 32, 64, 128, 256} returns cudaErrorInvalidValue.  Launches on
// `stream`, on the current device, and returns cudaGetLastError() (0 on
// success).
extern "C" int flash_attention_fwd_launch(const void* q, const void* k,
                                          const void* v, void* out,
                                          int is_bf16, int B, int S, int K,
                                          int H, int Hkv, int D,
                                          const long long* strides,
                                          int causal, int window,
                                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_d<__nv_bfloat16>(D, q, k, v, out, B, S, K, H, Hkv, strides,
                                   causal, window, s);
  return launch_d<float>(D, q, k, v, out, B, S, K, H, Hkv, strides, causal,
                         window, s);
}
