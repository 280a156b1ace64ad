// Flash-attention backward (GQA, causal, optional sliding window), written
// for Hopper (sm_90a): two kernels, dq and dk/dv.
//
// Replace the TPU kernels of src/repro/kernels/flash_attention/bwd.py:
// _bwd_dq_kernel (flash_bwd_dq here) and _bwd_dkv_kernel (flash_bwd_dkv).
//
// Contract, the TPU kernels': q, dout (B, S, H, D) and k, v (B, K, Hkv, D),
// one type (bf16 or f32); lse and delta f32 (B, H, S), contiguous, with
// lse the forward's row log-sum-exp and delta = rowsum(dout o).  Query head
// h reads kv head h / G (G = H / Hkv).  Query row i sits at position
// i + q_offset (q_offset = K - S); with diff = q_pos - k_pos a key is kept
// iff (!causal || diff >= 0) && (window <= 0 || diff < window).  In f32:
//   s = q k^T / sqrt(D), masked logits -1e30;  P = exp(s - lse);
//   dS = P (dout v^T - delta) / sqrt(D);
//   dq = dS k;  dk = sum_g dS^T q;  dv = sum_g P^T dout,
// dq written in q's type, dk and dv in k's.  Keys past K weigh 0 and query
// rows past S add nothing: ragged S and K are masked here, not padded by
// the caller.
//
// Bound: operations.  At one qwen3-4b layer's microbatch (B 1, S = K =
// 4096, H 32, Hkv 8, D 128, bf16, causal) dq does three causal products
// (s, dout v^T, dS k: 2.06e11 flops, 0.208 ms at the card's dense bf16
// tensor-core peak) and dk/dv four (s, dout v^T, P^T dout, dS^T q:
// 2.75e11 flops, 0.278 ms), against some 0.02 ms for the bytes each must
// move.
//
// Design: the TPU grid carries the dq (or dk, dv) sums across its
// sequential innermost axis in VMEM scratch.  Here one CTA of 256 threads
// owns one output tile and loops over the tiles the mask reaches itself:
//   flash_bwd_dq:  (b, h, query tile); loops over kv tiles from the
//                  window's first key to the causal diagonal;
//   flash_bwd_dkv: (b, hkv, key tile); loops over the query tiles that see
//                  the key tile (after the diagonal when causal, before the
//                  window's end), and inside them over the G query heads.
// Each CTA writes only its own outputs, with no atomics, so the gradients
// are the same bit for bit from run to run.  Tiles are staged in shared
// memory as f32 with rows padded by one float (the column reads of the
// products hit distinct banks).  Thread (ty, tx) of a 16 x 16 grid owns
// rows ty + 16 i and columns tx + 16 j of the logit tile and rows ty + 16 i,
// columns tx + 16 c of its output tile, accumulated in f32 registers.  Like
// the forward this is the simple kernel: every product is f32 FMAs on the
// CUDA cores, far from the tensor-core bound; wgmma, TMA and a bf16 P are
// the redesign.  At D 256, 32-row tiles keep the four staged tiles inside
// the 227 KB a CTA may use.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int NT = 256;   // threads per CTA, a 16 x 16 grid
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

struct Strides {  // element strides of the b, s and h axes; d is unit
  long long b, s, h;
};

// rows x D from base (rows row_stride apart) into an f32 tile with row
// stride D + 1; rows at or past n are zero
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* base,
                                      long long row_stride, int rows, int n) {
  for (int e = threadIdx.x; e < rows * D; e += NT) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = r < n ? to_f32(base[r * row_stride + d]) : 0.f;
  }
}

__device__ __forceinline__ bool kept(int diff, int causal, int window) {
  return (!causal || diff >= 0) && (window <= 0 || diff < window);
}

template <int D, int BQ, int BK>
constexpr size_t dq_smem_bytes() {  // Q, dO, K, V tiles and the dS tile
  return sizeof(float) *
         (2 * (size_t)BQ * (D + 1) + 2 * (size_t)BK * (D + 1) +
          (size_t)BQ * (BK + 1));
}

template <int D, int BQ, int BK>
constexpr size_t dkv_smem_bytes() {  // K, V, Q, dO tiles, P^T, dS^T, rows
  return sizeof(float) *
         (2 * (size_t)BK * (D + 1) + 2 * (size_t)BQ * (D + 1) +
          2 * (size_t)BK * (BQ + 1) + 2 * (size_t)BQ);
}

// ---------------------------------------------------------------- dq
template <int D, int BQ, int BK, typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int S, int K, int G, Strides qs, Strides ks, Strides vs,
                    Strides dos, Strides dqs, float scale, int causal,
                    int window, int q_offset) {
  constexpr int P = D + 1;     // padded row stride of the staged tiles
  constexpr int PS = BK + 1;   // padded row stride of the dS tile
  constexpr int RQ = BQ / 16;  // query rows per thread
  constexpr int CK = BK / 16;  // logit columns per thread
  constexpr int CD = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x P
  float* dOs = Qs + BQ * P;     // BQ x P
  float* Ks = dOs + BQ * P;     // BK x P
  float* Vs = Ks + BK * P;      // BK x P
  float* dSs = Vs + BK * P;     // BQ x PS

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int nq = (S + BQ - 1) / BQ;
  const int qi = nq - 1 - (int)blockIdx.x;   // heaviest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const int hk = h / G;
  const int q0 = qi * BQ;
  const int q_rows = min(BQ, S - q0);
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;

  stage<D>(Qs, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, BQ, q_rows);
  stage<D>(dOs, dout + b * dos.b + h * dos.h + q0 * dos.s, dos.s, BQ,
           q_rows);
  const float* lse_b = lse + ((size_t)b * H + h) * S + q0;
  const float* delta_b = delta + ((size_t)b * H + h) * S + q0;
  float row_lse[RQ], row_delta[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
    row_lse[i] = r < q_rows ? lse_b[r] : 0.f;
    row_delta[i] = r < q_rows ? delta_b[r] : 0.f;
  }

  // kv tiles the mask leaves non-empty for some row of this tile: from the
  // first row's window start to the last row's diagonal
  const int nk = (K + BK - 1) / BK;
  const int pos_first = q0 + q_offset;
  const int pos_last = q0 + q_rows - 1 + q_offset;
  const int t_hi = causal ? min(nk, pos_last / BK + 1) : nk;
  int t_lo = 0;
  if (window > 0) {
    const int first_key = pos_first - window + 1;
    t_lo = first_key > 0 ? first_key / BK : 0;
  }

  float acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    const int k_rows = min(BK, K - k0);
    __syncthreads();  // the last tile's reads of Ks, Vs and dSs are done
    stage<D>(Ks, kb + k0 * ks.s, ks.s, BK, k_rows);
    stage<D>(Vs, vb + k0 * vs.s, vs.s, BK, k_rows);
    __syncthreads();

    float s[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = Qs[(ty + 16 * i) * P + d];
        ov[i] = dOs[(ty + 16 * i) * P + d];
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        kv[j] = Ks[(tx + 16 * j) * P + d];
        vv[j] = Vs[(tx + 16 * j) * P + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int q_pos = q0 + ty + 16 * i + q_offset;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int col = tx + 16 * j;
        const float x =
            kept(q_pos - (k0 + col), causal, window) ? s[i][j] * scale
                                                     : MASKED;
        // past K: no key, weight 0
        const float p = col < k_rows ? expf(x - row_lse[i]) : 0.f;
        dSs[(ty + 16 * i) * PS + col] = p * (dp[i][j] - row_delta[i]) * scale;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RQ], kv[CD];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = dSs[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) kv[c] = Ks[kk * P + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c)
          acc[i][c] = fmaf(dsv[i], kv[c], acc[i][c]);
    }
  }

  T* dqb = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
    if (r < q_rows) {
      T* dst = dqb + (q0 + r) * dqs.s;
#pragma unroll
      for (int c = 0; c < CD; ++c) dst[tx + 16 * c] = from_f32<T>(acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------- dk, dv
template <int D, int BQ, int BK, typename T>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int S, int K, int G, Strides qs,
                     Strides ks, Strides vs, Strides dos, Strides dks,
                     Strides dvs, float scale, int causal, int window,
                     int q_offset) {
  constexpr int P = D + 1;     // padded row stride of the staged tiles
  constexpr int PT = BQ + 1;   // padded row stride of the P^T, dS^T tiles
  constexpr int RK = BK / 16;  // key rows per thread
  constexpr int CQ = BQ / 16;  // logit (query) columns per thread
  constexpr int CD = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;             // BK x P
  float* Vs = Ks + BK * P;      // BK x P
  float* Qs = Vs + BK * P;      // BQ x P
  float* dOs = Qs + BQ * P;     // BQ x P
  float* Pt = dOs + BQ * P;     // BK x PT
  float* dSt = Pt + BK * PT;    // BK x PT
  float* row_lse = dSt + BK * PT;    // BQ
  float* row_delta = row_lse + BQ;   // BQ

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int ki = blockIdx.x;    // the first (heaviest causal) tiles first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y * G;
  const int k0 = ki * BK;
  const int k_rows = min(BK, K - k0);

  stage<D>(Ks, k + b * ks.b + hk * ks.h + k0 * ks.s, ks.s, BK, k_rows);
  stage<D>(Vs, v + b * vs.b + hk * vs.h + k0 * vs.s, vs.s, BK, k_rows);

  // query tiles that see this key tile: from the first query at or after
  // its first key (causal) to the last query before its last key's window
  // ends; none may leave dk, dv zero
  const int nq = (S + BQ - 1) / BQ;
  int qt_lo = 0, qt_hi = nq;
  if (causal) qt_lo = max(0, k0 - q_offset) / BQ;
  if (window > 0) {
    const int i_max = k0 + k_rows - 1 + window - 1 - q_offset;
    qt_hi = i_max < 0 ? 0 : min(nq, i_max / BQ + 1);
  }

  float acc_k[RK][CD], acc_v[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int q0 = qt * BQ;
    const int q_rows = min(BQ, S - q0);
    for (int g = 0; g < G; ++g) {
      const int h = hk * G + g;
      __syncthreads();  // the last step's reads of Qs, dOs, Pt, dSt are done
      stage<D>(Qs, q + b * qs.b + h * qs.h + q0 * qs.s, qs.s, BQ, q_rows);
      stage<D>(dOs, dout + b * dos.b + h * dos.h + q0 * dos.s, dos.s, BQ,
               q_rows);
      if (tid < BQ) {
        const size_t row = ((size_t)b * H + h) * S + q0 + tid;
        row_lse[tid] = tid < q_rows ? lse[row] : 0.f;
        row_delta[tid] = tid < q_rows ? delta[row] : 0.f;
      }
      __syncthreads();

      // s^T and (dout v^T)^T for key rows ty + 16 i, query columns tx + 16 j
      float st[RK][CQ], dpt[RK][CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        float kv[RK], vv[RK], qv[CQ], ov[CQ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          kv[i] = Ks[(ty + 16 * i) * P + d];
          vv[i] = Vs[(ty + 16 * i) * P + d];
        }
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          qv[j] = Qs[(tx + 16 * j) * P + d];
          ov[j] = dOs[(tx + 16 * j) * P + d];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CQ; ++j) {
            st[i][j] = fmaf(qv[j], kv[i], st[i][j]);
            dpt[i][j] = fmaf(ov[j], vv[i], dpt[i][j]);
          }
      }

#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int k_pos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          const int col = tx + 16 * j;
          const float x =
              kept(q0 + col + q_offset - k_pos, causal, window)
                  ? st[i][j] * scale
                  : MASKED;
          // past S: no query, no share of the gradient
          const float p = col < q_rows ? expf(x - row_lse[col]) : 0.f;
          Pt[(ty + 16 * i) * PT + col] = p;
          dSt[(ty + 16 * i) * PT + col] =
              p * (dpt[i][j] - row_delta[col]) * scale;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[RK], dsv[RK], ov[CD], qv[CD];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pv[i] = Pt[(ty + 16 * i) * PT + qq];
          dsv[i] = dSt[(ty + 16 * i) * PT + qq];
        }
#pragma unroll
        for (int c = 0; c < CD; ++c) {
          ov[c] = dOs[qq * P + tx + 16 * c];
          qv[c] = Qs[qq * P + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            acc_v[i][c] = fmaf(pv[i], ov[c], acc_v[i][c]);
            acc_k[i][c] = fmaf(dsv[i], qv[c], acc_k[i][c]);
          }
      }
    }
  }

  T* dkb = dk + b * dks.b + hk * dks.h;
  T* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int r = ty + 16 * i;
    if (r < k_rows) {
      T* dkr = dkb + (k0 + r) * dks.s;
      T* dvr = dvb + (k0 + r) * dvs.s;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        dkr[tx + 16 * c] = from_f32<T>(acc_k[i][c]);
        dvr[tx + 16 * c] = from_f32<T>(acc_v[i][c]);
      }
    }
  }
}

// ---------------------------------------------------------------- launch
template <int D>
constexpr int tile() {  // rows of every tile: 32 at D 256 (shared memory)
  return D == 256 ? 32 : 64;
}

inline Strides strides_at(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int S,
              int K, int H, int Hkv, const long long* st, int causal,
              int window, cudaStream_t stream) {
  constexpr int BT = tile<D>();
  constexpr size_t smem = dq_smem_bytes<D, BT, BT>();
  // the opt-in holds per device, so it is made on every launch (cheap)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D, BT, BT, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((S + BT - 1) / BT, H, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_bwd_dq_kernel<D, BT, BT, T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), S, K, H / Hkv, strides_at(st, 0),
      strides_at(st, 1), strides_at(st, 2), strides_at(st, 3),
      strides_at(st, 4), scale, causal, window, K - S);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int S, int K, int H, int Hkv, const long long* st,
               int causal, int window, cudaStream_t stream) {
  constexpr int BT = tile<D>();
  constexpr size_t smem = dkv_smem_bytes<D, BT, BT>();
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, BT, BT, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((K + BT - 1) / BT, Hkv, B);
  const float scale = (float)(1.0 / sqrt((double)D));
  flash_bwd_dkv_kernel<D, BT, BT, T><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), S, K, H / Hkv,
      strides_at(st, 0), strides_at(st, 1), strides_at(st, 2),
      strides_at(st, 3), strides_at(st, 4), strides_at(st, 5), scale,
      causal, window, K - S);
  return (int)cudaGetLastError();
}

#define DISPATCH_D(D, CALL)                     \
  switch (D) {                                  \
    case 16: { constexpr int DD = 16; CALL; }   \
    case 32: { constexpr int DD = 32; CALL; }   \
    case 64: { constexpr int DD = 64; CALL; }   \
    case 128: { constexpr int DD = 128; CALL; } \
    case 256: { constexpr int DD = 256; CALL; } \
    default: return (int)cudaErrorInvalidValue; \
  }

}  // namespace

// q, dout (B, S, H, D) and k, v (B, K, Hkv, D), all of one type: bf16 when
// is_bf16, else f32; lse and delta f32 (B, H, S), contiguous; dq like q.
// strides: 15 element strides, the (b, s, h) strides of q, k, v, dout and
// dq in that order; the d axis is unit-stride.  Requires B, S, H >= 1,
// H <= 65535, B <= 65535, H % Hkv == 0 and K >= S when causal, as the
// Python wrapper checks; a D outside {16, 32, 64, 128, 256} returns
// cudaErrorInvalidValue.  Launches on `stream`, on the current device, and
// returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_dq_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int is_bf16, int B,
    int S, int K, int H, int Hkv, int D, const long long* strides,
    int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    DISPATCH_D(D, return (launch_dq<DD, __nv_bfloat16>(
                   q, k, v, dout, lse, delta, dq, B, S, K, H, Hkv, strides,
                   causal, window, s)));
  }
  DISPATCH_D(D, return (launch_dq<DD, float>(q, k, v, dout, lse, delta, dq,
                                             B, S, K, H, Hkv, strides,
                                             causal, window, s)));
  return (int)cudaErrorInvalidValue;  // not reached
}

// As above, with dk and dv like k (B, K, Hkv, D); strides: 18, the (b, s, h)
// strides of q, k, v, dout, dk and dv.  Requires B, K, Hkv >= 1 and
// Hkv <= 65535; with S = 0 it writes zeros.
extern "C" int flash_attention_bwd_dkv_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int is_bf16,
    int B, int S, int K, int H, int Hkv, int D, const long long* strides,
    int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    DISPATCH_D(D, return (launch_dkv<DD, __nv_bfloat16>(
                   q, k, v, dout, lse, delta, dk, dv, B, S, K, H, Hkv,
                   strides, causal, window, s)));
  }
  DISPATCH_D(D, return (launch_dkv<DD, float>(q, k, v, dout, lse, delta, dk,
                                              dv, B, S, K, H, Hkv, strides,
                                              causal, window, s)));
  return (int)cudaErrorInvalidValue;  // not reached
}
