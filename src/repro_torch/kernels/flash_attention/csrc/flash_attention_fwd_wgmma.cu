// Flash-attention forward on Hopper's tensor cores (sm_90a): the route of
// bf16 inputs at head width D 64, 128 or 256.  f32 inputs, and bf16 at D 16
// or 32, take the SIMT kernel of flash_attention_fwd.cu.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_flash_kernel, :25; pallas_call at :103).
//
// Contract, the TPU kernel's (and the SIMT route's): q (B, S, H, D) against
// k, v (B, K, Hkv, D); query head h reads kv head h / (H / Hkv).  Query row
// i sits at position i + q_offset (q_offset = K - S); with diff = q_pos -
// k_pos a key is kept iff (!causal || diff >= 0) && (window <= 0 || diff <
// window).  The logits are scaled by 1/sqrt(D), masked logits are -1e30,
// online softmax keeps f32 m, l and accumulator, and the output is
// acc / max(l, 1e-30) cast to bf16.  Given a non-null lse, each row's
// m + log(l) in f32, (B, H, S), for the backward kernels.
//
// f32-faithful P.  The TPU kernel casts q, k, v to f32 and keeps P in f32.
// QK^T: bf16 x bf16 products are exact in f32, so wgmma with bf16 inputs and
// an f32 accumulator is that product up to summation order.  PV: P is split
// into P_hi = bf16(P) and P_lo = bf16(P - P_hi), and both go through wgmma
// into the same f32 accumulator, so P is carried to about 2^-16 of itself
// (the error is at most 2^-16 (sum p|v|) / l, far inside one bf16 ulp of
// the output).  l sums the f32 P, so lse is what the backward expects.  The
// split costs 1.5x the tensor work of a kernel that rounds P to bf16.
//
// Bound: operations.  At the qwen3-4b shape (B 2, S = K = 4096, H 32, Hkv
// 8, D 128, causal) the two products need 2.75e11 flops, 0.278 ms at the
// card's dense bf16 peak of 989 TFLOP/s, against 0.05 ms for the 168 MB it
// must read and write; with the split P the tensor cores do 4.1e11.
//
// Design.  One CTA of three warpgroups per (b, h, 128-row query tile), the
// heaviest causal tiles of every head launched first.
// - Warpgroup 0 is the producer: one thread issues TMA loads of the Q tile
//   and of each kv tile's K and V into a two-stage ring in shared memory,
//   with a full and an empty mbarrier per stage (K and V apart, so QK^T
//   starts before V lands).  Its registers drop to 40 (setmaxnreg).
// - Warpgroups 1 and 2 are consumers of 64 query rows each, at 232
//   registers.  S = Q K^T is wgmma m64nBKk16 with Q and K read from shared
//   memory through descriptors; the softmax runs on the accumulator
//   fragment (a row's four threads reduce its max with shuffles); O += P V
//   takes P from registers (the S fragment converts pairwise into the bf16
//   A fragment, hi then lo) and V from shared memory, MN-major.  The two
//   consumers share the ring, so one's softmax overlaps the other's wgmma.
// - Tiles are BK = 128 keys at D <= 128 and 64 at D 256.  Shared memory:
//   Q 128 x D and 2 stages of BK x D for K and for V, bf16, each in boxes
//   of 64 columns (one 128-byte swizzle atom row; TMA's SWIZZLE_128B, the
//   descriptors' 128-byte swizzle mode): 80, 160 and 192 KiB at D 64, 128,
//   256.
// - TMA zero-fills rows past S and K; keys past K get -inf, rows past S are
//   not stored.  kv tiles that the mask empties for the whole query tile
//   are skipped, as on the TPU; the element mask runs only on the tiles
//   that need it (the diagonal, the window's edge, the ragged end of K).
//   A row whose first tiles are fully masked keeps m = -1e30 there and its
//   first live tile multiplies what they left by exp(-1e30 - m) = 0.
// The output leaves from registers with predicated stores.  Left for later:
// a persistent tile scheduler, FA3's ping-pong of the two consumers, and
// overlapping the softmax with the next tile's QK^T inside a warpgroup.
#include <math.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int BQ = 128;           // query rows per CTA, 64 per consumer
constexpr int NT = 384;           // three warpgroups
constexpr int STAGES = 2;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float MASKED = -1e30f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Tile {
  static constexpr int BK = D <= 128 ? 128 : 64;   // keys per kv tile
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;      // one stage of K or V
  // + 1024: the ring is aligned by hand to the 128-byte swizzle's period
  static constexpr int SMEM = Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

// One kv tile's softmax on a consumer thread's S fragment, in place: s
// holds rows r and r + 8 (hf 0, 1) at columns 8 j + c + e (register 4 j +
// 2 hf + e); logits are scaled to log2 units, masked where MASK asks, and
// become p = 2^(x - m_new).  Updates m and the thread's share of l, and
// returns each row's correction factor for the accumulator.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             float scale_log2, int qpos0,
                                             int kpos0, int K, int causal,
                                             int window) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float mx = m[hf];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[4 * j + 2 * hf + e] * scale_log2;
        if (MASK) {
          const int kpos = kpos0 + 8 * j + e;
          const int diff = qpos0 + 8 * hf - kpos;
          bool keep = !causal || diff >= 0;
          if (window > 0) keep = keep && diff < window;
          if (!keep) x = MASKED;
          if (kpos >= K) x = -INFINITY;  // past K: no key, weight 0
        }
        s[4 * j + 2 * hf + e] = x;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    corr[hf] = ex2(m[hf] - mx);
    m[hf] = mx;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = ex2(s[4 * j + 2 * hf + e] - mx);
        s[4 * j + 2 * hf + e] = p;
        sum += p;
      }
    l[hf] = l[hf] * corr[hf] + sum;
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int S, int K, int H, int B,
                       int G, int nq, long long os_b, long long os_s,
                       long long os_h, float scale_log2, int causal,
                       int window, int q_offset) {
  constexpr int BK = Tile<D>::BK;
  constexpr int KV_BYTES = Tile<D>::KV_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // q, then full K, full V and empty per stage
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + Tile<D>::Q_BYTES;    // stage s at + s * KV_BYTES
  const uint32_t sv = sk + STAGES * KV_BYTES;
  const uint32_t bar_q = smem_addr(&bars[0]);
  const uint32_t bar_k = smem_addr(&bars[1]);   // stage s at + 8 s
  const uint32_t bar_v = smem_addr(&bars[1 + STAGES]);
  const uint32_t bar_e = smem_addr(&bars[1 + 2 * STAGES]);

  // heaviest query tiles first, the heads of a kv group side by side
  const int qi = nq - 1 - (int)(blockIdx.x / (unsigned)(H * B));
  const int bh = (int)(blockIdx.x % (unsigned)(H * B));
  const int h = bh % H, b = bh / H, hk = h / G;
  const int q0 = qi * BQ;
  const int q_rows = min(BQ, S - q0);

  // kv tiles the mask leaves non-empty for some row of this tile
  const int nk = (K + BK - 1) / BK;
  int t_lo = 0, t_hi = nk;
  if (causal) t_hi = min(nk, (q0 + q_rows - 1 + q_offset) / BK + 1);
  if (window > 0) {
    const int first_key = q0 + q_offset - window + 1;
    if (first_key > 0) t_lo = first_key / BK;
  }

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // warp-uniform to the compiler, as setmaxnreg's regions need
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, Tile<D>::Q_BYTES);
      for (int c = 0; c < D / BOX; ++c)
        tma_load(sq + c * BQ * ATOM_ROW, &tm_q, bar_q, c * BOX, q0, h, b);
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo, s = i % STAGES;
        // the consumers have released this stage's last tile
        mbar_wait(bar_e + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_k + 8 * s, KV_BYTES);
        for (int c = 0; c < D / BOX; ++c)
          tma_load(sk + s * KV_BYTES + c * BK * ATOM_ROW, &tm_k, bar_k + 8 * s,
                   c * BOX, t * BK, hk, b);
        mbar_expect_tx(bar_v + 8 * s, KV_BYTES);
        for (int c = 0; c < D / BOX; ++c)
          tma_load(sv + s * KV_BYTES + c * BK * ATOM_ROW, &tm_v, bar_v + 8 * s,
                   c * BOX, t * BK, hk, b);
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;             // rows 64 cw .. 64 cw + 63 of the tile
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int r0 = 64 * cw + 16 * warp + lane / 4;   // rows r0 and r0 + 8
    const int col0 = 2 * (lane % 4);   // columns col0 + 8 j + {0, 1}
    const int wpos_first = q0 + 64 * cw + q_offset;
    const int wpos_last = wpos_first + 63;
    const uint32_t qa = sq + 64 * cw * ATOM_ROW;   // this warpgroup's Q rows

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {MASKED, MASKED}, l[2] = {0.f, 0.f};

    mbar_wait(bar_q, 0);
    for (int t = t_lo; t < t_hi; ++t) {
      const int i = t - t_lo, s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const int k0 = t * BK;

      // S = Q K^T over D in k-steps of 16 columns (4 per 64-column box)
      float sacc[BK / 2];
      mbar_wait(bar_k + 8 * s, parity);
      wgmma_fence();
      const uint32_t kb = sk + s * KV_BYTES;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint32_t off = (kd % 4) * 32;
        wgmma_ss<BK>(sacc,
                     smem_desc(qa + (kd / 4) * BQ * ATOM_ROW + off, 16, 1024),
                     smem_desc(kb + (kd / 4) * BK * ATOM_ROW + off, 16, 1024),
                     kd > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      operand_fence(sacc);

      // the element mask only where some (row, key) of this warpgroup's
      // rows is masked or past K
      const bool whole = k0 + BK <= K &&
                         (!causal || k0 + BK - 1 <= wpos_first) &&
                         (window <= 0 || wpos_last - k0 < window);
      float corr[2];
      const int qpos0 = q0 + r0 + q_offset;
      if (whole)
        softmax_tile<BK, false>(sacc, m, l, corr, scale_log2, qpos0,
                                k0 + col0, K, causal, window);
      else
        softmax_tile<BK, true>(sacc, m, l, corr, scale_log2, qpos0,
                               k0 + col0, K, causal, window);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }

      // P = P_hi + P_lo, bf16 pairs: registers 4 kk .. 4 kk + 3 are the A
      // fragment of key-step kk (keys 16 kk .. 16 kk + 15)
      uint32_t p_hi[BK / 4], p_lo[BK / 4];
      split_bf16(sacc, p_hi, p_lo);

      // O += P_hi V + P_lo V over the tile's keys in steps of 16
      mbar_wait(bar_v + 8 * s, parity);
      wgmma_fence();
      const uint32_t vb = sv + s * KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = smem_desc(vb + kk * 16 * ATOM_ROW,
                                      BK * ATOM_ROW, 1024);
        wgmma_rs<D>(o, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2],
                    p_hi[4 * kk + 3], dv);
        wgmma_rs<D>(o, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2],
                    p_lo[4 * kk + 3], dv);
      }
      wgmma_commit();
      wgmma_wait_all();
      operand_fence(o);
      operand_fence(p_hi);
      operand_fence(p_lo);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * s);
    }

    // l: the sum of the row's four threads' shares
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 1);
      l[hf] += __shfl_xor_sync(0xffffffffu, l[hf], 2);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf;
      if (r < q_rows) {
        if (lse != nullptr && lane % 4 == 0)
          lse[((size_t)b * H + h) * S + q0 + r] = m[hf] * LN2 + logf(l[hf]);
        const float den = fmaxf(l[hf], 1e-30f);
        __nv_bfloat16* dst = out + b * os_b + (q0 + r) * os_s + h * os_h;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + col0) =
              __floats2bfloat162_rn(o[4 * j + 2 * hf] / den,
                                    o[4 * j + 2 * hf + 1] / den);
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int S, int K, int H, int Hkv,
           const long long* st, int causal, int window,
           cudaStream_t stream) {
  constexpr int BK = Tile<D>::BK;
  CUtensorMap tq, tk, tv;
  int r = encode(&tq, q, B, S, H, D, st[0], st[1], st[2], BQ);
  if (!r) r = encode(&tk, k, B, K, Hkv, D, st[3], st[4], st[5], BK);
  if (!r) r = encode(&tv, v, B, K, Hkv, D, st[6], st[7], st[8], BK);
  if (r) return -r;
  // the opt-in holds per device, so it is made on every launch (cheap)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<D>::SMEM);
  if (e != cudaSuccess) return (int)e;
  const int nq = (S + BQ - 1) / BQ;
  const float scale_log2 = (float)(LOG2E / sqrt((double)D));
  flash_fwd_wgmma_kernel<D><<<(unsigned)nq * H * B, NT, Tile<D>::SMEM,
                              stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(out), lse, S, K, H, B,
      H / Hkv, nq, st[9], st[10], st[11], scale_log2, causal, window, K - S);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, S, H, D), k and v (B, K, Hkv, D), out (B, S, H, D), all bf16
// (is_bf16 must be 1); lse null or f32 (B, H, S), contiguous.  strides: 12
// element strides, the (b, s, h) strides of q, k, v and out in that order;
// the d axis is unit-stride.  q, k and v need 16-byte-aligned bases and
// (b, s, h) strides of a multiple of 8 elements (on axes longer than 1), out
// 4-byte-aligned rows.  Requires B, S, H >= 1, H % Hkv == 0, nq H B < 2^31
// and K >= S when causal, as the Python wrapper checks.  D outside {64,
// 128, 256} or an f32 input returns cudaErrorInvalidValue; a tensor map
// that cuTensorMapEncodeTiled refuses returns minus its CUresult.  Launches
// on `stream`, on the current device, and returns cudaGetLastError() (0 on
// success).
extern "C" int flash_attention_fwd_wgmma_launch(
    const void* q, const void* k, const void* v, void* out, float* lse,
    int is_bf16, int B, int S, int K, int H, int Hkv, int D,
    const long long* strides, int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch<64>(q, k, v, out, lse, B, S, K, H, Hkv, strides, causal,
                        window, s);
    case 128:
      return launch<128>(q, k, v, out, lse, B, S, K, H, Hkv, strides, causal,
                         window, s);
    case 256:
      return launch<256>(q, k, v, out, lse, B, S, K, H, Hkv, strides, causal,
                         window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
