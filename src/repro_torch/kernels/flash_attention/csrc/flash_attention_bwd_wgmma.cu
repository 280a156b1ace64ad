// Flash-attention backward on Hopper's tensor cores (sm_90a): the route of
// bf16 inputs at head width D 64 or 128.  f32 inputs, and bf16 at D 16, 32
// or 256, take the SIMT kernels of flash_attention_bwd.cu.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention/bwd.py:
// _bwd_dq_kernel (:34; pallas_call at :190) with flash_bwd_dq_wgmma_kernel
// and _bwd_dkv_kernel (:80; pallas_call at :214) with
// flash_bwd_dkv_wgmma_kernel.
//
// Contract, the TPU kernels' (and the SIMT route's): q, dout (B, S, H, D)
// and k, v (B, K, Hkv, D), bf16; lse and delta f32 (B, H, S), contiguous,
// lse the forward's row log-sum-exp and delta = rowsum(dout o).  Query
// head h reads kv head h / G (G = H / Hkv).  Query row i sits at position
// i + q_offset (q_offset = K - S); with diff = q_pos - k_pos a key is kept
// iff (!causal || diff >= 0) && (window <= 0 || diff < window).  In f32:
//   s = q k^T / sqrt(D);  P = exp(s - lse) (0 where masked);
//   dS = P (dout v^T - delta) / sqrt(D);
//   dq = dS k;  dk = sum_g dS^T q;  dv = sum_g P^T dout,
// each rounded once to bf16.  Keys past K weigh 0 and query rows past S add
// nothing: ragged S and K are masked here, not padded by the caller.
//
// f32-faithful P and dS.  S = Q K^T and dP = dO V^T are bf16 x bf16
// products, exact in f32: wgmma with an f32 accumulator computes them up to
// summation order.  The three products that read P or dS (dV += P^T dO,
// dK += dS^T Q, dQ += dS K) take them split, X_hi = bf16(X) and X_lo =
// bf16(X - X_hi), both through wgmma into one f32 accumulator, so X is
// carried to about 2^-16 of itself (a bf16-only X would carry 2^-9).  P is
// exp2(s log2(e) / sqrt(D) - lse log2(e)) on the ex2 unit: its error and the
// exponent's rounding stay near 1e-6 of P, far inside a bf16 output's ulp.
//
// Bound: operations.  At one qwen3-4b layer's microbatch (B 1, S = K =
// 4096, H 32, Hkv 8, D 128, causal) dq needs three causal products (2.06e11
// flops, 0.208 ms at the card's dense bf16 peak of 989 TFLOP/s) and dk/dv
// four (2.75e11, 0.278 ms), against some 0.02 ms for the bytes each moves.
// The split raises the tensor work to four products in dq (S, dP, dQ hi and
// lo: 2.75e11, 0.278 ms) and six in dk/dv (S, dP, dV and dK hi and lo:
// 4.12e11, 0.417 ms): 0.695 ms for the pair against the 0.487 ms bound.
//
// Design.  Three warpgroups per CTA, as the forward's kernel: warpgroup 0
// the producer (40 registers, setmaxnreg), warpgroups 1 and 2 consumers of
// 64 rows each (232 registers).  Each CTA writes only its own output tile,
// with no atomics, so two runs are equal bit for bit.
// - dq: one CTA per (b, h, 128-row query tile), the heaviest causal tiles
//   of every head first.  One thread TMA-loads Q and dO once, then K and V
//   tiles of 64 keys into a two-stage ring (full and empty mbarriers, K and
//   V apart).  A consumer computes S = Q K^T and dP = dO V^T from shared
//   memory (K-major), P and dS on the accumulator fragments with its rows'
//   lse and delta held in registers, and dQ += dS K with dS hi and lo from
//   registers and K read MN-major: the forward's P V with K in V's place.
//   kv tiles run from the window's first key to the causal diagonal
//   (flash_attention_bwd.cu's range); a consumer whose 64 rows see none of
//   a tile's keys skips its products.
// - dk/dv: one CTA per (b, hkv, 128-key tile), K and V resident in shared
//   memory, the first key tiles (the most causal work) first.  The
//   producer's first warp streams (query tile of 64 rows, head g) steps,
//   the G heads innermost: one thread TMA-loads Q and dO into the ring while
//   the warp writes the step's lse (in log2 units; +inf past S, so P is 0
//   there) and delta into the stage's row slots.  Each consumer owns 64 keys
//   and computes S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out in
//   the accumulator fragment and feed dV += P^T dO and dK += dS^T Q as
//   register A operands, dO and Q read MN-major: P never goes through
//   shared memory.  lse and delta are per column there, read from the row
//   slots.
// - The element mask runs only on the tiles that need it (the diagonal, the
//   window's edge, and in dq the ragged end of K); TMA zero-fills rows past
//   S and K, whose s = 0 is masked explicitly (dq) or meets lse = +inf
//   (dk/dv); keys past K in dk/dv and query rows past S in dq are not
//   stored.
// Left for later: overlapping a tile's softmax with the next tile's
// products inside a warpgroup, and a persistent tile scheduler.
#include <math.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int NT = 384;           // three warpgroups
constexpr int STAGES = 2;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr float LOG2E_F = 1.4426950408889634f;

__device__ __forceinline__ bool kept(int diff, int causal, int window) {
  return (!causal || diff >= 0) && (window <= 0 || diff < window);
}

// ---------------------------------------------------------------- dq
template <int D>
struct DqTile {
  static constexpr int BQ = 128;                 // query rows per CTA
  static constexpr int BK = 64;                  // keys per kv tile
  static constexpr int Q_BYTES = BQ * D * 2;     // Q or dO
  static constexpr int KV_BYTES = BK * D * 2;    // one stage of K or V
  // + 1024: the tiles are aligned by hand to the 128-byte swizzle's period
  static constexpr int SMEM = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 1024;
};

// dS of one kv tile on a consumer thread's fragments, in place of s: s and
// dp hold rows r and r + 8 (hf 0, 1) at columns 8 j + c + e (register 4 j +
// 2 hf + e).  P = 2^(s scale_log2 - lse2[hf]), zero where MASK finds the key
// masked or past K.
template <bool MASK>
__device__ __forceinline__ void dq_ds_tile(float (&s)[32],
                                           const float (&dp)[32],
                                           const float (&lse2)[2],
                                           const float (&dl)[2],
                                           float scale_log2, float scale,
                                           int qpos0, int kpos0, int K,
                                           int causal, int window) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hf + e;
        float p = ex2(s[i] * scale_log2 - lse2[hf]);
        if (MASK) {
          const int kpos = kpos0 + 8 * j + e;
          if (kpos >= K || !kept(qpos0 + 8 * hf - kpos, causal, window))
            p = 0.f;
        }
        s[i] = p * (dp[i] - dl[hf]) * scale;
      }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          __nv_bfloat16* __restrict__ dq, int S, int K, int H,
                          int B, int G, int nq, long long os_b, long long os_s,
                          long long os_h, float scale, float scale_log2,
                          int causal, int window, int q_offset) {
  using T = DqTile<D>;
  constexpr int BQ = T::BQ, BK = T::BK, KV_BYTES = T::KV_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // Q and dO, then full K, full V and empty per stage
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sdo = sq + T::Q_BYTES;
  const uint32_t sk = sdo + T::Q_BYTES;          // stage s at + s * KV_BYTES
  const uint32_t sv = sk + STAGES * KV_BYTES;
  const uint32_t bar_q = smem_addr(&bars[0]);
  const uint32_t bar_k = smem_addr(&bars[1]);    // stage s at + 8 s
  const uint32_t bar_v = smem_addr(&bars[1 + STAGES]);
  const uint32_t bar_e = smem_addr(&bars[1 + 2 * STAGES]);

  // heaviest query tiles first, the heads of a kv group side by side
  const int qi = nq - 1 - (int)(blockIdx.x / (unsigned)(H * B));
  const int bh = (int)(blockIdx.x % (unsigned)(H * B));
  const int h = bh % H, b = bh / H, hk = h / G;
  const int q0 = qi * BQ;
  const int q_rows = min(BQ, S - q0);

  // kv tiles the mask leaves non-empty for some row of this tile: from the
  // first row's window start to the last row's diagonal
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
      mbar_expect_tx(bar_q, 2 * T::Q_BYTES);
      for (int c = 0; c < D / BOX; ++c) {
        tma_load(sq + c * BQ * ATOM_ROW, &tm_q, bar_q, c * BOX, q0, h, b);
        tma_load(sdo + c * BQ * ATOM_ROW, &tm_do, bar_q, c * BOX, q0, h, b);
      }
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
    const bool live = 64 * cw < q_rows;   // some of its rows lie before S
    const uint32_t qa = sq + 64 * cw * ATOM_ROW;    // this warpgroup's rows
    const uint32_t doa = sdo + 64 * cw * ATOM_ROW;

    // the rows' lse (log2 units) and delta; rows past S are not stored
    float lse2[2], dl[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf;
      const size_t row = ((size_t)b * H + h) * S + q0 + r;
      lse2[hf] = r < q_rows ? lse[row] * LOG2E_F : 0.f;
      dl[hf] = r < q_rows ? delta[row] : 0.f;
    }

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(bar_q, 0);
    for (int t = t_lo; t < t_hi; ++t) {
      const int i = t - t_lo, s = i % STAGES;
      const uint32_t parity = (i / STAGES) & 1;
      const int k0 = t * BK;
      const uint32_t kb = sk + s * KV_BYTES, vb = sv + s * KV_BYTES;
      // none of this warpgroup's (row, key) pairs is kept
      const bool skip = !live || (causal && k0 > wpos_last) ||
                        (window > 0 && wpos_first - (k0 + BK - 1) >= window);
      if (skip) {
        // the stage must be whole before this warpgroup releases it
        mbar_wait(bar_k + 8 * s, parity);
        mbar_wait(bar_v + 8 * s, parity);
      } else {
        // S = Q K^T once K has landed, then dP = dO V^T once V has, over D
        // in k-steps of 16 columns
        float sacc[32], dpacc[32];
        mbar_wait(bar_k + 8 * s, parity);
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const uint32_t off = (kd / 4) * BQ * ATOM_ROW + (kd % 4) * 32;
          const uint32_t koff = (kd / 4) * BK * ATOM_ROW + (kd % 4) * 32;
          wgmma_ss<64>(sacc, smem_desc(qa + off, 16, 1024),
                       smem_desc(kb + koff, 16, 1024), kd > 0);
        }
        wgmma_commit();
        mbar_wait(bar_v + 8 * s, parity);
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const uint32_t off = (kd / 4) * BQ * ATOM_ROW + (kd % 4) * 32;
          const uint32_t koff = (kd / 4) * BK * ATOM_ROW + (kd % 4) * 32;
          wgmma_ss<64>(dpacc, smem_desc(doa + off, 16, 1024),
                       smem_desc(vb + koff, 16, 1024), kd > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        operand_fence(sacc);
        operand_fence(dpacc);

        // the element mask only where some (row, key) of this warpgroup's
        // rows is masked or past K
        const bool whole = k0 + BK <= K &&
                           (!causal || k0 + BK - 1 <= wpos_first) &&
                           (window <= 0 || wpos_last - k0 < window);
        const int qpos0 = q0 + r0 + q_offset;
        if (whole)
          dq_ds_tile<false>(sacc, dpacc, lse2, dl, scale_log2, scale, qpos0,
                            k0 + col0, K, causal, window);
        else
          dq_ds_tile<true>(sacc, dpacc, lse2, dl, scale_log2, scale, qpos0,
                           k0 + col0, K, causal, window);

        // dQ += dS_hi K + dS_lo K over the tile's keys in steps of 16
        uint32_t ds_hi[16], ds_lo[16];
        split_bf16(sacc, ds_hi, ds_lo);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t kd = smem_desc(kb + kk * 16 * ATOM_ROW,
                                        BK * ATOM_ROW, 1024);
          wgmma_rs<D>(acc, ds_hi[4 * kk], ds_hi[4 * kk + 1], ds_hi[4 * kk + 2],
                      ds_hi[4 * kk + 3], kd);
          wgmma_rs<D>(acc, ds_lo[4 * kk], ds_lo[4 * kk + 1], ds_lo[4 * kk + 2],
                      ds_lo[4 * kk + 3], kd);
        }
        wgmma_commit();
        wgmma_wait_all();
        operand_fence(acc);
        operand_fence(ds_hi);
        operand_fence(ds_lo);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * s);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + 8 * hf;
      if (r < q_rows) {
        __nv_bfloat16* dst = dq + b * os_b + (q0 + r) * os_s + h * os_h;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + col0) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hf],
                                    acc[4 * j + 2 * hf + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- dk, dv
template <int D>
struct DkvTile {
  static constexpr int BKV = 128;                // keys per CTA
  static constexpr int BM = 64;                  // query rows per step
  static constexpr int KV_BYTES = BKV * D * 2;   // resident K or V
  static constexpr int Q_BYTES = BM * D * 2;     // one stage of Q or dO
  static constexpr int ROW_FLOATS = 2 * BM;      // one stage's lse, delta
  static constexpr int SMEM = 2 * KV_BYTES + 2 * STAGES * Q_BYTES +
                              STAGES * ROW_FLOATS * 4 + 1024;
};

// P^T and dS^T of one step on a consumer thread's fragments, in place of st
// and dpt: they hold key rows r and r + 8 (hf 0, 1) at query columns 8 j +
// c + e (register 4 j + 2 hf + e), the columns' lse (log2 units) and delta
// in rows[c] and rows[BM + c].  P = 2^(s scale_log2 - lse2), zero where
// MASK finds the pair masked (and where lse2 is +inf: rows past S).
template <int BM, bool MASK>
__device__ __forceinline__ void dkv_p_ds_tile(float (&st)[32], float (&dpt)[32],
                                              const float* rows,
                                              float scale_log2, float scale,
                                              int qpos0, int kpos0, int causal,
                                              int window) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(rows + 8 * j);
    const float2 dl = *reinterpret_cast<const float2*>(rows + BM + 8 * j);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * hf + e;
        float p = ex2(st[i] * scale_log2 - (e ? l2.y : l2.x));
        if (MASK &&
            !kept(qpos0 + 8 * j + e - (kpos0 + 8 * hf), causal, window))
          p = 0.f;
        st[i] = p;
        dpt[i] = p * (dpt[i] - (e ? dl.y : dl.x)) * scale;
      }
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int S, int K,
                           int H, int Hkv, int B, long long dks_b,
                           long long dks_s, long long dks_h, long long dvs_b,
                           long long dvs_s, long long dvs_h, float scale,
                           float scale_log2, int causal, int window,
                           int q_offset) {
  using T = DkvTile<D>;
  constexpr int BKV = T::BKV, BM = T::BM, Q_BYTES = T::Q_BYTES;
  extern __shared__ uint8_t smem_raw[];
  // K and V, then full and empty per stage
  __shared__ __align__(8) uint64_t bars[1 + 2 * STAGES];
  uint8_t* tiles = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sk = smem_addr(tiles);
  const uint32_t sv = sk + T::KV_BYTES;
  const uint32_t sq = sv + T::KV_BYTES;         // stage s at + s * Q_BYTES
  const uint32_t sdo = sq + STAGES * Q_BYTES;
  // stage s's lse (log2 units) at [s][0, BM), delta at [s][BM, 2 BM)
  float* srow = reinterpret_cast<float*>(tiles + 2 * T::KV_BYTES +
                                         2 * STAGES * Q_BYTES);
  const uint32_t bar_kv = smem_addr(&bars[0]);
  const uint32_t bar_f = smem_addr(&bars[1]);   // stage s at + 8 s
  const uint32_t bar_e = smem_addr(&bars[1 + STAGES]);

  // the first key tiles, which the most causal query tiles see, first
  const int ki = (int)(blockIdx.x / (unsigned)(Hkv * B));
  const int bh = (int)(blockIdx.x % (unsigned)(Hkv * B));
  const int hk = bh % Hkv, b = bh / Hkv, G = H / Hkv;
  const int k0 = ki * BKV;
  const int k_rows = min(BKV, K - k0);

  // query tiles that see this key tile: from the first query at or after
  // its first key (causal) to the last query before its last key's window
  // ends; the G heads of the group step inside each
  const int nq = (S + BM - 1) / BM;
  int qt_lo = 0, qt_hi = nq;
  if (causal) qt_lo = max(0, k0 - q_offset) / BM;
  if (window > 0) {
    const int i_max = k0 + k_rows - 1 + window - 1 - q_offset;
    qt_hi = i_max < 0 ? 0 : min(nq, i_max / BM + 1);
  }
  const int n_steps = max(0, qt_hi - qt_lo) * G;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f + 8 * s, 32);  // the producer warp's lanes
      mbar_init(bar_e + 8 * s, 8);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * T::KV_BYTES);
        for (int c = 0; c < D / BOX; ++c) {
          tma_load(sk + c * BKV * ATOM_ROW, &tm_k, bar_kv, c * BOX, k0, hk, b);
          tma_load(sv + c * BKV * ATOM_ROW, &tm_v, bar_kv, c * BOX, k0, hk, b);
        }
      }
      for (int i = 0; i < n_steps; ++i) {
        const int s = i % STAGES;
        const int q0 = (qt_lo + i / G) * BM, h = hk * G + i % G;
        // the consumers have released this stage's last step
        mbar_wait(bar_e + 8 * s, ((i / STAGES) & 1) ^ 1);
        float* rows = srow + s * T::ROW_FLOATS;
        const size_t base = ((size_t)b * H + h) * S;
        for (int r = lane; r < BM; r += 32) {
          const bool in = q0 + r < S;
          rows[r] = in ? lse[base + q0 + r] * LOG2E_F : INFINITY;
          rows[BM + r] = in ? delta[base + q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(bar_f + 8 * s, 2 * Q_BYTES);
          for (int c = 0; c < D / BOX; ++c) {
            tma_load(sq + s * Q_BYTES + c * BM * ATOM_ROW, &tm_q, bar_f + 8 * s,
                     c * BOX, q0, h, b);
            tma_load(sdo + s * Q_BYTES + c * BM * ATOM_ROW, &tm_do,
                     bar_f + 8 * s, c * BOX, q0, h, b);
          }
        } else {
          mbar_arrive(bar_f + 8 * s);   // releases this lane's row writes
        }
      }
    }
  } else {
    // ---------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const int cw = wg - 1;             // keys 64 cw .. 64 cw + 63 of the tile
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int r0 = 64 * cw + 16 * warp + lane / 4;   // key rows r0, r0 + 8
    const int col0 = 2 * (lane % 4);   // query columns col0 + 8 j + {0, 1}
    const int kfirst = k0 + 64 * cw, klast = kfirst + 63;
    const bool live = kfirst < K;
    const uint32_t ka = sk + 64 * cw * ATOM_ROW;    // this warpgroup's keys
    const uint32_t va = sv + 64 * cw * ATOM_ROW;

    float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    mbar_wait(bar_kv, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int s = i % STAGES;
      const int q0 = (qt_lo + i / G) * BM;
      const int qpos_first = q0 + q_offset, qpos_last = qpos_first + BM - 1;
      const uint32_t qb = sq + s * Q_BYTES, dob = sdo + s * Q_BYTES;
      // none of this warpgroup's (key, query) pairs is kept
      const bool skip = !live || (causal && qpos_last < kfirst) ||
                        (window > 0 && qpos_first - klast >= window);
      mbar_wait(bar_f + 8 * s, (i / STAGES) & 1);
      if (!skip) {
        // S^T = K Q^T and dP^T = V dO^T over D in k-steps of 16 columns
        float st[32], dpt[32];
        wgmma_fence();
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const uint32_t off = (kd / 4) * BKV * ATOM_ROW + (kd % 4) * 32;
          const uint32_t qoff = (kd / 4) * BM * ATOM_ROW + (kd % 4) * 32;
          wgmma_ss<64>(st, smem_desc(ka + off, 16, 1024),
                       smem_desc(qb + qoff, 16, 1024), kd > 0);
        }
#pragma unroll
        for (int kd = 0; kd < D / 16; ++kd) {
          const uint32_t off = (kd / 4) * BKV * ATOM_ROW + (kd % 4) * 32;
          const uint32_t qoff = (kd / 4) * BM * ATOM_ROW + (kd % 4) * 32;
          wgmma_ss<64>(dpt, smem_desc(va + off, 16, 1024),
                       smem_desc(dob + qoff, 16, 1024), kd > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        operand_fence(st);
        operand_fence(dpt);

        // the element mask only where some (key, query) pair of this
        // warpgroup's keys is masked
        const bool whole = (!causal || qpos_first >= klast) &&
                           (window <= 0 || qpos_last - kfirst < window);
        const float* rows = srow + s * T::ROW_FLOATS + col0;
        const int kpos0 = k0 + r0;
        if (whole)
          dkv_p_ds_tile<BM, false>(st, dpt, rows, scale_log2, scale,
                                   qpos_first + col0, kpos0, causal, window);
        else
          dkv_p_ds_tile<BM, true>(st, dpt, rows, scale_log2, scale,
                                  qpos_first + col0, kpos0, causal, window);

        // dV += P^T_hi dO + P^T_lo dO, then dK += dS^T_hi Q + dS^T_lo Q,
        // over the step's query rows in steps of 16
        uint32_t p_hi[16], p_lo[16];
        split_bf16(st, p_hi, p_lo);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          const uint64_t od = smem_desc(dob + kk * 16 * ATOM_ROW,
                                        BM * ATOM_ROW, 1024);
          wgmma_rs<D>(acc_v, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2],
                      p_hi[4 * kk + 3], od);
          wgmma_rs<D>(acc_v, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2],
                      p_lo[4 * kk + 3], od);
        }
        wgmma_commit();
        uint32_t ds_hi[16], ds_lo[16];
        split_bf16(dpt, ds_hi, ds_lo);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BM / 16; ++kk) {
          const uint64_t qd = smem_desc(qb + kk * 16 * ATOM_ROW,
                                        BM * ATOM_ROW, 1024);
          wgmma_rs<D>(acc_k, ds_hi[4 * kk], ds_hi[4 * kk + 1],
                      ds_hi[4 * kk + 2], ds_hi[4 * kk + 3], qd);
          wgmma_rs<D>(acc_k, ds_lo[4 * kk], ds_lo[4 * kk + 1],
                      ds_lo[4 * kk + 2], ds_lo[4 * kk + 3], qd);
        }
        wgmma_commit();
        wgmma_wait_all();
        operand_fence(acc_v);
        operand_fence(acc_k);
        operand_fence(p_hi);
        operand_fence(p_lo);
        operand_fence(ds_hi);
        operand_fence(ds_lo);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_e + 8 * s);
    }

#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int key = k0 + r0 + 8 * hf;
      if (key < K) {
        __nv_bfloat16* dkr = dk + b * dks_b + key * dks_s + hk * dks_h;
        __nv_bfloat16* dvr = dv + b * dvs_b + key * dvs_s + hk * dvs_h;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dkr + 8 * j + col0) =
              __floats2bfloat162_rn(acc_k[4 * j + 2 * hf],
                                    acc_k[4 * j + 2 * hf + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dvr + 8 * j + col0) =
              __floats2bfloat162_rn(acc_v[4 * j + 2 * hf],
                                    acc_v[4 * j + 2 * hf + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- launch
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  // the opt-in holds per device, so it is made on every launch (cheap)
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// q, k, v and dout's tensor maps: boxes of q_box rows of q and dout and
// kv_box rows of k and v.  An empty q (S 0) or k (K 0) is never read: its
// map is k's or q's.  Returns 0 or minus the CUresult of a refused map.
int encode_inputs(CUtensorMap (&m)[4], const void* q, const void* k,
                  const void* v, const void* dout, int B, int S, int K, int H,
                  int Hkv, int D, const long long* st, int q_box,
                  int kv_box) {
  int r = 0;
  if (S > 0) {
    r = encode(&m[0], q, B, S, H, D, st[0], st[1], st[2], q_box);
    if (!r) r = encode(&m[3], dout, B, S, H, D, st[9], st[10], st[11], q_box);
  }
  if (!r && K > 0) {
    r = encode(&m[1], k, B, K, Hkv, D, st[3], st[4], st[5], kv_box);
    if (!r) r = encode(&m[2], v, B, K, Hkv, D, st[6], st[7], st[8], kv_box);
  }
  if (S == 0) m[0] = m[3] = m[1];
  if (K == 0) m[1] = m[2] = m[0];
  return -r;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int S,
              int K, int H, int Hkv, const long long* st, int causal,
              int window, cudaStream_t stream) {
  using T = DqTile<D>;
  CUtensorMap m[4];
  const int r = encode_inputs(m, q, k, v, dout, B, S, K, H, Hkv, D, st, T::BQ,
                              T::BK);
  if (r) return r;
  const int e = allow_smem(flash_bwd_dq_wgmma_kernel<D>, T::SMEM);
  if (e) return e;
  const int nq = (S + T::BQ - 1) / T::BQ;
  flash_bwd_dq_wgmma_kernel<D><<<(unsigned)nq * H * B, NT, T::SMEM, stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dq), S,
      K, H, B, H / Hkv, nq, st[12], st[13], st[14],
      (float)(1.0 / sqrt((double)D)), (float)(LOG2E / sqrt((double)D)),
      causal, window, K - S);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int S, int K, int H, int Hkv, const long long* st,
               int causal, int window, cudaStream_t stream) {
  using T = DkvTile<D>;
  CUtensorMap m[4];
  const int r = encode_inputs(m, q, k, v, dout, B, S, K, H, Hkv, D, st, T::BM,
                              T::BKV);
  if (r) return r;
  const int e = allow_smem(flash_bwd_dkv_wgmma_kernel<D>, T::SMEM);
  if (e) return e;
  const int nk = (K + T::BKV - 1) / T::BKV;
  flash_bwd_dkv_wgmma_kernel<D><<<(unsigned)nk * Hkv * B, NT, T::SMEM,
                                  stream>>>(
      m[0], m[1], m[2], m[3], lse, delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), S, K, H, Hkv, B, st[12], st[13],
      st[14], st[15], st[16], st[17], (float)(1.0 / sqrt((double)D)),
      (float)(LOG2E / sqrt((double)D)), causal, window, K - S);
  return (int)cudaGetLastError();
}

}  // namespace

// As flash_attention_bwd.cu's flash_attention_bwd_dq_launch, for bf16
// (is_bf16 must be 1) at D 64 or 128: q, dout (B, S, H, D) and k, v (B, K,
// Hkv, D); lse and delta f32 (B, H, S), contiguous; dq like q.  strides: 15
// element strides, the (b, s, h) strides of q, k, v, dout and dq in that
// order; the d axis is unit-stride.  q, k, v and dout need 16-byte-aligned
// bases and (b, s, h) strides of a multiple of 8 elements (on axes longer
// than 1), dq 4-byte-aligned rows.  Requires B, S, H >= 1, H % Hkv == 0,
// nq H B < 2^31 (nq = ceil(S / 128)) and K >= S when causal, as the Python
// wrapper checks.  Another D or an f32 input returns cudaErrorInvalidValue;
// a tensor map that cuTensorMapEncodeTiled refuses returns minus its
// CUresult.  Launches on `stream`, on the current device, and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_dq_wgmma_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq, int is_bf16, int B,
    int S, int K, int H, int Hkv, int D, const long long* strides,
    int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, S, K, H, Hkv,
                           strides, causal, window, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, S, K, H, Hkv,
                            strides, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As above, with dk and dv like k (B, K, Hkv, D); strides: 18, the (b, s, h)
// strides of q, k, v, dout, dk and dv.  Requires B, K, Hkv >= 1; with S = 0
// it writes zeros.
extern "C" int flash_attention_bwd_dkv_wgmma_launch(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv, int is_bf16,
    int B, int S, int K, int H, int Hkv, int D, const long long* strides,
    int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, S, K, H,
                            Hkv, strides, causal, window, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, S, K, H,
                             Hkv, strides, causal, window, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
