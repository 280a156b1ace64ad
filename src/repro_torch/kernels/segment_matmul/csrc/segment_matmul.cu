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
// VMEM.  Here one CTA of 256 threads owns a tile of BM = 32 output rows
// and BF = 64 output columns (grid.y walks F past 64), and carries nothing
// to another CTA, so no atomics are needed and the output repeats bit for
// bit.  The grid takes tiles from either end in turn: a sampled block's
// rows with neighbours come first, so the cheap tiles run beside the
// working ones.  The CTA stages its rows' nbr slice in shared memory; a
// tile without a valid slot (90% of a sampled block: its last hop has no
// neighbours) zero-fills its out and agg rows with 16-byte stores and
// leaves.
//
// Sums: each warp takes whole rows of the tile.  For up to SB valid slots
// of a row at once it loads the named x rows' columns into registers (an
// entry of V elements a lane in each of CE groups of 32: a chunk of up to
// DT = 640 columns in one pass), then adds them in slot order.  A block's
// neighbours are consecutive rows of x, so a warp reads long runs of
// contiguous bytes.  Loads are V elements wide (8-byte f32 pairs, 4-byte
// bf16 pairs where D is even and the addresses allow it, else single
// elements).  The sums start at +0.0 and add the valid slots only, which
// is what the plain version's masked sum computes, bit for bit.  They go
// to agg (coalesced) and to a BM x DT f32 tile in shared memory.
//
// Product, in f32 FMAs on the CUDA cores (TF32 would break the kernel's
// f32 product).  Rows of at most 32 entries (D <= 64, CE 1): W's rows for
// the tile's 64 columns load into registers before the sums and go to
// shared memory after them, and each thread takes 2 rows x 4 columns.
// Wider rows: W at D 602 is 154 KB in f32, too big to stage, so each warp
// takes 16 rows and a quarter of the chunk's columns, 4 at a time, each
// lane 2 output columns, with a = 4 sums read as a float4 and the next 4
// rows of W loading while these multiply; the four quarters' partial
// products are added in order at the end.  D past DT runs in chunks of
// DTM = 128 columns, the partial products beside the sums.  Offsets are
// 64-bit.  PERF.md records the designs measured against this one
// (scripts/time_segment_matmul.py times them).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 32;         // output rows a tile
constexpr int BF = 64;         // output columns per CTA
constexpr int DT = 640;        // columns of D a tile's sums hold
constexpr int DTM = 128;       // the chunk width where D passes DT
constexpr int NT = 256;        // threads per CTA
constexpr int NW = NT / 32;    // warps
constexpr int MAX_K = 1024;    // nbr slots a row may have
constexpr unsigned FULL = 0xffffffffu;

// the row stride of a chunk's sums in shared memory, in floats, and where
// the partial products of wide rows start
__host__ __device__ constexpr int sum_stride(long long D) {
  return D <= DT ? (int)((D + 3) & ~3LL) + 4 : DTM + 4;
}
__host__ __device__ constexpr int part_offset(long long D) {
  return D <= DT ? 0 : BM * (DTM + 4);
}
// shared floats before the tile's nbr slots.  Wide rows: the sums, with
// the 4 column slices' partial products over them where D fits one chunk,
// else beside them.  Rows of at most 32 entries (small): the sums and W's
// (at most 64) rows of the tile's 64 output columns.
__host__ __device__ constexpr int sum_floats(long long D, bool small) {
  return small ? BM * sum_stride(D) + 64 * BF
         : D <= DT ? (BM * sum_stride(D) > 4 * BM * BF ? BM * sum_stride(D)
                                                       : 4 * BM * BF)
                   : BM * sum_stride(D) + 4 * BM * BF;
}
size_t smem_bytes(long long D, int K, bool small) {
  return sizeof(float) * (size_t)sum_floats(D, small) + sizeof(int) * BM * K;
}

// V elements of T, loaded at once and summed in f32
template <typename T, int V> struct Vec;
template <> struct Vec<float, 1> {
  float v;
  __device__ __forceinline__ void load(const float* p) { v = __ldg(p); }
  __device__ __forceinline__ void add_to(float* s) const { s[0] += v; }
};
template <> struct Vec<float, 2> {
  float2 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldg(reinterpret_cast<const float2*>(p));
  }
  __device__ __forceinline__ void add_to(float* s) const {
    s[0] += v.x;
    s[1] += v.y;
  }
};
template <> struct Vec<__nv_bfloat16, 1> {
  __nv_bfloat16 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(p);
  }
  __device__ __forceinline__ void add_to(float* s) const {
    s[0] += __bfloat162float(v);
  }
};
template <> struct Vec<__nv_bfloat16, 2> {
  __nv_bfloat162 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    v = __ldg(reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ __forceinline__ void add_to(float* s) const {
    const float2 f = __bfloat1622float2(v);
    s[0] += f.x;
    s[1] += f.y;
  }
};

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

// n zero bytes from p, by every thread of the CTA: 16-byte stores over the
// aligned middle, bytes at either end
__device__ void zero_bytes(unsigned char* p, long long n) {
  long long head = (long long)((16 - ((uintptr_t)p & 15)) & 15);
  if (head > n) head = n;
  const long long body = (n - head) / 16;
  for (long long i = threadIdx.x; i < head; i += NT) p[i] = 0;
  uint4* v = reinterpret_cast<uint4*>(p + head);
  for (long long i = threadIdx.x; i < body; i += NT)
    v[i] = make_uint4(0, 0, 0, 0);
  for (long long i = head + 16 * body + threadIdx.x; i < n; i += NT) p[i] = 0;
}

// a tile without a valid slot: zeros in its out rows' columns and, where
// asked, its agg rows
template <typename T>
__device__ void zero_tile(T* out, float* agg, long long row0, long long f0,
                          int nrows, long long D, long long F,
                          bool write_agg) {
  unsigned char* o = reinterpret_cast<unsigned char*>(out);
  if (gridDim.y == 1) {
    zero_bytes(o + sizeof(T) * row0 * F, (long long)sizeof(T) * nrows * F);
  } else {
    const long long ncols = F - f0 < BF ? F - f0 : BF;
    for (int r = 0; r < nrows; ++r)
      zero_bytes(o + sizeof(T) * ((row0 + r) * F + f0),
                 (long long)sizeof(T) * ncols);
  }
  if (write_agg)
    zero_bytes(reinterpret_cast<unsigned char*>(agg + row0 * D),
               (long long)sizeof(float) * nrows * D);
}

// one warp: the f32 sums of the x rows that a row's K slots (nrow, -1 for
// padding) name, over columns d0 .. d0 + dlen - 1 (dlen <= 32 V CE: an
// entry of V elements a lane in each of CE groups of 32), into srow
// (shared memory, from column 0) and, where asked, the row of agg
template <typename T, int V, int CE>
__device__ __forceinline__ void sum_row(const T* __restrict__ x, long long D,
                                        const int* nrow, int K, long long d0,
                                        int dlen, float* srow,
                                        float* __restrict__ agg, int lane) {
  // entries a lane has in flight: 10 of 8 bytes, else 32
  constexpr int NB = V * sizeof(T) == 8 ? 10 : 32;
  constexpr int SB = NB / CE > 0 ? NB / CE : 1;   // slots in flight
  const T* base = x + d0;
  float acc[CE][V];
#pragma unroll
  for (int c = 0; c < CE; ++c)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[c][v] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int idx = k0 + lane < K ? nrow[k0 + lane] : -1;
    unsigned m = __ballot_sync(FULL, idx >= 0);
    while (m) {
      // up to SB valid slots' loads in flight, then their adds in order
      Vec<T, V> buf[SB][CE];
      int n = 0;
#pragma unroll
      for (int s = 0; s < SB; ++s) {
        if (m) {
          const int k = __ffs(m) - 1;
          m &= m - 1;
          const T* src = base + (long long)__shfl_sync(FULL, idx, k) * D;
#pragma unroll
          for (int c = 0; c < CE; ++c) {
            const int col = (lane + 32 * c) * V;
            if (col < dlen) buf[s][c].load(src + col);
          }
          n = s + 1;
        }
      }
#pragma unroll
      for (int s = 0; s < SB; ++s)
        if (s < n)
#pragma unroll
          for (int c = 0; c < CE; ++c)
            if ((lane + 32 * c) * V < dlen) buf[s][c].add_to(acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < CE; ++c) {
    const int col = (lane + 32 * c) * V;
    if (col < dlen) {
      if constexpr (V == 2) {
        const float2 v = make_float2(acc[c][0], acc[c][1]);
        *reinterpret_cast<float2*>(srow + col) = v;
        if (agg) *reinterpret_cast<float2*>(agg + d0 + col) = v;
      } else {
        srow[col] = acc[c][0];
        if (agg) agg[d0 + col] = acc[c][0];
      }
    }
  }
}

// W's rows d .. d + 3 at output columns fa and fa + 1 (zeros past row dend
// or column F)
template <typename T>
__device__ __forceinline__ void load_w(const T* __restrict__ w, long long F,
                                       long long d, long long dend,
                                       long long fa, float* wa, float* wb) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool in = d + i < dend;
    wa[i] = in && fa < F ? to_f32(w[(d + i) * F + fa]) : 0.f;
    wb[i] = in && fa + 1 < F ? to_f32(w[(d + i) * F + fa + 1]) : 0.f;
  }
}

template <typename T, int V, int CE>
__global__ void __launch_bounds__(NT, CE == 1 ? 4 : 2)
    segment_matmul_kernel(const T* __restrict__ x, long long N, long long D,
                          const int* __restrict__ nbr, long long M, int K,
                          const T* __restrict__ w, long long F,
                          T* __restrict__ out, float* __restrict__ agg) {
  constexpr bool SMALL = CE == 1;
  extern __shared__ __align__(16) float smem[];
  const int sa = sum_stride(D);
  float* agg_s = smem;                                           // BM x sa
  int* nbr_s = reinterpret_cast<int*>(smem + sum_floats(D, SMALL));  // BM x K

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // tiles from either end in turn: rows with neighbours cluster (a sampled
  // block's first hops), so the cheap tiles without any run beside them
  const long long nt = gridDim.x, b = blockIdx.x;
  const long long tile = b % 2 ? nt - 1 - b / 2 : b / 2;
  const long long row0 = tile * BM;
  const long long f0 = (long long)blockIdx.y * BF;
  const bool write_agg = agg != nullptr && blockIdx.y == 0;
  const int nrows = (int)(M - row0 < BM ? M - row0 : BM);

  // the tile's nbr slots, clamped to [0, N) or -1
  int any = 0;
  for (int i = tid; i < nrows * K; i += NT) {
    int idx = __ldg(nbr + row0 * K + i);
    if ((long long)idx >= N) idx = (int)(N - 1);
    nbr_s[i] = idx;
    any |= idx >= 0;
  }
  if (!__syncthreads_or(any)) {
    zero_tile<T>(out, agg, row0, f0, nrows, D, F, write_agg);
    return;
  }

  if constexpr (SMALL) {
    // D <= 64: W's rows for the tile's 64 columns load into registers
    // before the sums and go to shared memory after them
    float* w_s = smem + BM * sa;   // 64 x BF
    constexpr int WPT = 64 * BF / NT;
    float wr[WPT];
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const int i = tid + j * NT, dd = i / BF;
      const long long f = f0 + i % BF;
      wr[j] = dd < D && f < F ? to_f32(w[dd * F + f]) : 0.f;
    }
    for (int r = warp; r < nrows; r += NW)
      sum_row<T, V, CE>(x, D, nbr_s + r * K, K, 0, (int)D, agg_s + r * sa,
                        write_agg ? agg + (row0 + r) * D : nullptr, lane);
#pragma unroll
    for (int j = 0; j < WPT; ++j) w_s[tid + j * NT] = wr[j];
    __syncthreads();
    // 2 rows x 4 columns a thread
    const int prow = (warp % 4) * 4 + lane / 8;
    const int pcol = (warp / 4) * 32 + (lane % 8) * 4;
    float acc[2][4] = {};
    for (int c = 0; c < D; ++c) {
      const float4 b = *reinterpret_cast<const float4*>(w_s + c * BF + pcol);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float a = agg_s[(prow + 16 * i) * sa + c];
        acc[i][0] = fmaf(a, b.x, acc[i][0]);
        acc[i][1] = fmaf(a, b.y, acc[i][1]);
        acc[i][2] = fmaf(a, b.z, acc[i][2]);
        acc[i][3] = fmaf(a, b.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const long long r = row0 + prow + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long f = f0 + pcol + j;
        if (r < M && f < F) out[r * F + f] = from_f32<T>(acc[i][j]);
      }
    }
    return;
  }

  constexpr int DG = 4, RG = NW / DG, PR = BM / RG;
  static_assert(RG * DG == NW && BM % RG == 0, "tile");
  const bool one = D <= DT;
  const int dc = one ? DT : DTM;
  float* part = smem + part_offset(D);                  // DG x BM x BF
  // the product: warp (rg, dg) takes PR rows of the tile and a slice of
  // the chunk's columns, 4 at a time, and each lane 2 output columns; W's
  // next 4 rows load while these multiply
  const int rg = warp / DG, dg = warp % DG;
  const long long fa = f0 + 2 * lane;
  for (long long d0 = 0; d0 < D; d0 += dc) {
    const int dlen = (int)(D - d0 < dc ? D - d0 : dc);
    const int dpad = (dlen + 3) & ~3;
    for (int i = tid; i < BM * (dpad - dlen); i += NT)
      agg_s[(i / (dpad - dlen)) * sa + dlen + i % (dpad - dlen)] = 0.f;
    for (int r = warp; r < nrows; r += NW)
      sum_row<T, V, CE>(x, D, nbr_s + r * K, K, d0, dlen, agg_s + r * sa,
                        write_agg ? agg + (row0 + r) * D : nullptr, lane);
    __syncthreads();   // the sums are in

    const int cs = ((dlen + DG - 1) / DG + 3) & ~3;
    const int cbeg = dg * cs;
    const int cend = cbeg + cs < dlen ? cbeg + cs : dlen;
    float acc[PR][2];
#pragma unroll
    for (int r = 0; r < PR; ++r) acc[r][0] = acc[r][1] = 0.f;
    float wa[4], wb[4];
    load_w(w, F, d0 + cbeg, d0 + cend, fa, wa, wb);
    const float* a_s = agg_s + rg * PR * sa;
    for (int c = cbeg; c < cend; c += 4) {
      float na[4], nb[4];
      load_w(w, F, d0 + c + 4, d0 + cend, fa, na, nb);
#pragma unroll
      for (int r = 0; r < PR; ++r) {
        const float4 a = *reinterpret_cast<const float4*>(a_s + r * sa + c);
        acc[r][0] = fmaf(a.x, wa[0], acc[r][0]);
        acc[r][1] = fmaf(a.x, wb[0], acc[r][1]);
        acc[r][0] = fmaf(a.y, wa[1], acc[r][0]);
        acc[r][1] = fmaf(a.y, wb[1], acc[r][1]);
        acc[r][0] = fmaf(a.z, wa[2], acc[r][0]);
        acc[r][1] = fmaf(a.z, wb[2], acc[r][1]);
        acc[r][0] = fmaf(a.w, wa[3], acc[r][0]);
        acc[r][1] = fmaf(a.w, wb[3], acc[r][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        wa[i] = na[i];
        wb[i] = nb[i];
      }
    }
    if (one) __syncthreads();   // the product is done with the sums
    float2* mine = reinterpret_cast<float2*>(
        part + (dg * BM + rg * PR) * BF) + lane;
#pragma unroll
    for (int r = 0; r < PR; ++r) {
      float2 p = make_float2(acc[r][0], acc[r][1]);
      if (d0 > 0) {
        p.x += mine[r * BF / 2].x;
        p.y += mine[r * BF / 2].y;
      }
      mine[r * BF / 2] = p;
    }
    if (!one) __syncthreads();   // the product is done with the sums
  }

  // the column slices' partial products, added in slice order
  __syncthreads();
  for (int i = tid; i < BM * BF; i += NT) {
    const long long r = row0 + i / BF, f = f0 + i % BF;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < DG; ++j) sum += part[j * BM * BF + i];
    if (r < M && f < F) out[r * F + f] = from_f32<T>(sum);
  }
}

// whether the kernel's shared memory for the largest D and K has been
// allowed on each device, per instantiation: the attribute belongs to the
// function in the current device's context
constexpr int MAX_DEVICES = 64;

template <typename T, int V, int CE>
int launch_typed(const void* x, long long N, long long D, const int* nbr,
                 long long M, int K, const void* w, long long F, void* out,
                 float* agg, cudaStream_t stream) {
  static bool allowed[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= MAX_DEVICES || !allowed[dev]) {
    err = cudaFuncSetAttribute(
        segment_matmul_kernel<T, V, CE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(CE == 1 ? 64 : DT, MAX_K, CE == 1));
    if (err != cudaSuccess) return (int)err;
    if (dev >= 0 && dev < MAX_DEVICES) allowed[dev] = true;
  }
  const dim3 grid((unsigned int)((M + BM - 1) / BM),
                  (unsigned int)((F + BF - 1) / BF));
  segment_matmul_kernel<T, V, CE>
      <<<grid, NT, smem_bytes(D, K, CE == 1), stream>>>(
      static_cast<const T*>(x), N, D, nbr, M, K, static_cast<const T*>(w), F,
      static_cast<T*>(out), agg);
  return (int)cudaGetLastError();
}

// CE entries a lane: 1 for a row of at most 32 entries (a lane's registers
// then hold more slots), else a chunk's DT columns
template <typename T, int V>
int launch_rows(long long D, const void* x, long long N, const int* nbr,
                long long M, int K, const void* w, long long F, void* out,
                float* agg, cudaStream_t s) {
  static_assert(DT % (32 * V) == 0, "chunk");
  if ((D + V - 1) / V <= 32)
    return launch_typed<T, V, 1>(x, N, D, nbr, M, K, w, F, out, agg, s);
  return launch_typed<T, V, DT / (32 * V)>(x, N, D, nbr, M, K, w, F, out,
                                           agg, s);
}

template <typename T>
int launch_vec(int vec, const void* x, long long N, long long D,
               const int* nbr, long long M, int K, const void* w, long long F,
               void* out, float* agg, cudaStream_t s) {
  if (vec == 2)
    return launch_rows<T, 2>(D, x, N, nbr, M, K, w, F, out, agg, s);
  return launch_rows<T, 1>(D, x, N, nbr, M, K, w, F, out, agg, s);
}

}  // namespace

// x: (N, D), w: (D, F) and out: (M, F), contiguous, f32 (is_bf16 0) or
// bf16 (1); nbr: (M, K) int32 contiguous; agg: null, or (M, D) f32
// contiguous.  vec (1 or 2) elements a load: 2 needs an even D, x aligned
// to two elements and agg to 8 bytes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); nothing is launched when M or F is 0.
extern "C" int segment_matmul_launch(const void* x, long long N, long long D,
                                     const int* nbr, long long M, int K,
                                     const void* w, long long F, void* out,
                                     float* agg, int is_bf16, int vec,
                                     void* stream) {
  if (M <= 0 || F <= 0) return 0;
  const uintptr_t es = is_bf16 ? 2 : 4;
  if (N <= 0 || D < 0 || K < 0 || K > MAX_K ||
      (M + BM - 1) / BM > 0x7fffffffLL || (F + BF - 1) / BF > 65535 ||
      (vec != 1 && vec != 2) ||
      (vec == 2 && (D % 2 || (uintptr_t)x % (2 * es) ||
                    (uintptr_t)agg % 8)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_vec<__nv_bfloat16>(vec, x, N, D, nbr, M, K, w, F, out, agg,
                                     s);
  return launch_vec<float>(vec, x, N, D, nbr, M, K, w, F, out, agg, s);
}
