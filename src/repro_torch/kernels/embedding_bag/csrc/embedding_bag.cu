// Sum-mode EmbeddingBag, written for Hopper (sm_90a):
//
//     out[b] = sum over l of table[min(ids[b, l], V - 1)]   for ids[b, l] > 0
//
// Replaces the TPU kernel src/repro/kernels/embedding_bag/kernel.py
// (_embag_kernel, launched by embedding_bag_pallas).
//
// Contract: table (V, D) f32 or bf16, ids (B, L) int32, out (B, D) in the
// table's type.  An id of 0 or below is padding and is never read (the TPU
// kernel's `idx > 0`); an id of V or more reads row V - 1, as the JAX
// oracle ref.py clips (the Pallas kernel does not clip; this kernel
// follows the oracle).  Each bag's valid rows are summed in f32 in slot
// order l = 0 ... L - 1 from +0.0 and rounded once to the table's type, so
// the output equals the plain version (ref.py) bit for bit.  Any D, any L
// (0 and 1 included), any B.
//
// Bound: bytes.  The kernel must read each distinct valid row once, the
// ids once, and write the output once; it does one add per valid element.
// On SASRec's table (V 1,000,000, D 50, f32) with a 65,536 x 50 batch of
// histories as bags, some 845,000 distinct rows of 200 B, 13 MB of ids and
// 13 MB of output: about 0.058 ms at 3.35 TB/s.  That bound assumes that a
// row two bags share comes from HBM once; taken in bag order, rows shared
// across bags rarely stay in L2, and what HBM serves is each bag's
// distinct rows (1,874,811 there, about 0.44 GB of sectors).  The scalar
// kernel before this one already ran f32 at that traffic's roof; in bf16,
// with half the bytes, it ran no faster: held by the work a slot costs
// and by the loads a warp keeps in flight (PERF.md).
//
// Design: the TPU grid walks blocks of bags in order, with the ids in
// scalar memory, and adds one DMA'd row at a time into a VMEM sum.  Here a
// row is cut into C chunks of W bytes (W = 16, 8, 4 or 2: the widest that
// divides the row and both base addresses, chosen by kernel.py's
// `layout`), and a bag takes LB lanes, the least power of two that covers
// its C chunks, at most 32: lane `sub` of the bag sums chunk sub, sub + LB,
// ... in passes, each element in its own f32 register.  A warp serves
// 32 / LB bags at once (D 50 f32: 25 chunks of 8 bytes, one bag a warp;
// bf16 D 8: one 16-byte chunk, 32 bags a warp).  Nothing is carried
// between warps: no atomics, no block-wide barrier, and the output
// repeats bit for bit.
//
// A warp walks its bags' slots a window at a time: LB slots of each bag,
// lane `sub` of a bag holding slot sub.  It clips its id, and a ballot
// over the bag's lanes gives each valid id its rank, which places it in
// the warp's shared memory, so padding drops out and issues nothing
// later.  A lane reads its bag's valid ids four at a time (one 16-byte
// read), turns each into its chunk's address with one multiply-add, and
// issues up to 24 rows' loads (12 for 16-byte chunks) before the adds,
// which run in slot order.  The grid is persistent: a warp walks bag
// groups a grid's width apart, and loads the next window's id (of this
// bag or of the next) while this window's rows are in flight.  Three
// CTAs fit an SM (80 registers a thread).  Offsets are 64-bit.  Measured
// against this (PERF.md): a per-warp ring of rows filled by cp.async;
// lanes that each load every id themselves; windows of 32 slots for every
// bag with the ids copied ahead by cp.async; no persistent grid; 16 or 32
// slots; L2 eviction hints.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;    // warps a CTA
constexpr int CTAS = 3;     // CTAs an SM: at most 80 registers a thread
constexpr int SLOTS = 24;   // slots whose rows are in flight together

// slots whose rows are in flight together for chunks of W: SLOTS, or as
// many as 48 registers of chunks a lane hold, so that CTAS fit an SM
// without spills (12 for 16-byte chunks)
template <typename W>
__host__ __device__ constexpr int batch() {
  constexpr int words = sizeof(W) < 4 ? 1 : (int)(sizeof(W) / 4);
  constexpr int n = SLOTS < 48 / words ? SLOTS : 48 / words;
  static_assert(n % 4 == 0 && n <= 32, "slots come four at a time, <= 32");
  return n;
}

// a chunk's elements added to acc in element order: f32 words, or bf16
// pairs (element 2i in the low half of word i), widened exactly
template <typename T, typename W>
__device__ __forceinline__ void add_chunk(float* acc, const W& w) {
  if constexpr (sizeof(W) == 2) {
    acc[0] += __uint_as_float((uint32_t)reinterpret_cast<const uint16_t&>(w)
                              << 16);
  } else {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(&w);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(W) / 4); ++i) {
      if constexpr (sizeof(T) == 4) {
        acc[i] += __uint_as_float(p[i]);
      } else {
        acc[2 * i] += __uint_as_float(p[i] << 16);
        acc[2 * i + 1] += __uint_as_float(p[i] & 0xffff0000u);
      }
    }
  }
}

// the f32 sums rounded once to T (round to nearest even, as torch's cast)
// and packed into a chunk
template <typename T, typename W>
__device__ __forceinline__ W pack_chunk(const float* acc) {
  W w;
  if constexpr (sizeof(T) == 4) {
    uint32_t* p = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(W) / 4); ++i)
      p[i] = __float_as_uint(acc[i]);
  } else if constexpr (sizeof(W) == 2) {
    reinterpret_cast<uint16_t&>(w) =
        __bfloat16_as_ushort(__float2bfloat16(acc[0]));
  } else {
    uint32_t* p = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
    for (int i = 0; i < (int)(sizeof(W) / 4); ++i)
      p[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(acc[2 * i])) |
             ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(acc[2 * i + 1]))
              << 16);
  }
  return w;
}

// a warp's walk: bag group t (its bags t * bags ...), pass p (chunk
// p * LB + sub of each row), window w (slots LB w ... LB w + LB - 1 of
// each bag, one a lane)
struct Step {
  long long t;
  int p;
  long long w;
  __device__ __forceinline__ void next(long long windows, int passes,
                                       long long stride) {
    if (++w == windows) {
      w = 0;
      if (++p == passes) {
        p = 0;
        t += stride;
      }
    }
  }
};

template <typename T, typename W>
__global__ void __launch_bounds__(WARPS * 32, CTAS)
    embedding_bag_kernel(const W* __restrict__ table, long long V, int C,
                         int lanes_log2, const int* __restrict__ ids,
                         long long B, long long L, W* __restrict__ out) {
  constexpr int E = (int)(sizeof(W) / sizeof(T));   // elements a chunk
  constexpr int N = batch<W>();
  // each warp's staged ids: its bags' valid ids of a window, a bag's
  // LB of them at a 16-byte aligned place
  __shared__ __align__(16) int staged[WARPS][128];
  const int lane = threadIdx.x & 31;
  const int LB = 1 << lanes_log2;                   // lanes (and slots) a bag
  const int g = lane >> lanes_log2;                 // this lane's bag
  const int sub = lane & (LB - 1);                  // its chunk, its slot
  const long long groups = (B + (32 >> lanes_log2) - 1) >> (5 - lanes_log2);
  const long long stride = (long long)gridDim.x * WARPS;
  const int passes = (C + LB - 1) >> lanes_log2;
  const long long windows = (L + LB - 1) >> lanes_log2;
  Step at{(long long)blockIdx.x * WARPS + (threadIdx.x >> 5), 0, 0};
  if (at.t >= groups) return;   // the whole warp leaves
  if (L == 0) {                 // every sum is +0.0
    for (; at.t < groups; at.t += stride) {
      const long long b = (at.t << (5 - lanes_log2)) + g;
      for (int c = sub; b < B && c < C; c += LB)
        out[b * C + c] = W{};   // +0.0 in f32 and in bf16
    }
    return;
  }
  int* mine = staged[threadIdx.x >> 5] + g * (LB < 4 ? 4 : LB);
  const int4* my_ids = reinterpret_cast<const int4*>(mine);
  const unsigned bag_lanes = (LB == 32 ? 0xffffffffu : (1u << LB) - 1)
                             << (g << lanes_log2);
  const unsigned below = bag_lanes & ((1u << lane) - 1);
  const unsigned row_bytes = (unsigned)C * (unsigned)sizeof(W);
  // this lane's slot of the step's window in its bag, clipped: -1 for
  // padding and past the bag's end or the last bag
  auto slot_id = [&](const Step& x) {
    const long long b = (x.t << (5 - lanes_log2)) + g;
    const long long l = (x.w << lanes_log2) + sub;
    int k = -1;
    if (x.t < groups && b < B && l < L) {
      k = ids[b * L + l];
      // k is an int, so the clipped row fits in one
      k = k <= 0 ? -1 : ((long long)k < V ? k : (int)(V - 1));
    }
    return k;
  };

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;
  int k = slot_id(at);
  while (at.t < groups) {
    // stage the window's valid ids of each bag in slot order: a ballot
    // over the bag's lanes ranks each valid id among those below it
    const unsigned valid = __ballot_sync(0xffffffffu, k >= 0);
    __syncwarp();   // the last window's readers are done
    if (k >= 0) mine[__popc(valid & below)] = k;
    int n = __popc(valid & bag_lanes);
    int most = __reduce_max_sync(0xffffffffu, n);
    __syncwarp();
    // the next step's ids fly while this one's rows do
    Step next = at;
    next.next(windows, passes, stride);
    k = slot_id(next);

    const long long b = (at.t << (5 - lanes_log2)) + g;
    const int c = (at.p << lanes_log2) + sub;
    const bool live = b < B && c < C;
    const char* base = reinterpret_cast<const char*>(table + (live ? c : 0));
    if (!live) n = 0;
    for (int r0 = 0; r0 < most; r0 += N) {
      W v[N];
#pragma unroll
      for (int q = 0; q < N; q += 4) {
        if (r0 + q < most) {
          const int4 k4 = my_ids[(r0 + q) / 4];
          const int kq[4] = {k4.x, k4.y, k4.z, k4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            v[q + u] = W{};
            if (r0 + q + u < n)
              v[q + u] = __ldg(reinterpret_cast<const W*>(
                  base + (size_t)(unsigned)kq[u] * row_bytes));
          }
        }
      }
      // the adds in slot order; a slot past the bag's last adds +0.0,
      // which leaves a sum that started at +0.0 unchanged
#pragma unroll
      for (int u = 0; u < N; ++u) {
        if (r0 + u < most) add_chunk<T>(acc, v[u]);
      }
    }
    if (at.w == windows - 1) {   // the pass's sums are whole
      if (live) out[b * C + c] = pack_chunk<T, W>(acc);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = 0.f;
    }
    at = next;
  }
}

template <typename T, typename W>
int launch_typed(const void* table, long long V, long long row_bytes,
                 int lanes_log2, const int* ids, long long B, long long L,
                 void* out, cudaStream_t stream) {
  const long long C = row_bytes / (long long)sizeof(W);
  const long long groups = (B + (32 >> lanes_log2) - 1) >> (5 - lanes_log2);
  if (row_bytes > 0xffffffffLL) return (int)cudaErrorInvalidValue;
  // a persistent grid: as many CTAs as fit the card at once, each warp
  // walking bag groups a grid's width apart.  The card's capacity is
  // asked once a device (a race writes the same value).
  static int fits[64];   // CTAs the card holds at once, by device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (fits[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, embedding_bag_kernel<T, W>, WARPS * 32, 0);
    if (err != cudaSuccess) return (int)err;
    if (sms * per_sm <= 0) return (int)cudaErrorInvalidConfiguration;
    fits[dev] = sms * per_sm;
  }
  long long blocks = (groups + WARPS - 1) / WARPS;
  if (blocks > fits[dev]) blocks = fits[dev];
  embedding_bag_kernel<T, W><<<(unsigned int)blocks, WARPS * 32, 0,
                               stream>>>(
      static_cast<const W*>(table), V, (int)C, lanes_log2, ids, B, L,
      static_cast<W*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_width(const void* table, long long V, long long row_bytes,
                 int chunk_bytes, int lanes_log2, const int* ids, long long B,
                 long long L, void* out, cudaStream_t s) {
  switch (chunk_bytes) {
    case 16:
      return launch_typed<T, uint4>(table, V, row_bytes, lanes_log2, ids, B,
                                    L, out, s);
    case 8:
      return launch_typed<T, uint2>(table, V, row_bytes, lanes_log2, ids, B,
                                    L, out, s);
    case 4:
      return launch_typed<T, uint32_t>(table, V, row_bytes, lanes_log2, ids,
                                       B, L, out, s);
    case 2:
      if constexpr (sizeof(T) == 2)
        return launch_typed<T, uint16_t>(table, V, row_bytes, lanes_log2, ids,
                                         B, L, out, s);
      return (int)cudaErrorInvalidValue;   // half an f32
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// table: (V, D) contiguous, f32 (is_bf16 0) or bf16 (is_bf16 1); ids: (B, L)
// int32 contiguous; out: (B, D) contiguous, the table's type.  chunk_bytes
// (16, 8, 4 or 2, at least an element) divides the row's bytes and both
// base addresses; lanes_per_bag is a power of two up to 32 (kernel.py's
// `layout` chooses both).  Launches on `stream` and returns
// cudaGetLastError() (0 on success); nothing is launched when B or D is 0.
extern "C" int embedding_bag_launch(const void* table, long long V,
                                    long long D, int is_bf16,
                                    int chunk_bytes, int lanes_per_bag,
                                    const int* ids, long long B, long long L,
                                    void* out, void* stream) {
  if (B <= 0 || D <= 0) return 0;
  if (L < 0 || (V <= 0 && L > 0)) return (int)cudaErrorInvalidValue;
  const long long row_bytes = D * (is_bf16 ? 2 : 4);
  if (chunk_bytes <= 0 || row_bytes % chunk_bytes ||
      ((uintptr_t)table | (uintptr_t)out) % (uintptr_t)chunk_bytes ||
      lanes_per_bag <= 0 || lanes_per_bag > 32 ||
      (lanes_per_bag & (lanes_per_bag - 1)))
    return (int)cudaErrorInvalidValue;
  const int lanes_log2 = __builtin_ctz((unsigned)lanes_per_bag);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_width<__nv_bfloat16>(table, V, row_bytes, chunk_bytes,
                                       lanes_log2, ids, B, L, out, s);
  return launch_width<float>(table, V, row_bytes, chunk_bytes, lanes_log2,
                             ids, B, L, out, s);
}
