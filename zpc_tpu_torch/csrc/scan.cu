// 1-D prefix scan for Hopper (sm_90a): inclusive add / max / min and
// exclusive add over int32, uint32 and float32, for any n >= 1.
//
// Replaces zpc_tpu/ops/scan_pallas.py:scan_pallas.  The TPU kernel walks
// [1024, 128] chunks in order on one core and carries the running total in
// VMEM from one grid step to the next.  A GPU grid runs its blocks in no
// order, so the carry is passed between blocks through device memory in a
// single pass (the chained scan with decoupled look-back of Merrill and
// Garland, the design cub uses), one launch per call:
//
//   - Tiles.  A block of 256 threads takes a tile of 4,096 elements (16 per
//     thread) when n < 2^20 and of 8,192 (32 per thread) from there on.
//     Neither size serves both ends (PERF.md §6, one call): at the rebin's
//     327,680 elements 80 tiles of 4,096 take 4.4 us against 5.3 us for 40
//     of 8,192, which load on half the SMs; at 16,777,223 the 8,192 tiles
//     take 65 us against 81 us, where twice the tiles mean twice the
//     tickets, look-backs and waits.  Each warp loads its part with
//     16-byte vector loads (scalar loads when x or out is not 16-byte
//     aligned, as a view at an odd offset is) into its own padded shared
//     memory, reads its items back contiguously, and
//     the block scans the per-thread totals with warp shuffles and one
//     shared-memory pass over the warp totals.  The items stay in shared
//     memory and are read again for the output, so no register holds them
//     across the look-back.
//   - Tile order.  The tile comes from a ticket (atomicAdd on a counter),
//     not from blockIdx.x, so a block only ever waits on tiles whose blocks
//     are already running: the kernel always makes progress.
//   - Publishing and look-back.  Once a block knows its tile's aggregate it
//     publishes it.  Then the whole block looks back, 1,024 predecessors a
//     round trip: each thread reads 4 status words, each warp waits until
//     its reads are valid, and the block combines them up to the nearest
//     inclusive prefix (two barriers).  The block publishes its own
//     inclusive prefix and writes its tile once.  A status word packs
//     value, flag and epoch in 64 bits and is written with one store; as it
//     carries its own value, relaxed gpu-scope loads and stores are enough
//     (acquire and release would order nothing more).  A window read by
//     warp 0 alone, 32 tiles a round trip, made the chain of round trips,
//     not the bytes, set the time of a large scan.
//   - No host state per call.  The workspace (int32 words: ticket, done,
//     epoch, unused, then one 64-bit status per tile; zpc_scan_tile and
//     zpc_scan_slot_words give its size) is zeroed once by the wrapper when
//     it is made.  Each block reads the epoch before it takes its ticket
//     and tags its statuses with it, so statuses of earlier calls never read
//     as valid.  At its very end each block counts itself on `done`; the
//     block that brings `done` to the tile count is the last to use the
//     workspace, resets both counters and advances the epoch (mod 2^30).
//     When the epoch wraps to 0 that block also zeroes every word past the
//     header, so a status from 2^30 calls ago cannot come back as valid.
//     (The last block to take a ticket could not do this safely: others may
//     still be looking back.)  The launch is the same every call and can be
//     captured in a CUDA graph.
//   - One tile.  n <= 4,096 runs one block with no ticket, no look-back and
//     no workspace.
//
// Bound: memory.  The scan is one read and one write of the array, 8 bytes
// per 4-byte element, and this kernel moves exactly that plus 8 bytes of
// status per tile written and a few times that read back in L2 (the old
// three-launch form moved 12 bytes per element).  At the rebin's sizes
// (2,560 to 327,680 elements, at most 2.6 MB) the bytes take under a
// microsecond of HBM time, and the launch, one tile's load and the
// look-back's round trips set the time.  At 16M elements the kernel reaches
// about 60% of the byte bound, as cub's scan does (PERF.md §6): a block
// holds its place on the SM until its look-back resolves, so the waits of
// the look-back still stand between the loads.
//
// ptxas -v on sm_90a (printed by chip_smoke.py phase 2): 32-48 registers
// and 16,969 B of static shared memory at 16 items, 40-80 registers and
// 33,865 B at 32 items; no spills but 4-8 B in the scalar (unaligned)
// integer and float-add variants at 32 items.
//
// Tensor cores: none.  A scan is a chain of adds, maxes or mins with no
// product in it; the tensor cores only multiply-accumulate, and the one
// trick that maps a scan onto them (a product with a triangular matrix of
// ones) is exact only in a floating-point type whose mantissa holds every
// partial sum.  A 32-bit integer add mod 2^32, and max and min, have no
// such form.
//
// Integer add wraps modulo 2^32, as the TPU kernel's does.  Float add is
// taken in another order than a sequential cumsum, so results agree to
// rounding, not bitwise.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// contiguous elements per thread: 16 (tiles of 4,096) below kLargeFrom
// elements, 32 (tiles of 8,192) from there on
constexpr int kSmallItems = 16;
constexpr int kLargeItems = 32;
constexpr long long kLargeFrom = 1 << 20;
constexpr int kReads = 4;                    // statuses per thread per look-back step
constexpr int kWindow = kThreads * kReads;   // tiles per look-back step
constexpr unsigned kFull = 0xffffffffu;

// workspace: int32 words [ticket, done, epoch, unused], then one 64-bit
// status (kSlot words) per tile
constexpr int kHeader = 4;
constexpr int kSlot = 2;
constexpr unsigned kEpochMask = (1u << 30) - 1;
constexpr unsigned kAggregate = 1;
constexpr unsigned kInclusive = 2;

// Each warp stages its own 32 * kItems elements of the tile in shared
// memory, so staging needs no block-wide barrier.  One padding word every
// 32 elements keeps both the coalesced stores (lane l writes 4l .. 4l + 3)
// and the blocked reads (lane l reads kItems * l + i) free of bank
// conflicts.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }

template <int kItems> struct Tiling {
  static constexpr int kTile = kThreads * kItems;
  static constexpr int kVecs = kItems / 4;   // 16-byte vectors per thread
  static constexpr int kWarpItems = 32 * kItems;
  static constexpr int kWarpSmem = padded(kWarpItems - 1) + 1;
};

template <typename T> struct Limits;
template <> struct Limits<int32_t> {
  __device__ static int32_t lowest() { return INT_MIN; }
  __device__ static int32_t highest() { return INT_MAX; }
};
template <> struct Limits<uint32_t> {
  __device__ static uint32_t lowest() { return 0u; }
  __device__ static uint32_t highest() { return UINT_MAX; }
};
// +-inf, not +-FLT_MAX: a max scan over leading -inf stays -inf, as
// torch.cummax does
template <> struct Limits<float> {
  __device__ static float lowest() { return -INFINITY; }
  __device__ static float highest() { return INFINITY; }
};

template <typename T> struct Add {
  __device__ static T identity() { return T(0); }
  __device__ static T apply(T a, T b) { return a + b; }
};
template <> struct Add<int32_t> {
  __device__ static int32_t identity() { return 0; }
  // through unsigned: wraps mod 2^32 without signed-overflow UB
  __device__ static int32_t apply(int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) +
                                static_cast<uint32_t>(b));
  }
};
template <typename T> struct Max {
  __device__ static T identity() { return Limits<T>::lowest(); }
  __device__ static T apply(T a, T b) { return a > b ? a : b; }
};
template <typename T> struct Min {
  __device__ static T identity() { return Limits<T>::highest(); }
  __device__ static T apply(T a, T b) { return a < b ? a : b; }
};

template <typename T> __device__ uint32_t to_bits(T v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}
template <typename T> __device__ T from_bits(uint32_t u) {
  T v;
  memcpy(&v, &u, sizeof(v));
  return v;
}

// A status word carries its value, so it needs no ordering against other
// memory: relaxed gpu-scope accesses (single-copy atomic, never served from
// a stale L1 line) are enough.
__device__ unsigned long long ld_status(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ void st_status(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// status word: (epoch << 2 | flag) in the high half, the value's bits in
// the low half; a zeroed word has flag 0 and never reads as valid
template <typename T>
__device__ unsigned long long pack(unsigned epoch, unsigned flag, T v) {
  return (static_cast<unsigned long long>((epoch << 2) | flag) << 32) |
         to_bits(v);
}

// Exclusive scan of one value per thread across the block.  Returns the
// thread's exclusive prefix and sets `total` to the block's total.
template <typename T, typename Op>
__device__ T block_exclusive(T v, T* warp_tot, T& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T o = __shfl_up_sync(kFull, inc, d);
    if (lane >= d) inc = Op::apply(o, inc);
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_tot[lane] : Op::identity();
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      T o = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w = Op::apply(o, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  total = warp_tot[kWarps - 1];
  T before_warp = warp > 0 ? warp_tot[warp - 1] : Op::identity();
  T before_lane = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) before_lane = Op::identity();
  return Op::apply(before_warp, before_lane);
}

// Every thread of the block holding tile `ticket` > 0: the combination of
// every earlier tile.  A step reads a window of kWindow statuses in one
// round trip, thread t those of tiles pred - t - kThreads * r (r < kReads),
// each warp waiting until its reads are valid; the block then combines them
// up to the nearest inclusive prefix.  Reads before tile 0 take part as
// identities (tile 0 publishes only an inclusive prefix, so the window that
// reaches it always stops there).
template <typename T, typename Op>
__device__ T look_back(const unsigned long long* status, unsigned ticket,
                       unsigned epoch, T* part, int* first) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  T prefix = Op::identity();
  for (long long pred = static_cast<long long>(ticket) - 1;;
       pred -= kWindow) {
    unsigned long long w[kReads];
    bool ready[kReads];
#pragma unroll
    for (int r = 0; r < kReads; ++r) {
      w[r] = 0;
      ready[r] = pred - t - kThreads * r < 0;
    }
    for (;;) {
      bool all = true;
#pragma unroll
      for (int r = 0; r < kReads; ++r) {
        if (!ready[r]) {
          w[r] = ld_status(&status[pred - t - kThreads * r]);
          const unsigned hi = static_cast<unsigned>(w[r] >> 32);
          ready[r] = (hi >> 2) == epoch && (hi & 3u) != 0;
        }
        all = all && ready[r];
      }
      if (__all_sync(kFull, all)) break;
    }
    // the nearest inclusive prefix: the lowest window position kThreads r + t
    int near = kWindow;
#pragma unroll
    for (int r = kReads - 1; r >= 0; --r) {
      const unsigned incl = __ballot_sync(
          kFull, pred - t - kThreads * r >= 0 &&
                     (static_cast<unsigned>(w[r] >> 32) & 3u) == kInclusive);
      if (incl) near = kThreads * r + warp * 32 + __ffs(incl) - 1;
    }
    if (lane == 0) first[warp] = near;
    __syncthreads();
    int stop = kWindow;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) stop = min(stop, first[k]);
    T v = Op::identity();
#pragma unroll
    for (int r = 0; r < kReads; ++r)
      if (pred - t - kThreads * r >= 0 && kThreads * r + t <= stop)
        v = Op::apply(v, from_bits<T>(static_cast<uint32_t>(w[r])));
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      v = Op::apply(v, __shfl_xor_sync(kFull, v, d));
    if (lane == 0) part[warp] = v;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kWarps; ++k) prefix = Op::apply(part[k], prefix);
    __syncthreads();                             // part and first are reused
    if (stop < kWindow) return prefix;
  }
}

template <typename T, typename Op, int kItems, bool kAligned>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ x, T* __restrict__ out, unsigned* ws,
            int64_t n, unsigned tiles, int64_t ws_words, bool exclusive) {
  using Tl = Tiling<kItems>;
  constexpr int kVecs = Tl::kVecs;
  constexpr int kWarpItems = Tl::kWarpItems;
  __shared__ T s[kWarps][Tl::kWarpSmem];
  __shared__ T warp_tot[kWarps];
  __shared__ T part[kWarps];
  __shared__ int first[kWarps];
  __shared__ unsigned sh_ticket, sh_epoch;
  __shared__ bool sh_last;
  const int t = threadIdx.x;
  const int lane = t & 31;
  unsigned ticket = 0, epoch = 0;
  if (tiles > 1) {
    if (t == 0) {
      sh_epoch = *reinterpret_cast<volatile unsigned*>(&ws[2]);
      sh_ticket = atomicAdd(&ws[0], 1u);
    }
    __syncthreads();
    ticket = sh_ticket;
    epoch = sh_epoch;
  }
  // this warp's elements: [base, base + count) of x, count <= kWarpItems
  const int64_t base = static_cast<int64_t>(ticket) * Tl::kTile +
                       (t >> 5) * kWarpItems;
  const int count =
      static_cast<int>(n - base < kWarpItems ? (n > base ? n - base : 0)
                                             : kWarpItems);
  T* sw = s[t >> 5];

  if (kAligned) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + base);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = i * 32 + lane;               // coalesced 16-byte loads
      const int e = 4 * v;
      if (e + 4 <= count) {
        const uint4 q = xv[v];
        sw[padded(e)] = from_bits<T>(q.x);
        sw[padded(e + 1)] = from_bits<T>(q.y);
        sw[padded(e + 2)] = from_bits<T>(q.z);
        sw[padded(e + 3)] = from_bits<T>(q.w);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sw[padded(e + k)] = e + k < count ? x[base + e + k] : Op::identity();
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = i * 32 + lane;             // coalesced scalar loads
      sw[padded(idx)] = idx < count ? x[base + idx] : Op::identity();
    }
  }
  __syncwarp();
  // the items stay in shared memory, read again after the look-back, so
  // no register holds them across it
  T acc = Op::identity();
#pragma unroll
  for (int i = 0; i < kItems; ++i)
    acc = Op::apply(acc, sw[padded(lane * kItems + i)]);
  T total;
  const T excl = block_exclusive<T, Op>(acc, warp_tot, total);

  T prefix = Op::identity();
  unsigned long long* status =
      tiles > 1 ? reinterpret_cast<unsigned long long*>(ws + kHeader)
                : nullptr;
  if (tiles > 1) {
    if (ticket == 0) {
      if (t == 0) st_status(&status[0], pack(epoch, kInclusive, total));
    } else {
      if (t == 0) st_status(&status[ticket], pack(epoch, kAggregate, total));
      prefix = look_back<T, Op>(status, ticket, epoch, part, first);
      if (t == 0)
        st_status(&status[ticket],
                  pack(epoch, kInclusive, Op::apply(prefix, total)));
    }
  }

  T run = Op::apply(prefix, excl);
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    T& item = sw[padded(lane * kItems + i)];
    const T next = Op::apply(run, item);
    item = exclusive ? run : next;
    run = next;
  }
  __syncwarp();
  if (kAligned) {
    uint4* ov = reinterpret_cast<uint4*>(out + base);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = i * 32 + lane;               // coalesced 16-byte stores
      const int e = 4 * v;
      if (e + 4 <= count) {
        ov[v] = make_uint4(to_bits(sw[padded(e)]), to_bits(sw[padded(e + 1)]),
                           to_bits(sw[padded(e + 2)]),
                           to_bits(sw[padded(e + 3)]));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (e + k < count) out[base + e + k] = sw[padded(e + k)];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int idx = i * 32 + lane;
      if (idx < count) out[base + idx] = sw[padded(idx)];
    }
  }
  if (tiles > 1) {
    // this block is through with the workspace; the last one resets it
    if (t == 0) {
      __threadfence();
      sh_last = atomicAdd(&ws[1], 1u) == tiles - 1;
    }
    __syncthreads();
    if (sh_last) {
      const unsigned next = (epoch + 1) & kEpochMask;
      if (t == 0) {
        volatile unsigned* v = ws;
        v[0] = 0;
        v[1] = 0;
        v[2] = next;
      }
      // the epoch wrapped: no block of this launch reads a status any more
      if (next == 0)
        for (int64_t k = kHeader + t; k < ws_words; k += kThreads) ws[k] = 0u;
    }
  }
}

template <typename T, typename Op, int kItems>
cudaError_t launch(const void* x, void* out, unsigned* ws, int64_t n,
                   int64_t ws_words, bool exclusive, cudaStream_t stream) {
  constexpr int kTile = Tiling<kItems>::kTile;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles > 1 && (ws == nullptr || ws_words < kHeader + kSlot * tiles))
    return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const unsigned nt = static_cast<unsigned>(tiles);
  const int64_t words = tiles > 1 ? ws_words : 0;
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) &
       15u) == 0;
  if (aligned)
    scan_kernel<T, Op, kItems, true><<<nt, kThreads, 0, stream>>>(
        xp, op, ws, n, nt, words, exclusive);
  else
    scan_kernel<T, Op, kItems, false><<<nt, kThreads, 0, stream>>>(
        xp, op, ws, n, nt, words, exclusive);
  return cudaGetLastError();
}

template <typename T, typename Op>
cudaError_t launch_sized(const void* x, void* out, unsigned* ws, int64_t n,
                         int64_t words, bool excl, cudaStream_t s) {
  return n < kLargeFrom
             ? launch<T, Op, kSmallItems>(x, out, ws, n, words, excl, s)
             : launch<T, Op, kLargeItems>(x, out, ws, n, words, excl, s);
}

template <typename T>
cudaError_t launch_op(int op, const void* x, void* out, unsigned* ws,
                      int64_t n, int64_t words, bool excl, cudaStream_t s) {
  switch (op) {
    case 0: return launch_sized<T, Add<T>>(x, out, ws, n, words, excl, s);
    case 1: return launch_sized<T, Max<T>>(x, out, ws, n, words, excl, s);
    case 2: return launch_sized<T, Min<T>>(x, out, ws, n, words, excl, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The workspace's layout: elements per tile (the smaller of the two), and
// int32 words per tile past the 4-word header.  A call with n > tile needs
// a workspace of at least 4 + slot_words * ceil(n / tile) words, zeroed
// before its first use.
int zpc_scan_tile() { return Tiling<kSmallItems>::kTile; }
int zpc_scan_slot_words() { return kSlot; }

// dtype: 0 int32, 1 uint32, 2 float32.  op: 0 add, 1 max, 2 min.  ws holds
// ws_words int32 words (unused, and may be null, when n <= tile).  Launches
// one kernel on the caller's current device, which must hold x, out, ws and
// stream.  Returns a cudaError_t: 0 when the launch was accepted.
int zpc_scan(const void* x, void* out, void* ws, long long ws_words,
             long long n, int dtype, int op, int exclusive, void* stream) {
  if (n < 1 || n / Tiling<kSmallItems>::kTile >= INT_MAX)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* w = static_cast<unsigned*>(ws);
  const int64_t words = ws_words;
  switch (dtype) {
    case 0: return launch_op<int32_t>(op, x, out, w, n, words, exclusive, s);
    case 1: return launch_op<uint32_t>(op, x, out, w, n, words, exclusive, s);
    case 2: return launch_op<float>(op, x, out, w, n, words, exclusive, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
