// 1-D prefix scan for Hopper (sm_90a): inclusive add / max / min and
// exclusive add over int32, uint32 and float32, for any n >= 1.
//
// Replaces zpc_tpu/ops/scan_pallas.py:scan_pallas.  The TPU kernel walks
// [1024, 128] chunks in order on one core and carries the running total in
// VMEM from one grid step to the next.  A GPU grid runs its blocks in no
// order, so the carry becomes a second pass instead:
//
//   1. tile_reduce    one block per tile of kTile elements writes the tile's
//                     total to `partial`;
//   2. scan_partials  one block scans the tile totals in place (exclusive),
//                     looping over them kTile at a time with a carry;
//   3. tile_scan      one block per tile scans its tile in shared memory,
//                     starting from the tile's offset in `partial`.
//
// A single tile (n <= kTile) takes only the third launch, with no offset.
//
// Bound: memory.  The scan is one read and one write of the array; this
// three-launch form reads the array twice (reduce, then scan), so it moves
// 12 bytes per 4-byte element against the ideal 8.  A single-pass decoupled
// look-back would remove the reduce pass.  At the rebin's sizes (262,144
// and 327,680 elements, 1.0-1.3 MB) the traffic is a few microseconds of
// HBM time, so the call is bound by its launches, not by bytes.
//
// Integer add wraps modulo 2^32, as the TPU kernel's does.  Float add is
// taken in another order than a sequential cumsum, so results agree to
// rounding, not bitwise.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 8;                    // contiguous elements per thread
constexpr int kTile = kThreads * kItems;     // 2048 elements per block
constexpr int kWarps = kThreads / 32;

// One padding word every 32 elements keeps the strided per-thread reads of
// the tile (thread t reads t*kItems + i) free of shared-memory bank conflicts.
__host__ __device__ constexpr int padded(int i) { return i + (i >> 5); }
constexpr int kSmem = padded(kTile - 1) + 1;

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

// Exclusive scan of one value per thread across the block.  Returns the
// thread's exclusive prefix and sets `total` to the block's total.
template <typename T, typename Op>
__device__ T block_exclusive(T v, T* warp_tot, T& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  T inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    T o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc = Op::apply(o, inc);
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_tot[lane] : Op::identity();
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      T o = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = Op::apply(o, w);
    }
    if (lane < kWarps) warp_tot[lane] = w;   // inclusive over warps
  }
  __syncthreads();
  total = warp_tot[kWarps - 1];
  T before_warp = warp > 0 ? warp_tot[warp - 1] : Op::identity();
  T before_lane = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) before_lane = Op::identity();
  return Op::apply(before_warp, before_lane);
}

// Scans x[base, base + count) into out[base, ...) starting from `prefix`.
// Returns the tile's total.  Safe in place: the whole tile is in shared
// memory before anything is written.
template <typename T, typename Op>
__device__ T scan_tile(const T* x, T* out, int64_t base, int count, T prefix,
                       bool exclusive, T* s, T* warp_tot) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = i * kThreads + t;            // coalesced load
    s[padded(idx)] = idx < count ? x[base + idx] : Op::identity();
  }
  __syncthreads();
  T items[kItems];
  T acc = Op::identity();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    items[i] = s[padded(t * kItems + i)];
    acc = Op::apply(acc, items[i]);
  }
  T total;
  T run = Op::apply(prefix, block_exclusive<T, Op>(acc, warp_tot, total));
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const T next = Op::apply(run, items[i]);
    s[padded(t * kItems + i)] = exclusive ? run : next;
    run = next;
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int idx = i * kThreads + t;            // coalesced store
    if (idx < count) out[base + idx] = s[padded(idx)];
  }
  return total;
}

template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
tile_reduce(const T* __restrict__ x, T* __restrict__ partial, int64_t n) {
  __shared__ T warp_tot[kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  T acc = Op::identity();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int64_t idx = base + i * kThreads + threadIdx.x;
    if (idx < n) acc = Op::apply(acc, x[idx]);
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    acc = Op::apply(acc, __shfl_down_sync(0xffffffffu, acc, d));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_tot[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    T w = lane < kWarps ? warp_tot[lane] : Op::identity();
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      w = Op::apply(w, __shfl_down_sync(0xffffffffu, w, d));
    if (lane == 0) partial[blockIdx.x] = w;
  }
}

template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
scan_partials(T* partial, int64_t m) {
  __shared__ T s[kSmem];
  __shared__ T warp_tot[kWarps];
  T carry = Op::identity();
  for (int64_t base = 0; base < m; base += kTile) {
    const int count = static_cast<int>(m - base < kTile ? m - base : kTile);
    const T total = scan_tile<T, Op>(partial, partial, base, count, carry,
                                     /*exclusive=*/true, s, warp_tot);
    carry = Op::apply(carry, total);
    __syncthreads();
  }
}

template <typename T, typename Op>
__global__ void __launch_bounds__(kThreads)
tile_scan(const T* __restrict__ x, T* __restrict__ out,
          const T* __restrict__ partial, int64_t n, bool exclusive) {
  __shared__ T s[kSmem];
  __shared__ T warp_tot[kWarps];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int count = static_cast<int>(n - base < kTile ? n - base : kTile);
  const T prefix = partial != nullptr ? partial[blockIdx.x] : Op::identity();
  scan_tile<T, Op>(x, out, base, count, prefix, exclusive, s, warp_tot);
}

template <typename T, typename Op>
cudaError_t launch(const void* x, void* out, void* partial, int64_t n,
                   bool exclusive, cudaStream_t stream) {
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (tiles == 1) {
    tile_scan<T, Op><<<1, kThreads, 0, stream>>>(xp, op, nullptr, n,
                                                  exclusive);
  } else {
    T* pp = static_cast<T*>(partial);
    tile_reduce<T, Op><<<static_cast<unsigned>(tiles), kThreads, 0,
                         stream>>>(xp, pp, n);
    scan_partials<T, Op><<<1, kThreads, 0, stream>>>(pp, tiles);
    tile_scan<T, Op><<<static_cast<unsigned>(tiles), kThreads, 0,
                       stream>>>(xp, op, pp, n, exclusive);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_op(int op, const void* x, void* out, void* partial,
                      int64_t n, bool exclusive, cudaStream_t stream) {
  switch (op) {
    case 0: return launch<T, Add<T>>(x, out, partial, n, exclusive, stream);
    case 1: return launch<T, Max<T>>(x, out, partial, n, exclusive, stream);
    case 2: return launch<T, Min<T>>(x, out, partial, n, exclusive, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Elements per tile: the wrapper allocates ceil(n / tile) partials when
// n > tile.
int zpc_scan_tile() { return kTile; }

// dtype: 0 int32, 1 uint32, 2 float32.  op: 0 add, 1 max, 2 min.
// Launches on the caller's current device, which must hold x, out, partial
// and stream.  Returns a cudaError_t: 0 when every launch was accepted.
int zpc_scan(const void* x, void* out, void* partial, long long n, int dtype,
             int op, int exclusive, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_op<int32_t>(op, x, out, partial, n, exclusive, s);
    case 1: return launch_op<uint32_t>(op, x, out, partial, n, exclusive, s);
    case 2: return launch_op<float>(op, x, out, partial, n, exclusive, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
