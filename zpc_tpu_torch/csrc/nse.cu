// Packed nearest-smaller-element sweep for Hopper (sm_90a): for each i of
// an int32 array d with values in [1, 63], the nearest j < i with
// d[j] <= d[i] (strict: d[j] < d[i]), returned as (j << 6) | d[j], or
// NONE = -(1 << 30) when there is none.  Any 1 <= g < 2^24 (j << 6 must fit
// in 31 bits).  Values outside [0, 63] are never an answer and get NONE.
//
// Replaces zpc_tpu/ops/nse_pallas.py:nse_pallas, the two sweeps of the
// Karras topology (zpc_tpu/containers/bvh.py:_karras_topology).  The TPU
// kernel walks [32, 128] blocks in order on one core and carries the last
// position of each of the 64 values in a [64, 1] VMEM scratch.  A GPU grid
// has no order, so that carry becomes a pass of its own, as in scan.cu.
// The array is cut into segments of kSeg elements, one warp each:
//
//   1. segment_last     each warp writes its segment's last packed position
//                       of every value to a [64, nseg] table;
//   2. carry_scan       one block per value turns its table row into an
//                       exclusive max over the segments, in place: the
//                       carry each segment starts from;
//   3. segment_resolve  each warp walks its segment 32 elements at a time.
//                       A lane looks back through the earlier lanes of its
//                       32 with shuffles; if none qualifies, it reads the
//                       running "best position with value <= w" row, the
//                       prefix max over values of the 64-entry carry, kept
//                       in shared memory and refreshed after every 32.
//
// A single segment (g <= kSeg) takes only the third launch, with no carry.
//
// Bound: memory.  The function reads 4 bytes and writes 4 per element: at
// g = 1,048,575 that is 8.4 MB, 2.5 us at 3.35 TB/s.  This form reads d
// twice and moves a 256-byte table column four times per 2 KB segment,
// so about 14 bytes per element against the ideal 8.  At the LBVH's size
// the three launches cost more than the bytes, so the call is bound by its
// launches:
// the design keeps them to three, with every warp's 16 loads issued
// together from registers, and makes no pass over the 64 values per
// element (each element does 31 shuffles, one table read and one write).

#include <cuda_runtime.h>

namespace {

constexpr int kNone = -(1 << 30);
constexpr int kVals = 64;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = 16;               // 32-element chunks per segment
constexpr int kSeg = kChunks * 32;        // 512 elements per warp
constexpr int kOutside = kVals;           // a lane past the end, or a bad value
constexpr unsigned kFull = 0xffffffffu;

// Chunk c of the segment at `base`: lane l holds element base + 32c + l
// (coalesced); lanes past g and values outside [0, 63] read kOutside.
__device__ void load_segment(const int* __restrict__ d, int base, int g,
                             int lane, int (&v)[kChunks]) {
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = base + c * 32 + lane;
    const int x = i < g ? d[i] : kOutside;
    v[c] = (x >= 0 && x < kVals) ? x : kOutside;
  }
}

// b[w] = max over v <= w of r[v], for the warp's 64-entry rows (lane l
// owns values 2l and 2l + 1).
__device__ void value_prefix(const int* r, int* b, int lane) {
  const int a0 = r[2 * lane];
  const int a1 = max(a0, r[2 * lane + 1]);
  int s = a1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, s, o);
    if (lane >= o) s = max(s, y);
  }
  int e = __shfl_up_sync(kFull, s, 1);
  if (lane == 0) e = kNone;
  b[2 * lane] = max(e, a0);
  b[2 * lane + 1] = s;
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads)
segment_last(const int* __restrict__ d, int* __restrict__ table, int g,
             int nseg) {
  __shared__ int run[kWarps][kVals];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = blockIdx.x * kWarps + warp;
  if (seg >= nseg) return;                       // the whole warp leaves
  int* r = run[warp];
  r[lane] = kNone;
  r[lane + 32] = kNone;
  __syncwarp();
  const int base = seg * kSeg;
  int v[kChunks];
  load_segment(d, base, g, lane, v);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    // the highest lane of each value holds its last position in the chunk
    const unsigned same = __match_any_sync(kFull, v[c]);
    if (v[c] != kOutside && 31 - __clz(same) == lane)
      atomicMax(&r[v[c]], ((base + c * 32 + lane) << 6) | v[c]);
  }
  __syncwarp();
  table[lane * nseg + seg] = r[lane];
  table[(lane + 32) * nseg + seg] = r[lane + 32];
}

// Block v: row v of the table becomes its exclusive max over segments.
__global__ void __launch_bounds__(kThreads)
carry_scan(int* table, int nseg) {
  __shared__ int warp_tot[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* row = table + blockIdx.x * nseg;
  int carry = kNone;
  for (int base = 0; base < nseg; base += kThreads) {
    const int i = base + threadIdx.x;
    const int x = i < nseg ? row[i] : kNone;
    int inc = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc = max(inc, y);
    }
    if (lane == 31) warp_tot[warp] = inc;
    __syncthreads();
    int before = carry;
    int total = carry;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) before = max(before, warp_tot[w]);
      total = max(total, warp_tot[w]);
    }
    int prev = __shfl_up_sync(kFull, inc, 1);
    if (lane == 0) prev = kNone;
    if (i < nseg) row[i] = max(before, prev);
    carry = total;
    __syncthreads();                             // warp_tot is reused
  }
}

__global__ void __launch_bounds__(kThreads)
segment_resolve(const int* __restrict__ d, const int* __restrict__ carry,
                int* __restrict__ out, int g, int nseg, int strict) {
  __shared__ int run[kWarps][kVals];
  __shared__ int best[kWarps][kVals];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int seg = blockIdx.x * kWarps + warp;
  if (seg >= nseg) return;
  int* r = run[warp];
  int* b = best[warp];
  r[lane] = carry != nullptr ? carry[lane * nseg + seg] : kNone;
  r[lane + 32] = carry != nullptr ? carry[(lane + 32) * nseg + seg] : kNone;
  __syncwarp();
  value_prefix(r, b, lane);
  const int base = seg * kSeg;
  int v[kChunks];
  load_segment(d, base, g, lane, v);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int pos = base + c * 32 + lane;
    const int x = v[c];
    // a lane that is no candidate shows a negative packed value
    const int pk = x != kOutside ? (pos << 6) | x : -1;
    // w = -1 lets nothing qualify
    const int w = x == kOutside ? -1 : (strict ? x - 1 : x);
    int res = kNone;
    bool found = false;
#pragma unroll
    for (int k = 1; k < 32; ++k) {
      const int o = __shfl_up_sync(kFull, pk, k);
      if (!found && lane >= k && o >= 0 && (o & 63) <= w) {
        res = o;
        found = true;
      }
    }
    if (!found && w >= 0) res = b[w];
    if (pos < g) out[pos] = res;
    // fold this chunk into the carry, then refresh the best row
    const unsigned same = __match_any_sync(kFull, x);
    if (x != kOutside && 31 - __clz(same) == lane) r[x] = pk;
    __syncwarp();
    value_prefix(r, b, lane);
  }
}

}  // namespace

extern "C" {

// Elements per segment: the wrapper allocates a [64, ceil(g / segment)]
// int32 table when g > segment.
int zpc_nse_segment() { return kSeg; }

// Launches on the caller's current device, which must hold d, out, table
// and stream.  Returns a cudaError_t: 0 when every launch was accepted.
int zpc_nse(const void* d, void* out, void* table, int g, int strict,
            void* stream) {
  if (g < 1 || g >= (1 << 24)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nseg = (g + kSeg - 1) / kSeg;
  const int blocks = (nseg + kWarps - 1) / kWarps;
  const int* dp = static_cast<const int*>(d);
  int* tp = static_cast<int*>(table);
  if (nseg > 1) {
    segment_last<<<blocks, kThreads, 0, s>>>(dp, tp, g, nseg);
    carry_scan<<<kVals, kThreads, 0, s>>>(tp, nseg);
  }
  segment_resolve<<<blocks, kThreads, 0, s>>>(
      dp, nseg > 1 ? tp : nullptr, static_cast<int*>(out), g, nseg, strict);
  return cudaGetLastError();
}

}  // extern "C"
