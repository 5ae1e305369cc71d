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
// has no order, so the carry is passed between blocks through device memory
// in a single pass with decoupled look-back, as in scan.cu, one launch per
// call.
//
// The carry.  Let best[w] be the last packed position before i whose value
// is <= w.  The answer for i is best[w] with w = d[i] (strict: d[i] - 1),
// since a later position always packs larger.  best over a range combines
// with the one over the range before it by elementwise max, so best is the
// carry: 64 ints, 2 per lane of a warp (lane l holds w = 2l and 2l + 1).
//
//   - Tiles.  A block of 32 warps takes a tile of 8,192 elements, 256 per
//     warp in 8 chunks of 32 (coalesced loads, lane l holds element
//     32c + l of its warp's chunk c).  At g = 1,048,575 that is 128 blocks
//     of 32 warps, one per SM, every warp of the card's first wave busy;
//     larger tiles mean fewer links in the look-back chain.
//   - Bit planes.  Six ballots over a chunk's values (and one over "value
//     in [0, 63]") give every lane the whole chunk as 7 masks.  From them
//     lane l builds, in 5 steps of 3 bitwise operations, the masks of the
//     lanes whose value is <= 2l and <= 2l + 1; the highest such lane
//     (__clz) and one shuffle give the chunk's best vector.  An element
//     finds its own mask (lanes <= w) in lane w / 2 with one shuffle, keeps
//     the lanes below it and fetches the nearest one's packed value with a
//     second: a chain of ~25 operations in place of 31 dependent shuffles.
//   - Pass 1: each warp keeps its running best vector before every chunk in
//     shared memory as two 16-bit offsets per lane ((j - base) << 6 | d[j],
//     32 KB a block).  Each warp takes its carry from the warps before it
//     with independent loads; warp 0 takes the tile's vector and publishes
//     it.
//   - Look-back: a flag word per tile (epoch << 2 | flag) written with
//     st.release after the payload (its lanes' st.cg stores and a warp
//     barrier before it), two payloads per tile (aggregate, inclusive) so a
//     published payload is never rewritten.  The whole block looks back:
//     each of the 1,024 threads reads one predecessor's flag with
//     ld.acquire, each warp waits until its 32 are valid, and after a block
//     barrier the warps read the payloads up to the nearest inclusive
//     prefix (2 ints per lane, ld.cg) and merge them with shared atomicMax.
//     At g = 1,048,575 every block reaches tile 0 in its first window, so
//     no block waits on another's look-back.  Same self-resetting ticket,
//     done counter and epoch workspace as the scan (zpc_nse_tile and
//     zpc_nse_slot_words give its size), every word past the header zeroed
//     when the epoch wraps.
//   - Pass 2: each lane resolves its 8 elements; an element that finds no
//     lane below it in its chunk takes best[w] (the warp's running best
//     before the chunk, else the carry into the warp) from lane w / 2.
//
// A single tile (g <= 8,192) runs one block with no look-back and no
// workspace.
//
// Bound: memory.  The function reads 4 bytes and writes 4 per element: at
// g = 1,048,575 that is 8.4 MB, 2.5 us at 3.35 TB/s.  This kernel reads d
// once and writes the output once, plus 512 bytes of status per tile
// written and read back in L2.  At the LBVH's size it takes 13.3 us
// (PERF.md §6), five times the bytes' time: by the design's count the
// instructions of the two passes (about 130 a chunk of 32 elements, some
// 4.6 us of instruction slots over the card) and the phases a block runs
// one after another (load, pass 1, publish, look-back, pass 2) set it, and
// the look-back costs one round trip a block, since at this size every
// block finds an inclusive prefix in its first window.
//
// ptxas -v on sm_90a (printed by chip_smoke.py phase 2): 58 registers,
// 41,353 B of static shared memory, no spills.

#include <cuda_runtime.h>

namespace {

constexpr int kNone = -(1 << 30);
constexpr int kVals = 64;
constexpr int kWarps = 32;
constexpr int kThreads = kWarps * 32;
constexpr int kChunks = 8;                  // 32-element chunks per warp
constexpr int kWarpElems = kChunks * 32;    // 256 elements per warp
constexpr int kTile = kWarps * kWarpElems;  // 8,192 elements per block
constexpr unsigned kEmpty = 0xffffu;        // no lane of the warp so far
static_assert(((kWarpElems - 1) << 6 | 63) < kEmpty, "offsets fit 16 bits");
constexpr int kOutside = kVals;             // a lane past the end, or a bad value
constexpr unsigned kFull = 0xffffffffu;

// workspace: int32 words [ticket, done, epoch, unused], then per tile a
// slot of [flag, 3 unused, aggregate[64], inclusive[64]]
constexpr int kHeader = 4;
constexpr int kSlot = 4 + 2 * kVals;
constexpr unsigned kEpochMask = (1u << 30) - 1;
constexpr unsigned kAggregate = 1;
constexpr unsigned kInclusive = 2;

__device__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// The chunk's values as bit planes: bit[b] holds bit b of each lane's
// value, valid the lanes whose value is in [0, 63].
struct Planes {
  unsigned bit[6];
  unsigned valid;
};

__device__ Planes planes(int x) {
  Planes p;
#pragma unroll
  for (int b = 0; b < 6; ++b) p.bit[b] = __ballot_sync(kFull, (x >> b) & 1);
  p.valid = __ballot_sync(kFull, x != kOutside);
  return p;
}

// The lanes whose value is <= w, for w = 2 * lane (m0) and 2 * lane + 1
// (m1): compare from the top bit down, keeping the lanes equal to w so far
// and those already below it.  The two w share bits 5..1, which are bits
// 4..0 of the lane.
__device__ void le_pair(const Planes& p, int lane, unsigned& m0,
                        unsigned& m1) {
  unsigned lt = 0, eq = p.valid;
#pragma unroll
  for (int b = 5; b >= 1; --b) {
    const unsigned wb = 0u - ((static_cast<unsigned>(lane) >> (b - 1)) & 1u);
    lt |= eq & ~p.bit[b] & wb;
    eq &= ~(p.bit[b] ^ wb);
  }
  m0 = lt | (eq & ~p.bit[0]);
  m1 = lt | eq;
}

// The 16-bit value of the highest lane in m, put into half `h` of `run`
// when m has a lane; all lanes call it.
__device__ unsigned take(unsigned run, unsigned m, int pk16, int lane, int h) {
  const unsigned v = __shfl_sync(kFull, pk16, m ? 31 - __clz(m) : lane);
  return m ? (run & ~(kEmpty << h)) | (v << h) : run;
}

// One half of a running pair as a packed position, or `none`.
__device__ int unpack(unsigned run, int h, int base, int none) {
  const unsigned v = (run >> h) & kEmpty;
  return v == kEmpty ? none : (base << 6) + static_cast<int>(v);
}

__device__ unsigned* slot(unsigned* ws, long long tile) {
  return ws + kHeader + tile * kSlot;
}

// Lanes 0..31 of warp 0 publish the tile's vector (2 entries each) as an
// aggregate or an inclusive prefix: payload, fence, then the flag.
__device__ void publish(unsigned* ws, unsigned ticket, unsigned flag,
                        unsigned epoch, int r0, int r1, int lane) {
  unsigned* s = slot(ws, ticket);
  int2* pay = reinterpret_cast<int2*>(s + (flag == kInclusive ? 4 + kVals : 4));
  __stcg(&pay[lane], make_int2(r0, r1));
  __syncwarp();            // every lane's payload store before the release
  if (lane == 0) st_release(s, (epoch << 2) | flag);
}

// Every thread of the block holding tile `ticket` > 0: the max of every
// earlier tile's vector, into best[64] (shared, NONE on entry).  A step
// reads the flags of a window of kThreads tiles, thread t that of tile
// pred - t with ld.acquire, each warp waiting until its 32 are valid; after
// a barrier the block's warps read the payloads up to the nearest inclusive
// prefix (warp w the tiles pred - w, pred - w - kWarps, ...; 2 entries per
// lane with ld.cg) and merge them into best with shared atomicMax.  Threads
// before tile 0 take part as ready (tile 0 publishes only an inclusive
// prefix, so the window that reaches it stops there).
__device__ void look_back(unsigned* ws, unsigned ticket, unsigned epoch,
                          int* best, int* first) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (long long pred = static_cast<long long>(ticket) - 1;;
       pred -= kThreads) {
    const long long i = pred - t;
    unsigned f = 0;
    bool ready = i < 0;
    while (!__all_sync(kFull, ready)) {
      if (!ready) {
        f = ld_acquire(slot(ws, i));
        ready = (f >> 2) == epoch && (f & 3u) != 0;
      }
    }
    const unsigned incl =
        __ballot_sync(kFull, i >= 0 && (f & 3u) == kInclusive);
    if (lane == 0) first[warp] = incl ? warp * 32 + __ffs(incl) - 1 : kThreads;
    __syncthreads();         // every payload read after every acquire
    int stop = kThreads;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) stop = min(stop, first[w]);
    int r0 = kNone, r1 = kNone;
    for (int k = warp; k <= stop && k < kThreads; k += kWarps) {
      const int2* pay = reinterpret_cast<const int2*>(
          slot(ws, pred - k) + (k == stop ? 4 + kVals : 4));
      const int2 q = __ldcg(&pay[lane]);
      r0 = max(r0, q.x);
      r1 = max(r1, q.y);
    }
    if (r0 != kNone) atomicMax(&best[2 * lane], r0);
    if (r1 != kNone) atomicMax(&best[2 * lane + 1], r1);
    __syncthreads();         // best is complete; first is reused
    if (stop < kThreads) return;
  }
}

__global__ void __launch_bounds__(kThreads)
nse_kernel(const int* __restrict__ d, int* __restrict__ out, unsigned* ws,
           int g, unsigned tiles, long long ws_words, int strict) {
  // each warp's best vector, then the carry into each warp from the tile
  __shared__ __align__(16) int warp_best[kWarps][kVals];
  // per lane and chunk, the warp's best before the chunk for w = 2l (low
  // half) and 2l + 1 (high half), as 16-bit offsets (j - base) << 6 | d[j]
  __shared__ unsigned chunk_run[kWarps][kChunks][32];
  __shared__ __align__(16) int tile_prefix[kVals];
  __shared__ int first[kWarps];
  __shared__ unsigned sh_ticket, sh_epoch;
  __shared__ bool sh_last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned ticket = 0, epoch = 0;
  if (tiles > 1) {
    if (threadIdx.x == 0) {
      sh_epoch = *reinterpret_cast<volatile unsigned*>(&ws[2]);
      sh_ticket = atomicAdd(&ws[0], 1u);
    }
    __syncthreads();
    ticket = sh_ticket;
    epoch = sh_epoch;
  }
  const int base = static_cast<int>(ticket) * kTile + warp * kWarpElems;
  int v[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int i = base + c * 32 + lane;
    const int x = i < g ? d[i] : kOutside;
    v[c] = (x >= 0 && x < kVals) ? x : kOutside;
  }

  // pass 1: the warp's running best for w = 2l, 2l + 1, kept before each
  // chunk; a later lane packs larger, so the highest lane <= w of the
  // chunk replaces it
  unsigned run = kEmpty | (kEmpty << 16);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const Planes p = planes(v[c]);
    const int pk16 = ((c * 32 + lane) << 6) | v[c];
    unsigned m0, m1;
    le_pair(p, lane, m0, m1);
    chunk_run[warp][c][lane] = run;
    run = take(run, m0, pk16, lane, 0);
    run = take(run, m1, pk16, lane, 16);
  }
  reinterpret_cast<int2*>(warp_best[warp])[lane] =
      make_int2(unpack(run, 0, base, kNone), unpack(run, 16, base, kNone));
  __syncthreads();

  // each warp's carry from the warps before it (independent loads, no
  // chain through warp 0); warp 0 also takes the tile's vector, published
  // at once
  int c0 = kNone, c1 = kNone;
  for (int w = 0; w < warp; ++w) {
    const int2 q = reinterpret_cast<const int2*>(warp_best[w])[lane];
    c0 = max(c0, q.x);
    c1 = max(c1, q.y);
  }
  int r0 = kNone, r1 = kNone;
  if (warp == 0) {
#pragma unroll 8
    for (int w = 0; w < kWarps; ++w) {
      const int2 q = reinterpret_cast<const int2*>(warp_best[w])[lane];
      r0 = max(r0, q.x);
      r1 = max(r1, q.y);
    }
    if (tiles > 1)
      publish(ws, ticket, ticket == 0 ? kInclusive : kAggregate, epoch, r0,
              r1, lane);
    reinterpret_cast<int2*>(tile_prefix)[lane] = make_int2(kNone, kNone);
  }
  __syncthreads();
  if (tiles > 1 && ticket > 0) {
    look_back(ws, ticket, epoch, tile_prefix, first);
    if (warp == 0) {
      const int2 p = reinterpret_cast<const int2*>(tile_prefix)[lane];
      publish(ws, ticket, kInclusive, epoch, max(p.x, r0), max(p.y, r1),
              lane);
    }
  }

  // pass 2: resolve, with best = the carry into the warp, replaced by the
  // warp's own best before the chunk where it has one
  const int2 tp = reinterpret_cast<const int2*>(tile_prefix)[lane];
  c0 = max(c0, tp.x);
  c1 = max(c1, tp.y);
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const Planes p = planes(v[c]);
    unsigned m0, m1;
    le_pair(p, lane, m0, m1);
    const unsigned r = chunk_run[warp][c][lane];
    const int b0 = unpack(r, 0, base, c0);
    const int b1 = unpack(r, 16, base, c1);
    const int pos = base + c * 32 + lane;
    const int x = v[c];
    const int pk = (pos << 6) | x;
    // w = -1 lets nothing qualify
    const int w = x == kOutside ? -1 : x - strict;
    // the lanes <= w and best[w] are held by lane w / 2
    const int src = (w < 0 ? 0 : w) >> 1;
    const unsigned n0 = __shfl_sync(kFull, m0, src);
    const unsigned n1 = __shfl_sync(kFull, m1, src);
    const unsigned m = ((w & 1) ? n1 : n0) & below;
    const int hit = __shfl_sync(kFull, pk, m ? 31 - __clz(m) : lane);
    const int e0 = __shfl_sync(kFull, b0, src);
    const int e1 = __shfl_sync(kFull, b1, src);
    int res = m ? hit : ((w & 1) ? e1 : e0);
    if (w < 0) res = kNone;
    if (pos < g) out[pos] = res;
  }
  if (tiles > 1) {
    // this block is through with the workspace; the last one resets it
    if (threadIdx.x == 0) {
      __threadfence();
      sh_last = atomicAdd(&ws[1], 1u) == tiles - 1;
    }
    __syncthreads();
    if (sh_last) {
      const unsigned next = (epoch + 1) & kEpochMask;
      if (threadIdx.x == 0) {
        volatile unsigned* h = ws;
        h[0] = 0;
        h[1] = 0;
        h[2] = next;
      }
      // the epoch wrapped: no block of this launch reads a slot any more
      if (next == 0)
        for (long long k = kHeader + threadIdx.x; k < ws_words; k += kThreads)
          ws[k] = 0u;
    }
  }
}

}  // namespace

extern "C" {

// The workspace's layout: elements per tile, and int32 words per tile past
// the 4-word header.  A call with g > tile needs a workspace of at least
// 4 + slot_words * ceil(g / tile) words, zeroed before its first use.
int zpc_nse_tile() { return kTile; }
int zpc_nse_slot_words() { return kSlot; }

// ws holds ws_words int32 words (unused, and may be null, when g <= tile).
// Launches one kernel on the caller's current device, which must hold d,
// out, ws and stream.  Returns a cudaError_t: 0 when the launch was
// accepted.
int zpc_nse(const void* d, void* out, void* ws, long long ws_words, int g,
            int strict, void* stream) {
  if (g < 1 || g >= (1 << 24)) return cudaErrorInvalidValue;
  const unsigned tiles = static_cast<unsigned>((g + kTile - 1) / kTile);
  const long long need = kHeader + static_cast<long long>(kSlot) * tiles;
  if (tiles > 1 && (ws == nullptr || ws_words < need))
    return cudaErrorInvalidValue;
  nse_kernel<<<tiles, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(d), static_cast<int*>(out),
      static_cast<unsigned*>(ws), g, tiles, tiles > 1 ? ws_words : 0,
      strict != 0);
  return cudaGetLastError();
}

}  // extern "C"
