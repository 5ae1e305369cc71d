// The IPC point-triangle barrier of each bin's 128 lanes against the bin's
// candidate triangles, for Hopper (sm_90a): the narrow phase of the
// implicit MPM step's mesh contact (zpc_tpu_torch/sim/contact_implicit.py).
//
// Replaces no TPU kernel.  The JAX package (and the port before this
// kernel) evaluates every [B, K, max_tris] (bin, lane, slot) of the dense
// candidate table at once, as a chain of elementwise XLA ops whose every
// intermediate is a [B, K, max_tris] or [B, K, max_tris, 3] array in device
// memory.  At the source's 100,352-triangle terrain a bin window meets up
// to 648 triangles, and one such intermediate is 9.2 GB; at the 2,048-
// triangle terrain (max_tris 32) the chain already moved ~45 ms a step of
// device time.  Here nothing but the inputs and the results touches device
// memory:
//
//   - One block per bin, one thread per lane (K = 128).  A block whose bin
//     has no live lane writes zeros and exits, as does one whose bin has no
//     candidate (after reading its list).
//   - The bin's candidate list hits[b, :] (-1 where empty, in any order) is
//     read in chunks of 128 slots, one slot a thread.  The valid ids of a
//     chunk are packed to the front of shared memory (a warp ballot and the
//     four warps' counts), each with its triangle's corners a, b, c and the
//     edges ab = b - a, ac = c - a worked out once.
//   - Every thread then walks the chunk's triangles (all threads read the
//     same triangle: a shared-memory broadcast) and evaluates its lane
//     against each: the closest point by Ericson's region tests, exactly as
//     zpc_tpu_torch/geometry/distance.py:point_triangle_closest picks and
//     clamps them, d^2, and where 0 < d^2 < dhat^2 the barrier's first and
//     second derivatives of zpc_tpu_torch/geometry/contact.py.  The force
//     and the six distinct entries of the Gauss-Newton Hessian accumulate
//     in registers, in float32.
//   - The results go out through shared memory, so that a block writes its
//     128 x 3 forces and 128 x 9 Hessian entries as contiguous runs.
//   - The work it did (pairs, lanes, triangles, and the active pairs:
//     those with d^2 < dhat^2) is added to four int64 counters with one
//     atomic each per block that has a candidate.
//
// Bound: arithmetic, where the lists are long.  At the 100,352-triangle
// terrain a step has ~62 M (live lane, candidate) pairs, each needing the
// closest point and d^2 (72 float32 operations), and far fewer active
// ones, which alone need the barrier's derivatives and the sums (43 more;
// portbench/metrics/contact_narrow_roofline.py counts them from the plain
// reference's formulas): ~4.5 GFLOP, ~0.07 ms at 67 TFLOP/s, against 57
// MB of results (0.017 ms at 3.35 TB/s).  At the 2,048-triangle terrain
// (3.3 M pairs) the results' bytes bound it.
//
// Built with -fmad=false (zpc_tpu_torch/_kernels.py:KERNEL_FLAGS): no
// product is fused into a sum, so a pair's closest point, d^2 and barrier
// terms round as the plain version's (zpc_tpu_torch/ops/mesh_barrier.py)
// one operator at a time do, and a lane on an edge or a vertex, or against
// a degenerate triangle, reads the same there.  The sums over a lane's
// candidates run in slot order; the plain version's run in slot order on
// the CPU and in no set order on the card (index_add_), and the Hessian's
// (i, j) and (j, i) entries are one product here: the two agree to the
// rounding of the sums.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;             // K: lanes per bin, threads per block
constexpr int kWarps = kLanes / 32;

struct Tri {
  float4 a, b, c, ab, ac;               // .w unused
};

__device__ __forceinline__ float clip01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

__global__ void __launch_bounds__(kLanes)
mesh_barrier_kernel(const float* __restrict__ x, long long lane_stride,
                    const uint8_t* __restrict__ alive,
                    const int* __restrict__ hits, int max_tris,
                    const float* __restrict__ tri, int n_tri, float dhat2,
                    float kappa, float* __restrict__ fc,
                    float* __restrict__ hc,
                    unsigned long long* __restrict__ work) {
  __shared__ Tri s_tri[kLanes];
  __shared__ int s_count[kWarps];
  __shared__ float s_out[kLanes * 9];

  const int t = threadIdx.x;
  const int warp = t >> 5, l = t & 31;
  const long long bin = blockIdx.x;
  const long long lane = bin * kLanes + t;
  const bool live = alive[lane] != 0;
  const int n_live = __syncthreads_count(live);

  float f0 = 0.f, f1 = 0.f, f2 = 0.f;
  float h00 = 0.f, h01 = 0.f, h02 = 0.f, h11 = 0.f, h12 = 0.f, h22 = 0.f;
  int n_cand = 0, n_act = 0;
  if (n_live > 0) {
    const float* xp = x + lane * lane_stride;
    const float px = xp[0], py = xp[1], pz = xp[2];
    const int* row = hits + bin * max_tris;
    for (int s = 0; s < max_tris; s += kLanes) {
      const int id = s + t < max_tris ? row[s + t] : -1;
      const bool valid = id >= 0 && id < n_tri;
      const unsigned ballot = __ballot_sync(0xffffffffu, valid);
      if (l == 0) s_count[warp] = __popc(ballot);
      __syncthreads();
      int off = 0, n = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        off += w < warp ? s_count[w] : 0;
        n += s_count[w];
      }
      if (valid) {
        const float* q = tri + static_cast<long long>(id) * 9;
        Tri v;
        v.a = make_float4(q[0], q[1], q[2], 0.f);
        v.b = make_float4(q[3], q[4], q[5], 0.f);
        v.c = make_float4(q[6], q[7], q[8], 0.f);
        v.ab = make_float4(v.b.x - v.a.x, v.b.y - v.a.y, v.b.z - v.a.z, 0.f);
        v.ac = make_float4(v.c.x - v.a.x, v.c.y - v.a.y, v.c.z - v.a.z, 0.f);
        s_tri[off + __popc(ballot & ((1u << l) - 1u))] = v;
      }
      __syncthreads();
      n_cand += n;
      if (live) {
        for (int j = 0; j < n; ++j) {
          const float4 a = s_tri[j].a, b = s_tri[j].b, c = s_tri[j].c;
          const float4 ab = s_tri[j].ab, ac = s_tri[j].ac;
          const float apx = px - a.x, apy = py - a.y, apz = pz - a.z;
          const float d1 = ab.x * apx + ab.y * apy + ab.z * apz;
          const float d2 = ac.x * apx + ac.y * apy + ac.z * apz;
          const float bpx = px - b.x, bpy = py - b.y, bpz = pz - b.z;
          const float d3 = ab.x * bpx + ab.y * bpy + ab.z * bpz;
          const float d4 = ac.x * bpx + ac.y * bpy + ac.z * bpz;
          const float cpx = px - c.x, cpy = py - c.y, cpz = pz - c.z;
          const float d5 = ab.x * cpx + ab.y * cpy + ab.z * cpz;
          const float d6 = ac.x * cpx + ac.y * cpy + ac.z * cpz;
          const float va = d3 * d6 - d5 * d4;
          const float vb = d5 * d2 - d1 * d6;
          const float vc = d1 * d4 - d3 * d2;
          // barycentric weights of a, b, c; regions in the plain version's
          // priority (its later picks win): vertices a, b, c, then edges
          // ab, ac, bc, then the face
          float wa, wb, wc;
          if (d1 <= 0.f && d2 <= 0.f) {
            wa = 1.f; wb = 0.f; wc = 0.f;
          } else if (d3 >= 0.f && d4 <= d3) {
            wa = 0.f; wb = 1.f; wc = 0.f;
          } else if (d6 >= 0.f && d5 <= d6) {
            wa = 0.f; wb = 0.f; wc = 1.f;
          } else if (vc <= 0.f && d1 >= 0.f && d3 <= 0.f) {
            const float u = clip01(d1 / fmaxf(d1 - d3, 1e-30f));
            wa = 1.f - u; wb = u; wc = 0.f;
          } else if (vb <= 0.f && d2 >= 0.f && d6 <= 0.f) {
            const float u = clip01(d2 / fmaxf(d2 - d6, 1e-30f));
            wa = 1.f - u; wb = 0.f; wc = u;
          } else if (va <= 0.f && d4 - d3 >= 0.f && d5 - d6 >= 0.f) {
            const float u = clip01((d4 - d3) /
                                   fmaxf((d4 - d3) + (d5 - d6), 1e-30f));
            wa = 0.f; wb = 1.f - u; wc = u;
          } else {
            const float den = fmaxf(va + vb + vc, 1e-30f);
            const float v = vb / den, w = vc / den;
            wa = 1.f - v - w; wb = v; wc = w;
          }
          const float dx = px - (wa * a.x + wb * b.x + wc * c.x);
          const float dy = py - (wa * a.y + wb * b.y + wc * c.y);
          const float dz = pz - (wa * a.z + wb * b.z + wc * c.z);
          const float r2 = dx * dx + dy * dy + dz * dz;
          n_act += r2 < dhat2;
          if (r2 < dhat2 && r2 > 0.f) {
            const float sm = r2 - dhat2;
            const float lg = logf(r2 / dhat2);
            const float g = -kappa * (2.f * sm * lg + sm * sm / r2);
            const float h = fmaxf(
                -kappa * (2.f * lg + 2.f * sm / r2 +
                          sm * (r2 + dhat2) / (r2 * r2)), 0.f);
            const float g2 = 2.f * g;
            f0 += g2 * dx; f1 += g2 * dy; f2 += g2 * dz;
            const float h4 = 4.f * h;
            const float ux = h4 * dx, uy = h4 * dy, uz = h4 * dz;
            h00 += ux * dx; h01 += ux * dy; h02 += ux * dz;
            h11 += uy * dy; h12 += uy * dz; h22 += uz * dz;
          }
        }
      }
      __syncthreads();        // the next chunk overwrites s_tri, s_count
    }
  }
  // every thread of the block is here (n_live is the block's), and the
  // loop's last barrier has passed every read of s_count
  const unsigned act_warp = __reduce_add_sync(0xffffffffu, n_act);
  if (l == 0) s_count[warp] = static_cast<int>(act_warp);
  __syncthreads();
  if (t == 0 && n_cand > 0) {
    unsigned long long act = 0;
    for (int w = 0; w < kWarps; ++w) act += s_count[w];
    atomicAdd(work + 0, static_cast<unsigned long long>(n_live) * n_cand);
    atomicAdd(work + 1, static_cast<unsigned long long>(n_live));
    atomicAdd(work + 2, static_cast<unsigned long long>(n_cand));
    atomicAdd(work + 3, act);
  }

  float* mine = s_out + t * 9;
  mine[0] = h00; mine[1] = h01; mine[2] = h02;
  mine[3] = h01; mine[4] = h11; mine[5] = h12;
  mine[6] = h02; mine[7] = h12; mine[8] = h22;
  __syncthreads();
  float* hc_bin = hc + bin * kLanes * 9;
  for (int i = t; i < kLanes * 9; i += kLanes) hc_bin[i] = s_out[i];
  __syncthreads();
  s_out[t * 3 + 0] = -f0;
  s_out[t * 3 + 1] = -f1;
  s_out[t * 3 + 2] = -f2;
  __syncthreads();
  float* fc_bin = fc + bin * kLanes * 3;
  for (int i = t; i < kLanes * 3; i += kLanes) fc_bin[i] = s_out[i];
}

}  // namespace

extern "C" {

// x: float32 positions, lane i's three coordinates at x[i * lane_stride +
// 0..2]; alive: bool [bins, 128]; hits: int32 [bins, max_tris] (-1, or an
// id >= n_tri, where empty); tri: float32 [n_tri, 3, 3]; fc: float32
// [bins, 128, 3] and hc: float32 [bins, 128, 3, 3], written whole; work:
// int64 [4], added to (pairs, lanes, triangles, active pairs).  Launches one kernel on
// the caller's current device, which must hold every pointer and the
// stream.  Returns a cudaError_t: 0 when the launch was accepted.
int zpc_mesh_barrier(const void* x, long long lane_stride, const void* alive,
                     const void* hits, int max_tris, const void* tri,
                     int n_tri, int bins, float dhat2, float kappa, void* fc,
                     void* hc, void* work, void* stream) {
  if (bins < 1 || max_tris < 0 || n_tri < 0 || lane_stride < 3)
    return cudaErrorInvalidValue;
  mesh_barrier_kernel<<<bins, kLanes, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), lane_stride,
      static_cast<const uint8_t*>(alive), static_cast<const int*>(hits),
      max_tris, static_cast<const float*>(tri), n_tri, dhat2, kappa,
      static_cast<float*>(fc), static_cast<float*>(hc),
      static_cast<unsigned long long*>(work));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
