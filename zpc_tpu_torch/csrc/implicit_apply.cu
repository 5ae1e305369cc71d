// One application of the implicit MPM system's operator for a
// FixedCorotated solid in 3-D, for Hopper (sm_90a): the CG loop's
//
//   A u = gm u + P2G(kscale dP(dt dC F) F^T + dt^2 Hc s0)
//
// of zpc_tpu_torch/sim/implicit_binned2.py, with s0 = sum_i w_i u_i and
// dC = D^-1 sum_i w_i u_i (x_i - x_p)^T gathered from the node field u over
// each lane's 27 stencil nodes, dP the FixedCorotated stress differential,
// kscale = dt D^-1 vol, and Hc the barrier's Hessian where there is mesh
// contact.
//
// Replaces no TPU kernel: the JAX package's operator
// (zpc_tpu/sim/implicit_binned2.py) is a chain of XLA ops, as the port's
// was: a gather of [L, 27, 3], a batched product, forward-mode autodiff of
// the stress through the SVD's differential (dozens of elementwise
// kernels over [L, 3, 3]), a [L, 27, 3] payload and a global index_add_ of
// L x 27 rows, each intermediate in device memory.  At 9,216 bins x 128
// lanes that took ~32.5 ms an application on an H100, four fifths of an
// implicit step.  Here nothing but the inputs and the result touches
// device memory:
//
//   - One block of 128 threads a bin, one thread a lane.  A bin with no
//     live lane exits at once.
//   - The block loads its bin's 8-block window of u (2 x 2 x 2 blocks of
//     4^3 nodes: the table slots nbr8[bin_block[bin], :], as _make_ctx
//     maps them; an absent block reads as zero) into shared memory, 512
//     nodes x 3, in the layout of the node field, and zeroes a second
//     such window for the sums.
//   - Each thread rebuilds its lane's 27 quadratic B-spline weights and
//     x_i - x_p from its position and its bin's window origin, with
//     sim/mpm_binned2.py:_make_ctx's expressions (a node outside the window
//     is dropped), and gathers s0 and dC from the window.
//   - dP in closed form around the step's SVD of F (U, s, V, taken once a
//     step): with P = U^T dF V, ds_i = P_ii, the rotation's differential
//     dR = U skew((P_ij - P_ji) b_ij) V^T with b_ij the clamped 1/(s_i +
//     s_j) of math/svd.py:_pair_inverses, and dP = 2 mu (dF - dR) + lam
//     (dJ cof F + (J - 1) dcof(F)[dF]).  This is what forward-mode autodiff
//     of FixedCorotated._piola computes (R = U V^T takes only the x - y part
//     of the SVD's differential, so the clamped 1/(s_j - s_i) drops out).
//   - A = kscale dP F^T and Q = dt^2 Hc s0; w_i (Q + A (x_i - x_p)) goes
//     into the shared window with shared-memory atomics; then the block
//     adds the window's nonzero sums into the output with global atomics
//     (neighbouring bins share blocks).  The output arrives holding gm u.
//
// Bound: bytes.  One application reads, for each live lane, its position
// (12 B), F (36) and volume (4) from the state's columns, the step's SVD
// factors U, s and V (84: this design's choice, the SVD taken once a step
// rather than once an application), the Lame fields where they are per
// lane (4 each) and Hc where there is contact (36): 136 B a live lane, 172
// with Hc; every lane's alive flag (1 B); each bin's bin_block, nbr8 row
// and window origin (12 ints, 48 B); and, a node, u (12 B) and gm (4) read
// and the output (12) written once.  At the cells' shape (1,000,000 live
// lanes of 1,179,648 in 9,216 bins, 8,192 blocks of 64 nodes) that is
// 152.3 MB, 0.0455 ms at 3.35 TB/s (188.3 MB, 0.0562 ms with Hc).  The
// arithmetic, 2,070 float32 operations a live lane (a multiply-add counted
// as two: the two stencils 240, the gather 702, dF 81, P and dR 180, the
// pair inverses 33, cof F and its differential 90, J, dJ and dP 67, A 56,
// the scatter 621; Hc s0 18 more), is 2.07 GFLOP, ~0.031 ms at 67 TFLOP/s.
// chip_smoke.py:_apply_bound computes this count at the path's shape.
//
// Precision: float32 throughout, products fused into sums where the
// compiler chooses.  The plain version (zpc_tpu_torch/ops/implicit_apply.py)
// reads the same weights from the step's context and sums in another order
// (index_add_), so the two agree to float32 rounding, not bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;             // K: lanes per bin, threads per block
constexpr int kSide = 8;                // window side in nodes
constexpr int kQuads = 8;               // blocks of the window
constexpr int kBlockFloats = 64 * 3;    // one block's 4^3 nodes x 3
constexpr int kWinFloats = kQuads * kBlockFloats;

// Quadratic B-spline at signed node distance t (cells), as
// sim/mpm_binned2.py:_window_weight writes it.
__device__ __forceinline__ float window_weight(float t) {
  const float at = fabsf(t);
  const float c1 = fmaxf(1.5f - at, 0.f);
  const float c2 = fmaxf(0.5f - at, 0.f);
  return 0.5f * c1 * c1 - 1.5f * c2 * c2;
}

// A lane's stencil, per axis a and node k = 0, 1, 2 (at cell base + k):
// the weight factor (0 for a node outside the window, which drops every
// node it spans), x_i - x_p, and the node's float offset in the window
// along that axis.  A node's offset is the sum over the axes: its
// quadrant (own block or a +1 neighbour per axis) times 64 plus its cell
// in that block, last axis fastest, times 3.
struct Stencil {
  float w[3][3];
  float d[3][3];
  int o[3][3];
};

__device__ __forceinline__ void make_stencil(const float* __restrict__ xp,
                                             const int* __restrict__ bo,
                                             const float* __restrict__ org,
                                             long long org_stride, float dx,
                                             Stencil& st) {
  constexpr int quad_stride[3] = {4 * kBlockFloats, 2 * kBlockFloats,
                                  kBlockFloats};
  constexpr int cell_stride[3] = {16 * 3, 4 * 3, 3};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float xi = (xp[a] - org[a * org_stride]) / dx;
    const int base = static_cast<int>(floorf(xi - 0.5f));
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int p = base - bo[a] + k;
      const float tt = xi - static_cast<float>(base + k);
      const bool in = p >= 0 && p < kSide;
      st.w[a][k] = in ? window_weight(tt) : 0.f;
      st.d[a][k] = -tt * dx;
      st.o[a][k] = in ? (p >> 2) * quad_stride[a] + (p & 3) * cell_stride[a]
                      : 0;
    }
  }
}

__device__ __forceinline__ void cross(const float a0, const float a1,
                                      const float a2, const float b0,
                                      const float b1, const float b2,
                                      float* c) {
  c[0] = a1 * b2 - a2 * b1;
  c[1] = a2 * b0 - a0 * b2;
  c[2] = a0 * b1 - a1 * b0;
}

__global__ void __launch_bounds__(kLanes)
implicit_apply_kernel(const float* __restrict__ u, float* __restrict__ out,
                      const float* __restrict__ x, long long x_stride,
                      const float* __restrict__ fm, long long f_stride,
                      const float* __restrict__ vol, long long vol_stride,
                      const uint8_t* __restrict__ alive,
                      const float* __restrict__ um,
                      const float* __restrict__ sv,
                      const float* __restrict__ vm,
                      const float* __restrict__ mu, int mu_stride,
                      const float* __restrict__ lam, int lam_stride,
                      const float* __restrict__ hc,
                      const int* __restrict__ bin_block,
                      const int* __restrict__ nbr8, int nb,
                      const int* __restrict__ borigin,
                      const float* __restrict__ dinv_p,
                      const float* __restrict__ dx_p,
                      const float* __restrict__ org, long long org_stride,
                      float dt, float dt2) {
  __shared__ float s_u[kWinFloats];
  __shared__ float s_acc[kWinFloats];
  __shared__ int s_slot[kQuads];

  const int t = threadIdx.x;
  const long long bin = blockIdx.x;
  const long long lane = bin * kLanes + t;
  const bool live = alive[lane] != 0;
  if (__syncthreads_count(live) == 0) return;

  if (t < kQuads) {
    const int bb = bin_block[bin];
    s_slot[t] = bb >= 0 ? nbr8[static_cast<long long>(min(bb, nb - 1)) *
                                   kQuads + t]
                        : -1;
  }
  __syncthreads();
  for (int i = t; i < kWinFloats; i += kLanes) {
    const int q = i / kBlockFloats;
    const int slot = s_slot[q];
    s_u[i] = slot >= 0
                 ? u[static_cast<long long>(slot) * kBlockFloats +
                     (i - q * kBlockFloats)]
                 : 0.f;
    s_acc[i] = 0.f;
  }
  __syncthreads();

  if (live) {
    const float dinv = *dinv_p, dx = *dx_p;
    const float* xp = x + lane * x_stride;
    const int* bo = borigin + bin * kLanes * 3;

    // gather: s0 = sum w u, g = sum w u (x_i - x_p)^T
    float s0[3] = {0.f, 0.f, 0.f};
    float g[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    {
      Stencil st;
      make_stencil(xp, bo, org, org_stride, dx, st);
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const float w = st.w[0][i] * st.w[1][j] * st.w[2][k];
            const float* un = s_u + st.o[0][i] + st.o[1][j] + st.o[2][k];
            const float d[3] = {st.d[0][i], st.d[1][j], st.d[2][k]};
#pragma unroll
            for (int r = 0; r < 3; ++r) {
              const float wv = w * un[r];
              s0[r] += wv;
#pragma unroll
              for (int c = 0; c < 3; ++c) g[r * 3 + c] += wv * d[c];
            }
          }
    }

    // dF = dt (D^-1 g) F
    const float* fl = fm + lane * f_stride;
    float F[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) F[e] = fl[e];
    float dF[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        dF[r * 3 + c] = dt * (dinv * g[r * 3] * F[c] +
                              dinv * g[r * 3 + 1] * F[3 + c] +
                              dinv * g[r * 3 + 2] * F[6 + c]);

    // P = U^T dF V
    const float* U = um + lane * 9;
    const float* V = vm + lane * 9;
    const float s[3] = {sv[lane * 3], sv[lane * 3 + 1], sv[lane * 3 + 2]};
    float M[9], P[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        M[r * 3 + c] = U[r] * dF[c] + U[3 + r] * dF[3 + c] +
                       U[6 + r] * dF[6 + c];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        P[r * 3 + c] = M[r * 3] * V[c] + M[r * 3 + 1] * V[3 + c] +
                       M[r * 3 + 2] * V[6 + c];

    // dR = U S V^T, S skew with S_ij = (P_ij - P_ji) b_ij (i < j)
    float S[9];
    S[0] = S[4] = S[8] = 0.f;
    {
      const int pi[3] = {0, 0, 1}, pj[3] = {1, 2, 2};
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int i = pi[k], j = pj[k];
        const float si = s[i], sj = s[j];
        const float tsum = sj + si;
        const float m2 = si * si + sj * sj + 1e-12f;
        const float b = tsum / (tsum * tsum + 1e-8f * m2);
        const float xmy = (P[i * 3 + j] - P[j * 3 + i]) * b;
        S[i * 3 + j] = xmy;
        S[j * 3 + i] = -xmy;
      }
    }
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        M[r * 3 + c] = U[r * 3] * S[c] + U[r * 3 + 1] * S[3 + c] +
                       U[r * 3 + 2] * S[6 + c];
    float dR[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        dR[r * 3 + c] = M[r * 3] * V[c * 3] + M[r * 3 + 1] * V[c * 3 + 1] +
                        M[r * 3 + 2] * V[c * 3 + 2];

    // J and dJ from the singular values; cof F and its differential from
    // F's columns, as math/vecmat.py:cof3 takes them
    const float J = s[0] * s[1] * s[2];
    const float dJ = (P[0] * s[1] + s[0] * P[4]) * s[2] + s[0] * s[1] * P[8];
    float cof[9], dcof[9];
    {
      float c[3], e[3];
#pragma unroll
      for (int col = 0; col < 3; ++col) {
        const int a = (col + 1) % 3, b = (col + 2) % 3;
        cross(F[a], F[3 + a], F[6 + a], F[b], F[3 + b], F[6 + b], c);
        cof[col] = c[0]; cof[3 + col] = c[1]; cof[6 + col] = c[2];
        cross(dF[a], dF[3 + a], dF[6 + a], F[b], F[3 + b], F[6 + b], c);
        cross(F[a], F[3 + a], F[6 + a], dF[b], dF[3 + b], dF[6 + b], e);
        dcof[col] = c[0] + e[0];
        dcof[3 + col] = c[1] + e[1];
        dcof[6 + col] = c[2] + e[2];
      }
    }
    const float mu2 = 2.f * mu[lane * mu_stride];
    const float l = lam[lane * lam_stride];
    const float ldJ = l * dJ, lJ1 = l * (J - 1.f);
    float dP[9];
#pragma unroll
    for (int e = 0; e < 9; ++e)
      dP[e] = mu2 * (dF[e] - dR[e]) + (ldJ * cof[e] + lJ1 * dcof[e]);

    // A = kscale dP F^T, Q = dt^2 Hc s0
    const float kscale = dt * dinv * vol[lane * vol_stride];
    float A[9];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c)
        A[r * 3 + c] = kscale * (dP[r * 3] * F[c * 3] +
                                 dP[r * 3 + 1] * F[c * 3 + 1] +
                                 dP[r * 3 + 2] * F[c * 3 + 2]);
    float Q[3] = {0.f, 0.f, 0.f};
    if (hc != nullptr) {
      const float* H = hc + lane * 9;
#pragma unroll
      for (int r = 0; r < 3; ++r)
        Q[r] = dt2 * (H[r * 3] * s0[0] + H[r * 3 + 1] * s0[1] +
                      H[r * 3 + 2] * s0[2]);
    }

    // scatter w (Q + A (x_i - x_p)) into the window, the stencil made
    // again (it is cheaper than keeping it live through dP)
    Stencil st;
    make_stencil(xp, bo, org, org_stride, dx, st);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float w = st.w[0][i] * st.w[1][j] * st.w[2][k];
          if (w == 0.f) continue;
          float* acc = s_acc + st.o[0][i] + st.o[1][j] + st.o[2][k];
          const float d0 = st.d[0][i], d1 = st.d[1][j], d2 = st.d[2][k];
#pragma unroll
          for (int r = 0; r < 3; ++r)
            atomicAdd(acc + r, w * (Q[r] + (d0 * A[r * 3] + d1 * A[r * 3 + 1] +
                                            d2 * A[r * 3 + 2])));
        }
  }
  __syncthreads();

  // the window's sums into the output; absent blocks drop theirs
  for (int i = t; i < kWinFloats; i += kLanes) {
    const int q = i / kBlockFloats;
    const int slot = s_slot[q];
    const float v = s_acc[i];
    if (slot >= 0 && v != 0.f)
      atomicAdd(out + static_cast<long long>(slot) * kBlockFloats +
                    (i - q * kBlockFloats),
                v);
  }
}

}  // namespace

extern "C" {

// u: float32 [blocks, 64, 3]; out: float32 [blocks, 64, 3], holding gm u on
// entry, added to.  Lane i's position at x[i * x_stride + 0..2], its F
// (row-major) at f[i * f_stride + 0..8] and its volume at vol[i *
// vol_stride] (views of the state's columns pass as they are); alive: bool
// [bins * 128]; U, V: float32 [bins * 128, 3, 3] and s: float32 [bins *
// 128, 3], the SVD of F; mu, lam: float32 at lane stride 0 (one value) or
// 1; hc: float32 [bins * 128, 3, 3] or null; bin_block: int32 [bins],
// each bin's table slot (-1: none); nbr8: int32 [nb, 8], each slot's window
// blocks (-1: absent); borigin: int32 [bins * 128, 3], each lane's window
// origin in cells; dinv, dx: float32 D^-1 and the cell size, and origin
// the grid's origin at origin[a * origin_stride], on the device.  nb: the
// blocks of u, the bound of a table slot.  Launches one kernel on the
// caller's current device, which must hold every pointer and the stream.
// Returns a cudaError_t: 0 when the launch was accepted.
int zpc_implicit_apply(const void* u, void* out, int bins, const void* x,
                       long long x_stride, const void* f, long long f_stride,
                       const void* vol, long long vol_stride,
                       const void* alive, const void* um, const void* sv,
                       const void* vm, const void* mu, int mu_stride,
                       const void* lam, int lam_stride, const void* hc,
                       const void* bin_block, const void* nbr8, int nb,
                       const void* borigin, const void* dinv, const void* dx,
                       const void* origin, long long origin_stride, float dt,
                       float dt2, void* stream) {
  if (bins < 1 || nb < 1 || x_stride < 3 || f_stride < 9 ||
      vol_stride < 1 || mu_stride < 0 || lam_stride < 0)
    return cudaErrorInvalidValue;
  implicit_apply_kernel<<<bins, kLanes, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<float*>(out),
      static_cast<const float*>(x), x_stride, static_cast<const float*>(f),
      f_stride, static_cast<const float*>(vol), vol_stride,
      static_cast<const uint8_t*>(alive), static_cast<const float*>(um),
      static_cast<const float*>(sv), static_cast<const float*>(vm),
      static_cast<const float*>(mu), mu_stride,
      static_cast<const float*>(lam), lam_stride,
      static_cast<const float*>(hc), static_cast<const int*>(bin_block),
      static_cast<const int*>(nbr8), nb, static_cast<const int*>(borigin),
      static_cast<const float*>(dinv), static_cast<const float*>(dx),
      static_cast<const float*>(origin), origin_stride, dt, dt2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
