// zpc_tpu_torch native host runtime: a C ABI loaded with ctypes by
// zpc_tpu_torch/utils/native.py (the port's own copy of the JAX package's
// host_ops.cpp, function for function).
//
// The host-side hot loops of the reference's native layer (py_interop's
// C-ABI surface and io/ParticleIO.hpp's writers): big-endian record
// packing for bgeo, morton keys, an LSD radix sort of int32 pairs and a
// stack arena.  No device code: the port's device kernels live in csrc/.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 host_ops.cpp -o libzpc_host.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---- byte order (bgeo codec hot loop) --------------------------------------

// interleave columns into big-endian row-major records:
//   dst[n][stride] <- for each part p: cols[p] (width[p] floats, LE) -> BE
void zpc_pack_be_records(const float* const* cols, const int* widths,
                         int nparts, int64_t n, float* dst) {
  int stride = 0;
  for (int p = 0; p < nparts; ++p) stride += widths[p];
  for (int64_t i = 0; i < n; ++i) {
    float* out = dst + i * stride;
    for (int p = 0; p < nparts; ++p) {
      const float* src = cols[p] + i * widths[p];
      for (int w = 0; w < widths[p]; ++w) {
        uint32_t v;
        std::memcpy(&v, &src[w], 4);
        v = __builtin_bswap32(v);
        std::memcpy(out, &v, 4);
        ++out;
      }
    }
  }
}

// de-interleave big-endian records into separate LE columns
void zpc_unpack_be_records(const float* records, const int* widths,
                           int nparts, int64_t n, float* const* cols) {
  int stride = 0;
  for (int p = 0; p < nparts; ++p) stride += widths[p];
  for (int64_t i = 0; i < n; ++i) {
    const float* in = records + i * stride;
    for (int p = 0; p < nparts; ++p) {
      float* dst = cols[p] + i * widths[p];
      for (int w = 0; w < widths[p]; ++w) {
        uint32_t v;
        std::memcpy(&v, in, 4);
        v = __builtin_bswap32(v);
        std::memcpy(&dst[w], &v, 4);
        ++in;
      }
    }
  }
}

// ---- morton keys (math/bit/Bits.h analog, host-side preprocessing) ---------

static inline uint32_t expand3(uint32_t v) {
  v &= 0x3ff;
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

void zpc_morton3d(const int32_t* coords, int64_t n, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t x = expand3((uint32_t)coords[3 * i + 0]);
    uint32_t y = expand3((uint32_t)coords[3 * i + 1]);
    uint32_t z = expand3((uint32_t)coords[3 * i + 2]);
    out[i] = (int32_t)((x << 2) | (y << 1) | z);
  }
}

// quantize positions to 10-bit lattice and emit morton keys in one pass
void zpc_morton_from_points(const float* pts, int64_t n, const float* lo,
                            const float* inv_extent, int32_t* out) {
  for (int64_t i = 0; i < n; ++i) {
    uint32_t q[3];
    for (int d = 0; d < 3; ++d) {
      float t = (pts[3 * i + d] - lo[d]) * inv_extent[d] * 1024.0f;
      int32_t c = (int32_t)t;
      c = c < 0 ? 0 : (c > 1023 ? 1023 : c);
      q[d] = (uint32_t)c;
    }
    out[i] = (int32_t)((expand3(q[0]) << 2) | (expand3(q[1]) << 1) |
                       expand3(q[2]));
  }
}

// ---- host radix sort (execution/ExecutionPolicy.hpp radix_sort analog) -----

// LSD radix sort of (key, value) pairs over the bit window [sbit, ebit),
// 8 bits per pass — the host-backend primitive the reference stamps per
// backend/dtype (py_interop ExecutionPolicy exports).
void zpc_radix_sort_pairs_i32(int32_t* keys, int32_t* vals, int64_t n,
                              int sbit, int ebit) {
  std::vector<int32_t> kbuf(n), vbuf(n);
  int32_t* k0 = keys;
  int32_t* v0 = vals;
  int32_t* k1 = kbuf.data();
  int32_t* v1 = vbuf.data();
  for (int shift = sbit; shift < ebit; shift += 8) {
    int bits = std::min(8, ebit - shift);
    int buckets = 1 << bits;
    int mask = buckets - 1;
    std::vector<int64_t> count(buckets + 1, 0);
    for (int64_t i = 0; i < n; ++i)
      ++count[(((uint32_t)k0[i]) >> shift) & mask];
    int64_t sum = 0;
    for (int b = 0; b < buckets; ++b) {
      int64_t c = count[b];
      count[b] = sum;
      sum += c;
    }
    for (int64_t i = 0; i < n; ++i) {
      int b = (((uint32_t)k0[i]) >> shift) & mask;
      int64_t pos = count[b]++;
      k1[pos] = k0[i];
      v1[pos] = v0[i];
    }
    std::swap(k0, k1);
    std::swap(v0, v1);
  }
  if (k0 != keys) {
    std::memcpy(keys, k0, n * sizeof(int32_t));
    std::memcpy(vals, v0, n * sizeof(int32_t));
  }
}

// ---- simple arena allocator (memory/Allocator.h stack arena analog) --------

struct ZpcArena {
  std::vector<char> buf;
  size_t top;
};

void* zpc_arena_create(int64_t bytes) {
  auto* a = new ZpcArena();
  a->buf.resize((size_t)bytes);
  a->top = 0;
  return a;
}

void* zpc_arena_alloc(void* arena, int64_t bytes, int64_t align) {
  auto* a = (ZpcArena*)arena;
  size_t p = (a->top + (size_t)align - 1) & ~((size_t)align - 1);
  if (p + (size_t)bytes > a->buf.size()) return nullptr;
  a->top = p + (size_t)bytes;
  return a->buf.data() + p;
}

void zpc_arena_reset(void* arena) { ((ZpcArena*)arena)->top = 0; }

void zpc_arena_destroy(void* arena) { delete (ZpcArena*)arena; }

int zpc_abi_version() { return 1; }

}  // extern "C"
