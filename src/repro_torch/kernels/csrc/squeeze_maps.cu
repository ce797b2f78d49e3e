// Squeeze space-map kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels:
//   * nu_map_pallas     (src/repro/kernels/nu_map.py, _nu_kernel)  -> sq_nu_map
//   * lambda_map_pallas (src/repro/kernels/lambda_map.py,
//                        _lambda_kernel)                           -> sq_lambda_map
//
// nu(w): expanded (ex, ey) -> compact (cx, cy) and fractal membership.
// Per level mu the base-s digit pair of the clipped coordinate selects the
// replica code H_nu[ty][tx] (-1 for a hole: code 0, not a member), and
// cx / cy = sum code * k^floor((mu-1)/2), odd levels to x, even to y.
// lambda(w): compact (cx, cy) -> expanded (ex, ey). Per level beta =
// floor(w / k^floor((mu-1)/2)) mod k with w = cx (odd mu) or cy (even mu),
// and ex / ey = sum tau(beta) * s^(mu-1). lambda does not clip: negative and
// past-the-edge compact coordinates take floor division and a non-negative
// modulus, as the reference does, where C's / and % truncate toward zero.
//
// The TPU kernels build a (TILE, r) code matrix on the vector unit and sum
// codes x weights in one float32 product on the MXU, exact only below 2^24.
// Here both sum in integers, exact for every level the wrappers accept (s^r
// < 2^31, compact sides below 2^31). Each coordinate reads 8 bytes and
// writes 8 (lambda) or 9 (nu), so bytes are their bound.
//
// lambda (lambda_kernel): the same shape as nu's. A thread per coordinate
// running the level loop (sixteen floor divisions by k, two lookups and two
// multiply-adds a level at r = 16) was bound by issue at 2.5 times its
// bytes. So one lookup takes L levels at once (kLambdaL2 = 8 for s = 2,
// kLambdaL3 = 4 for s = 3; lambda_map.lambda_plan, which takes fewer where
// a table would not fit, for any other fractal):
//   * a group of L levels (L even, so it starts at an odd level) reads L/2
//     base-k digits of cx and L/2 of cy, the remainders of one floor
//     division of each by D = k^(L/2); its table, built on the host
//     (lambda_map.lambda_group_table), indexed by rx + D ry, holds in one
//     int32 the group's partial ex and ey (bits 0-15 and 16-31, each below
//     s^L <= 2^16), which add times s^(gL). Floor division keeps lambda's
//     no-clip semantics: negative and past-the-edge coordinates take one
//     floor divmod by D a group, which equals L/2 of them by k;
//   * the top group, over the last R levels, reads a table of its own
//     where R < L, indexed the same way, whose entries take only the
//     digits of those R levels (padding the levels past r with digit 0
//     would be wrong: tau(0) is not (0, 0) for vicsek, whose replica 0
//     sits at (1, 0));
//   * s, k, L and the group count G = ceil(r / L) are template constants
//     for the registry's (s, k) (the division by D a multiply-high, the
//     weights s^(gL) constants), and a runtime instance takes any other;
//   * four coordinates a thread with 16-byte loads and stores, a scalar
//     path for a tail and for pointers that are not 16-byte aligned, in a
//     persistent grid, as nu's.
// At r = 16 and s = 2 that is two lookups for sixteen levels.
//
// nu (nu_kernel): what costs is taking the coordinates apart into digits,
// not the sum: a thread per coordinate running the level loop (a division
// and modulus pair of each coordinate, a lookup, a select and two 64-bit
// multiply-adds a level) took some 300 instructions a coordinate at r =
// 16 and was bound by issue at three times its bytes. So one lookup takes
// L levels at once (L = kLevels2 = 4 for s = 2, kLevels3 = 2 for s = 3 and
// any other s):
//   * a table over L consecutive levels, built on the host from H_nu
//     (nu_map.nu_group_table) and indexed by (ux mod s^L) + s^L (uy mod
//     s^L), holds in one int32 the group's partial cx and cy (bits 0-14 and
//     16-30) and a hole bit (15) set where any of its levels is a hole; L
//     is even, so every group starts at an odd level and group g adds both
//     partials times k^(gL/2);
//   * the top group, over the last r - (G - 1) L levels, reads what is left
//     of the coordinates in a table of its own over those levels (padding
//     them with digit 0 would be wrong: (0, 0) is a hole of some fractals);
//     r = 0 has no group, and valid is then "in bounds";
//   * the group count G = ceil(r / L) is a template constant for s = 2 and
//     3 (the loop unrolled, the weights k^(gL/2) hoisted out of the
//     coordinate loop; the weight past the top group is never computed),
//     and the sums stay in int32;
//   * each thread takes four coordinates a turn: 16-byte loads of ex and
//     ey, 16-byte stores of cx and cy and one 4-byte store of the four
//     valid bytes (a scalar path in the same kernel for a tail, and for
//     pointers that are not 16-byte aligned), in a persistent grid of as
//     many CTAs as are resident.
// At r = 16 and s = 2 that is four lookups for sixteen levels. The paper's
// tensor-core form (an MMA of the code matrix and the weights) is not
// used: summing r / L small integers costs less than staging a code matrix
// into mma fragments, and what it would save is the part that costs
// least.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLevels2 = 4;   // levels a nu lookup covers for s = 2
constexpr int kLevels3 = 2;   // and for s = 3 and any other s
constexpr int kLambdaL2 = 8;  // levels a lambda lookup covers for s = 2
constexpr int kLambdaL3 = 4;  // and for s = 3
constexpr int kHole = 1 << 15;            // a nu table entry's hole bit
constexpr size_t kMaxSmem = 232448;       // shared bytes one CTA can use

__host__ __device__ constexpr long long ipow(long long b, int e) {
  return e > 0 ? b * ipow(b, e - 1) : 1;
}

// Groups of L levels the largest r of base s needs (s^r < 2^31).
constexpr int max_groups(int s, int L) {
  int r = 0;
  while (ipow(s, r + 1) < (1LL << 31)) ++r;
  return (r + L - 1) / L;
}

// What a nu launch needs besides the pointers (sq_nu_map fills it in).
struct NuGeom {
  int n;           // s^r, the grid's side
  int kl;          // k^(L/2): one group's weight over the one below
  int groups;      // G = ceil(r / L) (read where it is not a template)
  int sl;          // s^L (read where s is not a template)
  int top_off;     // where the top group's table starts
  int top_stride;  // s^R: the top table's row (R levels in the top group)
  int entries;     // entries of the tables
  int vec;         // 1: the coordinates are read and written four at once
};

// nu and membership of one coordinate (x, y) from the tables in shared
// memory: cx, cy into ox, oy; returns 1 for a member.
template <int S, int L, int NG>
__device__ __forceinline__ unsigned nu_one(int x, int y, const NuGeom& g,
                                           const int* tab, int& ox,
                                           int& oy) {
  const bool in = (unsigned)x < (unsigned)g.n && (unsigned)y < (unsigned)g.n;
  unsigned ux = (unsigned)min(max(x, 0), g.n - 1);
  unsigned uy = (unsigned)min(max(y, 0), g.n - 1);
  const unsigned sl = S > 0 ? (unsigned)ipow(S, L) : (unsigned)g.sl;
  const int groups = NG >= 0 ? NG : g.groups;
  int ax = 0, ay = 0, w = 1, bad = 0;
#pragma unroll
  for (int i = 0; i < groups; ++i) {
    unsigned at;
    if (i < groups - 1) {
      at = ux % sl + sl * (uy % sl);
      ux /= sl;
      uy /= sl;
    } else {   // the top group: what is left of the coordinates
      at = (unsigned)g.top_off + ux + (unsigned)g.top_stride * uy;
    }
    const int e = tab[at];
    bad |= e;
    ax += (e & (kHole - 1)) * w;
    ay += (e >> 16) * w;
    if (i < groups - 1) w *= g.kl;
  }
  ox = ax;
  oy = ay;
  return in && !(bad & kHole) ? 1u : 0u;
}

// S > 0: s is the constant S and NG the group count; S == 0: s, L and the
// groups at run time (NG = -1).
template <int S, int L, int NG>
__global__ void __launch_bounds__(kThreads)
nu_kernel(const int* __restrict__ ex, const int* __restrict__ ey,
          int* __restrict__ cx, int* __restrict__ cy,
          uint8_t* __restrict__ valid, long long count, NuGeom g,
          const int* __restrict__ table) {
  extern __shared__ int tab[];
  for (int t = threadIdx.x; t < g.entries; t += blockDim.x) tab[t] = table[t];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long quads = g.vec ? count / 4 : 0;
  for (long long i = first; i < quads; i += stride) {
    const int4 x = reinterpret_cast<const int4*>(ex)[i];
    const int4 y = reinterpret_cast<const int4*>(ey)[i];
    int4 ox, oy;
    unsigned v = nu_one<S, L, NG>(x.x, y.x, g, tab, ox.x, oy.x);
    v |= nu_one<S, L, NG>(x.y, y.y, g, tab, ox.y, oy.y) << 8;
    v |= nu_one<S, L, NG>(x.z, y.z, g, tab, ox.z, oy.z) << 16;
    v |= nu_one<S, L, NG>(x.w, y.w, g, tab, ox.w, oy.w) << 24;
    reinterpret_cast<int4*>(cx)[i] = ox;
    reinterpret_cast<int4*>(cy)[i] = oy;
    reinterpret_cast<unsigned*>(valid)[i] = v;
  }
  for (long long i = 4 * quads + first; i < count; i += stride) {
    int ox, oy;
    const unsigned v = nu_one<S, L, NG>(ex[i], ey[i], g, tab, ox, oy);
    cx[i] = ox;
    cy[i] = oy;
    valid[i] = (uint8_t)v;
  }
}

// Floor division of q by d > 0: q becomes floor(q / d), the result is the
// non-negative remainder. The division is unsigned (a multiply-high for a
// constant d) on q or, for q < 0, on -q - 1 = ~q, whose quotient and
// remainder flip back: floor(q / d) = ~(~q / d), q mod d = d - 1 - ~q % d.
__device__ __forceinline__ int floor_divmod(int& q, int d) {
  const int neg = q >> 31;
  const unsigned u = (unsigned)(q ^ neg);
  const unsigned uq = u / (unsigned)d;
  const int rem = ((int)(u - uq * (unsigned)d) ^ neg) + (neg & d);
  q = (int)uq ^ neg;
  return rem;
}

// What a lambda launch needs besides the pointers (sq_lambda_map fills it).
struct LambdaGeom {
  int d;         // D = k^(L/2): one group's divisor of cx and cy
  int sl;        // s^L: one group's weight over the one below
  int groups;    // G = ceil(r / L) (read where it is not a template)
  int top_off;   // where the top group's table starts (0: the group's)
  int entries;   // entries of the tables
  int vec;       // 1: the coordinates are read and written four at once
};

// lambda of one compact coordinate (x, y) from the tables in shared
// memory: ex, ey into ox, oy.
template <int S, int K, int L, int NG>
__device__ __forceinline__ void lambda_one(int x, int y, const LambdaGeom& g,
                                           const int* tab, int& ox,
                                           int& oy) {
  const int d = S > 0 ? (int)ipow(K, L / 2) : g.d;
  const int sl = S > 0 ? (int)ipow(S, L) : g.sl;
  const int groups = NG >= 0 ? NG : g.groups;
  int ax = 0, ay = 0, w = 1;
#pragma unroll
  for (int i = 0; i < groups; ++i) {
    const int rx = floor_divmod(x, d), ry = floor_divmod(y, d);
    const int e = tab[(i < groups - 1 ? 0 : g.top_off) + rx + d * ry];
    ax += (e & 0xffff) * w;
    ay += (int)((unsigned)e >> 16) * w;
    if (i < groups - 1) w *= sl;
  }
  ox = ax;
  oy = ay;
}

// S > 0: s, k, L and the group count NG are constants; S == 0: all at run
// time (NG = -1).
template <int S, int K, int L, int NG>
__global__ void __launch_bounds__(kThreads)
lambda_kernel(const int* __restrict__ cx, const int* __restrict__ cy,
              int* __restrict__ ex, int* __restrict__ ey, long long count,
              LambdaGeom g, const int* __restrict__ table) {
  extern __shared__ int tab[];
  for (int t = threadIdx.x; t < g.entries; t += blockDim.x) tab[t] = table[t];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long first = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long quads = g.vec ? count / 4 : 0;
  for (long long i = first; i < quads; i += stride) {
    const int4 x = reinterpret_cast<const int4*>(cx)[i];
    const int4 y = reinterpret_cast<const int4*>(cy)[i];
    int4 ox, oy;
    lambda_one<S, K, L, NG>(x.x, y.x, g, tab, ox.x, oy.x);
    lambda_one<S, K, L, NG>(x.y, y.y, g, tab, ox.y, oy.y);
    lambda_one<S, K, L, NG>(x.z, y.z, g, tab, ox.z, oy.z);
    lambda_one<S, K, L, NG>(x.w, y.w, g, tab, ox.w, oy.w);
    reinterpret_cast<int4*>(ex)[i] = ox;
    reinterpret_cast<int4*>(ey)[i] = oy;
  }
  for (long long i = 4 * quads + first; i < count; i += stride) {
    int ox, oy;
    lambda_one<S, K, L, NG>(cx[i], cy[i], g, tab, ox, oy);
    ex[i] = ox;
    ey[i] = oy;
  }
}

// A grid of as many CTAs as are resident at most, a thread a quad of
// coordinates (or a coordinate); the kernel's table in `smem` bytes.
template <typename Kernel>
int persistent_ctas(Kernel kernel, long long items, size_t smem,
                    long long& ctas) {
  int rc = 0, dev = 0, sms = 0, per_sm = 0;
  if (smem > 48 * 1024 &&
      (rc = (int)cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return rc;
  if ((rc = (int)cudaGetDevice(&dev)) ||
      (rc = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)) ||
      (rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)))
    return rc;
  ctas = (items + kThreads - 1) / kThreads;
  const long long resident = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (ctas > resident) ctas = resident;
  return 0;
}

template <int S, int K, int L, int NG>
int launch_lambda_kernel(const int* cx, const int* cy, int* ex, int* ey,
                         long long count, const LambdaGeom& g,
                         const int* table, cudaStream_t stream) {
  auto kernel = lambda_kernel<S, K, L, NG>;
  const size_t smem = (size_t)g.entries * sizeof(int);
  long long ctas = 0;
  const int rc = persistent_ctas(
      kernel, g.vec ? count / 4 + count % 4 : count, smem, ctas);
  if (rc) return rc;
  kernel<<<(unsigned)ctas, kThreads, smem, stream>>>(cx, cy, ex, ey, count,
                                                     g, table);
  return (int)cudaGetLastError();
}

// The instance of (s, k) = (S, K) compiled for `groups` groups.
template <int S, int K, int L, int NG>
int launch_lambda_groups(const int* cx, const int* cy, int* ex, int* ey,
                         long long count, const LambdaGeom& g,
                         const int* table, cudaStream_t stream) {
  if (g.groups == NG)
    return launch_lambda_kernel<S, K, L, NG>(cx, cy, ex, ey, count, g, table,
                                             stream);
  if constexpr (NG < max_groups(S, L))
    return launch_lambda_groups<S, K, L, NG + 1>(cx, cy, ex, ey, count, g,
                                                 table, stream);
  else
    return (int)cudaErrorInvalidValue;
}

template <int S, int L, int NG>
int launch_nu_kernel(const int* ex, const int* ey, int* cx, int* cy,
                     uint8_t* valid, long long count, const NuGeom& g,
                     const int* table, cudaStream_t stream) {
  auto kernel = nu_kernel<S, L, NG>;
  const size_t smem = (size_t)g.entries * sizeof(int);
  long long ctas = 0;
  const int rc = persistent_ctas(
      kernel, g.vec ? count / 4 + count % 4 : count, smem, ctas);
  if (rc) return rc;
  kernel<<<(unsigned)ctas, kThreads, smem, stream>>>(ex, ey, cx, cy, valid,
                                                     count, g, table);
  return (int)cudaGetLastError();
}

// The instance of s = S compiled for `groups` groups.
template <int S, int L, int NG>
int launch_nu_groups(const int* ex, const int* ey, int* cx, int* cy,
                     uint8_t* valid, long long count, const NuGeom& g,
                     const int* table, cudaStream_t stream) {
  if (g.groups == NG)
    return launch_nu_kernel<S, L, NG>(ex, ey, cx, cy, valid, count, g, table,
                                      stream);
  if constexpr (NG < max_groups(S, L))
    return launch_nu_groups<S, L, NG + 1>(ex, ey, cx, cy, valid, count, g,
                                          table, stream);
  else
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// nu(w) over `count` int32 coordinates, s^r < 2^31, with the tables of
// nu_map.nu_tables on the card: `entries` int32, s^(2L) for a group of L =
// `levels` levels (kLevels2 for s = 2, kLevels3 otherwise), then, where the
// top group has R < L levels, s^(2R) for it. Writes int32 cx, cy and uint8
// valid.
int sq_nu_map(const int* ex, const int* ey, int* cx, int* cy, uint8_t* valid,
              long long count, int r, int s, int k, int levels,
              const int* table, int entries, void* stream) {
  if (count < 1 || r < 0 || s < 2 || k < 1 ||
      levels != (s == 2 ? kLevels2 : kLevels3))
    return (int)cudaErrorInvalidValue;
  long long n = 1;
  for (int mu = 0; mu < r && n < (1LL << 31); ++mu) n *= s;
  if (n >= (1LL << 31) || s >= (1 << 15)) return (int)cudaErrorInvalidValue;
  const long long sl = ipow(s, levels);   // s^L < 2^30 where a table fits
  const int groups = (r + levels - 1) / levels;
  const int top = groups > 0 ? r - (groups - 1) * levels : 0;
  const long long st = ipow(s, top), kl = ipow(k, levels / 2);
  const long long want =
      sl * sl + (groups > 0 && top < levels ? st * st : 0);
  if (want != entries || (size_t)want * sizeof(int) > kMaxSmem ||
      (groups > 1 && kl >= (1LL << 31)))
    return (int)cudaErrorInvalidValue;
  NuGeom g;
  g.n = (int)n;
  g.kl = groups > 1 ? (int)kl : 1;
  g.groups = groups;
  g.sl = (int)sl;
  g.top_off = top < levels ? (int)(sl * sl) : 0;
  g.top_stride = (int)st;
  g.entries = entries;
  g.vec = (((uintptr_t)ex | (uintptr_t)ey | (uintptr_t)cx | (uintptr_t)cy) &
           15) == 0 && ((uintptr_t)valid & 3) == 0;
  cudaStream_t cs = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 2: return launch_nu_groups<2, kLevels2, 0>(ex, ey, cx, cy, valid,
                                                    count, g, table, cs);
    case 3: return launch_nu_groups<3, kLevels3, 0>(ex, ey, cx, cy, valid,
                                                    count, g, table, cs);
    default: return launch_nu_kernel<0, kLevels3, -1>(ex, ey, cx, cy, valid,
                                                      count, g, table, cs);
  }
}

// lambda(w) over `count` int32 compact coordinates (any sign), s^r < 2^31,
// with the tables of lambda_map.lambda_tables on the card: `entries`
// int32, k^L for a group of L = `levels` levels, then k^L more for the top
// group where it has R < L levels. Writes int32 ex, ey.
int sq_lambda_map(const int* cx, const int* cy, int* ex, int* ey,
                  long long count, int r, int s, int k, int levels,
                  const int* table, int entries, void* stream) {
  if (count < 1 || r < 0 || s < 2 || k < 1 || levels < 2 || levels % 2)
    return (int)cudaErrorInvalidValue;
  long long n = 1;
  for (int mu = 0; mu < r && n < (1LL << 31); ++mu) n *= s;
  const long long sl = ipow(s, levels), d = ipow(k, levels / 2);
  if (n >= (1LL << 31) || sl > (1 << 16) || d >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int groups = (r + levels - 1) / levels;
  const int top = groups > 0 ? r - (groups - 1) * levels : 0;
  const long long want = d * d * (top > 0 && top < levels ? 2 : 1);
  if (want != entries || (size_t)want * sizeof(int) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  LambdaGeom g;
  g.d = (int)d;
  g.sl = (int)sl;
  g.groups = groups;
  g.top_off = top > 0 && top < levels ? (int)(d * d) : 0;
  g.entries = entries;
  g.vec = (((uintptr_t)cx | (uintptr_t)cy | (uintptr_t)ex | (uintptr_t)ey) &
           15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s == 2 && k == 3 && levels == kLambdaL2)
    return launch_lambda_groups<2, 3, kLambdaL2, 0>(cx, cy, ex, ey, count, g,
                                                    table, st);
  if (s == 3 && k == 8 && levels == kLambdaL3)
    return launch_lambda_groups<3, 8, kLambdaL3, 0>(cx, cy, ex, ey, count, g,
                                                    table, st);
  if (s == 3 && k == 5 && levels == kLambdaL3)
    return launch_lambda_groups<3, 5, kLambdaL3, 0>(cx, cy, ex, ey, count, g,
                                                    table, st);
  if (s == 3 && k == 7 && levels == kLambdaL3)
    return launch_lambda_groups<3, 7, kLambdaL3, 0>(cx, cy, ex, ey, count, g,
                                                    table, st);
  return launch_lambda_kernel<0, 0, 0, -1>(cx, cy, ex, ey, count, g, table,
                                           st);
}

}  // extern "C"
