// Mamba-2 SSD intra-chunk block for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernel src/repro/kernels/ssd_chunk.py::
// ssd_chunk_scan's _ssd_chunk_kernel -> sq_ssd_chunk. The inter-chunk
// recurrence stays in PyTorch (kernels/ssd_chunk.py), as the reference
// keeps it in XLA.
//
// Inputs, float32 and contiguous: x (C, L, H, P), dt (C, L, H), a (H),
// B and C (C, L, N) shared by the heads (n_groups = 1), for C = batch x
// chunks. Outputs: y_diag (C, L, H, P) and the chunk-final states
// (C, H, P, N). Per chunk and head h, with da = dt a_h and cs its cumulative
// sum over the chunk:
//   cb[l, m]     = sum_n C[l, n] B[m, n]                       (m <= l)
//   y_diag[l, p] = sum_{m <= l} cb[l, m] exp(cs[l] - cs[m]) dt[m] x[m, p]
//   state[p, n]  = sum_m (x[m, p] (exp(cs[L-1] - cs[m]) dt[m])) B[m, n]
// Only the lower triangle is used: above it exp(cs[l] - cs[m]) has a
// positive exponent and overflows, which the reference masks afterwards.
//
// What bounds it on this card: bytes (x in, y_diag and the states out:
// 312 MB at mamba2-780m, 0.093 ms at 3.35 TB/s); its 9.8 GFLOP take 0.15 ms
// on the CUDA cores in FP32 but 0.06 ms as 3xTF32 on the tensor cores. So
// the three products run on the tensor cores, mma.sync m16n8k8 TF32 with
// the 3xTF32 split (a_lo b_hi + a_hi b_lo + a_hi b_hi), float32 accuracy:
//   * lower_cb_kernel forms cb = C B^T once a chunk, on the 16 x 8 tiles
//     on or below the diagonal, into a workspace (C, Lp, Lp) the wrapper
//     allocates (Lp: the chunk padded to whole 16-row tiles; 4 MB at
//     mamba2-780m, read back from L2). B and C pass through shared memory
//     by cp.async in 64-row, 128-column tiles, so neither L nor N is
//     bounded by it.
//   * ssd_kernel walks (chunk, head) units, a persistent grid of `ctas`
//     CTAs, each over a contiguous run of at most `heads` units: two CTAs
//     of 8 warps an SM where two x buffers fit them, else one of 16
//     (ssd_chunk.ssd_plan picks the CTAs, units, warps and buffers). A
//     unit's x is staged whole in shared memory with cp.async, the next
//     unit's while this one's products run (x_buffers = 2). Its work comes
//     in items that the warps take in order from a shared ticket that runs
//     over all the CTA's units (no barrier between units, so one unit's
//     short last items overlap the next one's long first ones): state
//     tiles of 32 x 32 (K = the chunk; B straight from L2 into the B
//     fragments, two k-steps ahead), then the y row tiles of 16 rows x 64
//     columns of P, longest first (the triangle: row tile i runs 2i + 2
//     k-steps of 8). A y row tile builds its scores fragment in registers
//     from the cb fragment it loads, times exp(cs_l - cs_m) (each exponent
//     once for its 64 columns) times dt_m, entries above the diagonal 0,
//     and feeds it straight in as the A operand: the k index is permuted
//     (slot t <-> m = 2t, slot t + 4 <-> m = 2t + 1) so that the C-fragment
//     pairs (2t, 2t + 1) of cb land where the A fragment wants them, and x
//     is read in the same order as the B operand.
//   * cs of every unit of a CTA is summed up front, one thread a unit,
//     sequentially in float32: the order of PyTorch's outer-dimension
//     cumsum on the card, so the kernel and its plain version see the same
//     decay exponents (a parallel scan moves them by ulps at |cs| ~ 90,
//     the size of the 2e-5 bar).
// Results are not bit for bit with the plain version (another summation
// order and 3xTF32 products); the bar is the reference's, rtol = atol =
// 2e-5. A chunk is bounded by one x in shared memory: Lp (P + 4) floats.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCbThreads = 128;  // lower_cb_kernel: 4 warps, 16 rows each
constexpr int kCbK = 128;        // columns of N it stages at a time
constexpr int kCbKs = kCbK + 4;  // its staged row, in floats
constexpr size_t kMaxSmem = 232448;  // shared bytes one Hopper CTA can use
constexpr int kStateRows = 32;  // rows of P a state item forms
constexpr int kStateCols = 32;  // columns of N a state item forms

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// x's row in shared memory, in floats: P padded to 32, plus 4 so that rows
// 2 apart fall 8 banks apart (the fragments read rows m0 + 2t).
__host__ __device__ inline int x_stride(int P) { return round_up(P, 32) + 4; }

// ssd_kernel's shared layout, in floats: x_buffers x (Lp rows of x), cs
// and dt of each of `heads` units (Lp each), x_buffers x w (Lp), then the
// ticket, a done count and a ready flag a buffer (ints).
__host__ __device__ inline size_t ssd_smem(int L, int P, int heads,
                                           int xbuf) {
  const int Lp = round_up(L, 16);
  return sizeof(float) * ((size_t)xbuf * Lp * (x_stride(P) + 1) +
                          (size_t)2 * heads * Lp + 1 + 2 * xbuf);
}

// x rounded to TF32, to nearest with ties away from zero, as
// cvt.rna.tf32.f32 does on this card: half an ulp of TF32 (bit 12) added,
// the 13 low bits left for the tensor cores to ignore (finite x).
__device__ __forceinline__ uint32_t tf32(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// x = hi + lo, both rounded to TF32 (hi's low bits cleared, so that x - hi
// is exact).
struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split(float x) {
  Split s;
  s.hi = tf32(x) & 0xffffe000u;
  s.lo = tf32(x - __uint_as_float(s.hi));
  return s;
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32: a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms
// first. kFresh: the three summed in a fresh accumulator that is then added
// to d in float32. The tensor cores truncate what they add to their
// accumulator, so a long sum kept there drifts toward zero by up to an ulp
// of the sum a product: y_diag, a sum of up to 3 L products of either sign,
// read 0.97 of the 2e-5 bar so, and 0.32 a k-step at a time; the states,
// whose products share a sign more often, 0.02 either way (on the card).
template <bool kFresh>
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     const Split (&b)[2]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  float (&c)[4] = kFresh ? s : d;
  mma(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
  if (kFresh) {
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += s[e];
  }
}

// A 4-byte or 16-byte copy to shared memory; `on` false zero-fills (the
// source is not read).
template <int kBytes>
__device__ __forceinline__ void cp_async(void* to, const void* from,
                                         bool on) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(to);
  const int n = on ? kBytes : 0;
  if (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(s), "l"(from), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(s), "l"(from), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

// ---------------------------------------------------------------- cb
// Stage rows r0 .. r0 + 63 of one chunk's B or C (L rows of N), columns
// k0 .. k0 + kCbK - 1, into s (rows kCbKs apart), zeros past L and N:
// 16-byte copies where the rows allow (vec), else 4-byte ones.
__device__ __forceinline__ void stage_rows(float* s, const float* m, int r0,
                                           int k0, int L, int N, bool vec) {
  constexpr int q = kCbK / 4;   // 16-byte groups a staged row
  for (int e = threadIdx.x; e < 64 * q; e += kCbThreads) {
    const int r = e / q, k = 4 * (e - r * q);
    const float* from = m + (long long)(r0 + r) * N + k0 + k;
    float* to = s + r * kCbKs + k;
    if (vec) {
      const bool on = r0 + r < L && k0 + k < N;
      cp_async<16>(to, on ? from : m, on);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool on = r0 + r < L && k0 + k + j < N;
        cp_async<4>(to + j, on ? from + j : m, on);
      }
    }
  }
  cp_commit();
}

// grid (chunks, 64 x 64 blocks on or below the diagonal): block (I, J),
// J <= I, of cb = C B^T into work (C, Lp, Lp); warp r forms its 16 rows,
// all 64 columns (the block's tiles above the diagonal too, which no y
// item reads: the loop has no branch). B and C are staged kCbK columns at
// a time with cp.async, a round trip for N <= kCbK; rows and columns past
// L are staged as zeros, so their cb is 0.
__global__ void __launch_bounds__(kCbThreads)
lower_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
                float* __restrict__ work, int L, int N, bool vec) {
  extern __shared__ __align__(16) float cbs[];
  float* Cs = cbs;
  float* Bs = cbs + 64 * kCbKs;
  const long long c = blockIdx.x;
  const int Lp = round_up(L, 16);
  int I = 0, J = blockIdx.y;
  while (J > I) J -= ++I;   // blockIdx.y = I (I + 1) / 2 + J
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i = 4 * I + warp;           // this warp's 16-row tile
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kCbK) {
    __syncthreads();   // the last stage is read
    stage_rows(Cs, cm + c * L * N, 64 * I, k0, L, N, vec);
    stage_rows(Bs, bm + c * L * N, 64 * J, k0, L, N, vec);
    cp_wait<0>();
    __syncthreads();
    if (i * 16 >= Lp) continue;
    for (int kk = 0; kk < min(kCbK, N - k0); kk += 8) {
      const float* ca = Cs + (16 * warp + g) * kCbKs + kk + t;
      const Split a[4] = {split(ca[0]), split(ca[8 * kCbKs]), split(ca[4]),
                          split(ca[8 * kCbKs + 4])};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* br = Bs + (8 * nt + g) * kCbKs + kk + t;
        const Split b[2] = {split(br[0]), split(br[4])};
        mma3<true>(acc[nt], a, b);
      }
    }
  }
  if (i * 16 >= Lp) return;
  float* out = work + (c * Lp + 16 * i + g) * Lp + 64 * J + 2 * t;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (64 * J + 8 * nt < Lp) {
      *reinterpret_cast<float2*>(out + 8 * nt) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(out + 8 * Lp + 8 * nt) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

// ------------------------------------------------------------- units
struct Unit {
  long long c;     // chunk
  int h;           // head
  const float* x;  // its x[c, 0, h, 0]: rows H P apart
};

// Stage unit u's x (L rows of P) into xs, rows past L and columns past P
// zeroed: 16-byte copies where the rows allow (vec), else 4-byte ones; by
// threads `first`, `first` + `stride`, ... (the CTA, or one warp).
__device__ __forceinline__ void stage_x(float* xs, const Unit& u, int L,
                                        int Lp, int H, int P, int XS,
                                        bool vec, int first, int stride) {
  const int q4 = round_up(P, 32) / 4;   // 16-byte groups a staged row
  const long long rs = (long long)H * P;
  for (int e = first; e < Lp * q4; e += stride) {
    const int l = e / q4, p = 4 * (e - l * q4);
    float* to = xs + l * XS + p;
    const float* from = u.x + l * rs + p;
    if (vec) {
      const bool on = l < L && p < P;
      cp_async<16>(to, on ? from : u.x, on);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool on = l < L && p + j < P;
        cp_async<4>(to + j, on ? from + j : u.x, on);
      }
    }
  }
  cp_commit();
}

__device__ __forceinline__ Unit unit_of(long long u, const float* x, int L,
                                        int H, int P) {
  Unit r;
  r.c = u / H;
  r.h = (int)(u - r.c * H);
  r.x = x + (r.c * L * H + r.h) * (long long)P;
  return r;
}

// State item: rows p0 .. p0 + kStateRows - 1, columns n0 .. n0 +
// kStateCols - 1 of the unit's state, K = Lp (rows past L: x zero, w
// zero). A = (x w)^T from shared memory, B from L2 (two k-steps ahead),
// both in the permuted k order. kFull:
// every row and column of the item lies in P and N, so its loops have no
// branch and the compiler interleaves the tiles' products (B's rows past L
// are read at L - 1: finite, times A's zeros).
template <bool kFull>
__device__ __forceinline__ void state_item(
    const float* __restrict__ xs, const float* __restrict__ w,
    const float* __restrict__ bb, float* __restrict__ st, int p0, int n0,
    int L, int Lp, int P, int N, int XS, int g, int t) {
  constexpr int kMT = kStateRows / 16, kNT = kStateCols / 8;
  float acc[kMT][kNT][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  // B two k-steps ahead, in two register buffers (Lp is a multiple of 16)
  float nb[2][kNT][2];
  auto load_b = [&](float (&to)[kNT][2], int m0) {
    const int ma = m0 + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = n0 + 8 * nt + g;
      if (kFull) {
        to[nt][0] = __ldg(bb + (long long)min(ma, L - 1) * N + n);
        to[nt][1] = __ldg(bb + (long long)min(ma + 1, L - 1) * N + n);
      } else {
        to[nt][0] = ma < L && n < N ? __ldg(bb + (long long)ma * N + n) : 0.f;
        to[nt][1] = ma + 1 < L && n < N
                        ? __ldg(bb + (long long)(ma + 1) * N + n) : 0.f;
      }
    }
  };
  auto step = [&](float (&from)[kNT][2], int m0) {
    Split b[kNT][2];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      b[nt][0] = split(from[nt][0]);
      b[nt][1] = split(from[nt][1]);
    }
    if (m0 + 16 < Lp) load_b(from, m0 + 16);
    const int ma = m0 + 2 * t;
    const float wa = w[ma], wb = w[ma + 1];
    const float* xa = xs + ma * XS + p0 + g;
    const float* xb = xa + XS;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if (!kFull && p0 + 16 * mt >= P) continue;
      const Split a[4] = {split(xa[16 * mt] * wa), split(xa[16 * mt + 8] * wa),
                          split(xb[16 * mt] * wb),
                          split(xb[16 * mt + 8] * wb)};
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
        if (kFull || n0 + 8 * nt < N) mma3<false>(acc[mt][nt], a, b[nt]);
    }
  };
  load_b(nb[0], 0);
  load_b(nb[1], 8);
  for (int m0 = 0; m0 < Lp; m0 += 16) {
    step(nb[0], m0);
    step(nb[1], m0 + 8);
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int n = n0 + 8 * nt + 2 * t;
#pragma unroll
      for (int hv = 0; hv < 2; ++hv) {
        const int p = p0 + 16 * mt + g + 8 * hv;
        if (p >= P) continue;
        float* to = st + (long long)p * N + n;
        if (n < N) to[0] = acc[mt][nt][2 * hv];
        if (n + 1 < N) to[1] = acc[mt][nt][2 * hv + 1];
      }
    }
  }
}

// y item: rows 16 i .. 16 i + 15 and columns p0 .. p0 + 63 of the unit's
// y_diag, k-steps of 8 over m < 16 i + 16. The scores fragment is built in
// registers from cb (from L2, one k-step ahead) and fed to the products as
// their A operand; x from shared memory is the B operand. The exponents are
// taken whether or not the entry lies below the diagonal, then selected, so
// that the loop has no branch; kFull: the 64 columns lie in P (no guard).
template <bool kFull>
__device__ __forceinline__ void y_item(
    const float* __restrict__ xs, const float* __restrict__ cs,
    const float* __restrict__ dt, const float* __restrict__ cbw,
    float* __restrict__ y, int i, int p0, int L, int Lp, int H, int P,
    int XS, int g, int t) {
  float acc[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  const int la = 16 * i + g, lb = la + 8;
  const bool ra = la < L, rb = lb < L;
  const float csa = cs[la], csb = cs[lb];
  const float* cba = cbw + (long long)la * Lp + 2 * t;
  const float* cbb = cba + 8 * Lp;
  float2 na = __ldg(reinterpret_cast<const float2*>(cba));
  float2 nb = __ldg(reinterpret_cast<const float2*>(cbb));
  const int steps = 2 * i + 2;
  for (int s = 0; s < steps; ++s) {
    const float2 ca = na, cb = nb;
    if (s + 1 < steps) {
      na = __ldg(reinterpret_cast<const float2*>(cba + 8 * (s + 1)));
      nb = __ldg(reinterpret_cast<const float2*>(cbb + 8 * (s + 1)));
    }
    const int ma = 8 * s + 2 * t, mb = ma + 1;
    const float ea = cs[ma], eb = cs[mb], da = dt[ma], db = dt[mb];
    const float s00 = ca.x * expf(csa - ea) * da;
    const float s10 = cb.x * expf(csb - ea) * da;
    const float s01 = ca.y * expf(csa - eb) * db;
    const float s11 = cb.y * expf(csb - eb) * db;
    // slot t <-> m = ma, slot t + 4 <-> m = mb
    const Split a[4] = {split(ra && ma <= la ? s00 : 0.f),
                        split(rb && ma <= lb ? s10 : 0.f),
                        split(ra && mb <= la ? s01 : 0.f),
                        split(rb && mb <= lb ? s11 : 0.f)};
    const float* xa = xs + ma * XS + p0 + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      if (kFull || p0 + 8 * nt < P) {
        const Split b[2] = {split(xa[8 * nt]), split(xa[XS + 8 * nt])};
        mma3<true>(acc[nt], a, b);
      }
    }
  }
  const long long rs = (long long)H * P;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int p = p0 + 8 * nt + 2 * t;
#pragma unroll
    for (int hv = 0; hv < 2; ++hv) {
      const int l = la + 8 * hv;
      if (l >= L) continue;
      float* to = y + l * rs + p;
      if (p < P) to[0] = acc[nt][2 * hv];
      if (p + 1 < P) to[1] = acc[nt][2 * hv + 1];
    }
  }
}

// w of one unit (x's weight in its state), Lp entries, 0 past L; by
// threads `first`, `first` + `stride`, ...
__device__ __forceinline__ void unit_w(float* w, const float* cs,
                                       const float* d, int L, int Lp,
                                       int first, int stride) {
  for (int m = first; m < Lp; m += stride)
    w[m] = m < L ? expf(cs[L - 1] - cs[m]) * d[m] : 0.f;
}

// The persistent grid: CTA b takes units [b U / ctas, (b + 1) U / ctas),
// U = chunks x H, at most `heads`, with xbuf x buffers (unit j in buffer
// j % xbuf); kWarps warps a CTA, 16 an SM either way (two CTAs of 8, or
// one of 16 where two x buffers do not fit two CTAs), 128 registers. The
// warps take tickets in order over every item of every unit, so one
// unit's short last items overlap the next unit's long first ones, with
// no barrier. The warp that finishes a unit's last item stages
// the unit xbuf further into the buffer it frees (x by cp.async, and w)
// while the others go on, then sets the buffer's ready flag, on which a
// warp holding a ticket of that unit waits.
template <int kWarps>
__global__ void __launch_bounds__(32 * kWarps, 16 / kWarps)
ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a, const float* __restrict__ bm,
           const float* __restrict__ cbw, float* __restrict__ y,
           float* __restrict__ st, long long units, int L, int H, int P,
           int N, int heads, int xbuf, bool vec) {
  constexpr int kThreads = 32 * kWarps;
  extern __shared__ __align__(16) float sm[];
  const int Lp = round_up(L, 16), XS = x_stride(P);
  float* xs = sm;
  float* css = sm + (size_t)xbuf * Lp * XS;
  float* dts = css + (size_t)heads * Lp;
  float* ws = dts + (size_t)heads * Lp;
  int* ticket = reinterpret_cast<int*>(ws + (size_t)xbuf * Lp);
  int* done = ticket + 1;
  volatile int* ready = done + xbuf;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const int nu = (int)(units * (blockIdx.x + 1) / gridDim.x - u0);
  const int staged = min(nu, xbuf);

  for (int j = 0; j < staged; ++j)
    stage_x(xs + (size_t)j * Lp * XS, unit_of(u0 + j, x, L, H, P), L, Lp,
            H, P, XS, vec, tid, kThreads);
  for (int e = tid; e < nu * Lp; e += kThreads) {
    const int j = e / Lp, l = e - j * Lp;
    const Unit u = unit_of(u0 + j, x, L, H, P);
    dts[e] = l < L ? dt[(u.c * L + l) * H + u.h] : 0.f;
  }
  if (tid == 0) {
    *ticket = 0;
    for (int b = 0; b < xbuf; ++b) {
      done[b] = 0;
      ready[b] = b;
    }
  }
  __syncthreads();
  for (int j = tid; j < nu; j += kThreads) {   // cs, sequentially in float32
    const float ah = a[unit_of(u0 + j, x, L, H, P).h];
    const float* d = dts + (size_t)j * Lp;
    float* cs = css + (size_t)j * Lp;
    float acc = 0.f;
    for (int l = 0; l < L; ++l) {
      acc = acc + d[l] * ah;
      cs[l] = acc;
    }
    for (int l = L; l < Lp; ++l) cs[l] = acc;
  }
  __syncthreads();
  for (int j = 0; j < staged; ++j)
    unit_w(ws + (size_t)j * Lp, css + (size_t)j * Lp, dts + (size_t)j * Lp,
           L, Lp, tid, kThreads);
  cp_wait<0>();
  __syncthreads();

  const int RT = Lp / 16, PS = (P + 63) / 64;
  const int PT = (P + kStateRows - 1) / kStateRows;
  const int NT = (N + kStateCols - 1) / kStateCols;
  const int n_state = PT * NT, n_items = n_state + RT * PS;
  for (;;) {
    int tk = 0;
    if (lane == 0) tk = atomicAdd(ticket, 1);
    tk = __shfl_sync(0xffffffffu, tk, 0);
    if (tk >= nu * n_items) break;
    const int j = tk / n_items, it = tk - j * n_items, b = j % xbuf;
    if (lane == 0)
      while (ready[b] != j) __nanosleep(64);
    __syncwarp();
    __threadfence_block();
    const Unit u = unit_of(u0 + j, x, L, H, P);
    float* xj = xs + (size_t)b * Lp * XS;
    if (it < n_state) {
      const float* bb = bm + u.c * L * (long long)N;
      float* stj = st + (u.c * H + u.h) * (long long)P * N;
      const float* w = ws + (size_t)b * Lp;
      const int p0 = kStateRows * (it / NT), n0 = kStateCols * (it % NT);
      if (p0 + kStateRows <= P && n0 + kStateCols <= N)
        state_item<true>(xj, w, bb, stj, p0, n0, L, Lp, P, N, XS, g, t);
      else
        state_item<false>(xj, w, bb, stj, p0, n0, L, Lp, P, N, XS, g, t);
    } else {
      const float* cbw_c = cbw + u.c * Lp * (long long)Lp;
      float* yj = y + (u.c * L * H + u.h) * (long long)P;
      const float* cs = css + (size_t)j * Lp;
      const float* d = dts + (size_t)j * Lp;
      const int q = it - n_state, i = RT - 1 - q / PS, p0 = 64 * (q % PS);
      if (p0 + 64 <= P)
        y_item<true>(xj, cs, d, cbw_c, yj, i, p0, L, Lp, H, P, XS, g, t);
      else
        y_item<false>(xj, cs, d, cbw_c, yj, i, p0, L, Lp, H, P, XS, g, t);
    }
    int n_done = 0;
    if (lane == 0) n_done = atomicAdd(done + b, 1) + 1;
    n_done = __shfl_sync(0xffffffffu, n_done, 0);
    const int jn = j + xbuf;
    if (n_done == n_items && jn < nu) {   // unit j done: buffer b is free
      if (lane == 0) done[b] = 0;
      stage_x(xj, unit_of(u0 + jn, x, L, H, P), L, Lp, H, P, XS, vec, lane,
              32);
      unit_w(ws + (size_t)b * Lp, css + (size_t)jn * Lp,
             dts + (size_t)jn * Lp, L, Lp, lane, 32);
      cp_wait<0>();
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        ready[b] = jn;
      }
    }
  }
}

}  // namespace

extern "C" {

// x (C, L, H, P), dt (C, L, H), a (H), bm and cm (C, L, N) -> y
// (C, L, H, P) and st (C, H, P, N), all float32 and contiguous; work a
// float32 workspace of C Lp Lp (Lp = L rounded up to 16). The plan
// (ssd_chunk.ssd_plan): `ctas` CTAs of `warps` warps (8 or 16) and at
// most `heads` (chunk, head) units, `xbuf` x buffers; checked here, not
// chosen.
int sq_ssd_chunk(const float* x, const float* dt, const float* a,
                 const float* bm, const float* cm, float* y, float* st,
                 float* work, long long n_chunks, int L, int H, int P, int N,
                 int heads, int ctas, int xbuf, int warps, void* stream) {
  if (n_chunks < 1 || n_chunks > 0x7fffffffLL || L < 1 || H < 1 || P < 1 ||
      N < 1 || heads < 1 || ctas < 1 || (xbuf != 1 && xbuf != 2) ||
      (warps != 8 && warps != 16))
    return (int)cudaErrorInvalidValue;
  const long long units = n_chunks * H;
  if (ctas > units || (units + ctas - 1) / ctas > heads)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ssd_smem(L, P, heads, xbuf);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int Lp = round_up(L, 16), nb = (Lp + 63) / 64;
  if (nb * (nb + 1) / 2 > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t cb_smem = 2 * 64 * kCbKs * sizeof(float);
  cudaError_t rc = cudaFuncSetAttribute(
      lower_cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cb_smem);
  if (rc != cudaSuccess) return (int)rc;
  const bool cb_vec =
      N % 4 == 0 && (((uintptr_t)bm | (uintptr_t)cm) & 15) == 0;
  lower_cb_kernel<<<dim3((unsigned)n_chunks,
                         (unsigned)(nb * (nb + 1) / 2)),
                    kCbThreads, cb_smem, s>>>(bm, cm, work, L, N, cb_vec);
  if ((rc = cudaGetLastError()) != cudaSuccess) return (int)rc;
  auto kernel = warps == 8 ? ssd_kernel<8> : ssd_kernel<16>;
  if (smem > 48 * 1024 &&
      (rc = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem)) != cudaSuccess)
    return (int)rc;
  const bool vec = P % 4 == 0 && ((uintptr_t)x & 15) == 0;
  kernel<<<(unsigned)ctas, 32 * warps, smem, s>>>(
      x, dt, a, bm, work, y, st, units, L, H, P, N, heads, xbuf, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
