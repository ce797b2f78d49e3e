// Flash attention forward for NVIDIA Hopper (sm_90a): three bodies.
//
// Replaces the TPU (Pallas) kernel src/repro/kernels/attention.py::
// flash_attention (body _flash_kernel). q (BH, Sq, D), k and v (BH, Sk, D),
// float32 or bfloat16, contiguous; out (BH, Sq, D) in q's type. Scores are
// float32 dot products times `scale`, optionally softcap * tanh(s /
// softcap); query i sits at position i + Sk - Sq (right-aligned, so Sq = 1
// decodes against a long cache); the causal mask keeps kpos <= qpos, the
// window kpos > qpos - window; masked scores are -1e30 (not -inf), as the
// reference sets them. Online softmax with a running max m, a denominator l
// and a float32 accumulator, and the output acc / max(l, 1e-30), as
// _flash_kernel computes it. The wrapper (kernels/attention.py::plan)
// picks the body from the shape alone:
//
// 1. sq_flash_attention_tc, bf16 prefill on the tensor cores (D a
//    multiple of 8, 16-byte aligned rows). Bound by operations: 4 D a
//    visible (query, key) pair against 989 TFLOP/s. A CTA of two
//    warpgroups owns 128 query rows (64 a warpgroup), grid (ceil(Sq / 128),
//    BH), and walks 64-key tiles. Q and two stages of K and V tiles come in
//    by TMA (one thread issues a tile's boxes of 64 columns, an mbarrier a
//    stage counts their bytes; rows and columns past the head's edge come
//    in as zeros) in wgmma's 128-byte-swizzled layout: tile t + 1 loads
//    while tile t computes, one barrier a tile; 193 KB at D = 256, one CTA
//    an SM. S = Q K^T by wgmma.m64n64k16 bf16 -> f32 with both operands in
//    shared memory (a product of two bf16 values is exact in float32, so
//    this is the reference's float32 dot up to the order of summation);
//    each operand is read once per warpgroup. The online softmax stays in
//    registers (a row's max over the 4 threads that share it, its sum per
//    thread until the end), with accurate expf and tanhf (the softcap's
//    division as a product by 1 / softcap). P V in two products into one
//    float32 accumulator: P_hi = bf16(P), P_lo = bf16(P - P_hi), P_hi V +
//    P_lo V (V is exact in bf16), which keeps about 16 bits of P where one
//    bf16 product keeps 8 (one product alone misses the bar of one bf16
//    rounding); it costs 1.5x the operations of one product. P is wgmma's
//    A operand straight from the score registers (the accumulator layout,
//    in bf16 pairs), V the B operand (MN-major) from shared memory.
// 2. sq_flash_attention_split, decode (Sq <= 8, D a multiple of 16 bytes,
//    aligned), float32 or bf16. Bound by bytes: K and V once against 3.35
//    TB/s. Grid (n_split, BH): a CTA streams its share of the keys with
//    16-byte loads, each warp (or each group of lanes that one key row
//    fills) a streamer with its own (m, l, acc) for every row, four keys
//    in flight before it computes; the streamers merge in shared memory
//    and the CTA writes a partial (m, l, acc[D]) in float32 to a
//    workspace the wrapper allocates. A second kernel combines the
//    partials: acc = sum exp(m_i - m) acc_i, l likewise. FP32 FMA
//    throughout. A split whose keys are all masked for a row that sees
//    keys elsewhere has m_i = -1e30 and weight 0; a row that sees no key
//    has m_i = -1e30 everywhere, and the combine gives sum v / Sk, the
//    reference's mean. The wrapper skips keys that no row sees (exact: they
//    weigh 0) unless a row sees none, and makes no split empty.
// 3. sq_flash_attention, everything else: float32 prefill (TF32 misses the
//    float32 bar of 2e-5) and rows the 16-byte loads cannot take (bf16
//    with D = 36). Bound by operations, FP32 FMA on the CUDA cores:
//    a CTA owns kBQ = 64 query rows of one (batch, head), grid
//    (ceil(Sq / 64), B * H), and loops over 64-row kv tiles itself. The Q
//    tile, one K tile, one V tile (converted to float32 on load, zero past
//    D and past Sk) and the tile's probabilities live in shared memory:
//    211 KB at D = 256. A tile is loaded with 16-byte loads, eight in
//    flight per thread before the first lands in shared memory, so that it
//    waits about one memory latency, not one per element (one element a
//    load where D or the alignment does not allow 16-byte loads). 256
//    threads: thread (ty, tx) owns query rows 4 ty .. 4 ty + 3, the scores
//    of keys tx + 16 j (j < 4) and the output columns 4 (tx + 16 g) .. +
//    3; a row's max and sum are reduced over its 16 threads by warp
//    shuffles (explicit fmaf, accurate expf and tanhf).
//
// Both prefill bodies skip fully masked kv tiles only where that cannot
// change a row: a masked key adds exp(-1e30 - m) = 0 once the row has seen
// a visible key, and before that its weight is wiped by alpha = exp(-1e30 -
// m) = 0. A row that sees no key at all (causal with Sq > Sk, or a window
// that hides every key) gets the mean of v over all Sk keys in the
// reference (every score -1e30, so exp(0) = 1 each); a CTA holding such a
// row visits every kv tile and computes it the same way. Keys past Sk in
// the last tile are not keys: their score is -inf, their weight 0.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;              // query rows of a CTA
constexpr int kBK = 64;              // key rows of a kv tile
constexpr int kPad = 4;              // floats of padding per row of Q, K, P
constexpr float kMasked = -1e30f;    // the reference's masked score
constexpr size_t kMaxSmem = 232448;  // shared bytes one Hopper CTA can use

__device__ __forceinline__ float load_f(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, long long i,
                                        float v) {
  p[i] = __float2bfloat16(v);  // round to nearest even, as .to(bfloat16)
}

// Four float32 or eight bfloat16 values of one 16-byte load, as floats.
__device__ __forceinline__ void unpack16(const uint4& u, const float*,
                                         float* out) {
  out[0] = __uint_as_float(u.x);
  out[1] = __uint_as_float(u.y);
  out[2] = __uint_as_float(u.z);
  out[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, const __nv_bfloat16*,
                                         float* out) {
  const unsigned words[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(words[i] << 16);          // low half
    out[2 * i + 1] = __uint_as_float(words[i] & 0xffff0000u);
  }
}

// Rows [row0, row0 + kRows) of a (S, D) matrix into a float tile of row
// stride ld and kDMax columns, zero past D and past S. kVec: 16-byte loads
// (D a multiple of 16 / sizeof(T), the rows 16-byte aligned), a batch of
// kBatch loads in flight per thread before any lands in shared memory, so
// a tile waits about one memory latency, not one per element; else one
// element per load.
template <class T, int kDMax, int kRows, bool kVec>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int row0, int S, int D) {
  if constexpr (kVec) {
    constexpr int E = 16 / sizeof(T);       // values per load
    constexpr int kSlots = kRows * (kDMax / E);
    constexpr int kBatch = 8;
    const int dv = D / E;
    for (int base = 0; base < kSlots; base += kBatch * kThreads) {
      uint4 buf[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int t = base + i * kThreads + threadIdx.x;
        const int r = t / (kDMax / E), c = t - r * (kDMax / E);
        const int gr = row0 + r;
        buf[i] = (t < kSlots && gr < S && c < dv)
                     ? *reinterpret_cast<const uint4*>(
                           src + (long long)gr * D + c * E)
                     : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int t = base + i * kThreads + threadIdx.x;
        if (t >= kSlots) continue;
        const int r = t / (kDMax / E), c = t - r * (kDMax / E);
        float v[E];
        unpack16(buf[i], src, v);
#pragma unroll
        for (int e = 0; e < E; e += 4)
          *reinterpret_cast<float4*>(dst + r * ld + c * E + e) =
              make_float4(v[e], v[e + 1], v[e + 2], v[e + 3]);
      }
    }
  } else {
    for (int t = threadIdx.x; t < kRows * kDMax; t += kThreads) {
      const int r = t / kDMax, d = t - r * kDMax;
      const int gr = row0 + r;
      dst[r * ld + d] =
          (gr < S && d < D) ? load_f(src, (long long)gr * D + d) : 0.f;
    }
  }
}

template <int kDMax>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)(kBQ + kBK) * (kDMax + kPad) +
                          (size_t)kBK * kDMax + (size_t)kBQ * (kBK + kPad));
}

struct AttnArgs {
  int Sq, Sk, D;
  float scale;
  int causal, has_window, window, has_softcap;
  float softcap;
};

template <class T, int kDMax, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, AttnArgs a) {
  constexpr int LQ = kDMax + kPad;  // row stride of the Q and K tiles
  constexpr int LP = kBK + kPad;    // row stride of the probabilities
  constexpr int NG = kDMax / 64;    // float4 output groups of a thread
  extern __shared__ __align__(16) float sm[];
  float* Qs = sm;                   // kBQ x LQ
  float* Ks = Qs + kBQ * LQ;        // kBK x LQ
  float* Vs = Ks + kBK * LQ;        // kBK x kDMax
  float* Ps = Vs + kBK * kDMax;     // kBQ x LP

  const int Sq = a.Sq, Sk = a.Sk, D = a.D;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;  // longest rows first
  const long long bh = blockIdx.y;
  const T* qb = q + bh * Sq * D;
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int off = Sk - Sq;
  const int nq = min(kBQ, Sq - q0);
  const bool active = ty * 4 < nq;  // rows past Sq skip the products

  // The kv tiles to visit: every tile when a row of this CTA sees no key,
  // else those meeting [lo(first row), hi(last row)] (lo and hi grow with
  // the row).
  int empty = 0;
  if (tid < nq) {
    const int qp = q0 + tid + off;
    const int lo = a.has_window ? max(0, qp - a.window + 1) : 0;
    const int hi = a.causal ? min(Sk - 1, qp) : Sk - 1;
    empty = lo > hi;
  }
  int kv_lo = 0, kv_hi = Sk - 1;
  if (!__syncthreads_or(empty)) {
    if (a.has_window) kv_lo = max(0, q0 + off - a.window + 1);
    if (a.causal) kv_hi = min(Sk - 1, q0 + nq - 1 + off);
  }

  load_tile<T, kDMax, kBQ, kVec>(Qs, LQ, qb, q0, Sq, D);
  const int dl = (D + 3) & ~3;
  float m[4], l[4], acc[4][NG * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * 4; ++c) acc[i][c] = 0.f;
  }

  for (int t = kv_lo / kBK; t <= kv_hi / kBK; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the last tile's K, V and P are read
    load_tile<T, kDMax, kBK, kVec>(Ks, LQ, kb, k0, Sk, D);
    load_tile<T, kDMax, kBK, kVec>(Vs, kDMax, vb, k0, Sk, D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    if (active) {
      for (int d = 0; d < dl; d += 4) {
        float4 qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * LQ + d);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LQ +
                                                   d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float x = s[i][j];
            x = fmaf(qv[i].x, kv[j].x, x);
            x = fmaf(qv[i].y, kv[j].y, x);
            x = fmaf(qv[i].z, kv[j].z, x);
            x = fmaf(qv[i].w, kv[j].w, x);
            s[i][j] = x;
          }
      }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i + off;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        if (a.has_softcap) x = a.softcap * tanhf(x / a.softcap);
        const bool vis = (!a.causal || kp <= qp) &&
                         (!a.has_window || kp > qp - a.window);
        s[i][j] = kp >= Sk ? -INFINITY : (vis ? x : kMasked);
      }
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int sh = 8; sh >= 1; sh >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int sh = 8; sh >= 1; sh >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, sh);
      l[i] = l[i] * alpha[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty * 4 + i) * LP + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NG * 4; ++c) acc[i][c] *= alpha[i];
    if (active) {
      for (int j = 0; j < kBK; j += 4) {
        float4 pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pv[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * LP + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            const float4 vv = *reinterpret_cast<const float4*>(
                Vs + (j + jj) * kDMax + (tx + 16 * g) * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = jj == 0 ? pv[i].x
                            : jj == 1 ? pv[i].y
                            : jj == 2 ? pv[i].z : pv[i].w;
              acc[i][g * 4 + 0] = fmaf(p, vv.x, acc[i][g * 4 + 0]);
              acc[i][g * 4 + 1] = fmaf(p, vv.y, acc[i][g * 4 + 1]);
              acc[i][g * 4 + 2] = fmaf(p, vv.z, acc[i][g * 4 + 2]);
              acc[i][g * 4 + 3] = fmaf(p, vv.w, acc[i][g * 4 + 3]);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + (bh * Sq + row) * D;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = (tx + 16 * g) * 4 + e;
        if (col < D) store_f(orow, col, acc[i][g * 4 + e] / den);
      }
  }
}

template <class T, int kDMax>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<kDMax>();
  static_assert(smem <= kMaxSmem, "tiles over one CTA's shared memory");
  const bool vec = a.D % (16 / sizeof(T)) == 0 &&
                   ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  auto kernel = vec ? flash_kernel<T, kDMax, true>
                    : flash_kernel<T, kDMax, false>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((unsigned)((a.Sq + kBQ - 1) / kBQ), (unsigned)bh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), a);
  return (int)cudaGetLastError();
}

template <class T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             const AttnArgs& a, cudaStream_t s) {
  if (a.D <= 64) return launch<T, 64>(q, k, v, o, bh, a, s);
  if (a.D <= 128) return launch<T, 128>(q, k, v, o, bh, a, s);
  return launch<T, 256>(q, k, v, o, bh, a, s);
}

// ---------------------------------------------------------------- body 1
namespace tc {

constexpr int kBQ = 128;           // query rows of a CTA: 2 warpgroups of 64
constexpr int kThreads = 2 * kBQ;  // 8 warps
constexpr int kBK = 64;            // key rows of a kv tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of r across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// box (64 columns, rows, 1) at (c0, c1, c2) of a 3D tensor map -> dst
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int c0, int c1,
                                        int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}
// rows [row0, row0 + kRows) of head bh, all kD / 64 panels
template <int kD, int kRows>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int row0, int bh) {
#pragma unroll
  for (int p = 0; p < kD / 64; ++p)
    tma_box(dst + p * kRows * 128, map, bar, 64 * p, row0, bh);
}

// Shared-memory matrix descriptor, 128-byte swizzle: 8-row groups of
// 128-byte rows, 16-byte chunk c of row r stored at c ^ (r % 8); lbo and
// sbo in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)lbo << 16) |
         ((uint64_t)sbo << 32) | (1ull << 62);
}
// the 32 accumulator registers of a 64x64 float32 wgmma tile: operands
// %0 .. %31 of the asm statements below
#define WG_ACC_REGS                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "  \
  "%26, %27, %28, %29, %30, %31}"
#define WG_ACC(d)                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),       \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),   \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),           \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),           \
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),           \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),           \
      "+f"(d[30]), "+f"(d[31])
// d (+)= a b, a 64x16 and b 16x64 from shared memory (both K-major), d a
// 64x64 float32 tile over the warpgroup; d is overwritten when kAcc is 0.
template <int kAcc>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC(d)
      : "l"(da), "l"(db), "r"(kAcc));
}
// d += a b, a 64x16 bf16 from registers (the accumulator layout of a
// 64x16 float32 tile, in pairs), b 16x64 from shared memory, MN-major
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_ACC_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}
// (x0, x1) -> hi = bf16(x), lo = bf16(x - hi), two bf16 pairs
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

template <int kD>
constexpr size_t smem_bytes() {  // Q, two stages of (K, V), alignment
  return sizeof(__nv_bfloat16) * (size_t)(kBQ + 4 * kBK) * kD + 1024 + 16;
}

template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
tc_kernel(const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv,
          __nv_bfloat16* __restrict__ o, AttnArgs a) {
  constexpr int NP = kD / 64;                    // 64-column panels
  constexpr uint32_t kTile = kBK * kD * 2;       // bytes of a K or V tile
  constexpr uint32_t kPanelQ = kBQ * 128, kPanelKV = kBK * 128;
  extern __shared__ __align__(1024) unsigned char smraw[];
  const uint32_t Qs = (smem_u32(smraw) + 1023u) & ~1023u;
  const uint32_t KVs = Qs + kBQ * kD * 2;  // stage s: K, then V
  const uint32_t bars = KVs + 4 * kTile;   // stage s full: bars + 8 s

  const int Sq = a.Sq, Sk = a.Sk, D = a.D;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;  // longest rows first
  const long long bh = blockIdx.y;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, tq = lane & 3;
  const int off = Sk - Sq;
  const int nq = min(kBQ, Sq - q0);
  const float inv_cap = 1.f / a.softcap;

  if (tid == 0) {
    mbar_init(bars);
    mbar_init(bars + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The kv tiles to visit, as in body 3.
  int empty = 0;
  if (tid < nq) {
    const int qp = q0 + tid + off;
    const int lo = a.has_window ? max(0, qp - a.window + 1) : 0;
    const int hi = a.causal ? min(Sk - 1, qp) : Sk - 1;
    empty = lo > hi;
  }
  int kv_lo = 0, kv_hi = Sk - 1;
  if (!__syncthreads_or(empty)) {
    if (a.has_window) kv_lo = max(0, q0 + off - a.window + 1);
    if (a.causal) kv_hi = min(Sk - 1, q0 + nq - 1 + off);
  }
  const int t_lo = kv_lo / kBK, t_hi = kv_hi / kBK;

  if (tid == 0) {
    mbar_expect(bars, kBQ * kD * 2 + 2 * kTile);
    tma_tile<kD, kBQ>(Qs, &mq, bars, q0, (int)bh);
    tma_tile<kD, kBK>(KVs, &mk, bars, t_lo * kBK, (int)bh);
    tma_tile<kD, kBK>(KVs + kTile, &mv, bars, t_lo * kBK, (int)bh);
  }

  // this thread's rows g and g + 8 of its warp's 16 in its warpgroup's 64
  const int qp0 = q0 + wg * 64 + warp * 16 + g + off;
  const uint32_t q_wg = Qs + wg * 64 * 128;  // the warpgroup's rows of Q

  float acc[NP][32];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[p][e] = 0.f;
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * kBK;
    const int st = (t - t_lo) & 1;                // this tile's stage
    const uint32_t ks_ = KVs + st * 2 * kTile;   // K(t)
    const uint32_t vs_ = ks_ + kTile;            // V(t)
    mbar_wait(bars + 8 * st, ((t - t_lo) >> 1) & 1);  // tile t has landed
    __syncthreads();  // no warp still reads tile t - 1
    if (t < t_hi && tid == 0) {  // the next tile into the other stage
      const uint32_t nx = KVs + (st ^ 1) * 2 * kTile;
      mbar_expect(bars + 8 * (st ^ 1), 2 * kTile);
      tma_tile<kD, kBK>(nx, &mk, bars + 8 * (st ^ 1), k0 + kBK, (int)bh);
      tma_tile<kD, kBK>(nx + kTile, &mv, bars + 8 * (st ^ 1), k0 + kBK,
                        (int)bh);
    }

    // S = Q K^T over the warpgroup's 64 rows: 64 x 64 float32
    float s[32];
    wg_fence();
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc(q_wg + p * kPanelQ + kk * 32, 1, 64);
        const uint64_t db = desc(ks_ + p * kPanelKV + kk * 32, 1, 64);
        if (p == 0 && kk == 0)
          wgmma_ss<0>(s, da, db);
        else
          wgmma_ss<1>(s, da, db);
      }
    wg_commit();
    wg_wait_all();
    fence_regs(s);

    // scale, softcap, masks; then the online softmax of rows g and g + 8
    // (s[4 j + e]: row g + 8 (e >> 1), key 8 j + 2 tq + (e & 1))
    const bool full = (!a.causal || k0 + kBK - 1 <= q0 + off) &&
                      (!a.has_window || k0 > q0 + nq - 1 + off - a.window) &&
                      k0 + kBK <= Sk;
    float mx[2] = {kMasked, kMasked};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * a.scale;
        if (a.has_softcap) x = a.softcap * tanhf(x * inv_cap);
        if (!full) {
          const int kp = k0 + 8 * j + 2 * tq + (e & 1);
          const int qp = qp0 + (e >> 1) * 8;
          const bool vis = (!a.causal || kp <= qp) &&
                           (!a.has_window || kp > qp - a.window);
          x = kp >= Sk ? -INFINITY : (vis ? x : kMasked);
        }
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = expf(s[e] - m[(e >> 1) & 1]);
      rs[(e >> 1) & 1] += s[e];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[p][e] *= alpha[(e >> 1) & 1];

    // P as the A operand, keys 16 ks .. + 15: P_hi and P_lo
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_pair(s[8 * ks + 2 * i], s[8 * ks + 2 * i + 1], ph[ks][i],
                   pl[ks][i]);
    // O += P_hi V + P_lo V, V(t) MN-major (64-column panels 8 KB apart)
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        const uint64_t db =
            desc(vs_ + p * kPanelKV + ks * 16 * 128, kPanelKV / 16, 64);
        wgmma_rs(acc[p], ph[ks], db);
        wgmma_rs(acc[p], pl[ks], db);
      }
    wg_commit();
    wg_wait_all();
#pragma unroll
    for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = q0 + wg * 64 + warp * 16 + g + 8 * i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = o + (bh * Sq + row) * D;
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * p + 8 * j + 2 * tq;  // D is a multiple of 8
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[p][4 * j + 2 * i] / den,
                                    acc[p][4 * j + 2 * i + 1] / den);
      }
  }
}

// cuTensorMapEncodeTiled from the driver, without linking it
PFN_cuTensorMapEncodeTiled encoder() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult qr;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &qr) ==
            cudaSuccess &&
        qr == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }
  return fn;
}

// (D, S, BH) bf16, boxes of 64 columns x rows, 128-byte swizzle, zero
// past every edge
bool make_map(CUtensorMap* m, const void* base, int D, int S, int BH,
              int rows) {
  PFN_cuTensorMapEncodeTiled fn = encoder();
  if (!fn) return false;
  cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)BH};
  cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  cuuint32_t estr[3] = {1, 1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           const AttnArgs& a, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<kD>();
  static_assert(smem <= 232448, "tiles over one CTA's shared memory");
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, a.D, a.Sq, bh, kBQ) ||
      !make_map(&mk, k, a.D, a.Sk, bh, kBK) ||
      !make_map(&mv, v, a.D, a.Sk, bh, kBK))
    return (int)cudaErrorInvalidValue;
  cudaError_t rc = cudaFuncSetAttribute(
      tc_kernel<kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc != cudaSuccess) return (int)rc;
  dim3 grid((unsigned)((a.Sq + kBQ - 1) / kBQ), (unsigned)bh);
  tc_kernel<kD><<<grid, kThreads, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), a);
  return (int)cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------- body 2
namespace split {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKB = 4;      // keys a streamer loads before it computes
constexpr int kMaxRows = 8;

// Keys [kv_lo + s * split_len, min(kv_lo + (s + 1) * split_len, kv_end)) of
// split s = blockIdx.x for all Sq <= kR rows of (batch, head) blockIdx.y;
// writes m, l (ml, 2 floats) and acc (D floats) of each row to the
// workspace at [(bh * Sq + row) * n_split + s].
template <class T, int kD, int kR>
__global__ void __launch_bounds__(kThreads)
split_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, float* __restrict__ ws_acc,
             float* __restrict__ ws_ml, AttnArgs a, int kv_lo, int kv_end,
             int split_len) {
  constexpr int E = 16 / sizeof(T);     // values a 16-byte load
  constexpr int C = kD / E;             // 16-byte chunks a row
  constexpr int L = C < 32 ? C : 32;    // lanes that read one key row
  constexpr int KW = 32 / L;            // key rows a warp reads at once
  constexpr int NC = C / L;             // chunks a lane
  constexpr int NS = kWarps * KW;       // streamers of the CTA
  __shared__ __align__(16) float sm_q[kR][kD];
  __shared__ __align__(16) float sm_acc[NS][kD];
  __shared__ float sm_m[NS], sm_l[NS];

  const int n_split = gridDim.x, sp = blockIdx.x;
  const long long bh = blockIdx.y;
  const int Sq = a.Sq, Sk = a.Sk, D = a.D, off = Sk - Sq;
  const int kbeg = kv_lo + sp * split_len;
  const int kend = min(kbeg + split_len, kv_end);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int sub = lane / L, sl = lane % L;
  const int sid = warp * KW + sub;
  const int dc = D / E;  // chunks of a row that hold values

  for (int t = tid; t < kR * kD; t += kThreads) {
    const int r = t / kD, d = t % kD;
    sm_q[r][d] = (r < Sq && d < D) ? load_f(q, (bh * Sq + r) * D + d) : 0.f;
  }
  __syncthreads();

  float m[kR], l[kR], acc[kR][NC * E];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = kMasked;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < NC * E; ++e) acc[r][e] = 0.f;
  }
  const T* kb = k + bh * Sk * D;
  const T* vb = v + bh * Sk * D;

  // warp-uniform loop: the streamer's keys are j0 + sub * kKB + i
  for (int jw = kbeg + warp * KW * kKB; jw < kend; jw += NS * kKB) {
    const int j0 = jw + sub * kKB;
    uint4 kr[kKB][NC], vr[kKB][NC];
#pragma unroll
    for (int i = 0; i < kKB; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int ch = sl + L * c;
        const bool in = j0 + i < kend && ch < dc;
        const long long at = (long long)(j0 + i) * D + ch * E;
        kr[i][c] = in ? *reinterpret_cast<const uint4*>(kb + at)
                      : make_uint4(0u, 0u, 0u, 0u);
        vr[i][c] = in ? *reinterpret_cast<const uint4*>(vb + at)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (r >= Sq) break;
      const int qp = r + off;
      float qv[NC * E];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 x = *reinterpret_cast<const float4*>(
              &sm_q[r][(sl + L * c) * E + e]);
          qv[c * E + e] = x.x;
          qv[c * E + e + 1] = x.y;
          qv[c * E + e + 2] = x.z;
          qv[c * E + e + 3] = x.w;
        }
      float s[kKB];
      float mx = kMasked;
#pragma unroll
      for (int i = 0; i < kKB; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float kv[E];
          unpack16(kr[i][c], k, kv);
#pragma unroll
          for (int e = 0; e < E; ++e) dot = fmaf(qv[c * E + e], kv[e], dot);
        }
#pragma unroll
        for (int sh = L / 2; sh >= 1; sh >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, sh);
        const int kp = j0 + i;
        float x = dot * a.scale;
        if (a.has_softcap) x = a.softcap * tanhf(x / a.softcap);
        const bool vis = (!a.causal || kp <= qp) &&
                         (!a.has_window || kp > qp - a.window);
        s[i] = kp >= kend ? -INFINITY : (vis ? x : kMasked);
        mx = fmaxf(mx, s[i]);
      }
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      m[r] = m_new;
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < kKB; ++i) {
        s[i] = expf(s[i] - m_new);
        rs += s[i];
      }
      l[r] = l[r] * alpha + rs;
#pragma unroll
      for (int e = 0; e < NC * E; ++e) acc[r][e] *= alpha;
#pragma unroll
      for (int i = 0; i < kKB; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float vv[E];
          unpack16(vr[i][c], v, vv);
#pragma unroll
          for (int e = 0; e < E; ++e)
            acc[r][c * E + e] = fmaf(s[i], vv[e], acc[r][c * E + e]);
        }
    }
  }

  // merge the streamers of the CTA, one row at a time
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (r >= Sq) break;
    if (sl == 0) {
      sm_m[sid] = m[r];
      sm_l[sid] = l[r];
    }
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[sid][(sl + L * c) * E + e] =
          acc[r][c * E + e];
    __syncthreads();
    float mm = kMasked;
    for (int s = 0; s < NS; ++s) mm = fmaxf(mm, sm_m[s]);
    const long long at = (bh * Sq + r) * n_split + sp;
    if (tid < D) {
      float x = 0.f;
      for (int s = 0; s < NS; ++s)
        x = fmaf(expf(sm_m[s] - mm), sm_acc[s][tid], x);
      ws_acc[at * D + tid] = x;
    }
    if (tid == 0) {
      float x = 0.f;
      for (int s = 0; s < NS; ++s) x = fmaf(expf(sm_m[s] - mm), sm_l[s], x);
      ws_ml[2 * at] = mm;
      ws_ml[2 * at + 1] = x;
    }
    __syncthreads();
  }
}

// One CTA a (batch, head, row): the n_split partials -> out.
template <class T>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ ws_acc,
               const float* __restrict__ ws_ml, T* __restrict__ o, int D,
               int n_split) {
  const long long row = blockIdx.x;
  const float* ml = ws_ml + row * n_split * 2;
  float mm = kMasked;
  for (int s = 0; s < n_split; ++s) mm = fmaxf(mm, ml[2 * s]);
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float x = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float w = expf(ml[2 * s] - mm);
      x = fmaf(w, ws_acc[(row * n_split + s) * D + d], x);
      den = fmaf(w, ml[2 * s + 1], den);
    }
    store_f(o, row * D + d, x / fmaxf(den, 1e-30f));
  }
}

template <class T, int kD, int kR>
int launch(const void* q, const void* k, const void* v, void* o, float* ws,
           int bh, const AttnArgs& a, int kv_lo, int kv_end, int split_len,
           int n_split, cudaStream_t stream) {
  float* ws_acc = ws;
  float* ws_ml = ws + (size_t)bh * a.Sq * n_split * a.D;
  split_kernel<T, kD, kR><<<dim3((unsigned)n_split, (unsigned)bh), kThreads,
                            0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), ws_acc, ws_ml, a, kv_lo, kv_end, split_len);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  combine_kernel<T><<<(unsigned)((long long)bh * a.Sq), kThreads, 0,
                      stream>>>(ws_acc, ws_ml, static_cast<T*>(o), a.D,
                                n_split);
  return (int)cudaGetLastError();
}

template <class T, int kR>
int dispatch_d(const void* q, const void* k, const void* v, void* o,
               float* ws, int bh, const AttnArgs& a, int kv_lo, int kv_end,
               int split_len, int n_split, cudaStream_t s) {
  if (a.D <= 64)
    return launch<T, 64, kR>(q, k, v, o, ws, bh, a, kv_lo, kv_end, split_len,
                             n_split, s);
  if (a.D <= 128)
    return launch<T, 128, kR>(q, k, v, o, ws, bh, a, kv_lo, kv_end,
                              split_len, n_split, s);
  return launch<T, 256, kR>(q, k, v, o, ws, bh, a, kv_lo, kv_end, split_len,
                            n_split, s);
}

template <class T>
int dispatch(const void* q, const void* k, const void* v, void* o, float* ws,
             int bh, const AttnArgs& a, int kv_lo, int kv_end, int split_len,
             int n_split, cudaStream_t s) {
  if (a.Sq == 1)
    return dispatch_d<T, 1>(q, k, v, o, ws, bh, a, kv_lo, kv_end, split_len,
                            n_split, s);
  return dispatch_d<T, kMaxRows>(q, k, v, o, ws, bh, a, kv_lo, kv_end,
                                 split_len, n_split, s);
}

}  // namespace split

}  // namespace

extern "C" {

// Body 3. dtype 0: float32, 1: bfloat16. q (bh, sq, d), k and v (bh, sk,
// d), o like q; 1 <= d <= 256, bh <= 65535; has_window / has_softcap select
// the window and the softcap.
int sq_flash_attention(int dtype, const void* q, const void* k,
                       const void* v, void* o, int bh, int sq, int sk, int d,
                       float scale, int causal, int has_window, int window,
                       int has_softcap, float softcap, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || d < 1 || d > 256)
    return (int)cudaErrorInvalidValue;
  AttnArgs a = {sq, sk, d, scale, causal, has_window, window, has_softcap,
                softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(q, k, v, o, bh, a, s);
    case 1: return dispatch<__nv_bfloat16>(q, k, v, o, bh, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Body 1, bfloat16 only: d a multiple of 8, q, k and v 16-byte aligned;
// the rest as sq_flash_attention.
int sq_flash_attention_tc(const void* q, const void* k, const void* v,
                          void* o, int bh, int sq, int sk, int d, float scale,
                          int causal, int has_window, int window,
                          int has_softcap, float softcap, void* stream) {
  if (bh < 1 || bh > 65535 || sq < 1 || sk < 1 || d < 8 || d > 256 ||
      d % 8 || ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
  AttnArgs a = {sq, sk, d, scale, causal, has_window, window, has_softcap,
                softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return tc::launch<64>(q, k, v, o, bh, a, s);
  if (d <= 128) return tc::launch<128>(q, k, v, o, bh, a, s);
  return tc::launch<256>(q, k, v, o, bh, a, s);
}

// Body 2: sq <= 8, d a multiple of 16 bytes, q, k and v 16-byte aligned;
// keys [kv_lo, kv_end) in n_split splits of split_len (the last may be
// shorter, none empty); ws holds bh * sq * n_split * (d + 2) floats. The
// rest as sq_flash_attention.
int sq_flash_attention_split(int dtype, const void* q, const void* k,
                             const void* v, void* o, void* ws, int bh,
                             int sq, int sk, int d, float scale, int causal,
                             int has_window, int window, int has_softcap,
                             float softcap, int kv_lo, int kv_end,
                             int split_len, int n_split, void* stream) {
  const int e = dtype == 0 ? 4 : 8;  // values a 16-byte load
  if (bh < 1 || bh > 65535 || sq < 1 || sq > split::kMaxRows || sk < 1 ||
      d < 1 || d > 256 || d % e ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 || kv_lo < 0 ||
      kv_end > sk || kv_lo >= kv_end || split_len < 1 || n_split < 1 ||
      (long long)(n_split - 1) * split_len >= kv_end - kv_lo ||
      (long long)n_split * split_len < kv_end - kv_lo)
    return (int)cudaErrorInvalidValue;
  AttnArgs a = {sq, sk, d, scale, causal, has_window, window, has_softcap,
                softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws);
  switch (dtype) {
    case 0: return split::dispatch<float>(q, k, v, o, w, bh, a, kv_lo, kv_end,
                                          split_len, n_split, s);
    case 1: return split::dispatch<__nv_bfloat16>(
        q, k, v, o, w, bh, a, kv_lo, kv_end, split_len, n_split, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
