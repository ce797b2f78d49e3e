// Flash attention forward for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernel src/repro/kernels/attention.py::
// flash_attention (body _flash_kernel) -> sq_flash_attention.
//
// q (BH, Sq, D), k and v (BH, Sk, D), float32 or bfloat16, contiguous; out
// (BH, Sq, D) in q's type. Scores are float32 dot products times `scale`,
// optionally softcap * tanh(s / softcap); query i sits at position
// i + Sk - Sq (right-aligned, so Sq = 1 decodes against a long cache); the
// causal mask keeps kpos <= qpos, the window kpos > qpos - window; masked
// scores are -1e30 (not -inf), as the reference sets them. Online softmax
// with a running max m, a denominator l and a float32 accumulator, and the
// output acc / max(l, 1e-30), as _flash_kernel computes it.
//
// On the TPU the kv blocks are the innermost, sequential grid axis with m, l
// and acc in VMEM scratch. Here a CTA owns kBQ = 64 query rows of one
// (batch, head), grid (ceil(Sq / 64), B * H), and loops over 64-row kv tiles
// itself. The Q tile, one K tile, one V tile (converted to float32 on load,
// zero past D and past Sk) and the tile's probabilities live in shared
// memory: 211 KB at D = 256, the gemma2-2b head width. A tile is loaded
// with 16-byte loads, eight in flight per thread before the first lands in
// shared memory, so that it waits about one memory latency, not one per
// element (one element a load where D or the alignment does not allow
// 16-byte loads). 256 threads: thread
// (ty, tx) owns query rows 4 ty .. 4 ty + 3, the scores of keys tx + 16 j
// (j < 4) and the output columns 4 (tx + 16 g) .. + 3; a row's max and sum
// are reduced over its 16 threads by warp shuffles. All arithmetic is FP32
// on the CUDA cores (explicit fmaf, accurate expf and tanhf): TF32 tensor
// cores cannot hold the float32 bar of 2e-5. What bounds it on this card:
// the 4 D operations of each visible (query, key) pair, against the FP32
// rate of 67 TFLOP/s (989 TFLOP/s for bf16 on the tensor cores, a later
// version's route); the bytes (Q, K, V and O once) are 40-100x less.
//
// Fully masked kv tiles are skipped only where that cannot change a row: a
// masked key adds exp(-1e30 - m) = 0 once the row has seen a visible key,
// and before that its weight is wiped by alpha = exp(-1e30 - m) = 0. A row
// that sees no key at all (causal with Sq > Sk, or a window that hides
// every key) gets the mean of v over all Sk keys in the reference (every
// score -1e30, so exp(0) = 1 each); a CTA holding such a row visits every kv
// tile and computes it the same way. Keys past Sk in the last tile are not
// keys: their score is -inf, their weight 0.
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

}  // namespace

extern "C" {

// dtype 0: float32, 1: bfloat16. q (bh, sq, d), k and v (bh, sk, d), o like
// q; 1 <= d <= 256, bh <= 65535; has_window / has_softcap select the window
// and the softcap.
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

}  // extern "C"
