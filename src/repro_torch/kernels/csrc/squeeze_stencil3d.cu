// 3D block-level Squeeze stencil kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels of src/repro/kernels/squeeze_stencil3d.py:
//   * stencil3d_step_fused_k (_fused3_k_kernel, 3D v4) -> sq3_step_fused_k
//   * stencil3d_step_mxu_k   (_mxu3_kernel, 3D v5)     -> sq3_step_mxu_k
//
// State layout: (B, nb, rho, rho, rho), contiguous, indexed [b, blk, z, y, x];
// u8 for the totalistic CA rules (int aggregate), f32 for Heat. Neighbor ids
// come from BlockLayout3D.neighbor_table (nb, 26) in MOORE3_DIRS order (dz
// slowest, dx fastest, the center skipped); ghost id == nb reads 0, and a
// neighbor "exists" iff its id != nb, which is how existence_table is
// defined, so the kernels read the neighbor table alone.
//
// What bounds them on this card: a launch must read the state and the
// neighbor table once and write the state once; the work per cell is a few
// dozen operations, so device-memory bytes bound the function. The reference
// gathers six face slabs with XLA before each call (_gather_halo3_k); here
// one CTA stages G compact blocks as (rho+2k)^3 windows in shared memory
// straight through the neighbor table (no halo tensor in device memory),
// builds each window's mask from window_mask(k) gated per halo region by the
// neighbor's existence, runs the k substeps on a shrinking window between two
// shared buffers and writes the rho^3 center once. G fills kCellsPerCta
// window cells (one block at rho=9, k >= 2); the CTA's threads stride over
// the live cells of each substep. Shared bytes are 2 G (rho+2k)^3 state
// cells plus the window mask: about 10 KB (LIFE3D) and 30 KB (HEAT3D) at
// rho=9, k=3.
//
// A window over 232,448 shared bytes (HEAT3D at rho=27, k >= 2: 2 x 31^3 f32
// cells; LIFE3D at k=rho=27: 2 x 81^3 cells) takes the second instance of the
// same kernel body, kGlobal: the two state buffers live in a device workspace
// the wrapper allocates, 2 G w^3 cells a CTA, and the window mask and the mxu
// operators are read where they lie in device memory; only the slot ids stay
// in shared memory. Its grid is persistent and bounded (the wrapper launches
// at most 2 x 132 CTAs, each looping over its (block group, batch) items), so
// the workspace stays at 2 x 132 windows however many blocks there are (280
// MB for LIFE3D at k=27). The buffers are read back within the CTA after a
// __syncthreads, which orders global memory for the block as it does shared
// memory, and most of a window stays in L1/L2 between substeps.
//
// The two kernels differ only in the aggregate. The fused kernel sums the 26
// neighbors as workloads/base.py::weighted_moore_agg3 does: a uniform weight
// set by the separable z, y, x passes minus the center, any other set in
// MOORE3_DIRS order from zero. The mxu kernel computes the z-slab banded
// products sum_t R_t @ X[z + dz_t] @ C_t^T of the per-plane rank-1 factors
// (weight_factors3) in f32 FMAs on the CUDA cores: per output cell, per term,
// the three band entries of (R_t @ X)[y, x'] for x' in x-1..x+1, then their
// product with C_t's band; rintf gives the integer aggregate. Its P slots per
// CTA are the G above, chosen by BlockLayout3D.macro_tiles. Only the live
// cells of each substep are computed: they never read a truncated band or a
// z-shift past the window, so the center equals the whole-window form.
//
// Compiled with -fmad=false, so the fused kernel rounds each operation as the
// plain PyTorch version does (HEAT3D bit-exact); the mxu kernel uses
// explicit fmaf.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;         // threads of one CTA
constexpr int kDirs = 26;             // 3D Moore directions
constexpr int kIds = kDirs + 1;       // ids of one slot: 26 neighbors + self
constexpr int kSelf = kDirs;          // index of the slot's own id
constexpr int kMaxTerms = 9;          // rank-1 terms: <= 3 per z-plane
constexpr size_t kMaxSmem = 232448;   // shared bytes one Hopper CTA can use

struct Rule3Args {
  int born, survive;     // 27-bit neighbor-count masks (totalistic)
  float alpha, degree;   // heat
  int uniform;           // all 26 weights equal to wu: the separable sum
  float wu;
  float w[kDirs];        // weights in MOORE3_DIRS order (per-direction sum)
  int n_terms, t0, t1;   // mxu: dz = -1 for t < t0, 0 for t < t1, else +1
};

struct Totalistic {
  using T = uint8_t;
  using A = int;
  __device__ static A from_f32(float a) { return (A)rintf(a); }
  __device__ static T apply(T c, A a, int m, const Rule3Args& ra) {
    int set = c > 0 ? ra.survive : ra.born;
    int v = (a >= 0 && a <= kDirs) ? ((set >> a) & 1) : 0;
    return (T)(v * m);
  }
};

struct Heat {
  using T = float;
  using A = float;
  __device__ static A from_f32(float a) { return a; }
  __device__ static T apply(T u, A a, int m, const Rule3Args& ra) {
    float nx = u + ra.alpha * (a - ra.degree * u);
    return nx * (float)m;
  }
};

// Weighted 26-neighbor aggregate at (z, y, x) of a w^3 window, summed in the
// order of workloads/base.py::weighted_moore_agg3.
template <class A, class T>
__device__ __forceinline__ A moore_agg3(const T* p, int z, int y, int x,
                                        int w, const Rule3Args& ra) {
  const int ww = w * w;
  const T* c = p + z * ww + y * w + x;
  if (ra.uniform) {
    A rows[3];
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      A sl[3];
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
        const T* q = c + dy * w + dx;
        sl[dy + 1] = ((A)q[-ww] + (A)q[0]) + (A)q[ww];   // z pass
      }
      rows[dx + 1] = (sl[0] + sl[1]) + sl[2];            // y pass
    }
    A agg = ((rows[0] + rows[1]) + rows[2]) - (A)c[0];  // x pass, center
    if (ra.wu != 1.f) agg = agg * (A)ra.wu;
    return agg;
  }
  A agg = (A)0;
  int d = 0;
#pragma unroll
  for (int dz = -1; dz <= 1; ++dz)
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (dz == 0 && dy == 0 && dx == 0) continue;
        const float wt = ra.w[d++];
        if (wt == 0.f) continue;
        A v = (A)c[dz * ww + dy * w + dx];
        agg = agg + (wt == 1.f ? v : v * (A)wt);
      }
  return agg;
}

// The mxu aggregate at (z, y, x): sum over the rank-1 terms t of
// (R_t @ X[z + dz_t] @ C_t^T)[y, x], R_t and C_t (w, w) banded.
template <class T>
__device__ __forceinline__ float banded_agg3(const T* p, int z, int y, int x,
                                             int w, const float* rs,
                                             const float* cs,
                                             const Rule3Args& ra) {
  const int ww = w * w;
  const int ylo = max(0, y - 1), yhi = min(w - 1, y + 1);
  const int xlo = max(0, x - 1), xhi = min(w - 1, x + 1);
  float acc = 0.f;
  for (int t = 0; t < ra.n_terms; ++t) {
    const int dz = t < ra.t0 ? -1 : (t < ra.t1 ? 0 : 1);
    const T* X = p + (z + dz) * ww;
    const float* R = rs + t * ww + y * w;
    const float* Cm = cs + t * ww + x * w;
    float s = 0.f;
    for (int xx = xlo; xx <= xhi; ++xx) {
      float yv = 0.f;
      for (int yy = ylo; yy <= yhi; ++yy)
        yv = fmaf(R[yy], (float)X[yy * w + xx], yv);
      s = fmaf(yv, Cm[xx], s);
    }
    acc = acc + s;
  }
  return acc;
}

// Halo region of window cell (z, y, x): MOORE3_DIRS index 0..25, or kSelf
// for the center; (rz, ry, rx) in {0, 1, 2} give the block offset (r - 1).
__device__ __forceinline__ int region3(int z, int y, int x, int rho, int k,
                                       int* rz, int* ry, int* rx) {
  *rz = z < k ? 0 : (z < k + rho ? 1 : 2);
  *ry = y < k ? 0 : (y < k + rho ? 1 : 2);
  *rx = x < k ? 0 : (x < k + rho ? 1 : 2);
  const int raster = (*rz * 3 + *ry) * 3 + *rx;
  return raster < 13 ? raster : (raster == 13 ? kSelf : raster - 1);
}

// Offsets of the dynamic shared memory: the two state buffers, the mxu
// operators, the slot ids and the window mask. The host launch computes the
// same layout (and the wrapper in kernels/squeeze_stencil3d.py its size).
struct Smem3 {
  size_t rs, cs, ids, wm, total;
};

__host__ __device__ inline Smem3 smem3(int G, int w, int n_terms,
                                       size_t tsize) {
  const size_t www = (size_t)w * w * w, ww = (size_t)w * w;
  Smem3 s;
  size_t off = (2 * (size_t)G * www * tsize + 15) & ~(size_t)15;
  s.rs = off; off += (size_t)n_terms * ww * sizeof(float);
  s.cs = off; off += (size_t)n_terms * ww * sizeof(float);
  s.ids = off; off += (size_t)G * kIds * sizeof(int);
  s.wm = off; off += www;
  s.total = off;
  return s;
}

// Shared-memory variant: grid (ceil(nb / G), B), one item per CTA, every
// buffer in dynamic shared memory. Global variant (kGlobal): grid (n_ctas),
// each CTA looping over the (block group, batch) items with its own slice
// of the workspace ws, the window mask and the mxu operators read where
// they lie in device memory, the slot ids in shared memory. An item: G
// compact blocks of simulation b from blk0, staged as windows in buf0 (from
// the slot ids), k substeps on a shrinking window between buf0 and buf1,
// the centers written to dst; kBanded picks the mxu aggregate. ws and
// batch come after ra: placed before it, ptxas spilled in the shared HEAT3D
// mxu instance, 1-3 % slower on an H100.
template <class Rule, bool kBanded, bool kGlobal>
__global__ void __launch_bounds__(kThreads)
step3_kernel(const typename Rule::T* __restrict__ src,
             typename Rule::T* __restrict__ dst, const int* __restrict__ nbr,
             const uint8_t* __restrict__ wmask,
             const float* __restrict__ rop, const float* __restrict__ cop,
             long long nb, int rho, int k, int G, Rule3Args ra,
             typename Rule::T* __restrict__ ws, int batch) {
  using T = typename Rule::T;
  using A = typename Rule::A;
  const int w = rho + 2 * k, ww = w * w, www = ww * w;
  const long long cells = (long long)rho * rho * rho;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf0;
  const float* rs;
  const float* cs;
  const uint8_t* wm;
  int* ids;
  if constexpr (kGlobal) {
    buf0 = ws + (size_t)blockIdx.x * 2 * G * www;
    rs = rop;
    cs = cop;
    wm = wmask;
    ids = reinterpret_cast<int*>(smem);
  } else {
    const Smem3 lay = smem3(G, w, kBanded ? ra.n_terms : 0, sizeof(T));
    buf0 = reinterpret_cast<T*>(smem);
    float* rsw = reinterpret_cast<float*>(smem + lay.rs);
    float* csw = reinterpret_cast<float*>(smem + lay.cs);
    uint8_t* wmw = smem + lay.wm;
    for (int t = threadIdx.x; t < www; t += blockDim.x) wmw[t] = wmask[t];
    if (kBanded)
      for (int t = threadIdx.x; t < ra.n_terms * ww; t += blockDim.x) {
        rsw[t] = rop[t];
        csw[t] = cop[t];
      }
    rs = rsw;
    cs = csw;
    wm = wmw;
    ids = reinterpret_cast<int*>(smem + lay.ids);
  }
  T* buf1 = buf0 + (size_t)G * www;
  const long long n_groups = (nb + G - 1) / G;
  const long long n_items = kGlobal ? n_groups * batch : 1;
  for (long long item = kGlobal ? blockIdx.x : 0; item < n_items;
       item += kGlobal ? gridDim.x : 1) {
    const long long blk0 =
        kGlobal ? item % n_groups * G : (long long)blockIdx.x * G;
    const int b = kGlobal ? (int)(item / n_groups) : (int)blockIdx.y;
    const int slots = (int)min((long long)G, nb - blk0);
    for (int t = threadIdx.x; t < slots * kIds; t += blockDim.x) {
      const int g = t / kIds, d = t - g * kIds;
      const long long blk = blk0 + g;
      ids[t] = d == kSelf ? (int)blk : nbr[blk * kDirs + d];
    }
    __syncthreads();

    // stage the windows, a ghost neighbor as zeros
    for (int t = threadIdx.x; t < slots * www; t += blockDim.x) {
      const int g = t / www, cell = t - g * www;
      const int z = cell / ww, rem = cell - z * ww, y = rem / w,
                x = rem - y * w;
      int rz, ry, rx;
      const int d = region3(z, y, x, rho, k, &rz, &ry, &rx);
      const long long id = ids[g * kIds + d];
      const int sz = z - k - (rz - 1) * rho, sy = y - k - (ry - 1) * rho,
                sx = x - k - (rx - 1) * rho;
      T v = (T)0;
      if (id < nb)
        v = src[((long long)b * nb + id) * cells + ((long long)sz * rho + sy) *
                                                       rho + sx];
      buf0[(size_t)g * www + cell] = v;
    }
    __syncthreads();

    T* cur = buf0;
    T* nxt = buf1;
    for (int j = 1; j <= k; ++j) {
      const int span = w - 2 * j, area = span * span, vol = area * span;
      for (int t = threadIdx.x; t < slots * vol; t += blockDim.x) {
        const int g = t / vol, a = t - g * vol;
        const int z = j + a / area, a2 = a % area;
        const int y = j + a2 / span, x = j + a2 % span;
        const T* tile = cur + (size_t)g * www;
        A agg;
        if constexpr (kBanded)
          agg = Rule::from_f32(banded_agg3(tile, z, y, x, w, rs, cs, ra));
        else
          agg = moore_agg3<A>(tile, z, y, x, w, ra);
        int rz, ry, rx;
        const int d = region3(z, y, x, rho, k, &rz, &ry, &rx);
        const int cell = (z * w + y) * w + x;
        const int m = wm[cell] * (d == kSelf || ids[g * kIds + d] < nb);
        nxt[(size_t)g * www + cell] = Rule::apply(tile[cell], agg, m, ra);
      }
      __syncthreads();
      T* tmp = cur; cur = nxt; nxt = tmp;
    }

    // write the rho^3 centers
    for (int t = threadIdx.x; t < slots * cells; t += blockDim.x) {
      const int g = t / (int)cells, c = t - g * (int)cells;
      const int z = c / (rho * rho), rem = c - z * rho * rho, y = rem / rho,
                x = rem - y * rho;
      dst[((long long)b * nb + blk0 + g) * cells + c] =
          cur[(size_t)g * www + ((z + k) * w + (y + k)) * w + (x + k)];
    }
    if constexpr (kGlobal) __syncthreads();  // the next item overwrites
  }
}

// ws == nullptr: the shared-memory variant; else the global variant over
// n_ctas CTAs, ws holding n_ctas x 2 G (rho+2k)^3 cells.
template <class Rule, bool kBanded>
int launch3(const void* src, void* dst, const int* nbr, const uint8_t* wmask,
            const float* rop, const float* cop, void* ws, int n_ctas,
            long long nb, int batch, int rho, int k, int G,
            const Rule3Args& ra, cudaStream_t stream) {
  using T = typename Rule::T;
  if (G < 1 || k < 1 || k > rho || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (ws != nullptr) {
    if (n_ctas < 1) return (int)cudaErrorInvalidValue;
    step3_kernel<Rule, kBanded, true>
        <<<n_ctas, kThreads, (size_t)G * kIds * sizeof(int), stream>>>(
            static_cast<const T*>(src), static_cast<T*>(dst), nbr, wmask,
            rop, cop, nb, rho, k, G, ra, static_cast<T*>(ws), batch);
    return (int)cudaGetLastError();
  }
  const size_t smem = smem3(G, rho + 2 * k, kBanded ? ra.n_terms : 0,
                            sizeof(T)).total;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = step3_kernel<Rule, kBanded, false>;
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  dim3 grid((unsigned)((nb + G - 1) / G), (unsigned)batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), nbr, wmask, rop, cop,
      nb, rho, k, G, ra, nullptr, batch);
  return (int)cudaGetLastError();
}

template <bool kBanded>
int entry3(int rule, const void* src, void* dst, const int* nbr,
           const uint8_t* wmask, const float* rop, const float* cop,
           void* ws, int n_ctas, long long nb, int batch, int rho, int k,
           int G, const Rule3Args& ra, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rule) {
    case 0: return launch3<Totalistic, kBanded>(src, dst, nbr, wmask, rop, cop,
                                                ws, n_ctas, nb, batch, rho, k,
                                                G, ra, s);
    case 1: return launch3<Heat, kBanded>(src, dst, nbr, wmask, rop, cop, ws,
                                          n_ctas, nb, batch, rho, k, G, ra,
                                          s);
    default: return (int)cudaErrorInvalidValue;
  }
}

Rule3Args make_args3(int born, int survive, float alpha, float degree) {
  Rule3Args ra = {};
  ra.born = born; ra.survive = survive;
  ra.alpha = alpha; ra.degree = degree;
  return ra;
}

}  // namespace

extern "C" {

// 3D v4: k exact steps per launch (1 <= k <= rho), G blocks per CTA; the
// 26 weights (MOORE3_DIRS order) are read from host memory. ws == nullptr
// holds the windows in shared memory, else in ws over n_ctas CTAs.
int sq3_step_fused_k(int rule, const void* src, void* dst, const int* nbr,
                     const uint8_t* wmask, long long nb, int batch, int rho,
                     int k, int G, int born, int survive, float alpha,
                     float degree, int uniform, float wu,
                     const float* weights, void* ws, int n_ctas,
                     void* stream) {
  Rule3Args ra = make_args3(born, survive, alpha, degree);
  ra.uniform = uniform;
  ra.wu = wu;
  for (int d = 0; d < kDirs; ++d) ra.w[d] = weights[d];
  return entry3<false>(rule, src, dst, nbr, wmask, nullptr, nullptr, ws,
                       n_ctas, nb, batch, rho, k, G, ra, stream);
}

// 3D v5: k exact steps per launch, the aggregate as the banded products of
// n_terms rank-1 operators (rop, cop: (n_terms, w, w) f32 on the device,
// ordered by dz: terms [0, t0) at dz = -1, [t0, t1) at 0, [t1, n) at +1),
// P blocks per CTA; ws and n_ctas as for sq3_step_fused_k.
int sq3_step_mxu_k(int rule, const void* src, void* dst, const int* nbr,
                   const uint8_t* wmask, const float* rop, const float* cop,
                   int n_terms, int t0, int t1, long long nb, int batch,
                   int rho, int k, int P, int born, int survive, float alpha,
                   float degree, void* ws, int n_ctas, void* stream) {
  if (n_terms < 1 || n_terms > kMaxTerms || t0 < 0 || t1 < t0 ||
      t1 > n_terms)
    return (int)cudaErrorInvalidValue;
  Rule3Args ra = make_args3(born, survive, alpha, degree);
  ra.n_terms = n_terms; ra.t0 = t0; ra.t1 = t1;
  return entry3<true>(rule, src, dst, nbr, wmask, rop, cop, ws, n_ctas, nb,
                      batch, rho, k, P, ra, stream);
}

}  // extern "C"
