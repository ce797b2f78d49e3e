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
// defined, so the kernels read the neighbor table alone. A launch stages
// each block's (rho+2k)^3 window straight through the neighbor table (no
// halo tensor in device memory), builds its mask from window_mask(k) gated
// per halo region by the neighbor's existence, runs k substeps on chip on a
// window that shrinks by a ring each substep and writes the rho^3 center
// once.
//
// What bounds them on this card. The function needs its bytes: the state
// read and written once and the neighbor table read once (0.075 ms for
// LIFE3D and 0.283 ms for HEAT3D on the Menger sponge r=6 m=2 at 3.35
// TB/s); its operations take less (about 10 a cell and substep, 0.029 ms
// at k=3 in FP32). The kernels are bound by neither: taken apart on the
// card (tools/ab_kernels3d.py), the first CTA body spent 59 % of the fused
// kernel's 8.5 ms and 83 % of the banded kernel's 21.3 ms in its substeps
// (five divisions, region3 and a mask lookup per cell, 27 shared loads a
// cell for the sum, about 160 for the banded sum on the CUDA cores), a
// third of the fused kernel's in staging (three divisions and region3 per
// staged cell, one-byte loads) and 0.73 ms in the ids and center stores:
// instructions per cell, not bytes. The banded products themselves, as
// the tensor-core body runs them (33 live planes a window at k=3; 24
// 16x8x8 TF32 products a plane for LIFE3D, 64 for HEAT3D in 3xTF32), take
// 0.52 and 1.40 ms at 495 TFLOP/s. The new bodies, taken apart the same
// way, spend most of their time in the substeps' instructions (LIFE3D:
// 1.2 of 2.3 ms and 3.4 of 4.5) and a quarter to a third in the loads of
// the next windows, which one thread a column makes as scattered one-byte
// (LIFE3D) or four-byte loads, three runs a warp row.
//
// Bodies, picked by shape before the launch (fused3_plan and mxu3_plan in
// kernels/squeeze_stencil3d.py; the C entries take the plan's W and
// windows a CTA and only check them):
//   * the column body (column_kernel, the fused kernel for w = rho + 2k <=
//     16 and the rule's own weights: 1 on all 26 directions for the
//     totalistic rules, 1 on the six faces for Heat): a CTA of 256 threads
//     is a W x W grid of window columns (W = 16, or W = 8 and four windows
//     for w <= 8); each thread holds its column's W z-cells in registers
//     across the k substeps, updated in place. The aggregate is
//     weighted_moore_agg3's sum, bit for bit: for the uniform weights the z
//     pass from the thread's own registers, the y pass over the z-sums of
//     the rows above and below (one shared plane of z-sums a substep,
//     written by every thread and read back after one barrier; the two
//     buffers alternate, so one barrier a substep), the x pass by __shfl
//     within the W-lane row, minus the center; for Heat the six faces in
//     MOORE3_DIRS order from zero (the rows above and below through the
//     same plane, x by __shfl, z from the registers). A substep computes
//     the planes [j, W - j) of every column only (j <= 3), unrolled with no
//     branch a cell; each column's halo region, block offsets and mask bits
//     are found once per kernel and gated per window by the existence of
//     its three blocks; a thread loads its column straight into registers
//     (up to three runs at stride rho^2 from the blocks that own its z
//     regions), the next window's loads issued before this window's
//     substeps (a LIFE3D block is 729 bytes at any alignment: staging the
//     27 blocks' runs by 16-byte cp.async over the aligned memory around
//     them into fixed shared slots took fewer loads but more time, and so
//     did giving each CTA a contiguous range of windows); the centers are
//     stored from the registers; a persistent grid, two CTAs an SM.
//   * the tensor-core body (tc_kernel, the banded kernel for w <= 16 and
//     terms with the dz = -1 and +1 operators equal and at most two at dz =
//     0, so three operator groups; every shipped workload's four terms are
//     such): one CTA of 8 warps a window, padded to 16^3 in
//     two float32 window buffers in shared memory (rows 24 floats apart:
//     the fragment loads are free of bank conflicts); warp i owns planes i
//     and i + 8 and keeps their cells in registers in the accumulator
//     layout across the substeps. Per live plane z the aggregate is
//     sum_t (R_t X[z + dz_t]) C_t^T on the tensor cores (mma.sync m16n8k8
//     TF32): the first product's accumulator is the second's A operand as
//     it stands (its K index permuted: column 2t + h at t + 4h, the same
//     permutation in C's B fragment), so Y never leaves the registers; the
//     dz = -1 and +1 terms, their operators equal (LIFE3D's ones band,
//     HEAT3D's identity), are one group on X[z - 1] + X[z + 1]; a warp
//     whose two planes are both live computes them interleaved. The
//     uint8 CA states take one TF32 pass, exact after rintf (every count
//     within 2e-3 of its integer); float32 takes 3xTF32, less the product
//     of an operator's lo part where the operator is exact in TF32. The
//     rule runs in the accumulator layout, the new plane goes to the other
//     buffer, one barrier a substep; the columns of the next window load
//     into registers while this one computes; a persistent grid, one CTA
//     an SM (about 200 registers a thread for LIFE3D, the 255 cap
//     for HEAT3D; chip_smoke.py prints each instance's).
//   * the CTA body (step3_kernel, counted as <name>[wide]): windows over
//     16 cells (rho = 9 at k >= 4, rho = 27), weights of neither form, and
//     terms the tensor-core body does not take. One CTA of 256 threads
//     stages G compact blocks (G fills 4096 window cells for the fused
//     kernel, P macro-tile slots for the banded one) as windows in shared
//     memory and strides over the live cells of each substep between two
//     shared buffers, barrier-joined; the banded sum runs in FP32 FMAs.
//   * its workspace variant (counted as <name>[global]): a CTA body window
//     over 232,448 shared bytes (HEAT3D at rho=27, k >= 2: 2 x 31^3 f32
//     cells; LIFE3D at k=rho=27: 2 x 81^3 cells) keeps the two state
//     buffers in a device workspace the wrapper allocates, 2 G w^3 cells a
//     CTA, and reads the window mask and the operators where they lie in
//     device memory; only the slot ids stay in shared memory. Its grid is
//     persistent and bounded (the wrapper launches at most 2 x 132 CTAs,
//     each looping over its (block group, batch) items), so the workspace
//     stays at 2 x 132 windows however many blocks there are. The buffers
//     are read back within the CTA after a __syncthreads, which orders
//     global memory for the block as it does shared memory.
//
// Compiled with -fmad=false, so the fused kernel's bodies round each
// operation as the plain PyTorch version does (HEAT3D bit-exact); the CTA
// body's banded sum uses explicit fmaf, and mma.sync is not touched.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstdlib>
#include <type_traits>

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

// Conversions between the states and float32 on the FP32 pipe: a uint8 to
// float, an integer-valued float in [0, 256) to its uint8, and rintf of
// |a| <= 2^22 as an int (round to nearest even, as rintf).
__device__ __forceinline__ float u8_to_f32(unsigned v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.f;
}
__device__ __forceinline__ unsigned f32_to_u8(float v) {
  return __float_as_uint(v + 8388608.f) & 0xffu;
}
__device__ __forceinline__ int rint_small(float a) {
  return __float_as_int(a + 12582912.f) - 0x4B400000;
}
__device__ __forceinline__ float to_f32(uint8_t v) { return u8_to_f32(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }
template <class T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (sizeof(T) == 1) return (T)f32_to_u8(v);
  else return v;
}

// The aggregate form of a rule's weights that the column body computes
// (form_holds): 1 on all 26 directions (the totalistic rules), or 1 on the
// six faces and 0 elsewhere (Heat).
enum Form { kUniformUnit = 1, kOrthUnit = 2 };

// `apply` updates one cell of the CTA body; `cell` one cell of the column
// body held in registers (its value and aggregate in A, its mask m 1 or
// 0); `tc_cell` one cell of the tensor-core body in the accumulator layout
// (its value and aggregate in float32).
struct Totalistic {
  using T = uint8_t;
  using A = int;
  static constexpr int kForm = kUniformUnit;
  __device__ static A from_f32(float a) { return (A)rintf(a); }
  __device__ static T apply(T c, A a, int m, const Rule3Args& ra) {
    int set = c > 0 ? ra.survive : ra.born;
    int v = (a >= 0 && a <= kDirs) ? ((set >> a) & 1) : 0;
    return (T)(v * m);
  }
  // a count of 0..26 picks its bit; shr clamps a shift past 31 (any other
  // count, or a negative one as unsigned) to 0
  __device__ static unsigned bit(int set, int a) {
    unsigned b;
    asm("shr.b32 %0, %1, %2;" : "=r"(b) : "r"(set), "r"(a));
    return b;
  }
  __device__ static A cell(A u, A a, unsigned m, const Rule3Args& ra) {
    return (A)(bit(u > 0 ? ra.survive : ra.born, a) & m & 1u);
  }
  __device__ static float tc_cell(float u, float a, unsigned m,
                                  const Rule3Args& ra) {
    const unsigned b =
        bit(u > 0.f ? ra.survive : ra.born, rint_small(a)) & m & 1u;
    return b ? 1.f : 0.f;
  }
};

struct Heat {
  using T = float;
  using A = float;
  static constexpr int kForm = kOrthUnit;
  __device__ static A from_f32(float a) { return a; }
  __device__ static T apply(T u, A a, int m, const Rule3Args& ra) {
    float nx = u + ra.alpha * (a - ra.degree * u);
    return nx * (float)m;
  }
  __device__ static A cell(A u, A a, unsigned m, const Rule3Args& ra) {
    const float nx = u + ra.alpha * (a - ra.degree * u);
    return nx * (m ? 1.f : 0.f);
  }
  __device__ static float tc_cell(float u, float a, unsigned m,
                                  const Rule3Args& ra) {
    return cell(u, a, m, ra);
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


// ---------------------------------------------------------------------
// The column and tensor-core bodies (see the note at the top of the file).
// ---------------------------------------------------------------------
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBodyThreads = 256;   // threads of a column or tc CTA
constexpr int kGroups = 3;          // tc: most operator groups
constexpr int kTcStride = 24;       // tc: floats a plane row (16 + 8 pad)
constexpr int kTcPlane = 16 * kTcStride;   // tc: floats a plane
constexpr int kTcWin = 16 * kTcPlane;      // tc: floats a window buffer

// The launch geometry of the column and tc bodies (the launchers fill it
// in from the plan's W and windows a CTA, G). An item is a group of G
// windows of consecutive blocks of one simulation.
struct BGeom {
  int nb, batch, rho, k, w;
  int groups;          // items of one simulation: ceil(nb / G)
  int n_groups;        // tc: operator groups (<= kGroups): group 0 is term
                       // 0 (dz = -1) on X[z - 1] + X[z + 1], group gi > 0
                       // term gi (dz = 0)
};

__device__ __forceinline__ unsigned low_bits(int n) {
  return n >= 32 ? ~0u : (1u << n) - 1u;
}

// A thread's window column (y, x): for each of the window's three z
// regions (rows [0, k), [k, k + rho), [k + rho, w)) the MOORE3_DIRS index
// of the block that owns it (kSelf: the center), the element of that block
// at z = 0 (so z's element is base + z rho^2) and the region's z bits;
// `inside`: y, x < w.
struct Column {
  int dir[3], base[3];
  unsigned zbits[3];
  bool inside;
};

__device__ __forceinline__ Column column_of(int y, int x, const BGeom& gm) {
  const int rho = gm.rho, k = gm.k;
  Column c;
  c.inside = y < gm.w && x < gm.w;
  const int ry = y < k ? 0 : (y < k + rho ? 1 : 2);
  const int rx = x < k ? 0 : (x < k + rho ? 1 : 2);
  const int yx = (y - k - (ry - 1) * rho) * rho + (x - k - (rx - 1) * rho);
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int raster = (r * 3 + ry) * 3 + rx;
    c.dir[r] = raster < 13 ? raster : (raster == 13 ? kSelf : raster - 1);
    c.base[r] = -(k + (r - 1) * rho) * rho * rho + yx;
  }
  c.zbits[0] = low_bits(k);
  c.zbits[1] = low_bits(k + rho) & ~low_bits(k);
  c.zbits[2] = low_bits(gm.w) & ~low_bits(k + rho);
  return c;
}

// What a CTA works on: group g (blocks g G ..) of simulation b; it is past
// the work when b >= batch.
struct Item {
  int b, g;
};

__device__ __forceinline__ void next_item(Item& it, int stride,
                                          const BGeom& gm) {
  it.g += stride;
  while (it.g >= gm.groups) {
    it.g -= gm.groups;
    ++it.b;
  }
}

// The ids of the blocks that own a column's three z regions in block blk
// of item it (a ghost, nb, past the blocks or the batch).
__device__ __forceinline__ void column_ids(const int* __restrict__ nbr,
                                           const Item& it, int blk,
                                           const Column& c, const BGeom& gm,
                                           int (&ids)[3]) {
  const bool on = it.b < gm.batch && blk < gm.nb;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    ids[r] = !on ? gm.nb
           : c.dir[r] == kSelf ? blk
                               : __ldg(nbr + (size_t)blk * kDirs + c.dir[r]);
}

// A column of a window of simulation b into registers, v[z] for z < W:
// z's element of the block that owns its region, zeros past the window
// and for a ghost block.
template <class T, int W>
__device__ __forceinline__ void load_column(const T* __restrict__ src,
                                            T (&v)[W], const Column& c,
                                            const int (&ids)[3], int b,
                                            const BGeom& gm) {
  const int rho = gm.rho, k = gm.k, rho2 = rho * rho;
  const long long rho3 = (long long)rho2 * rho;
  const long long sim = (long long)b * gm.nb;
  const bool ok0 = c.inside && ids[0] < gm.nb;
  const bool ok1 = c.inside && ids[1] < gm.nb;
  const bool ok2 = c.inside && ids[2] < gm.nb;
  const long long a0 = ok0 ? (sim + ids[0]) * rho3 + c.base[0] : 0;
  const long long a1 = ok1 ? (sim + ids[1]) * rho3 + c.base[1] : 0;
  const long long a2 = ok2 ? (sim + ids[2]) * rho3 + c.base[2] : 0;
#pragma unroll
  for (int z = 0; z < W; ++z) {
    const bool lo = z < k, mid = z < k + rho;
    const bool on = (lo ? ok0 : mid ? ok1 : ok2) && z < gm.w;
    const long long a = lo ? a0 : mid ? a1 : a2;
    v[z] = on ? __ldg(src + a + (long long)z * rho2) : (T)0;
  }
}

// A column's mask bits: window_mask(k)'s bits of the column (wmc) where
// the block that owns the z region exists.
__device__ __forceinline__ unsigned column_mask(const Column& c,
                                                const int (&ids)[3],
                                                unsigned wmc, int nb) {
  unsigned m = 0u;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    if (ids[r] < nb) m |= c.zbits[r];
  return wmc & m;
}

// One substep of the column body: planes [J0, W - J0) of the thread's
// column, in place. Phase one writes each plane's z-sum (the uniform form)
// or value (Heat) into `plane` (this substep's buffer: W planes of W x W);
// after a barrier phase two reads the rows above and below back (at `up`
// and `dn`; `at` is the thread's own) and takes x from the lanes beside
// (__shfl in the W-lane row; a row's edge lanes read their own, and are
// never live). Each sum is weighted_moore_agg3's, in its order. A warp
// none of whose rows is live (`live`: warp-uniform) skips phase two: the
// rows it would compute are never read again.
template <class Rule, int W, int J0>
__device__ __forceinline__ void col_substep(typename Rule::A (&q)[W],
                                            unsigned cmask,
                                            typename Rule::A* plane, int at,
                                            int up, int dn, bool live,
                                            const Rule3Args& ra) {
  using A = typename Rule::A;
  constexpr bool kU = Rule::kForm == kUniformUnit;
  constexpr int WW = W * W;
#pragma unroll
  for (int z = J0; z < W - J0; ++z)
    plane[z * WW + at] = kU ? (q[z - 1] + q[z]) + q[z + 1] : q[z];
  __syncthreads();
  if (!live) return;   // none of the warp's rows is live: nothing to do
  A prev = q[J0 - 1];   // the old value of the plane below
#pragma unroll
  for (int z = J0; z < W - J0; ++z) {
    const A* pz = plane + z * WW;
    const A old = q[z];
    A agg;
    if constexpr (kU) {   // the z-sum again, from the old values
      const A s = (prev + old) + q[z + 1];
      const A row = (pz[up] + s) + pz[dn];
      const A l = __shfl_up_sync(kFull, row, 1, W);
      const A r = __shfl_down_sync(kFull, row, 1, W);
      agg = ((l + row) + r) - old;
    } else {   // MOORE3_DIRS order: z-1, y-1, x-1, x+1, y+1, z+1
      const A l = __shfl_up_sync(kFull, old, 1, W);
      const A r = __shfl_down_sync(kFull, old, 1, W);
      agg = (A)0;
      agg = agg + prev;
      agg = agg + pz[up];
      agg = agg + l;
      agg = agg + r;
      agg = agg + pz[dn];
      agg = agg + q[z + 1];
    }
    q[z] = Rule::cell(old, agg, (cmask >> z) & 1u, ra);
    prev = old;
  }
}

// The fused kernel for windows of w <= W (the column body): a persistent
// grid of CTAs of 256 threads, G = 256 / W^2 windows a CTA; thread q W^2 +
// y W + x holds column (y, x) of window q in registers across the k
// substeps. Its column's halo regions and window-mask bits are found once;
// per window, the ids of the three blocks it reads gate the mask. While a
// window runs its substeps, the next window's columns load into registers
// (nxt) and the ids of the one after. Two plane buffers alternate from
// substep to substep, across windows too, so one barrier a substep orders
// every write and read.
template <class Rule, int W>
__global__ void __launch_bounds__(kBodyThreads, 2)
column_kernel(const typename Rule::T* __restrict__ src,
              typename Rule::T* __restrict__ dst,
              const int* __restrict__ nbr,
              const uint8_t* __restrict__ wmask, BGeom gm, Rule3Args ra) {
  using T = typename Rule::T;
  using A = typename Rule::A;
  constexpr int WW = W * W, G = kBodyThreads / WW, kBuf = G * W * WW;
  const int qw = threadIdx.x / WW, c = threadIdx.x % WW;
  const int y = c / W, x = c % W;
  const int rho = gm.rho, k = gm.k, w = gm.w, rho2 = rho * rho;
  extern __shared__ __align__(16) unsigned char smem[];
  A* const planes = reinterpret_cast<A*>(smem) + qw * W * WW;

  const Column cl = column_of(y, x, gm);
  unsigned wmc = 0u;
#pragma unroll
  for (int z = 0; z < W; ++z)
    if (cl.inside && z < w && wmask[(z * w + y) * w + x]) wmc |= 1u << z;
  const int at = y * W + x;
  const int up = (y > 0 ? y - 1 : y) * W + x;
  const int dn = (y < W - 1 ? y + 1 : y) * W + x;
  const bool center = x >= k && x < k + rho && y >= k && y < k + rho;
  // the rows of this thread's warp: [y0, y0 + 32 / W)
  const int y0 = (threadIdx.x & ~31) % WW / W;

  const int stride = gridDim.x;
  Item it{(int)blockIdx.x / gm.groups, (int)blockIdx.x % gm.groups};
  Item itn = it;
  next_item(itn, stride, gm);
  int ids[3], ids_n[3];
  column_ids(nbr, it, it.g * G + qw, cl, gm, ids);
  column_ids(nbr, itn, itn.g * G + qw, cl, gm, ids_n);
  T nxt[W];
  load_column<T, W>(src, nxt, cl, ids, it.b, gm);
  int par = 0;
  while (it.b < gm.batch) {
    A q[W];
#pragma unroll
    for (int z = 0; z < W; ++z) q[z] = (A)nxt[z];
    const unsigned cmask = column_mask(cl, ids, wmc, gm.nb);
    load_column<T, W>(src, nxt, cl, ids_n, itn.b, gm);
    Item itnn = itn;
    next_item(itnn, stride, gm);
    int ids_nn[3];
    column_ids(nbr, itnn, itnn.g * G + qw, cl, gm, ids_nn);

    for (int j = 1; j <= gm.k; ++j) {  // column substeps
      A* const plane = planes + par * kBuf;
      par ^= 1;
      const bool live = y0 + 32 / W > j && y0 < w - j;
      if (j == 1)
        col_substep<Rule, W, 1>(q, cmask, plane, at, up, dn, live, ra);
      else if (W == 8 || j == 2)
        col_substep<Rule, W, 2>(q, cmask, plane, at, up, dn, live, ra);
      else
        col_substep<Rule, W, 3>(q, cmask, plane, at, up, dn, live, ra);
    }

    const int blk = it.g * G + qw;
    if (center && blk < gm.nb) {
      T* to = dst + ((long long)it.b * gm.nb + blk) * rho2 * rho +
              (y - k) * rho + (x - k);
#pragma unroll
      for (int z = 0; z < W; ++z)
        if (z >= k && z < k + rho) to[(z - k) * rho2] = (T)q[z];
    }
    it = itn;
    itn = itnn;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      ids[r] = ids_n[r];
      ids_n[r] = ids_nn[r];
    }
  }
}

// x rounded to TF32, to nearest with ties away from zero, as
// cvt.rna.tf32.f32 does on this card: half an ulp of TF32 (bit 12) added,
// the 13 low bits left for the tensor cores to ignore (finite x).
__device__ __forceinline__ uint32_t tf32(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// x = hi + lo, both rounded to TF32 by round-to-nearest (hi's low bits
// cleared, so that x - hi is exact); lo is left 0 (never multiplied) in
// the one-pass form.
struct Split {
  uint32_t hi, lo;
};

template <bool X3>
__device__ __forceinline__ Split split(float x) {
  Split s;
  s.hi = X3 ? tf32(x) & 0xffffe000u : tf32(x);
  s.lo = X3 ? tf32(x - __uint_as_float(s.hi)) : 0u;
  return s;
}

// A window value as the first product's B operand: as it is for the
// uint8 CA states (a small integer is exact in TF32), else split.
template <bool X3>
__device__ __forceinline__ Split state_operand(float x) {
  return X3 ? split<true>(x) : Split{__float_as_uint(x), 0u};
}

__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1,
                                    uint32_t a2, uint32_t a3, uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d = a b, the accumulator input zero.
__device__ __forceinline__ void mma0(float (&d)[4], uint32_t a0, uint32_t a1,
                                     uint32_t a2, uint32_t a3, uint32_t b0,
                                     uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "f"(0.f));
}

// d (+)= a b in one TF32 product, or in three (3xTF32: a_lo b_hi + a_hi
// b_lo + a_hi b_hi, the small terms first); `zero` starts d from 0. An
// operand exact in TF32 (a_exact, b_exact: its lo parts all zero) drops
// the product of its lo part.
template <bool X3>
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     const Split (&b)[2], bool zero,
                                     bool a_exact = false,
                                     bool b_exact = false) {
  if (X3) {
    if (!a_exact) {
      if (zero)
        mma0(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
      else
        mma(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
      zero = false;
    }
    if (!b_exact) {
      if (zero)
        mma0(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
      else
        mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
      zero = false;
    }
    if (zero)
      mma0(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
    else
      mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
  } else if (zero) {
    mma0(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
  } else {
    mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
  }
}

// Operator entry op[tau][y][x], zero in the padding past w.
__device__ __forceinline__ float op_at(const float* __restrict__ op, int tau,
                                       int y, int x, int w) {
  return (y < w && x < w) ? __ldg(op + ((size_t)tau * w + y) * w + x) : 0.f;
}

// A lane's operator fragments, loaded once per CTA: per group, R as the
// first product's A operand (k-steps kt: rows g and g + 8, columns 8 kt +
// t and + 4) and C as the second product's B operand (n-tile nt, k-step
// kt: C[8 nt + g][8 kt + 2 t] and [.. + 1], the K index permuted as Y's);
// bit gi of a_exact (b_exact): group gi's R (C) is exact in TF32 (HEAT3D's
// identity, LIFE3D's ones), so 3xTF32 drops its lo product.
template <bool X3>
struct TcOps {
  Split a[kGroups][2][4];
  Split b[kGroups][2][2][2];
  unsigned a_exact, b_exact;
};

template <bool X3>
__device__ __forceinline__ void tc_ops(TcOps<X3>& op,
                                       const float* __restrict__ rop,
                                       const float* __restrict__ cop,
                                       const BGeom& gm, int g, int t) {
  const int w = gm.w;
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    const bool on = gi < gm.n_groups;
#pragma unroll
    for (int kt = 0; kt < 2; ++kt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        op.a[gi][kt][i] = split<X3>(
            on ? op_at(rop, gi, g + 8 * (i & 1), 8 * kt + t + 4 * (i >> 1),
                       w)
               : 0.f);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int kt = 0; kt < 2; ++kt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          op.b[gi][nt][kt][h] = split<X3>(
              on ? op_at(cop, gi, 8 * nt + g, 8 * kt + 2 * t + h, w) : 0.f);
  }
  // bit gi: a lo part of this lane's is not 0 (as TF32: its top 19 bits)
  unsigned al = 0u, bl = 0u;
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (op.a[gi][i >> 2][i & 3].lo & 0xffffe000u) al |= 1u << gi;
      if (op.b[gi][i >> 2][(i >> 1) & 1][i & 1].lo & 0xffffe000u)
        bl |= 1u << gi;
    }
  op.a_exact = ~__reduce_or_sync(kFull, al);
  op.b_exact = ~__reduce_or_sync(kFull, bl);
}

// The aggregates of planes z[p], p in [P0, P0 + NP), of a window (cur: 16
// planes of kTcPlane floats; 1 <= z <= 14) in the accumulator layout:
// e[p][nt][i] at row g + 8 (i >> 1), column 8 nt + 2 t + (i & 1) of plane
// z[p]. Per operator group, Y = R X on the tensor cores (X the group's
// plane z; group 0's X[z - 1] + X[z + 1]), then Y C^T with
// Y's accumulator as the A operand as it stands, summed into e. Two
// planes' products are independent and interleave.
template <bool X3, int P0, int NP>
__device__ __forceinline__ void plane_agg(const float* cur, const int (&z)[2],
                                          const TcOps<X3>& op,
                                          const BGeom& gm, int g, int t,
                                          float (&e)[2][2][4]) {
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi) {
    if (gi >= gm.n_groups) break;
    const bool ax = op.a_exact >> gi & 1u, bx_ = op.b_exact >> gi & 1u;
    float y[2][2][4];
#pragma unroll
    for (int p = P0; p < P0 + NP; ++p) {
      // group 0 at dz = -1 (and +1), the others at dz = 0
      const float* xa = cur + (z[p] - (gi == 0)) * kTcPlane;
      const float* xb = cur + (z[p] + 1) * kTcPlane;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          const int at = (8 * kt + t) * kTcStride + 8 * nt + g;
          float v0 = xa[at], v1 = xa[at + 4 * kTcStride];
          if (gi == 0) {
            v0 = v0 + xb[at];
            v1 = v1 + xb[at + 4 * kTcStride];
          }
          const Split bx[2] = {state_operand<X3>(v0), state_operand<X3>(v1)};
          mma3<X3>(y[p][nt], op.a[gi][kt], bx, kt == 0, ax);
        }
    }
#pragma unroll
    for (int p = P0; p < P0 + NP; ++p)
#pragma unroll
      for (int kt = 0; kt < 2; ++kt) {
        const Split ya[4] = {split<X3>(y[p][kt][0]), split<X3>(y[p][kt][2]),
                             split<X3>(y[p][kt][1]), split<X3>(y[p][kt][3])};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
          mma3<X3>(e[p][nt], ya, op.b[gi][nt][kt], gi == 0 && kt == 0,
                   false, bx_);
      }
  }
}

// The banded kernel for windows of w <= 16 (the tensor-core body): a
// persistent grid of CTAs of 8 warps, a window an item. Each thread loads
// window column (tid / 16, tid % 16) into registers and stages it into
// buffer 0; warp i owns planes i and i + 8, its lane (g, t) their cells
// (row g + 8 (c >> 1), column 8 nt + 2 t + (c & 1)) in registers u[.][4 nt
// + c]. A substep computes each owned live plane's aggregate on the tensor
// cores from the current buffer, applies the rule under the mask and
// writes the new plane into the other buffer; one barrier a substep.
// While a window computes, the next window's columns load into registers.
template <class Rule>
__global__ void __launch_bounds__(kBodyThreads)
tc_kernel(const typename Rule::T* __restrict__ src,
          typename Rule::T* __restrict__ dst, const int* __restrict__ nbr,
          const uint8_t* __restrict__ wmask, const float* __restrict__ rop,
          const float* __restrict__ cop, BGeom gm, Rule3Args ra) {
  using T = typename Rule::T;
  constexpr bool X3 = std::is_same<T, float>::value;   // 3xTF32 for floats
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rho = gm.rho, k = gm.k, w = gm.w, rho2 = rho * rho;
  extern __shared__ __align__(16) float win[];   // buffers 0 and 1
  for (int i = tid; i < 2 * kTcWin; i += kBodyThreads) win[i] = 0.f;

  TcOps<X3> op;
  tc_ops<X3>(op, rop, cop, gm, g, t);
  const int sy = tid >> 4, sx = tid & 15;   // this thread's staged column
  const Column cl = column_of(sy, sx, gm);
  // the owned cells' window-mask bits (bit 8 i + 4 nt + c) and halo
  // regions (raster: rz 9 + ry 3 + rx)
  unsigned pm = 0u;
  int rz9[2], ry3[2], rx[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int z = warp + 8 * i;
    rz9[i] = 9 * (z < k ? 0 : (z < k + rho ? 1 : 2));
    ry3[i] = 3 * ((g + 8 * i) < k ? 0 : ((g + 8 * i) < k + rho ? 1 : 2));
  }
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int xx = 8 * (h >> 1) + 2 * t + (h & 1);
    rx[h] = xx < k ? 0 : (xx < k + rho ? 1 : 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int z = warp + 8 * i, yy = g + 8 * (c >> 1),
                  xx = 8 * nt + 2 * t + (c & 1);
        if (z < w && yy < w && xx < w && wmask[(z * w + yy) * w + xx])
          pm |= 1u << (8 * i + 4 * nt + c);
      }

  const int stride = gridDim.x;
  Item it{(int)blockIdx.x / gm.groups, (int)blockIdx.x % gm.groups};
  Item itn = it;
  next_item(itn, stride, gm);
  int ids[3], ids_n[3];
  column_ids(nbr, it, it.g, cl, gm, ids);
  column_ids(nbr, itn, itn.g, cl, gm, ids_n);
  // lane d < 26 holds direction d of the window's block (its existence)
  const int d = lane < kDirs ? lane : 0;
  int row = __ldg(nbr + (size_t)it.g * kDirs + d);
  int row_n = itn.b < gm.batch ? __ldg(nbr + (size_t)itn.g * kDirs + d)
                               : gm.nb;
  T nxt[16];
  load_column<T, 16>(src, nxt, cl, ids, it.b, gm);
  __syncthreads();   // the buffers are zeroed
  while (it.b < gm.batch) {
#pragma unroll
    for (int z = 0; z < 16; ++z)
      win[z * kTcPlane + sy * kTcStride + sx] = to_f32(nxt[z]);
    // the window's existence bits in raster order, the center set
    const unsigned bal = __ballot_sync(kFull, lane < kDirs && row < gm.nb);
    const unsigned ex = (bal & 0x1fffu) | 0x2000u | ((bal >> 13) << 14);
    load_column<T, 16>(src, nxt, cl, ids_n, itn.b, gm);
    Item itnn = itn;
    next_item(itnn, stride, gm);
    int ids_nn[3];
    column_ids(nbr, itnn, itnn.g, cl, gm, ids_nn);
    const int row_nn = itnn.b < gm.batch
                           ? __ldg(nbr + (size_t)itnn.g * kDirs + d)
                           : gm.nb;
    __syncthreads();

    float u[2][8];
    unsigned mb = 0u;   // the owned cells' masks, bit 8 i + 4 nt + c
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int z = warp + 8 * i, yy = g + 8 * (c >> 1),
                    xx = 8 * nt + 2 * t + (c & 1), bit = 8 * i + 4 * nt + c;
          u[i][4 * nt + c] = win[z * kTcPlane + yy * kTcStride + xx];
          const int reg = rz9[i] + ry3[c >> 1] + rx[2 * nt + (c & 1)];
          mb |= (pm >> bit & ex >> reg & 1u) << bit;
        }

    for (int j = 1; j <= gm.k; ++j) {  // plane substeps
      const float* cur = win + ((j - 1) & 1) * kTcWin;
      float* nw = win + (j & 1) * kTcWin;
      // the owned live planes, both at once where both are live
      const int zr[2] = {warp, warp + 8};
      const bool l0 = warp >= j && warp < w - j;
      const bool l1 = warp + 8 >= j && warp + 8 < w - j;
      float e[2][2][4];
      if (l0 && l1)
        plane_agg<X3, 0, 2>(cur, zr, op, gm, g, t, e);
      else if (l0)
        plane_agg<X3, 0, 1>(cur, zr, op, gm, g, t, e);
      else if (l1)
        plane_agg<X3, 1, 1>(cur, zr, op, gm, g, t, e);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int z = warp + 8 * i;
        if (z < j || z >= w - j) continue;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const unsigned m = mb >> (8 * i + 4 * nt + c) & 1u;
            u[i][4 * nt + c] =
                Rule::tc_cell(u[i][4 * nt + c], e[i][nt][c], m, ra);
          }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(
                nw + z * kTcPlane + (g + 8 * r) * kTcStride + 8 * nt + 2 * t) =
                make_float2(u[i][4 * nt + 2 * r], u[i][4 * nt + 2 * r + 1]);
      }
      __syncthreads();
    }

    // the centers, from the registers
    T* to = dst + ((long long)it.b * gm.nb + it.g) * rho2 * rho;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int z = warp + 8 * i - k, yy = g + 8 * (c >> 1) - k,
                    xx = 8 * nt + 2 * t + (c & 1) - k;
          if (z >= 0 && z < rho && yy >= 0 && yy < rho && xx >= 0 &&
              xx < rho)
            to[(z * rho + yy) * rho + xx] = from_f32<T>(u[i][4 * nt + c]);
        }
    it = itn;
    itn = itnn;
    row = row_n;
    row_n = row_nn;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      ids[r] = ids_n[r];
      ids_n[r] = ids_nn[r];
    }
  }
}

template <class Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Launch `kernel` over a persistent grid: as many CTAs as fit the card at
// once, at most one an item.
template <class Kernel, class... Args>
int launch_persistent(Kernel kernel, size_t smem, long long items,
                      cudaStream_t stream, Args... args) {
  int rc = set_smem(kernel, smem);
  if (rc) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = (int)cudaGetDevice(&dev)) ||
      (rc = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)) ||
      (rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kBodyThreads, smem)))
    return rc;
  const long long ctas = std::min(items, (long long)std::max(per_sm, 1) * sms);
  kernel<<<(unsigned)ctas, kBodyThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The geometry both bodies share, or false where the shapes exceed their
// 32-bit indices (blocks, items and the grid's stride below 2^30).
bool body_geom(BGeom& gm, long long nb, int batch, int rho, int k, int G) {
  if (nb < 1 || batch < 1 || k < 1 || k > rho || nb >= (1LL << 30) ||
      (long long)batch * ((nb + G - 1) / G) >= (1LL << 30))
    return false;
  gm = BGeom{};
  gm.nb = (int)nb;
  gm.batch = batch;
  gm.rho = rho;
  gm.k = k;
  gm.w = rho + 2 * k;
  gm.groups = (int)((nb + G - 1) / G);
  return true;
}

// MOORE3_DIRS index d is a face (one nonzero offset).
bool is_face(int d) {
  const int raster = d < 13 ? d : d + 1;
  return std::abs(raster / 9 - 1) + std::abs(raster / 3 % 3 - 1) +
             std::abs(raster % 3 - 1) == 1;
}

// Whether the 26 weights are form f's (the launcher refuses the column
// body otherwise; fused3_plan gives such weights the CTA body).
bool form_holds(int f, const float* weights) {
  for (int d = 0; d < kDirs; ++d) {
    const float want = f == kUniformUnit ? 1.f : (is_face(d) ? 1.f : 0.f);
    if (weights[d] != want) return false;
  }
  return true;
}

// The fused kernel with the body fused3_plan picked: W = 0 the CTA body
// over G slots (its workspace variant when ws is given), else the column
// body, whose W (8 for w <= 8, else 16, w <= 16) and G (256 / W^2) the
// launcher checks, with the rule's own weights.
template <class Rule>
int launch_fused3(const void* src, void* dst, const int* nbr,
                  const uint8_t* wmask, void* ws, int n_ctas, long long nb,
                  int batch, int rho, int k, int W, int G,
                  const Rule3Args& ra, const float* weights,
                  cudaStream_t stream) {
  using T = typename Rule::T;
  const int w = rho + 2 * k;
  if (W == 0)
    return launch3<Rule, false>(src, dst, nbr, wmask, nullptr, nullptr, ws,
                                n_ctas, nb, batch, rho, k, G, ra, stream);
  BGeom gm;
  if (W != (w <= 8 ? 8 : 16) || w > 16 || G != kBodyThreads / (W * W) ||
      ws != nullptr || !form_holds(Rule::kForm, weights) ||
      !body_geom(gm, nb, batch, rho, k, G))
    return (int)cudaErrorInvalidValue;
  const long long items = (long long)gm.groups * batch;
  const size_t smem = 2 * (size_t)G * W * W * W * sizeof(typename Rule::A);
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  if (W == 8)
    return launch_persistent(column_kernel<Rule, 8>, smem, items, stream, s,
                             d, nbr, wmask, gm, ra);
  return launch_persistent(column_kernel<Rule, 16>, smem, items, stream, s,
                           d, nbr, wmask, gm, ra);
}

// The banded kernel with the body mxu3_plan picked: W = 0 the CTA body over
// P slots (its workspace variant when ws is given), else the tensor-core
// body (W = 16 for w <= 16, one window a CTA, P = 1) over the terms one at
// dz = -1, at most kGroups - 1 at dz = 0 and one at dz = +1, whose
// operators the plan found equal to the dz = -1 term's: the pair is one
// group on X[z - 1] + X[z + 1].
template <class Rule>
int launch_mxu3(const void* src, void* dst, const int* nbr,
                const uint8_t* wmask, const float* rop, const float* cop,
                void* ws, int n_ctas, long long nb, int batch, int rho,
                int k, int P, int W, const Rule3Args& ra,
                cudaStream_t stream) {
  using T = typename Rule::T;
  if (W == 0)
    return launch3<Rule, true>(src, dst, nbr, wmask, rop, cop, ws, n_ctas,
                               nb, batch, rho, k, P, ra, stream);
  const int n = ra.n_terms, t0 = ra.t0, t1 = ra.t1;
  BGeom gm;
  if (W != 16 || rho + 2 * k > 16 || P != 1 || ws != nullptr || t0 != 1 ||
      t1 != n - 1 || n - 1 > kGroups || !body_geom(gm, nb, batch, rho, k, 1))
    return (int)cudaErrorInvalidValue;
  gm.n_groups = n - 1;
  const long long items = (long long)gm.groups * batch;
  const size_t smem = 2 * (size_t)kTcWin * sizeof(float);
  const T* s = static_cast<const T*>(src);
  T* d = static_cast<T*>(dst);
  return launch_persistent(tc_kernel<Rule>, smem, items, stream, s, d, nbr,
                           wmask, rop, cop, gm, ra);
}

Rule3Args make_args3(int born, int survive, float alpha, float degree) {
  Rule3Args ra = {};
  ra.born = born; ra.survive = survive;
  ra.alpha = alpha; ra.degree = degree;
  return ra;
}

}  // namespace

extern "C" {

// 3D v4: k exact steps per launch (1 <= k <= rho) with the body fused3_plan
// picked: W = 0 the CTA body over G blocks a CTA (the 26 weights, MOORE3_DIRS
// order, read from host memory; ws == nullptr holds the windows in shared
// memory, else in ws over n_ctas CTAs), W = 8 or 16 the column body over G
// = 256 / W^2 windows a CTA.
int sq3_step_fused_k(int rule, const void* src, void* dst, const int* nbr,
                     const uint8_t* wmask, long long nb, int batch, int rho,
                     int k, int W, int G, int born, int survive, float alpha,
                     float degree, int uniform, float wu,
                     const float* weights, void* ws, int n_ctas,
                     void* stream) {
  if (G < 1 || k < 1 || k > rho || batch < 1 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  Rule3Args ra = make_args3(born, survive, alpha, degree);
  ra.uniform = uniform;
  ra.wu = wu;
  for (int d = 0; d < kDirs; ++d) ra.w[d] = weights[d];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rule) {
    case 0: return launch_fused3<Totalistic>(src, dst, nbr, wmask, ws,
                                             n_ctas, nb, batch, rho, k, W, G,
                                             ra, weights, s);
    case 1: return launch_fused3<Heat>(src, dst, nbr, wmask, ws, n_ctas, nb,
                                       batch, rho, k, W, G, ra, weights, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// 3D v5: k exact steps per launch, the aggregate as the banded products of
// n_terms rank-1 operators (rop, cop: (n_terms, w, w) f32 on the device,
// ordered by dz: terms [0, t0) at dz = -1, [t0, t1) at 0, [t1, n) at +1),
// with the body mxu3_plan picked: W = 0 the CTA body over P blocks a CTA
// (ws and n_ctas as for sq3_step_fused_k), W = 16 the tensor-core body
// (P = 1; the dz = -1 and +1 terms' operators equal, one term each).
int sq3_step_mxu_k(int rule, const void* src, void* dst, const int* nbr,
                   const uint8_t* wmask, const float* rop, const float* cop,
                   int n_terms, int t0, int t1, long long nb, int batch,
                   int rho, int k, int P, int W, int born,
                   int survive, float alpha, float degree, void* ws,
                   int n_ctas, void* stream) {
  if (n_terms < 1 || n_terms > kMaxTerms || t0 < 0 || t1 < t0 ||
      t1 > n_terms || P < 1 || k < 1 || k > rho || batch < 1 ||
      batch > 65535)
    return (int)cudaErrorInvalidValue;
  Rule3Args ra = make_args3(born, survive, alpha, degree);
  ra.n_terms = n_terms; ra.t0 = t0; ra.t1 = t1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rule) {
    case 0: return launch_mxu3<Totalistic>(src, dst, nbr, wmask, rop, cop, ws,
                                           n_ctas, nb, batch, rho, k, P, W,
                                           ra, s);
    case 1: return launch_mxu3<Heat>(src, dst, nbr, wmask, rop, cop, ws,
                                     n_ctas, nb, batch, rho, k, P, W, ra,
                                     s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
