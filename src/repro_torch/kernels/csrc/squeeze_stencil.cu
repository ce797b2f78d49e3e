// Block-level Squeeze stencil kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU (Pallas) kernels of src/repro/kernels/squeeze_stencil.py:
//   * stencil_step_blocks       (v1, _blocks_kernel)   -> sq_stencil_step_blocks
//   * stencil_step_strips       (v2, _strips_kernel)   -> sq_stencil_step_strips
//   * stencil_step_fused        (v3, _fused_kernel)    -> sq_stencil_step_fused
//   * stencil_step_fused_k      (v4, _fused_k_kernel)  -> sq_stencil_step_fused_k
//   * stencil_step_mxu_batched  (v5, _mxu_kernel)      -> sq_stencil_step_mxu
//   * stencil_step_fused_k_local (v4 on one shard)     ->
//                                               sq_stencil_step_fused_k_local
//   * stencil_step_mxu_k_local   (v5 on one shard)     ->
//                                                 sq_stencil_step_mxu_k_local
//
// State layout: (B, C, nb, rho, rho), contiguous; u8 for the totalistic CA
// rules (int aggregate), f32 for Heat and Gray-Scott. nb is the number of
// compact blocks; neighbor ids come from BlockLayout.neighbor_table (nb, 8)
// in MOORE_DIRS order (NW, N, NE, W, E, SW, S, SE), ghost id == nb reads 0.
// A neighbor "exists" iff its id != nb, which is how existence_table is
// defined, so the kernels read the neighbor table alone.
//
// What bounds them on this card: v1-v4 do a few integer or float operations
// per cell and step, so they are bound by device-memory bytes: each launch
// needs to read the state and the neighbor table once and write the state
// once.
// The design keeps everything else on chip: one CTA stages G compact blocks
// as (rho+2k)^2 windows in shared memory, read straight through the
// neighbor table (no halo tensor in device memory), builds the per-block
// window mask from window_mask(k) and the neighbor existence, runs the k
// substeps between two shared buffers and writes the center once, so the
// bytes per simulated step fall by ~k. G packs several small blocks per CTA
// (rho is 3..9 for the shipped fractals; one block per CTA would leave most
// threads idle); its threads stride over the live cells of each substep.
//
// v1 and v2 are the same one-step kernel with other halo staging. v1, the
// paper's per-block scheme, stages the center block and its 8 Moore-neighbor
// blocks whole (9 rho^2 cells read for rho^2 written, ~9x the v3 reads) and
// assembles the (rho+2)^2 window from them in shared memory. v2 reads the
// center and its row of a (B, C, nb, 4, rho+2) strip tensor gathered before
// the launch (outside the kernel, as XLA gathers it outside the Pallas call);
// it needs no neighbor table. Both step under micro_mask.
//
// v5 computes the Moore aggregate as sum_t (R_t @ X) @ C_t^T, the rank-1
// banded products of the SVD of the 3x3 weights, over P window slots per
// CTA. Its f32 multiply-adds make it bound by operations at small rho.
// The factors are irrational (sqrt(sigma) folded in), so the products run
// in plain f32 FMAs (no TF32 or bf16); each slot uses its own w x w
// operands, never a block-diagonal (P w, P w) matrix, and only the three
// nonzero band entries of each row are visited (the skipped products are
// exact zeros). Integer aggregates are rounded with rintf. It works on the
// whole window at every substep, so each thread owns one slot cell (its
// index arithmetic runs once per launch) and keeps the cell's aggregate in
// registers; the v3/v4 kernel loops instead, which measured faster there.
//
// The two shard-local entries of the distributed engine run the same v4 and
// v5 kernels on one shard's blocks. Their halo comes as four pieces
// assembled before the launch from the exchanged edge strips (top/bottom
// (B, C, nbl, k, rho+2k) rows with the corners, west/east (B, C, nbl, rho,
// k) columns), and an (nbl, 8) int32 existence table takes the neighbor
// table's place: each halo region of window_mask(k) is gated by its row.
// A window reads its pieces whatever the existence says, as the reference
// assembles its padded tile (kPieces staging).
//
// Compiled with -fmad=false so v1-v4 round each operation as the plain
// PyTorch version does; v5 uses explicit fmaf.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // threads of one v1-v4 CTA
constexpr int kCellsPerCta = 1024;      // window cells one v1-v4 CTA holds
constexpr int kMaxThreads = 1024;       // threads of one v5 CTA
constexpr int kMaxCellsPerThread = 8;   // window cells one v5 thread owns
constexpr int kMaxTerms = 3;
constexpr size_t kMaxSmem = 232448;     // shared bytes one Hopper CTA can use

struct RuleArgs {
  int born, survive;       // 9-bit neighbor-count masks (totalistic)
  float p0, p1, p2, p3;    // heat: alpha, degree; gray-scott: du, dv,
                           // feed, feed + kill
  float wd, wc;            // ring weights: diagonal, orthogonal - diagonal
  float wo;                // orthogonal weight (used when wd == 0)
};

// Weighted 8-neighbor aggregate at (y, x) of a w-wide tile, summed in the
// order of workloads/base.py::weighted_moore_agg.
template <class A, class T>
__device__ __forceinline__ A moore_agg(const T* p, int y, int x, int w,
                                       const RuleArgs& ra) {
  const T* up = p + (y - 1) * w;
  const T* mid = p + y * w;
  const T* dn = p + (y + 1) * w;
  if (ra.wd != 0.f) {
    A r0 = (A)up[x - 1] + (A)mid[x - 1] + (A)dn[x - 1];
    A r1 = (A)up[x] + (A)mid[x] + (A)dn[x];
    A r2 = (A)up[x + 1] + (A)mid[x + 1] + (A)dn[x + 1];
    A agg = r0 + r1 + r2 - (A)mid[x];
    if (ra.wd != 1.f) agg = agg * (A)ra.wd;
    if (ra.wc != 0.f) {
      A cross = (A)up[x] + (A)mid[x - 1] + (A)mid[x + 1] + (A)dn[x];
      agg = agg + (ra.wc == 1.f ? cross : cross * (A)ra.wc);
    }
    return agg;
  }
  A agg = (A)0;
  if (ra.wo != 0.f) {  // orthogonal neighbors only, MOORE_DIRS order
    A n = (A)up[x], wv = (A)mid[x - 1], e = (A)mid[x + 1], s = (A)dn[x];
    if (ra.wo != 1.f) {
      n = n * (A)ra.wo; wv = wv * (A)ra.wo;
      e = e * (A)ra.wo; s = s * (A)ra.wo;
    }
    agg = agg + n; agg = agg + wv; agg = agg + e; agg = agg + s;
  }
  return agg;
}

// Each rule updates one cell position (all channels) given its aggregates.
// `cur` and `out` point at channel 0 of one slot; channels are ww apart.
struct Totalistic {
  using T = uint8_t;
  using A = int;
  static constexpr int C = 1;
  __device__ static A from_f32(float a) { return (A)rintf(a); }
  __device__ static void apply(const T* cur, T* out, int i, int ww,
                               const A* agg, int m, const RuleArgs& ra) {
    int set = cur[i] > 0 ? ra.survive : ra.born;
    int a = agg[0];
    int v = (a >= 0 && a <= 8) ? ((set >> a) & 1) : 0;
    out[i] = (T)(v * m);
  }
};

struct Heat {
  using T = float;
  using A = float;
  static constexpr int C = 1;
  __device__ static A from_f32(float a) { return a; }
  __device__ static void apply(const T* cur, T* out, int i, int ww,
                               const A* agg, int m, const RuleArgs& ra) {
    float u = cur[i];
    float nx = u + ra.p0 * (agg[0] - ra.p1 * u);
    out[i] = nx * (float)m;
  }
};

struct GrayScott {
  using T = float;
  using A = float;
  static constexpr int C = 2;
  __device__ static A from_f32(float a) { return a; }
  __device__ static void apply(const T* cur, T* out, int i, int ww,
                               const A* agg, int m, const RuleArgs& ra) {
    float u = cur[i], v = cur[ww + i];
    float lu = agg[0] - u, lv = agg[1] - v;
    float uvv = u * v * v;
    float nu = u + ra.p0 * lu - uvv + ra.p2 * (1.f - u);
    float nv = v + ra.p1 * lv + uvv - ra.p3 * v;
    out[i] = nu * (float)m;
    out[ww + i] = nv * (float)m;
  }
};

// Halo region of window coordinate (y, x): MOORE_DIRS index 0..7, or 8 for
// the center; (ry, rx) in {0, 1, 2} give the block offset (r - 1).
__device__ __forceinline__ int region(int y, int x, int rho, int k, int* ry,
                                      int* rx) {
  *ry = y < k ? 0 : (y < k + rho ? 1 : 2);
  *rx = x < k ? 0 : (x < k + rho ? 1 : 2);
  int raster = *ry * 3 + *rx;
  return raster < 4 ? raster : (raster == 4 ? 8 : raster - 1);
}

// Stage `slots` depth-k windows (all channels) of the blocks whose ids (self
// and 8 neighbors, ghost == nb) are in ids[slot * 9 + d], and the window
// mask, into shared memory.
template <class Rule>
__device__ void load_windows(const typename Rule::T* __restrict__ src,
                             typename Rule::T* buf, const int* ids,
                             int slots, long long nb, int b, int rho,
                             int k) {
  using T = typename Rule::T;
  constexpr int C = Rule::C;
  const int w = rho + 2 * k, ww = w * w;
  const long long cells = (long long)rho * rho;
  for (int t = threadIdx.x; t < slots * ww; t += blockDim.x) {
    int g = t / ww, cell = t - g * ww, y = cell / w, x = cell - y * w;
    int ry, rx;
    int d = region(y, x, rho, k, &ry, &rx);
    long long id = ids[g * 9 + d];
    int sy = y - k - (ry - 1) * rho, sx = x - k - (rx - 1) * rho;
    for (int c = 0; c < C; ++c) {
      T v = (T)0;
      if (id < nb)
        v = src[((long long)b * C + c) * nb * cells + id * cells +
                sy * rho + sx];
      buf[(g * C + c) * ww + cell] = v;
    }
  }
}

// Block ids of `slots` consecutive blocks from blk0 (self at d == 8).
__device__ void load_ids(const int* __restrict__ nbr, int* ids, int slots,
                         long long blk0, long long nb) {
  for (int t = threadIdx.x; t < slots * 9; t += blockDim.x) {
    int g = t / 9, d = t - g * 9;
    long long blk = blk0 + g;
    int id = (int)nb;
    if (blk < nb) id = d == 8 ? (int)blk : nbr[blk * 8 + d];
    ids[t] = id;
  }
}

// Window mask of one slot at cell (y, x): window_mask(k) gated by the
// existence of the neighbor block that owns the cell's halo region.
__device__ __forceinline__ int cell_mask(const uint8_t* wm, const int* ids,
                                         int y, int x, int w, int rho, int k,
                                         long long nb) {
  int ry, rx;
  int d = region(y, x, rho, k, &ry, &rx);
  int exists = d == 8 ? 1 : (ids[d] < nb);
  return wm[y * w + x] * exists;
}

template <class Rule>
__device__ void store_centers(const typename Rule::T* buf, const int* ids,
                              typename Rule::T* __restrict__ dst, int slots,
                              long long blk0, long long nb, int b, int rho,
                              int k) {
  constexpr int C = Rule::C;
  const int w = rho + 2 * k, ww = w * w, cells = rho * rho;
  for (int t = threadIdx.x; t < slots * cells; t += blockDim.x) {
    int g = t / cells, cell = t - g * cells, y = cell / rho,
        x = cell - y * rho;
    long long blk = blk0 + g;
    if (blk >= nb) continue;
    for (int c = 0; c < C; ++c)
      dst[((long long)b * C + c) * nb * cells + blk * cells + cell] =
          buf[(g * C + c) * ww + (y + k) * w + (x + k)];
  }
}

// How a CTA fills its windows: v3/v4 read the depth-k windows straight
// through the neighbor table, v1 stages the nine blocks whole, v2 reads the
// pre-gathered strips (v1 and v2 take k == 1).
// kPieces (the shard-local entries) reads the window from the center block
// and four pre-assembled halo pieces, and the region existence from an
// (nb, 8) table.
enum Halo { kInKernel = 0, kWholeBlocks = 1, kStrips = 2, kPieces = 3 };

// The halo pieces of the shard-local entries, (B, C, nb, ...) contiguous,
// and the (nb, 8) int32 existence table.
struct Pieces {
  const void* top;   // (B, C, nb, k, rho+2k): window rows [0, k)
  const void* bot;   // (B, C, nb, k, rho+2k): window rows [k+rho, w)
  const void* west;  // (B, C, nb, rho, k): window columns [0, k)
  const void* east;  // (B, C, nb, rho, k): window columns [k+rho, w)
  const int* ex;
};

// The ids of `slots` blocks from blk0 as load_ids gives them, from an
// existence table: self at d == 8, 0 for a neighbor that exists and the
// ghost id nb for one that does not (only `id < nb` is read).
__device__ void load_ex_ids(const int* __restrict__ ex, int* ids, int slots,
                            long long blk0, long long nb) {
  for (int t = threadIdx.x; t < slots * 9; t += blockDim.x) {
    int g = t / 9, d = t - g * 9;
    long long blk = blk0 + g;
    int id = (int)nb;
    if (blk < nb) id = d == 8 ? (int)blk : (ex[blk * 8 + d] ? 0 : (int)nb);
    ids[t] = id;
  }
}

// Window cell (y, x) of the block and channel row sc = (b * C + c) * nb +
// blk: a halo piece in the frame, the center block inside.
template <class T>
__device__ __forceinline__ T piece_at(const T* __restrict__ src,
                                      const Pieces& pc, long long sc, int y,
                                      int x, int rho, int k) {
  const int w = rho + 2 * k;
  if (y < k) return static_cast<const T*>(pc.top)[sc * k * w + y * w + x];
  if (y >= k + rho)
    return static_cast<const T*>(pc.bot)[sc * k * w + (y - k - rho) * w + x];
  if (x < k)
    return static_cast<const T*>(pc.west)[sc * rho * k + (y - k) * k + x];
  if (x >= k + rho)
    return static_cast<const T*>(pc.east)[sc * rho * k + (y - k) * k +
                                          (x - k - rho)];
  return src[sc * rho * rho + (y - k) * rho + (x - k)];
}

// kPieces: `slots` depth-k windows (all channels) from the pieces.
template <class Rule>
__device__ void load_pieces(const typename Rule::T* __restrict__ src,
                            const Pieces& pc, typename Rule::T* buf,
                            int slots, long long blk0, long long nb, int b,
                            int rho, int k) {
  constexpr int C = Rule::C;
  const int w = rho + 2 * k, ww = w * w;
  for (int t = threadIdx.x; t < slots * ww; t += blockDim.x) {
    int g = t / ww, cell = t - g * ww, y = cell / w, x = cell - y * w;
    for (int c = 0; c < C; ++c)
      buf[(g * C + c) * ww + cell] = piece_at(
          src, pc, ((long long)b * C + c) * nb + blk0 + g, y, x, rho, k);
  }
}

// v1: the center and its 8 Moore-neighbor blocks of each slot, whole, into
// `nine` (slots, 9, C, rho^2), a ghost as a zero block; then each
// (rho+2)^2 window is assembled from them.
template <class Rule>
__device__ void load_blocks(const typename Rule::T* __restrict__ src,
                            typename Rule::T* nine, typename Rule::T* buf,
                            const int* ids, int slots, long long nb, int b,
                            int rho) {
  using T = typename Rule::T;
  constexpr int C = Rule::C;
  const int w = rho + 2, ww = w * w, cells = rho * rho;
  for (int t = threadIdx.x; t < slots * 9 * C * cells; t += blockDim.x) {
    int cell = t % cells, rest = t / cells;
    int c = rest % C, gd = rest / C;  // gd = g * 9 + d
    long long id = ids[gd];
    nine[t] = id < nb ? src[((long long)b * C + c) * nb * cells +
                            id * cells + cell]
                      : (T)0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < slots * ww; t += blockDim.x) {
    int g = t / ww, cell = t - g * ww, y = cell / w, x = cell - y * w;
    int ry, rx;
    int d = region(y, x, rho, 1, &ry, &rx);
    int sy = y - 1 - (ry - 1) * rho, sx = x - 1 - (rx - 1) * rho;
    for (int c = 0; c < C; ++c)
      buf[(g * C + c) * ww + cell] =
          nine[((g * 9 + d) * C + c) * cells + sy * rho + sx];
  }
}

// v2: each (rho+2)^2 window from the center block and its strips
// (B, C, nb, 4, rho+2): row 0 the top row with both corners, row 1 the
// bottom row, rows 2 and 3 the west and east columns (first rho entries).
template <class Rule>
__device__ void load_strips(const typename Rule::T* __restrict__ src,
                            const typename Rule::T* __restrict__ strips,
                            typename Rule::T* buf, int slots, long long blk0,
                            long long nb, int b, int rho) {
  constexpr int C = Rule::C;
  const int w = rho + 2, ww = w * w;
  const long long cells = (long long)rho * rho;
  for (int t = threadIdx.x; t < slots * ww; t += blockDim.x) {
    int g = t / ww, cell = t - g * ww, y = cell / w, x = cell - y * w;
    long long blk = blk0 + g;
    for (int c = 0; c < C; ++c) {
      long long sc = ((long long)b * C + c) * nb + blk;
      const typename Rule::T* st = strips + sc * 4 * w;
      typename Rule::T v;
      if (y == 0) v = st[x];
      else if (y == w - 1) v = st[w + x];
      else if (x == 0) v = st[2 * w + y - 1];
      else if (x == w - 1) v = st[3 * w + y - 1];
      else v = src[sc * cells + (y - 1) * rho + (x - 1)];
      buf[(g * C + c) * ww + cell] = v;
    }
  }
}

// v1-v4: grid (ceil(nb / G), B); G compact blocks per CTA; k substeps on a
// shrinking window between two shared buffers. `mask` is window_mask(k)
// for v3/v4 (and the shard-local v4) and micro_mask (rho, rho) for v1/v2,
// placed at the window's center (k == 1 updates only the center).
template <class Rule, int H>
__global__ void __launch_bounds__(kThreads)
step_kernel(const typename Rule::T* __restrict__ src,
            typename Rule::T* __restrict__ dst, const int* __restrict__ nbr,
            const typename Rule::T* __restrict__ strips,
            const uint8_t* __restrict__ mask, long long nb, int rho, int k,
            int G, Pieces pc, RuleArgs ra) {
  using T = typename Rule::T;
  using A = typename Rule::A;
  constexpr int C = Rule::C;
  const int w = rho + 2 * k, ww = w * w;
  extern __shared__ __align__(16) unsigned char smem[];
  T* buf0 = reinterpret_cast<T*>(smem);
  T* buf1 = buf0 + (size_t)G * C * ww;
  T* nine = buf1 + (size_t)G * C * ww;  // v1 only
  const size_t tiles = (size_t)G * C *
      (2 * ww + (H == kWholeBlocks ? 9 * rho * rho : 0)) * sizeof(T);
  int* ids = reinterpret_cast<int*>(smem + ((tiles + 15) & ~(size_t)15));
  uint8_t* wm = reinterpret_cast<uint8_t*>(ids + G * 9);

  const long long blk0 = (long long)blockIdx.x * G;
  const int b = blockIdx.y;
  const int slots = (int)min((long long)G, nb - blk0);
  if constexpr (H == kPieces)
    load_ex_ids(pc.ex, ids, slots, blk0, nb);
  else if constexpr (H != kStrips)
    load_ids(nbr, ids, slots, blk0, nb);
  for (int t = threadIdx.x; t < ww; t += blockDim.x) {
    if constexpr (H == kInKernel || H == kPieces) {
      wm[t] = mask[t];
    } else {
      int y = t / w - 1, x = t % w - 1;
      wm[t] = (y >= 0 && y < rho && x >= 0 && x < rho) ? mask[y * rho + x]
                                                       : 0;
    }
  }
  __syncthreads();
  if constexpr (H == kInKernel)
    load_windows<Rule>(src, buf0, ids, slots, nb, b, rho, k);
  else if constexpr (H == kWholeBlocks)
    load_blocks<Rule>(src, nine, buf0, ids, slots, nb, b, rho);
  else if constexpr (H == kPieces)
    load_pieces<Rule>(src, pc, buf0, slots, blk0, nb, b, rho, k);
  else
    load_strips<Rule>(src, strips, buf0, slots, blk0, nb, b, rho);
  __syncthreads();

  T* cur = buf0;
  T* nxt = buf1;
  for (int j = 1; j <= k; ++j) {
    const int lo = j, span = w - 2 * j, area = span * span;
    for (int t = threadIdx.x; t < slots * area; t += blockDim.x) {
      int g = t / area, a = t - g * area;
      int y = lo + a / span, x = lo + a % span;
      const T* tile = cur + (size_t)g * C * ww;
      A agg[C];
      for (int c = 0; c < C; ++c)
        agg[c] = moore_agg<A>(tile + c * ww, y, x, w, ra);
      int m = cell_mask(wm, ids + g * 9, y, x, w, rho, k, nb);
      Rule::apply(tile, nxt + (size_t)g * C * ww, y * w + x, ww, agg, m,
                  ra);
    }
    __syncthreads();
    T* tmp = cur; cur = nxt; nxt = tmp;
  }
  store_centers<Rule>(cur, ids, dst, slots, blk0, nb, b, rho, k);
}

// The window cells one thread owns, t = threadIdx.x + i * blockDim.x for
// i < CPT, over `slots` windows of w x w cells. The index arithmetic runs
// once here, not in the substep loops. Each cell's mask is window_mask(k)
// gated by the existence of the block that owns its halo region.
template <int CPT>
struct Cells {
  int g[CPT], y[CPT], x[CPT], cell[CPT], m[CPT];
  bool on[CPT];
};

template <class Rule, int CPT, int H>
__device__ void stage(Cells<CPT>& cs, const typename Rule::T* __restrict__ src,
                      const Pieces& pc, typename Rule::T* buf, const int* ids,
                      const uint8_t* __restrict__ wmask, int slots,
                      long long blk0, long long nb, int b, int rho, int k) {
  using T = typename Rule::T;
  constexpr int C = Rule::C;
  const int w = rho + 2 * k, ww = w * w;
  const long long cells = (long long)rho * rho;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    int t = threadIdx.x + i * blockDim.x;
    cs.on[i] = t < slots * ww;
    int g = t / ww, cell = t - g * ww, y = cell / w;
    cs.g[i] = g; cs.cell[i] = cell; cs.y[i] = y; cs.x[i] = cell - y * w;
    cs.m[i] = 0;
    if (!cs.on[i]) continue;
    int ry, rx;
    int d = region(y, cs.x[i], rho, k, &ry, &rx);
    long long id = ids[g * 9 + d];
    int sy = y - k - (ry - 1) * rho, sx = cs.x[i] - k - (rx - 1) * rho;
    cs.m[i] = wmask[cell] * (d == 8 || id < nb);
    for (int c = 0; c < C; ++c) {
      T v = (T)0;
      if constexpr (H == kPieces) {
        if (blk0 + g < nb)
          v = piece_at(src, pc, ((long long)b * C + c) * nb + blk0 + g, y,
                       cs.x[i], rho, k);
      } else if (id < nb) {
        v = src[((long long)b * C + c) * nb * cells + id * cells +
                sy * rho + sx];
      }
      buf[(g * C + c) * ww + cell] = v;
    }
  }
}

template <class Rule, int CPT>
__device__ void store_cells(const Cells<CPT>& cs,
                            const typename Rule::T* buf,
                            typename Rule::T* __restrict__ dst,
                            long long blk0, long long nb, int b, int rho,
                            int k) {
  constexpr int C = Rule::C;
  const int w = rho + 2 * k, ww = w * w;
  const long long cells = (long long)rho * rho;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    int y = cs.y[i] - k, x = cs.x[i] - k;
    long long blk = blk0 + cs.g[i];
    if (!cs.on[i] || y < 0 || y >= rho || x < 0 || x >= rho || blk >= nb)
      continue;
    for (int c = 0; c < C; ++c)
      dst[((long long)b * C + c) * nb * cells + blk * cells + y * rho + x] =
          buf[(cs.g[i] * C + c) * ww + cs.cell[i]];
  }
}

// v5: grid (n_macro, B); P window slots per CTA, one thread per slot cell
// (CPT cells when the slots exceed the CTA); each substep computes the
// aggregate of the whole window as sum_t (R_t @ X) @ C_t^T in f32, kept in
// registers, and updates the window in place. Slot borders pick up
// truncated-band values ring by ring; the center sits at distance >= k
// from them and is exact. H is kInKernel (windows read through the
// neighbor table) or kPieces (the shard-local entry).
template <class Rule, int CPT, int H>
__global__ void __launch_bounds__(kMaxThreads)
mxu_kernel(const typename Rule::T* __restrict__ src,
           typename Rule::T* __restrict__ dst, const int* __restrict__ nbr,
           const uint8_t* __restrict__ wmask,
           const float* __restrict__ rop, const float* __restrict__ cop,
           int n_terms, long long nb, int rho, int k, int P, Pieces pc,
           RuleArgs ra) {
  using T = typename Rule::T;
  using A = typename Rule::A;
  constexpr int C = Rule::C;
  const int w = rho + 2 * k, ww = w * w;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ybuf = reinterpret_cast<float*>(smem);      // (P, C, ww)
  float* rs = ybuf + (size_t)P * C * ww;             // (T, ww)
  float* cs_op = rs + (size_t)n_terms * ww;          // (T, ww)
  T* cur = reinterpret_cast<T*>(cs_op + (size_t)n_terms * ww);  // (P, C, ww)
  int* ids = reinterpret_cast<int*>(
      reinterpret_cast<unsigned char*>(cur) +
      (((size_t)P * C * ww * sizeof(T) + 15) & ~(size_t)15));

  const long long blk0 = (long long)blockIdx.x * P;
  const int b = blockIdx.y;
  if constexpr (H == kPieces)
    load_ex_ids(pc.ex, ids, P, blk0, nb);
  else
    load_ids(nbr, ids, P, blk0, nb);
  for (int t = threadIdx.x; t < n_terms * ww; t += blockDim.x) {
    rs[t] = rop[t];
    cs_op[t] = cop[t];
  }
  __syncthreads();
  Cells<CPT> cs;
  stage<Rule, CPT, H>(cs, src, pc, cur, ids, wmask, P, blk0, nb, b, rho, k);
  __syncthreads();

  for (int j = 0; j < k; ++j) {
    float acc[CPT][C];
#pragma unroll
    for (int i = 0; i < CPT; ++i)
      for (int c = 0; c < C; ++c) acc[i][c] = 0.f;
    for (int term = 0; term < n_terms; ++term) {
      const float* R = rs + term * ww;
      const float* Cm = cs_op + term * ww;
      // Y = R_t @ X, per slot and channel
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        if (!cs.on[i]) continue;
        int y = cs.y[i], x = cs.x[i];
        int lo = max(0, y - 1), hi = min(w - 1, y + 1);
        for (int c = 0; c < C; ++c) {
          const T* X = cur + (size_t)(cs.g[i] * C + c) * ww;
          float s = 0.f;
          for (int ii = lo; ii <= hi; ++ii)
            s = fmaf(R[y * w + ii], (float)X[ii * w + x], s);
          ybuf[(cs.g[i] * C + c) * ww + cs.cell[i]] = s;
        }
      }
      __syncthreads();
      // acc += Y @ C_t^T
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        if (!cs.on[i]) continue;
        int y = cs.y[i], x = cs.x[i];
        int lo = max(0, x - 1), hi = min(w - 1, x + 1);
        for (int c = 0; c < C; ++c) {
          const float* Y = ybuf + (size_t)(cs.g[i] * C + c) * ww + y * w;
          float s = 0.f;
          for (int ii = lo; ii <= hi; ++ii)
            s = fmaf(Y[ii], Cm[x * w + ii], s);
          acc[i][c] = acc[i][c] + s;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (!cs.on[i]) continue;
      A agg[C];
      for (int c = 0; c < C; ++c) agg[c] = Rule::from_f32(acc[i][c]);
      T* tile = cur + (size_t)cs.g[i] * C * ww;
      Rule::apply(tile, tile, cs.cell[i], ww, agg, cs.m[i], ra);
    }
    __syncthreads();
  }
  store_cells<Rule, CPT>(cs, cur, dst, blk0, nb, b, rho, k);
}

RuleArgs make_args(int born, int survive, float p0, float p1, float p2,
                   float p3, float wd, float wo, float wc) {
  RuleArgs ra;
  ra.born = born; ra.survive = survive;
  ra.p0 = p0; ra.p1 = p1; ra.p2 = p2; ra.p3 = p3;
  ra.wd = wd; ra.wo = wo; ra.wc = wc;
  return ra;
}

template <class Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <class Rule, int H>
int launch_step(const void* src, void* dst, const int* nbr,
                const void* strips, const uint8_t* mask, const Pieces& pc,
                long long nb, int batch, int rho, int k, const RuleArgs& ra,
                cudaStream_t stream) {
  using T = typename Rule::T;
  const int w = rho + 2 * k, ww = w * w;
  int G = kCellsPerCta / ww;
  if (G < 1) G = 1;
  if (G > nb) G = (int)nb;
  size_t tiles = (size_t)G * Rule::C *
      (2 * ww + (H == kWholeBlocks ? 9 * rho * rho : 0)) * sizeof(T);
  size_t smem = ((tiles + 15) & ~(size_t)15) + (size_t)G * 9 * sizeof(int) +
                ww;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = step_kernel<Rule, H>;
  int rc = set_smem(kernel, smem);
  if (rc) return rc;
  dim3 grid((unsigned)((nb + G - 1) / G), (unsigned)batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), nbr,
      static_cast<const T*>(strips), mask, nb, rho, k, G, pc, ra);
  return (int)cudaGetLastError();
}

// Threads for `cells` window cells: one per cell up to kMaxThreads, in
// whole warps; *cpt receives the cells each thread owns.
int threads_for(long long cells, int* cpt) {
  long long threads = cells < kMaxThreads ? cells : kMaxThreads;
  threads = (threads + 31) / 32 * 32;
  *cpt = (int)((cells + threads - 1) / threads);
  return (int)threads;
}

template <class Rule, int CPT, int H>
int launch_mxu_cpt(const void* src, void* dst, const int* nbr,
                   const uint8_t* wmask, const float* rop, const float* cop,
                   int n_terms, long long nb, int batch, int rho, int k,
                   int P, int threads, const Pieces& pc, const RuleArgs& ra,
                   cudaStream_t stream) {
  using T = typename Rule::T;
  const int ww = (rho + 2 * k) * (rho + 2 * k);
  size_t cur_bytes = ((size_t)P * Rule::C * ww * sizeof(T) + 15) &
                     ~(size_t)15;
  size_t smem = (size_t)(P * Rule::C + 2 * n_terms) * ww * sizeof(float) +
                cur_bytes + (size_t)P * 9 * sizeof(int);
  auto kernel = mxu_kernel<Rule, CPT, H>;
  int rc = set_smem(kernel, smem);
  if (rc) return rc;
  dim3 grid((unsigned)((nb + P - 1) / P), (unsigned)batch);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), nbr, wmask, rop, cop,
      n_terms, nb, rho, k, P, pc, ra);
  return (int)cudaGetLastError();
}

template <class Rule, int H>
int launch_mxu(const void* src, void* dst, const int* nbr,
               const uint8_t* wmask, const float* rop, const float* cop,
               int n_terms, long long nb, int batch, int rho, int k, int P,
               const Pieces& pc, const RuleArgs& ra, cudaStream_t stream) {
  const int ww = (rho + 2 * k) * (rho + 2 * k);
  int cpt;
  int threads = threads_for((long long)P * ww, &cpt);
#define SQ_LAUNCH_MXU(CPT)                                                  \
  launch_mxu_cpt<Rule, CPT, H>(src, dst, nbr, wmask, rop, cop, n_terms, nb, \
                               batch, rho, k, P, threads, pc, ra, stream)
  switch (cpt) {
    case 1: return SQ_LAUNCH_MXU(1);
    case 2: return SQ_LAUNCH_MXU(2);
    case 3: case 4: return SQ_LAUNCH_MXU(4);
    default:
      if (cpt <= kMaxCellsPerThread) return SQ_LAUNCH_MXU(kMaxCellsPerThread);
      return (int)cudaErrorInvalidValue;
  }
#undef SQ_LAUNCH_MXU
}

template <int H>
int step_entry(int rule, const void* src, void* dst, const int* nbr,
               const void* strips, const uint8_t* mask, const Pieces& pc,
               long long nb, int batch, int rho, int k, int born, int survive,
               float p0, float p1, float p2, float p3, float wd, float wo,
               float wc, void* stream) {
  RuleArgs ra = make_args(born, survive, p0, p1, p2, p3, wd, wo, wc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rule) {
    case 0: return launch_step<Totalistic, H>(src, dst, nbr, strips, mask, pc,
                                              nb, batch, rho, k, ra, s);
    case 1: return launch_step<Heat, H>(src, dst, nbr, strips, mask, pc, nb,
                                        batch, rho, k, ra, s);
    case 2: return launch_step<GrayScott, H>(src, dst, nbr, strips, mask, pc,
                                             nb, batch, rho, k, ra, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int H>
int mxu_entry(int rule, const void* src, void* dst, const int* nbr,
              const uint8_t* wmask, const float* rop, const float* cop,
              int n_terms, long long nb, int batch, int rho, int k, int P,
              const Pieces& pc, int born, int survive, float p0, float p1,
              float p2, float p3, float wd, float wo, float wc,
              void* stream) {
  if (n_terms < 1 || n_terms > kMaxTerms) return (int)cudaErrorInvalidValue;
  RuleArgs ra = make_args(born, survive, p0, p1, p2, p3, wd, wo, wc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rule) {
    case 0: return launch_mxu<Totalistic, H>(src, dst, nbr, wmask, rop, cop,
                                             n_terms, nb, batch, rho, k, P,
                                             pc, ra, s);
    case 1: return launch_mxu<Heat, H>(src, dst, nbr, wmask, rop, cop, n_terms,
                                       nb, batch, rho, k, P, pc, ra, s);
    case 2: return launch_mxu<GrayScott, H>(src, dst, nbr, wmask, rop, cop,
                                            n_terms, nb, batch, rho, k, P, pc,
                                            ra, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// v1: one step, the center and its 8 neighbor blocks staged whole.
int sq_stencil_step_blocks(int rule, const void* src, void* dst,
                           const int* nbr, const uint8_t* micro,
                           long long nb, int batch, int rho, int born,
                           int survive, float p0, float p1, float p2,
                           float p3, float wd, float wo, float wc,
                           void* stream) {
  return step_entry<kWholeBlocks>(rule, src, dst, nbr, nullptr, micro,
                                  Pieces{}, nb, batch, rho, 1, born, survive,
                                  p0, p1, p2, p3, wd, wo, wc, stream);
}

// v2: one step from the center and its pre-gathered strips.
int sq_stencil_step_strips(int rule, const void* src, void* dst,
                           const void* strips, const uint8_t* micro,
                           long long nb, int batch, int rho, int born,
                           int survive, float p0, float p1, float p2,
                           float p3, float wd, float wo, float wc,
                           void* stream) {
  return step_entry<kStrips>(rule, src, dst, nullptr, strips, micro,
                             Pieces{}, nb, batch, rho, 1, born, survive, p0,
                             p1, p2, p3, wd, wo, wc, stream);
}

// v3: one step (k = 1 instance of the fused kernel).
int sq_stencil_step_fused(int rule, const void* src, void* dst,
                          const int* nbr, const uint8_t* wmask, long long nb,
                          int batch, int rho, int born, int survive,
                          float p0, float p1, float p2, float p3, float wd,
                          float wo, float wc, void* stream) {
  return step_entry<kInKernel>(rule, src, dst, nbr, nullptr, wmask, Pieces{},
                               nb, batch, rho, 1, born, survive, p0, p1, p2,
                               p3, wd, wo, wc, stream);
}

// v4: k exact steps per launch, 1 <= k <= rho.
int sq_stencil_step_fused_k(int rule, const void* src, void* dst,
                            const int* nbr, const uint8_t* wmask,
                            long long nb, int batch, int rho, int k,
                            int born, int survive, float p0, float p1,
                            float p2, float p3, float wd, float wo, float wc,
                            void* stream) {
  return step_entry<kInKernel>(rule, src, dst, nbr, nullptr, wmask, Pieces{},
                               nb, batch, rho, k, born, survive, p0, p1, p2,
                               p3, wd, wo, wc, stream);
}

// v5: k exact steps per launch over a (n_macro, B) grid of P-slot CTAs.
int sq_stencil_step_mxu(int rule, const void* src, void* dst, const int* nbr,
                        const uint8_t* wmask, const float* rop,
                        const float* cop, int n_terms, long long nb,
                        int batch, int rho, int k, int P, int born,
                        int survive, float p0, float p1, float p2, float p3,
                        float wd, float wo, float wc, void* stream) {
  return mxu_entry<kInKernel>(rule, src, dst, nbr, wmask, rop, cop, n_terms,
                              nb, batch, rho, k, P, Pieces{}, born, survive,
                              p0, p1, p2, p3, wd, wo, wc, stream);
}

// Shard-local v4: k exact steps of the nbl blocks of one shard from their
// halo pieces and existence table, 1 <= k <= rho.
int sq_stencil_step_fused_k_local(int rule, const void* src, void* dst,
                                  const void* top, const void* bot,
                                  const void* west, const void* east,
                                  const int* ex, const uint8_t* wmask,
                                  long long nbl, int batch, int rho, int k,
                                  int born, int survive, float p0, float p1,
                                  float p2, float p3, float wd, float wo,
                                  float wc, void* stream) {
  return step_entry<kPieces>(rule, src, dst, nullptr, nullptr, wmask,
                             Pieces{top, bot, west, east, ex}, nbl, batch,
                             rho, k, born, survive, p0, p1, p2, p3, wd, wo,
                             wc, stream);
}

// Shard-local v5: k exact steps of B simulations over the nbl blocks of one
// shard, P slots per CTA, from their halo pieces and existence table.
int sq_stencil_step_mxu_k_local(int rule, const void* src, void* dst,
                                const void* top, const void* bot,
                                const void* west, const void* east,
                                const int* ex, const uint8_t* wmask,
                                const float* rop, const float* cop,
                                int n_terms, long long nbl, int batch, int rho,
                                int k, int P, int born, int survive, float p0,
                                float p1, float p2, float p3, float wd,
                                float wo, float wc, void* stream) {
  return mxu_entry<kPieces>(rule, src, dst, nullptr, wmask, rop, cop, n_terms,
                            nbl, batch, rho, k, P,
                            Pieces{top, bot, west, east, ex}, born, survive,
                            p0, p1, p2, p3, wd, wo, wc, stream);
}

}  // extern "C"
