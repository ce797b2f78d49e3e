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
// per cell and step, so the least they need is device-memory bytes: each
// launch reads the state and the neighbor table once and writes the state
// once. Both designs keep everything else on chip: each window is read
// straight through the neighbor table (no halo tensor in device memory),
// its mask built from window_mask(k) and the neighbor existence, its k
// substeps run on chip and its center written once, so the bytes per
// simulated step fall by ~k.
//
// The CTA body (step_kernel: v1-v4 and kernel 6 for windows over 32 cells
// or ring weights that are not their rule's, their [wide] instance): one
// CTA of 256 threads stages G compact blocks as (rho+2k)^2 windows in
// shared memory and runs the k substeps between two shared buffers, its
// threads striding over the live cells of each substep, the phases joined
// by block-wide barriers. Taken apart on the card (tools/ab_fused.py) it
// spends v4's time on index arithmetic per cell (divisions by runtime w,
// span and area, region() per cell), one-byte staging loads and the
// barriers, some 30x over its bytes.
//
// The warp body (warp_kernel: v4 and kernel 6 for windows of w <= 32
// cells, and v3, v4 at k = 1; fused_plan in squeeze_stencil.py picks the
// body and its geometry, the launcher checks them) does per cell only the
// arithmetic of the stencil:
//   * lanes are window columns and registers window rows: a warp holds
//     32 / W windows (W the power of two >= max(w, 8): 4, 2 or 1), each
//     lane its column's w cells of every channel, across the k substeps;
//   * the aggregate's vertical sums are taken in the lane, the left and
//     right ones come from the lanes beside it (__shfl with width W),
//     summed in weighted_moore_agg's order, so the float rules stay bit
//     for bit; only the sum of the rule's own weights is compiled (1 on
//     both rings for the CA rules, 1 orthogonal for heat, two scaled rings
//     for Gray-Scott); rows update in place, the old row above carried
//     along;
//   * each lane's staged element per row and its column's mask bits (by
//     halo region, gated per window by one ballot of the existence) are
//     computed once per kernel: no division or region() per cell, and one
//     shared load a row;
//   * a warp stages its group's blocks into a fixed layout of a
//     warp-private buffer with 16-byte cp.async loads where aligned: the
//     group's centers as one contiguous run, each window's 8 neighbors by
//     the 8 lanes that hold their ids (a lane a block), or, for kernel 6,
//     the group's five contiguous piece runs, the next group's loads in
//     flight while this group computes; the neighbor ids of four windows
//     come as one coalesced load; centers are stored from the registers; a
//     persistent grid, no block-wide barrier. Loading each distinct block
//     once (__match_any_sync and a block list) moved fewer bytes but took
//     more instructions than it saved.
//
// Every k = 1 launch runs an instance compiled at k = 1 (the substep loop
// fixed; runtime k kept v1's loop at 877 instructions). At k = 1 only the
// window's center is computed, and no existence gates it, so its mask is
// the center's bits alone and no ballot of the neighbor ids is taken. v3
// is v4 at k = 1: v4's staging (the centers as one run, of each neighbor
// block only the loads that hold the row or column its window reads)
// under window_mask(1). v1 and v2 are one step under micro_mask on the
// same warp body (windows of w = rho + 2 <= 32 cells; step_plan in
// squeeze_stencil.py picks W and the warps, other ring weights take the
// CTA body) with other halo staging, both into a fixed layout, no division
// or region() per cell:
//   * v1 (kWholeBlocks), the paper's per-block scheme, stages the center
//     block and its 8 Moore-neighbor blocks whole (9 rho^2 cells read for
//     rho^2 written): the group's centers as one run, each neighbor by the
//     lane that holds its id, 16-byte cp.async where aligned, so the 9x
//     read amplification falls on L2 and not on instructions; a lane reads
//     its column's rows from the staged blocks through offsets computed
//     once per kernel;
//   * v2 (kStrips) reads the center and its row of a (B, C, nb, 4, rho+2)
//     strip tensor gathered before the launch (outside the step, as XLA
//     gathers it outside the Pallas call), no neighbor table: a group's
//     centers and its strips are two contiguous runs, each staged with
//     16-byte cp.async where the run is aligned (narrower loads where it is
//     not, as at rho = 3 uint8).
// The gather (gather_kernel, sq_gather_halo_strips) is one launch, a thread
// a block: its 8 neighbor ids as two 16-byte loads, each neighbor's edge
// (a block of 16 bytes, as rho = 4 uint8, in one aligned 16-byte load, the
// edge picked in registers), its 4 (rho + 2) elements stored as 8-byte
// words; a ghost neighbor, or a direction the workload never reads, gives
// zeros.
//
// v5 computes each window slot's Moore aggregate as sum_t (R_t X) C_t^T,
// the rank-1 banded products of the SVD of the 3x3 weights (two terms for
// every shipped workload), for P slots per CTA work item. What bounds it
// is not bytes (it reads each state byte about 9 times from L2, 0.23 ms of
// device memory at the r=16 LIFE shape) nor its products (0.32 ms at the
// tensor cores' TF32 rate) but the instructions and shared-memory accesses
// each slot costs: a thread per window cell with f32 FMA band passes and
// block-wide barriers took 35 ms there. The design:
//   * the products on the tensor cores, mma.sync m16n8k8 TF32: the two
//     terms' R stacked in M ([R_0; R_1] X gives Y_0 and Y_1 of one slot);
//     that accumulator is the second product's A operand as it stands,
//     with two slots stacked in M and the K index permuted (column 2t + h
//     at t + 4h, the same permutation in the operators' B fragment), so Y
//     never leaves the registers; windows wider than 8 cells are padded to
//     W = 8 ceil(w / 8) with zero operator rows and columns, and only the
//     band tiles (|I - J| <= 1) are multiplied;
//   * precision by state type: the uint8 CA states take one TF32 pass (X
//     in {0, 1} is exact; the operators and Y rounded to nearest); every
//     one of the 512 Moore patterns then aggregates within 1.2e-3 of its
//     count at w = 5..12 (numpy emulation, tests/test_torch_mxu.py), far
//     inside rintf's 0.5, so CA states are bit-exact. float32 takes
//     3xTF32 (a = a_hi + a_lo, a_lo b_hi + a_hi b_lo + a_hi b_hi), within
//     6.4e-7 of the float64 aggregate for HEAT and GRAY_SCOTT;
//   * a warp per pair of slots, CTAs of up to 8 warps in a persistent grid
//     over the (simulation, macro-tile) items: each warp stages its pair's
//     nine whole blocks (or the four halo pieces) with 16-byte cp.async
//     loads where aligned, the next pair's neighbor ids loading while this
//     pair computes, keeps its own cells in registers across the k
//     substeps, exchanges the rest through two window buffers of its own
//     and stores whole center rows; no block-wide barrier at all.
// Conversions between u8 and f32 and the rounding of the aggregate run on
// the FP32 pipe (the conversion instructions run at a quarter of its rate).
// The wide instance (W > 8) runs the same products tile by tile with
// everything read at the point of use.
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
// Compiled with -fmad=false so v1-v4 and the rules round each operation as
// the plain PyTorch version does; it does not touch mma.
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <numeric>
#include <type_traits>

namespace {

constexpr int kThreads = 256;           // threads of one v1-v4 CTA
constexpr int kCellsPerCta = 1024;      // window cells one v1-v4 CTA holds
constexpr int kMxuWarps = 8;            // most warps of one v5 CTA
constexpr int kMaxTerms = 2;     // rank-1 terms of ring-uniform weights
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

// Conversions between the states and float32 on the FP32 pipe (the
// conversion instructions run at a quarter of its rate): a uint8 to float,
// an integer-valued float in [0, 256) to its uint8, and rintf of |a| <=
// 2^22 as an int (round to nearest even, as rintf).
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

// Each rule updates one cell position (all channels) given its aggregates.
// `cur` and `out` point at channel 0 of one slot; channels are ww apart.
// `update` is the same on one cell held in registers (v5), its mask m 1.f
// or 0.f.
// `cell` is the same on one cell held in a lane's registers (v4 and kernel
// 6), its value and aggregate in A, its mask m 1 or 0; `kForm` is the
// aggregate's sum for the weights the rule's workloads have (AggForm): the
// warp body computes that sum only (form_holds).
enum AggForm { kRingUnit = 1, kOrthUnit = 2, kRingScaled = 3 };

struct Totalistic {
  using T = uint8_t;
  using A = int;
  static constexpr int C = 1;
  static constexpr int kForm = kRingUnit;
  __device__ static void cell(const A* u, const A* agg, unsigned m,
                              const RuleArgs& ra, A* out) {
    const int set = u[0] > 0 ? ra.survive : ra.born;
    // a count of 0..26 picks its bit; shr clamps a shift past 31 (any
    // other count, or a negative one as unsigned) to 0
    unsigned bit;
    asm("shr.b32 %0, %1, %2;" : "=r"(bit) : "r"(set), "r"(agg[0]));
    out[0] = (int)(bit & m & 1u);
  }
  __device__ static void apply(const T* cur, T* out, int i, int ww,
                               const A* agg, int m, const RuleArgs& ra) {
    int set = cur[i] > 0 ? ra.survive : ra.born;
    int a = agg[0];
    int v = (a >= 0 && a <= 8) ? ((set >> a) & 1) : 0;
    out[i] = (T)(v * m);
  }
  __device__ static void update(const float* u, const float* agg, float m,
                                const RuleArgs& ra, float* out) {
    int set = u[0] > 0.f ? ra.survive : ra.born;
    int a = rint_small(agg[0]);   // the aggregate rounded, as rintf
    int v = (a >= 0 && a <= 8) ? ((set >> a) & 1) : 0;
    out[0] = v ? m : 0.f;
  }
};

struct Heat {
  using T = float;
  using A = float;
  static constexpr int C = 1;
  static constexpr int kForm = kOrthUnit;
  __device__ static void cell(const A* u, const A* agg, unsigned m,
                              const RuleArgs& ra, A* out) {
    update(u, agg, m ? 1.f : 0.f, ra, out);
  }
  __device__ static void apply(const T* cur, T* out, int i, int ww,
                               const A* agg, int m, const RuleArgs& ra) {
    float u = cur[i];
    float nx = u + ra.p0 * (agg[0] - ra.p1 * u);
    out[i] = nx * (float)m;
  }
  __device__ static void update(const float* u, const float* agg, float m,
                                const RuleArgs& ra, float* out) {
    float nx = u[0] + ra.p0 * (agg[0] - ra.p1 * u[0]);
    out[0] = nx * m;
  }
};

struct GrayScott {
  using T = float;
  using A = float;
  static constexpr int C = 2;
  static constexpr int kForm = kRingScaled;
  __device__ static void cell(const A* u, const A* agg, unsigned m,
                              const RuleArgs& ra, A* out) {
    update(u, agg, m ? 1.f : 0.f, ra, out);
  }
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
  __device__ static void update(const float* u, const float* agg, float m,
                                const RuleArgs& ra, float* out) {
    float lu = agg[0] - u[0], lv = agg[1] - u[1];
    float uvv = u[0] * u[1] * u[1];
    float nu = u[0] + ra.p0 * lu - uvv + ra.p2 * (1.f - u[0]);
    float nv = u[1] + ra.p1 * lv + uvv - ra.p3 * u[1];
    out[0] = nu * m;
    out[1] = nv * m;
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
// and the (nb, 8) int32 existence table; v2's strips (kStrips).
struct Pieces {
  const void* top;   // (B, C, nb, k, rho+2k): window rows [0, k)
  const void* bot;   // (B, C, nb, k, rho+2k): window rows [k+rho, w)
  const void* west;  // (B, C, nb, rho, k): window columns [0, k)
  const void* east;  // (B, C, nb, rho, k): window columns [k+rho, w)
  const int* ex;
  const void* strips;  // (B, C, nb, 4, rho+2)
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

// ---------------------------------------------------------------------
// v5 on the tensor cores (see the note at the top of the file).
// ---------------------------------------------------------------------
constexpr unsigned kFull = 0xffffffffu;

// The launch geometry (``mxu_plan`` in squeeze_stencil.py picks nt, spw
// and the warps by shape; the launcher fills in the rest).
struct Geom {
  int nb, n_macro;         // blocks (of the shard, for kPieces), macro-tiles
  int batch, rho, k, w;
  int P;                   // slots per macro-tile (one CTA's work item)
  int n_terms;
  int nt;                  // 8 x 8 tiles per window side, W = 8 nt
  int spw;                 // slots per warp: a pair, or one
  int slot_elems;          // staged elements per slot and channel
  int vin, vout;           // bytes per staging load and per center store
  int n_in, n_out;         // staging loads and center stores per unit
  int stage_bytes, win_bytes;  // one staging buffer, one window buffer
};

// x rounded to TF32, to nearest with ties away from zero, as
// cvt.rna.tf32.f32 does on this card: half an ulp of TF32 (bit 12) added,
// the 13 low bits left for the tensor cores to ignore (finite x).
__device__ __forceinline__ uint32_t tf32(float x) {
  return __float_as_uint(x) + 0x1000u;
}

// x = hi + lo, both rounded to TF32 by round-to-nearest (hi's low bits
// cleared, so that x - hi is exact); lo is left 0 (never multiplied) in the
// one-pass form.
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
// uint8 CA states (0 and 1, or any byte, are exact in TF32), else split.
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

// d (+)= a b in one TF32 product, or in three (3xTF32: a_lo b_hi + a_hi b_lo
// + a_hi b_hi, the small terms first); `zero` starts d from 0.
template <bool X3>
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     const Split (&b)[2], bool zero) {
  if (X3) {
    if (zero)
      mma0(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
    else
      mma(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
    mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
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

// The first product's A operand, the terms' R stacked in M (rows 0-7 and
// 8-15; a missing second term zero): this lane's row y = 8 I + g, columns
// x = 8 K + 2t and x + 1 (the K index permuted so that column 2t + h sits
// at t + 4h).
template <bool X3>
__device__ __forceinline__ void a_frag(Split (&a)[4],
                                       const float* __restrict__ rop,
                                       int n_terms, int y, int x, int w) {
#pragma unroll
  for (int tau = 0; tau < 2; ++tau) {
    a[tau] = split<X3>(tau < n_terms ? op_at(rop, tau, y, x, w) : 0.f);
    a[tau + 2] = split<X3>(tau < n_terms ? op_at(rop, tau, y, x + 1, w)
                                         : 0.f);
  }
}

// The second product's B operand of term tau: C_tau[y][x], C_tau[y][x + 1]
// with y = 8 J + g, x = 8 J' + 2t (same permutation).
template <bool X3>
__device__ __forceinline__ void b_frag(Split (&b)[2],
                                       const float* __restrict__ cop,
                                       int tau, int y, int x, int w) {
  b[0] = split<X3>(op_at(cop, tau, y, x, w));
  b[1] = split<X3>(op_at(cop, tau, y, x + 1, w));
}

// A one-tile window's operator fragments, loaded once per warp: terms 0
// and 1 of R (the first product's A) and C_0, C_1 (the second's B).
template <bool X3>
struct Frags {
  Split a[4];
  Split b[2][2];
};

// The aggregate of output tile (ti, tj) of a pair of windows, one channel:
// sum_t (R_t X) C_t^T with both products on the tensor cores. xa and xb
// are the two slots' W x W windows (xb null: no second slot). The first
// product takes X as its B operand (lane: X[8K + 2t + h][8J' + g]) and
// gives [Y_0; Y_1] of one slot in its accumulator; that accumulator is
// the second product's A operand as it stands (two slots stacked in M,
// the K index permuted as above), so Y never leaves the registers. e gets
// this lane's cells (8 ti + g, 8 tj + 2t + h): slot a in e[h], slot b in
// e[2 + h]. Only band tiles (|I - K| <= 1, |J - J'| <= 1) are multiplied.
template <bool X3>
__device__ __forceinline__ void products(int nt, int ti, int tj, int w,
                                         int lane,
                                         const float* xa, const float* xb,
                                         const float* __restrict__ rop,
                                         const float* __restrict__ cop,
                                         int n_terms, float (&e)[4]) {
  const int g = lane >> 2, t = lane & 3, W = 8 * nt;
  const int k0 = max(0, ti - 1), k1 = min(nt - 1, ti + 1);
  bool e_zero = true;
  for (int jp = max(0, tj - 1); jp <= min(nt - 1, tj + 1); ++jp) {
    float d[2][4] = {};   // the pair's Y tile (ti, jp) of both terms
    for (int kk = k0; kk <= k1; ++kk) {
      const int at = (8 * kk + 2 * t) * W + 8 * jp + g;
      Split bx[2][2], a[4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bx[0][h] = state_operand<X3>(xa[at + h * W]);
        if (xb) bx[1][h] = state_operand<X3>(xb[at + h * W]);
      }
      a_frag<X3>(a, rop, n_terms, 8 * ti + g, 8 * kk + 2 * t, w);
      mma3<X3>(d[0], a, bx[0], kk == k0);
      if (xb) mma3<X3>(d[1], a, bx[1], kk == k0);
    }
#pragma unroll
    for (int tau = 0; tau < 2; ++tau) {
      if (tau >= n_terms) break;
      Split y[4] = {split<X3>(d[0][2 * tau]), split<X3>(d[1][2 * tau]),
                    split<X3>(d[0][2 * tau + 1]),
                    split<X3>(d[1][2 * tau + 1])};
      Split b[2];
      b_frag<X3>(b, cop, tau, 8 * tj + g, 8 * jp + 2 * t, w);
      mma3<X3>(e, y, b, e_zero);
      e_zero = false;
    }
  }
}

// products for a one-tile window (W = 8), the operators in registers: two
// first products (one a slot), then the two terms' k8 steps of the second
// into two accumulators, summed. A missing second term has zero operators
// and adds exact zeros.
template <bool X3>
__device__ __forceinline__ void products1(const Frags<X3>& f, int lane,
                                          const float* xa, const float* xb,
                                          float (&e)[4]) {
  const int at = 16 * (lane & 3) + (lane >> 2);   // X[2t][g]
  Split ba[2] = {state_operand<X3>(xa[at]), state_operand<X3>(xa[at + 8])};
  Split bb[2] = {state_operand<X3>(xb[at]), state_operand<X3>(xb[at + 8])};
  float d[2][4], e1[4];
  mma3<X3>(d[0], f.a, ba, true);
  mma3<X3>(d[1], f.a, bb, true);
  const Split y0[4] = {split<X3>(d[0][0]), split<X3>(d[1][0]),
                       split<X3>(d[0][1]), split<X3>(d[1][1])};
  const Split y1[4] = {split<X3>(d[0][2]), split<X3>(d[1][2]),
                       split<X3>(d[0][3]), split<X3>(d[1][3])};
  mma3<X3>(e, y0, f.b[0], true);
  mma3<X3>(e1, y1, f.b[1], true);
#pragma unroll
  for (int i = 0; i < 4; ++i) e[i] = e[i] + e1[i];
}

// What a warp works on: slot pair `pair` of macro-tile m of simulation b.
struct Unit {
  int b, m, pair;
};

// The warp's next unit: its next pair of the macro-tile, else its first
// pair of the CTA's next macro-tile (the grid strides over (b, m)).
__device__ __forceinline__ void advance(Unit& u, int warp, int warps,
                                        int npairs, const Geom& gm) {
  u.pair += warps;
  if (u.pair < npairs) return;
  u.pair = warp;
  u.m += gridDim.x;
  while (u.m >= gm.n_macro) {
    u.m -= gm.n_macro;
    ++u.b;
  }
}

// Block of slot s of u, or -1 when the slot is past the macro-tile, the
// blocks or the batch (a zero slot).
__device__ __forceinline__ int slot_block(const Unit& u, int s,
                                          const Geom& gm) {
  const int sl = u.pair * gm.spw + s, blk = u.m * gm.P + sl;
  return (u.b < gm.batch && s < gm.spw && sl < gm.P && blk < gm.nb) ? blk
                                                                    : -1;
}

// Lane 8 s + d's row of the neighbor table (kInKernel: the neighbor id,
// ghost nb) or of the existence table (kPieces) for slot s of u.
template <int H>
__device__ __forceinline__ int load_row(const int* __restrict__ nbr,
                                        const Pieces& pc, const Unit& u,
                                        const Geom& gm, int lane) {
  const int blk = slot_block(u, lane >> 3, gm);
  const long long at = (long long)blk * 8 + (lane & 7);
  if (H == kPieces) return blk >= 0 ? pc.ex[at] : 0;
  return blk >= 0 ? nbr[at] : gm.nb;
}

// Staging load i of a unit: vin bytes at element o of the staged region of
// slot-and-channel sc (s * C + c), which is block d (kInKernel: the
// neighbors in MOORE_DIRS order, 8 the block itself, rho^2 elements each)
// or the center and its four halo pieces (kPieces, see piece_src).
struct Chunk {
  int sc, o, d;
};

template <class Rule, int H>
__device__ __forceinline__ Chunk chunk_at(int i, const Geom& gm) {
  const int per = gm.vin / (int)sizeof(typename Rule::T);
  const int cps = gm.slot_elems / per;
  Chunk ch;
  ch.sc = i / cps;
  ch.o = (i - ch.sc * cps) * per;
  ch.d = H == kPieces ? 0 : ch.o / (gm.rho * gm.rho);
  return ch;
}

// kL1 false: a 16-byte copy bypasses L1 (.cg; v1 and v2's staging, which
// reads its blocks from L2).
template <bool kL1 = true>
__device__ __forceinline__ void cp_async(void* to, const void* from,
                                         int bytes, bool on) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(to);
  const int n = on ? bytes : 0;   // 0: the bytes are zero-filled
  if (bytes == 16 && !kL1)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(s), "l"(from), "r"(n) : "memory");
  else if (bytes == 16)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;"
                 :: "r"(s), "l"(from), "r"(n) : "memory");
  else if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;"
                 :: "r"(s), "l"(from), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(s), "l"(from), "r"(n) : "memory");
}

// Element `o` of the kPieces staged region of row sc = (b C + c) nb + blk:
// [center rho^2 | top k w | bottom k w | west rho k | east rho k].
template <class T>
__device__ __forceinline__ const T* piece_src(const T* src, const Pieces& pc,
                                              long long sc, int o,
                                              const Geom& gm) {
  const int rho2 = gm.rho * gm.rho, kw = gm.k * gm.w, rk = gm.rho * gm.k;
  if (o < rho2) return src + sc * rho2 + o;
  o -= rho2;
  if (o < kw) return static_cast<const T*>(pc.top) + sc * kw + o;
  o -= kw;
  if (o < kw) return static_cast<const T*>(pc.bot) + sc * kw + o;
  o -= kw;
  if (o < rk) return static_cast<const T*>(pc.west) + sc * rk + o;
  return static_cast<const T*>(pc.east) + sc * rk + (o - rk);
}

// Issue the loads of u's slots into a staging buffer: whole blocks (self
// and its 8 neighbors, a ghost as zeros; kInKernel) or the center and its
// four halo pieces (kPieces), vin bytes a lane and load, cp.async where
// vin >= 4. `first` is this lane's load of the first round (i = lane).
template <class Rule, int H>
__device__ __forceinline__ void issue(const typename Rule::T* __restrict__ src,
                                      const Pieces& pc,
                                      typename Rule::T* buf, const Unit& u,
                                      int row, const Chunk& first,
                                      const Geom& gm, int lane) {
  using T = typename Rule::T;
  constexpr int C = Rule::C;
  const int rho2 = gm.rho * gm.rho;
  for (int base = 0; base < gm.n_in; base += 32) {
    const Chunk ch = base ? chunk_at<Rule, H>(base + lane, gm) : first;
    const int s = ch.sc / C, c = ch.sc - s * C;
    const int blk = slot_block(u, s, gm);
    const long long sc = ((long long)u.b * C + c) * gm.nb;
    bool on = blk >= 0;
    const T* from = src;
    if (H == kPieces) {
      if (on) from = piece_src(src, pc, sc + blk, ch.o, gm);
    } else {
      int id = __shfl_sync(kFull, row, (8 * s + min(ch.d, 7)) & 31);
      if (ch.d == 8) id = blk;
      on = on && id < gm.nb;   // a ghost reads as zeros
      if (on) from = src + (sc + id) * rho2 + (ch.o - ch.d * rho2);
    }
    if (base + lane >= gm.n_in) break;
    T* to = buf + ch.sc * gm.slot_elems + ch.o;
    if (gm.vin >= 4)
      cp_async(to, from, gm.vin, on);
    else
      *to = on ? *from : (T)0;
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Element offset of window cell (y, x) in a slot and channel's staged
// region, -1 in the padding past w.
template <int H>
__device__ __forceinline__ int stage_off(int y, int x, const Geom& gm) {
  const int rho = gm.rho, k = gm.k, w = gm.w;
  if (y >= w || x >= w) return -1;
  if (H == kPieces) {
    const int rho2 = rho * rho, kw = k * w;
    if (y < k) return rho2 + y * w + x;
    if (y >= k + rho) return rho2 + kw + (y - k - rho) * w + x;
    if (x < k) return rho2 + 2 * kw + (y - k) * k + x;
    if (x >= k + rho) return rho2 + 2 * kw + rho * k + (y - k) * k +
                             (x - k - rho);
    return (y - k) * rho + (x - k);
  }
  int ry, rx;
  const int d = region(y, x, rho, k, &ry, &rx);
  return d * rho * rho + (y - k - (ry - 1) * rho) * rho +
         (x - k - (rx - 1) * rho);
}

// Window cell (y, x)'s mask as a bit set: 1 << its halo region (8 for the
// center) where window_mask(k) is set, else 0. ANDed with a slot's
// existence bits it gives the cell's mask.
__device__ __forceinline__ unsigned cell_bits(const uint8_t* __restrict__ wm,
                                              int y, int x, const Geom& gm) {
  if (y >= gm.w || x >= gm.w || !wm[y * gm.w + x]) return 0u;
  int ry, rx;
  return 1u << region(y, x, gm.rho, gm.k, &ry, &rx);
}

// Center store i of a unit: E = vout / sizeof(T) cells (E divides rho)
// from element o of the block of slot-and-channel sc, the first at `at` in
// the slot's W x W window.
struct Out {
  int sc, o, at;
};

template <class Rule>
__device__ __forceinline__ Out out_at(int i, const Geom& gm) {
  const int e = gm.vout / (int)sizeof(typename Rule::T);
  const int per = gm.rho * gm.rho / e;
  Out ot;
  ot.sc = i / per;
  ot.o = (i - ot.sc * per) * e;
  ot.at = (gm.k + ot.o / gm.rho) * 8 * gm.nt + gm.k + ot.o % gm.rho;
  return ot;
}

// Store the centers of u's slots from the window buffer, vout bytes a lane
// and store. `first` is this lane's store of the first round (i = lane).
template <class Rule>
__device__ __forceinline__ void store_pair(const float* win,
                                           typename Rule::T* __restrict__ dst,
                                           const Unit& u, const Out& first,
                                           const Geom& gm, int lane) {
  using T = typename Rule::T;
  constexpr int C = Rule::C;
  const int E = gm.vout / (int)sizeof(T), WW = 64 * gm.nt * gm.nt;
  for (int base = 0; base < gm.n_out; base += 32) {
    if (base + lane >= gm.n_out) break;
    const Out ot = base ? out_at<Rule>(base + lane, gm) : first;
    const int s = ot.sc / C, c = ot.sc - s * C;
    const int blk = slot_block(u, s, gm);
    if (blk < 0) continue;
    const float* from = win + ot.sc * WW + ot.at;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < E) v[q] = from[q];
    T* to = dst + (((long long)u.b * C + c) * gm.nb + blk) * gm.rho * gm.rho +
            ot.o;
    if (sizeof(T) == 1) {
      if (E == 1)
        *to = (T)f32_to_u8(v[0]);
      else
        *reinterpret_cast<uint32_t*>(to) =
            f32_to_u8(v[0]) | f32_to_u8(v[1]) << 8 | f32_to_u8(v[2]) << 16 |
            f32_to_u8(v[3]) << 24;
    } else if (E == 1) {
      *to = (T)v[0];
    } else if (E == 2) {
      *reinterpret_cast<float2*>(to) = make_float2(v[0], v[1]);
    } else {
      *reinterpret_cast<float4*>(to) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The k substeps of a warp's pair of one-tile windows (W = 8), from the
// staged blocks in `stage`, and the store of the centers. The lane keeps
// its own cells (g, 2t) and (g, 2t+1) of each slot and channel in
// registers and stores those that lie in the center (bit h of `cen` for
// cell h, at element coff + h of the block; 7: both, in one aligned
// store); the window buffers (win + i * win_step) carry the values other
// lanes read as the first product's B operand.
template <class Rule>
__device__ __forceinline__ void pair_one_tile(
    const typename Rule::T* stage, float* win, int win_step,
    typename Rule::T* __restrict__ dst, const Unit& u,
    const Frags<std::is_same<typename Rule::T, float>::value>& f,
    const int (&soff)[2], const unsigned (&bits)[2], const unsigned (&ex)[2],
    unsigned cen, int coff, const Geom& gm, int lane, const RuleArgs& ra) {
  using T = typename Rule::T;
  constexpr int C = Rule::C;
  constexpr bool X3 = std::is_same<T, float>::value;
  const int own = (lane >> 2) * 8 + 2 * (lane & 3);
  float st[2][C][2];
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int c = 0; c < C; ++c) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
        st[s][c][h] = soff[h] >= 0
            ? to_f32(stage[(s * C + c) * gm.slot_elems + soff[h]]) : 0.f;
      *reinterpret_cast<float2*>(win + (s * C + c) * 64 + own) =
          make_float2(st[s][c][0], st[s][c][1]);
    }
  __syncwarp();
  int cur = 0;
  for (int j = 0; j < gm.k; ++j) {
    const float* wc = win + cur * win_step;
    float* wn = win + (cur ^ 1) * win_step;
    float e[C][4];
#pragma unroll
    for (int c = 0; c < C; ++c)
      products1<X3>(f, lane, wc + c * 64, wc + (C + c) * 64, e[c]);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float m = (ex[s] & bits[h]) ? 1.f : 0.f;
        float v[C], agg[C], nx[C];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          v[c] = st[s][c][h];
          agg[c] = e[c][2 * s + h];
        }
        Rule::update(v, agg, m, ra, nx);
#pragma unroll
        for (int c = 0; c < C; ++c) st[s][c][h] = nx[c];
      }
    if (j + 1 == gm.k) break;   // the last substep's cells go out below
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int c = 0; c < C; ++c)
        *reinterpret_cast<float2*>(wn + (s * C + c) * 64 + own) =
            make_float2(st[s][c][0], st[s][c][1]);
    __syncwarp();
    cur ^= 1;
  }
  if (!cen) return;
  const long long cells = (long long)gm.rho * gm.rho;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int blk = slot_block(u, s, gm);
    if (blk < 0) continue;
    T* to = dst + ((long long)u.b * C * gm.nb + blk) * cells;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      T* cell = to + c * gm.nb * cells + coff;
      if (cen == 7u) {   // both cells, 2-element aligned: one store
        if (sizeof(T) == 1)
          *reinterpret_cast<uint16_t*>(cell) = (uint16_t)(
              f32_to_u8(st[s][c][0]) | f32_to_u8(st[s][c][1]) << 8);
        else
          *reinterpret_cast<float2*>(cell) =
              make_float2(st[s][c][0], st[s][c][1]);
        continue;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (cen >> h & 1) cell[h] = from_f32<T>(st[s][c][h]);
    }
  }
}

// The same for windows of W = 8 nt (any nt): the windows assembled whole
// into the buffers, every cell read back from them, the operators, masks
// and staging offsets found at the point of use, band tiles only.
template <class Rule, int H>
__device__ __forceinline__ int pair_wide(
    const typename Rule::T* stage, float* win, int win_step,
    const unsigned (&ex)[2], const uint8_t* __restrict__ wmask,
    const float* __restrict__ rop, const float* __restrict__ cop,
    const Geom& gm, int lane, const RuleArgs& ra) {
  constexpr int C = Rule::C;
  constexpr bool X3 = std::is_same<typename Rule::T, float>::value;
  const int nt = gm.nt, W = 8 * nt, WW = W * W, spw = gm.spw;
  const int g = lane >> 2, t = lane & 3;
  for (int cell = lane; cell < WW; cell += 32) {
    const int o = stage_off<H>(cell / W, cell % W, gm);
    for (int sc = 0; sc < spw * C; ++sc)
      win[sc * WW + cell] = o >= 0 ? to_f32(stage[sc * gm.slot_elems + o])
                                   : 0.f;
  }
  __syncwarp();
  int cur = 0;
  for (int j = 0; j < gm.k; ++j) {
    const float* wc = win + cur * win_step;
    float* wn = win + (cur ^ 1) * win_step;
    for (int ti = 0; ti < nt; ++ti) {
      for (int tj = 0; tj < nt; ++tj) {
        float e[C][4];
#pragma unroll
        for (int c = 0; c < C; ++c)
          products<X3>(nt, ti, tj, gm.w, lane, wc + c * WW,
                       spw > 1 ? wc + (C + c) * WW : nullptr, rop, cop,
                       gm.n_terms, e[c]);
        const int y = 8 * ti + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int x = 8 * tj + 2 * t + h, at = y * W + x;
          const unsigned cb = cell_bits(wmask, y, x, gm);
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            if (s >= spw) break;
            const float m = (ex[s] & cb) ? 1.f : 0.f;
            float u[C], agg[C], nx[C];
#pragma unroll
            for (int c = 0; c < C; ++c) {
              u[c] = wc[(s * C + c) * WW + at];
              agg[c] = e[c][2 * s + h];
            }
            Rule::update(u, agg, m, ra, nx);
#pragma unroll
            for (int c = 0; c < C; ++c) wn[(s * C + c) * WW + at] = nx[c];
          }
        }
      }
    }
    __syncwarp();
    cur ^= 1;
  }
  return cur;
}

// v5: a persistent grid of CTAs of `warps` warps; each CTA strides over
// the (simulation, macro-tile) items of P slots, each warp over the slot
// pairs of its CTA's items. A warp stages its pair's blocks with cp.async,
// assembles the two w x w windows (padded to W = 8 nt) and runs the k
// substeps: per output tile the aggregate on the tensor cores, then the
// rule under the window mask; then it stores the centers. While a pair
// computes, the next pair's neighbor ids load and, for NT == 1, its blocks
// too (into the other staging buffer). No block-wide barrier: each warp
// waits on its own loads and __syncwarp only. Slot borders pick up
// truncated-band values ring by ring; the center sits at distance >= k
// from them and is exact. NT is 1 (one tile, W = 8, a pair a warp:
// pair_one_tile) or 0 (the wide instance, W = 8 gm.nt: pair_wide).
template <class Rule, int H, int NT>
__global__ void __launch_bounds__(kMxuWarps * 32)
mxu_kernel(const typename Rule::T* __restrict__ src,
           typename Rule::T* __restrict__ dst, const int* __restrict__ nbr,
           const uint8_t* __restrict__ wmask, const float* __restrict__ rop,
           const float* __restrict__ cop, Pieces pc, Geom gm, RuleArgs ra) {
  using T = typename Rule::T;
  constexpr int C = Rule::C;
  constexpr bool X3 = std::is_same<T, float>::value;   // 3xTF32 for floats
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int spw = NT ? 2 : gm.spw;
  const int g = lane >> 2, t = lane & 3;
  const int npairs = (gm.P + spw - 1) / spw;
  if (warp >= npairs) return;
  // this warp's staging buffers (stage + i * stage_step; two for NT == 1,
  // one for the wide instance) and window buffers (win + i * win_step,
  // i < 2)
  constexpr int kStages = NT == 1 ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* mine = smem + (size_t)warp * (kStages * gm.stage_bytes +
                                               2 * gm.win_bytes);
  T* const stage = reinterpret_cast<T*>(mine);
  const int stage_step = gm.stage_bytes / (int)sizeof(T);
  float* const win = reinterpret_cast<float*>(mine + kStages *
                                                         gm.stage_bytes);
  const int win_step = gm.win_bytes / (int)sizeof(float);

  Frags<X3> f;
  int soff[2] = {0, 0}, coff = 0;
  unsigned bits[2] = {0u, 0u}, cen = 0u;
  if (NT == 1) {
    a_frag<X3>(f.a, rop, gm.n_terms, g, 2 * t, gm.w);
#pragma unroll
    for (int tau = 0; tau < 2; ++tau) {
      if (tau < gm.n_terms) {
        b_frag<X3>(f.b[tau], cop, tau, g, 2 * t, gm.w);
      } else {
        f.b[tau][0] = f.b[tau][1] = Split{0u, 0u};
      }
    }
    const int y = g - gm.k, x = 2 * t - gm.k;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      soff[h] = stage_off<H>(g, 2 * t + h, gm);
      bits[h] = cell_bits(wmask, g, 2 * t + h, gm);
      if (y >= 0 && y < gm.rho && x + h >= 0 && x + h < gm.rho)
        cen |= 1u << h;
    }
    coff = y * gm.rho + x;
    // both cells in one store where the pair is aligned to two elements
    if (cen == 3u && gm.rho % 2 == 0 && coff % 2 == 0 &&
        (unsigned long long)dst % (2 * sizeof(T)) == 0)
      cen = 7u;
  }
  const Chunk first_in = chunk_at<Rule, H>(lane, gm);
  const Out first_out = out_at<Rule>(lane, gm);

  // the pipeline: this pair computes while the next pair's blocks (NT ==
  // 1: into the other staging buffer) and the one after's neighbor ids
  // load
  Unit cu{(int)(blockIdx.x / gm.n_macro), (int)(blockIdx.x % gm.n_macro),
          warp};
  bool has = cu.b < gm.batch;
  int row_c = load_row<H>(nbr, pc, cu, gm, lane);
  Unit nu = cu;
  advance(nu, warp, warps, npairs, gm);
  bool has_next = has && nu.b < gm.batch;
  int row_n = load_row<H>(nbr, pc, nu, gm, lane);
  if (has) issue<Rule, H>(src, pc, stage, cu, row_c, first_in, gm, lane);
  int buf = 0;
  while (has) {
    const bool ahead = NT == 1 && has_next;
    if (ahead)
      issue<Rule, H>(src, pc, stage + (buf ^ 1) * stage_step, nu, row_n,
                     first_in, gm, lane);
    Unit nn = nu;
    advance(nn, warp, warps, npairs, gm);
    const bool has_nn = has_next && nn.b < gm.batch;
    const int row_nn = load_row<H>(nbr, pc, nn, gm, lane);
    if (ahead)
      asm volatile("cp.async.wait_group 1;" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncwarp();

    // the slots' existence bits: lane 8 s + d holds direction d of slot s
    const unsigned ball = __ballot_sync(
        kFull, H == kPieces ? row_c != 0 : row_c < gm.nb);
    const unsigned ex[2] = {(ball & 0xffu) | 0x100u,
                            ((ball >> 8) & 0xffu) | 0x100u};
    const T* sb = stage + buf * stage_step;
    if (NT == 1) {
      pair_one_tile<Rule>(sb, win, win_step, dst, cu, f, soff, bits, ex,
                          cen, coff, gm, lane, ra);
    } else {
      const int cur = pair_wide<Rule, H>(sb, win, win_step, ex, wmask, rop,
                                         cop, gm, lane, ra);
      store_pair<Rule>(win + cur * win_step, dst, cu, first_out, gm, lane);
    }
    __syncwarp();   // the staging and window buffers are free again

    if (!ahead && has_next)
      issue<Rule, H>(src, pc, stage + buf * stage_step, nu, row_n, first_in,
                     gm, lane);
    if (ahead) buf ^= 1;
    cu = nu;
    row_c = row_n;
    has = has_next;
    nu = nn;
    row_n = row_nn;
    has_next = has_nn;
  }
}

// ---------------------------------------------------------------------
// v4 and kernel 6: the warp body (see the note at the top of the file).
// ---------------------------------------------------------------------
constexpr int kWarpWarps = 8;   // most warps of one warp-body CTA

// The warp body's launch geometry (launch_fused fills it in from the W and
// warps that fused_plan in squeeze_stencil.py picked). A warp takes a group
// of G = 32 / W windows of consecutive blocks; an item is one group of one
// simulation.
struct WGeom {
  int nb, groups, batch, rho, k, w;
  int cstride;             // elements of one channel's staged region, its
                           // 16 zero bytes and alignment included
  int vin, per;            // bytes and elements of one staging load
  int svin, sper;          // kStrips: the same for the strips run
  int cpc;                 // kPieces: staging loads of one channel
  int ends[4];             // kPieces: where the center, top, bottom and
                           // west runs of a channel end, in loads
};

// kStrips: where a channel's strips run starts in its staged region, after
// the G centers and 16-byte aligned (elements of sz bytes).
__host__ __device__ __forceinline__ int strips_at(int G, int rho, int sz) {
  return ((G * rho * rho * sz + 15) & ~15) / sz;
}

// Elements of one channel's staged region of G windows, before its
// alignment and 16 zero bytes: kInKernel and kWholeBlocks G centers and 8 G
// neighbor slots, kPieces w^2 a window, kStrips the centers and 4 w strip
// elements a window.
template <int H>
__host__ __device__ __forceinline__ int region_elems(int G, int rho, int w,
                                                     int sz) {
  return H == kPieces ? G * w * w
       : H == kStrips ? strips_at(G, rho, sz) + 4 * G * w
                      : 9 * G * rho * rho;
}

// The Moore aggregate at this lane's cell of a row from the lane's up, mid
// and dn values; the columns left and right of it are the lanes beside it
// in its W-lane window (shuffles; the lanes at a window's edge read their
// own, and are never live). Each form is moore_agg's sum for its weights,
// in its order: kOrthUnit (1 orthogonal, 0 diagonal), kRingUnit (1 on both
// rings) and kRingScaled (both ring weights other than 0 and 1).
template <int F, int W, class A>
__device__ __forceinline__ A lane_agg(A up, A mid, A dn, const RuleArgs& ra) {
  if (F == kOrthUnit) {
    const A wv = __shfl_up_sync(kFull, mid, 1, W);
    const A e = __shfl_down_sync(kFull, mid, 1, W);
    A agg = (A)0;
    agg = agg + up; agg = agg + wv; agg = agg + e; agg = agg + dn;
    return agg;
  }
  const A col = up + mid + dn;
  const A l = __shfl_up_sync(kFull, col, 1, W);
  const A r = __shfl_down_sync(kFull, col, 1, W);
  const A agg = l + col + r - mid;
  if (F == kRingUnit) return agg;
  const A ml = __shfl_up_sync(kFull, mid, 1, W);
  const A mr = __shfl_down_sync(kFull, mid, 1, W);
  return agg * (A)ra.wd + (up + ml + mr + dn) * (A)ra.wc;
}

// Whether the ring weights are form f's (the launcher refuses the warp body
// otherwise; fused_plan gives such weights the CTA body).
bool form_holds(int f, const RuleArgs& ra) {
  return f == kRingUnit ? ra.wd == 1.f && ra.wc == 0.f
       : f == kOrthUnit ? ra.wd == 0.f && ra.wo == 1.f
       : f == kRingScaled && ra.wd != 0.f && ra.wd != 1.f && ra.wc != 0.f &&
             ra.wc != 1.f;
}

// One substep of the windows whose columns the warp's lanes hold, rows in
// registers: rows [J0, W - J0) of every lane are computed from the old
// rows (one straight-line block, so the rows' shuffles and arithmetic
// interleave), the old row above carried along.
template <class Rule, int F, int W, int J0>
__device__ __forceinline__ void substep(typename Rule::A (&v)[W][Rule::C],
                                        unsigned colmask,
                                        const RuleArgs& ra) {
  using A = typename Rule::A;
  constexpr int C = Rule::C;
  A up[C];
#pragma unroll
  for (int c = 0; c < C; ++c) up[c] = v[J0 - 1][c];
#pragma unroll
  for (int y = J0; y < W - J0; ++y) {
    A mid[C], agg[C], nx[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      mid[c] = v[y][c];
      agg[c] = lane_agg<F, W>(up[c], mid[c], v[y + 1][c], ra);
    }
    Rule::cell(mid, agg, (colmask >> y) & 1u, ra, nx);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[y][c] = nx[c];
      up[c] = mid[c];
    }
  }
}

// The k substeps. Substep j needs rows and columns [j, w - j): the first
// computes rows [1, W - 1), the later ones [2, W - 2) for W = 8 (the main
// path's w = 8 at k = 2) and [1, W - 1) for wider W (one copy of the rows
// each). The rows and columns outside [j, w - j) get values nothing reads
// again: the next substep reads rows [j, w - j) only.
template <class Rule, int F, int W>
__device__ __forceinline__ void substeps(
    typename Rule::A (&v)[W][Rule::C], unsigned colmask, int k,
    const RuleArgs& ra) {
  for (int j = 1; j <= k; ++j) {  // substeps
    if (W > 8 || j == 1)
      substep<Rule, F, W, 1>(v, colmask, ra);
    else
      substep<Rule, F, W, 2>(v, colmask, ra);
  }
}

// What a warp works on: group g (blocks g G ..) of simulation b; it is
// past the work when b >= batch.
struct Item {
  int b, g;
};

__device__ __forceinline__ void next_item(Item& it, int stride,
                                          const WGeom& gm) {
  it.g += stride;
  while (it.g >= gm.groups) {
    it.g -= gm.groups;
    ++it.b;
  }
}

// Lane 8 q + d's row of the neighbor table (kInKernel: the neighbor id,
// ghost nb) or of the existence table (kPieces: 0 for none) for window q of
// the item.
template <int H, int G>
__device__ __forceinline__ int group_row(const int* __restrict__ nbr,
                                         const Pieces& pc, const Item& it,
                                         const WGeom& gm, int lane) {
  if (H == kStrips) return 0;   // no table: the strips hold the halo
  const int blk = it.g * G + (lane >> 3);
  const bool on = it.b < gm.batch && lane < 8 * G && blk < gm.nb;
  const size_t at = (size_t)blk * 8 + (lane & 7);
  if (H == kPieces) return on ? pc.ex[at] : 0;
  return on ? nbr[at] : gm.nb;
}

// One staging load of `bytes` (vin) bytes, cp.async where vin >= 4 (zeros
// where !on), else one element.
template <bool kL1 = true, class T>
__device__ __forceinline__ void stage_load(T* to, const T* from, int bytes,
                                           bool on) {
  if (bytes >= 4)
    cp_async<kL1>(to, from, bytes, on);
  else
    *to = on ? *from : (T)0;
}

// A run of n contiguous elements into a staging buffer, vin bytes a lane
// and load; elements past `valid` as zeros.
template <class T>
__device__ __forceinline__ void stage_run(T* to, const T* from, int n,
                                          int valid, const WGeom& gm,
                                          int lane) {
  for (int i = lane * gm.per; i < n; i += 32 * gm.per)
    stage_load(to + i, from + i, gm.vin, i < valid);
}

// v1 and v2's stage_run, `step` elements apart a load (32 per for a lane
// of a warp's run, per for one lane's whole block), past L1: its `valid`
// elements need not be a whole number of loads (kStrips: the loads are
// aligned to the group's run, not to a block), so the load across their
// end is taken an element at a time, the rest as zeros. Not unrolled: a
// run is one or two loads a lane at the main path's shapes.
template <class T>
__device__ __forceinline__ void stage_tail(T* to, const T* from, int i,
                                           int n, int valid, int vin, int per,
                                           int step) {
#pragma unroll 1
  for (; i < n; i += step) {
    if (i + per <= valid || i >= valid) {
      stage_load<false>(to + i, from + i, vin, i < valid);
    } else {
#pragma unroll 1
      for (int e = 0; e < per; ++e)
        to[i + e] = i + e < valid ? from[i + e] : (T)0;
    }
  }
}

// Issue the staging loads of an item into the warp's buffer and commit
// them as one group (an empty one past the work). Each channel's region of
// the buffer is followed by 16 zero bytes (the rows past a window read
// them).
//
// kInKernel: [c][G centers | 8 G neighbor slots][rho^2]. The centers are
// consecutive blocks, one contiguous run; lane 8 q + d loads its neighbor
// `row` (direction d of window q, a ghost nb as zeros) into slot G + 8 q +
// d, of it the loads [olo, ohi) that hold the rows the window reads (the
// bottom k rows of a northern neighbor, the top k of a southern one).
//
// kWholeBlocks: as kInKernel, every neighbor block whole ([olo, ohi) =
// [0, rho^2)).
//
// kPieces: [c][centers | tops | bottoms | wests | easts], each run
// contiguous in device memory for consecutive blocks: load j of a channel
// is the walk's, 32 a round.
//
// kStrips: [c][G centers | G strips of 4 w], the strips run from
// strips_at(), both runs contiguous for consecutive blocks.
template <class Rule, int H, int G>
__device__ __forceinline__ void issue_group(
    const typename Rule::T* __restrict__ src, const Pieces& pc,
    typename Rule::T* buf, const Item& it, int row, int olo, int ohi,
    const WGeom& gm, int lane) {
  using T = typename Rule::T;
  constexpr int C = Rule::C;
  if (it.b < gm.batch) {
    const int rho2 = gm.rho * gm.rho, blk0 = it.g * G;
    const int nv = min(G, gm.nb - blk0);   // windows of the group in nb
    if (H == kPieces) {
      const int kw = gm.k * gm.w, rk = gm.rho * gm.k;
      int c = 0, j = lane;
      while (j >= gm.cpc) {
        j -= gm.cpc;
        ++c;
      }
      for (int base = 0; base < C * gm.cpc; base += 32) {
        const int r = j < gm.ends[0] ? 0 : j < gm.ends[1] ? 1
                    : j < gm.ends[2] ? 2 : j < gm.ends[3] ? 3 : 4;
        const int start = r == 0 ? 0 : r == 1 ? gm.ends[0]
                        : r == 2 ? gm.ends[1] : r == 3 ? gm.ends[2]
                                              : gm.ends[3];
        const int pb = r == 0 ? rho2 : (r <= 2 ? kw : rk);
        const T* p = r == 0 ? src
                   : static_cast<const T*>(r == 1 ? pc.top : r == 2 ? pc.bot
                                           : r == 3 ? pc.west : pc.east);
        const int e = (j - start) * gm.per;
        const bool on = e < nv * pb;
        const T* from =
            on ? p + ((size_t)(it.b * C + c) * gm.nb + blk0) * pb + e : src;
        if (base + lane < C * gm.cpc)
          stage_load(buf + c * gm.cstride + j * gm.per, from, gm.vin, on);
        j += 32;
        while (j >= gm.cpc) {
          j -= gm.cpc;
          ++c;
        }
      }
    } else if (H == kStrips) {
      const int w4 = 4 * gm.w, sat = strips_at(G, gm.rho, (int)sizeof(T));
      const T* const strips = static_cast<const T*>(pc.strips);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const size_t sc = (size_t)(it.b * C + c) * gm.nb + blk0;
        T* const to = buf + c * gm.cstride;
        stage_tail(to, src + sc * rho2, lane * gm.per, G * rho2, nv * rho2,
                   gm.vin, gm.per, 32 * gm.per);
        stage_tail(to + sat, strips + sc * w4, lane * gm.sper, G * w4,
                   nv * w4, gm.svin, gm.sper, 32 * gm.sper);
      }
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const size_t sc = (size_t)(it.b * C + c) * gm.nb;
        T* const to = buf + c * gm.cstride;
        const bool on = row < gm.nb;
        const T* from = src + (sc + (on ? row : 0)) * rho2;
        T* const slot = to + (G + lane) * rho2;
        if (H == kWholeBlocks) {   // v1: every neighbor block whole
          stage_tail(to, src + (sc + blk0) * rho2, lane * gm.per, G * rho2,
                     nv * rho2, gm.vin, gm.per, 32 * gm.per);
          if (lane < 8 * G)
            stage_tail(slot, from, 0, rho2, on ? rho2 : 0, gm.vin, gm.per,
                       gm.per);
          continue;
        }
        stage_run(to, src + (sc + blk0) * rho2, G * rho2, nv * rho2, gm,
                  lane);
        for (int o = olo; o < ohi; o += gm.per)
          stage_load(slot + o, from + o, gm.vin, on);
      }
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// A lane's column of its window, all channels, from the staging buffer
// into registers: row y at off[y] (past the window: the zero bytes), one
// load a row and channel.
template <class Rule, int W>
__device__ __forceinline__ void stage_column(
    const typename Rule::T* sb, const int (&off)[W], int cstride,
    typename Rule::A (&v)[W][Rule::C]) {
#pragma unroll
  for (int y = 0; y < W; ++y)
#pragma unroll
    for (int c = 0; c < Rule::C; ++c)
      v[y][c] = (typename Rule::A)sb[off[y] + c * cstride];
}

// A lane's column mask: window_mask(k)'s bits of the column, and for each
// of the three halo regions the column crosses (rows [0, k), [k, k + rho),
// [k + rho, w)) its rows and the MOORE_DIRS index (8: the center) of the
// block that owns it.
struct ColMask {
  unsigned wm, rows[3];
  int dir[3];
};

// Bit y set where window_mask(k) is set and the region's block exists;
// e holds a window's existence bits, bit 8 (the center) set.
__device__ __forceinline__ unsigned column_mask(const ColMask& cm,
                                                unsigned e) {
  unsigned m = 0u;
#pragma unroll
  for (int r = 0; r < 3; ++r)
    if ((e >> cm.dir[r]) & 1u) m |= cm.rows[r];
  return cm.wm & m;
}

__device__ __forceinline__ unsigned low_bits(int n) {
  return n >= 32 ? ~0u : (1u << n) - 1u;
}

// v4 (kInKernel) and kernel 6 (kPieces) for windows of w <= 32 cells, and
// v3 (kInKernel), v1 (kWholeBlocks) and v2 (kStrips) at k = 1 for windows
// of w = rho + 2 <= 32. KC is k when compiled: 1 for every k = 1 launch
// (its mask window_mask(1)'s center or micro_mask, which only the center
// is computed under, so no existence is read), 0 for k at run time: a
// persistent grid of CTAs of up to kWarpWarps warps; each warp strides over
// the (simulation, group) items on its own, no block-wide barrier. Lane
// q W + x holds column x of window q (block g G + q) in registers, all
// channels, across the k substeps (lanes past w hold zeros). The column's
// staged element of each row, its mask bits and halo regions are computed
// once per lane. A group's blocks are staged with cp.async into a
// warp-private buffer; once its columns are in registers, the next
// group's loads are issued into the same buffer and fly while this group
// runs its substeps (a second buffer, two groups ahead, was slower). The
// centers are stored from the registers.
template <class Rule, int H, int W, int KC>
__global__ void __launch_bounds__(kWarpWarps * 32)
warp_kernel(const typename Rule::T* __restrict__ src,
            typename Rule::T* __restrict__ dst, const int* __restrict__ nbr,
            const uint8_t* __restrict__ wmask, Pieces pc, WGeom gm,
            RuleArgs ra) {
  using T = typename Rule::T;
  using A = typename Rule::A;
  constexpr int C = Rule::C, G = 32 / W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = lane / W, x = lane % W;
  constexpr bool kOne = H == kWholeBlocks || H == kStrips;   // micro_mask
  const int rho = gm.rho, k = KC > 0 ? KC : gm.k, w = gm.w, rho2 = rho * rho;
  extern __shared__ __align__(16) unsigned char smem[];
  T* const stage = reinterpret_cast<T*>(smem) +
                   (size_t)warp * C * gm.cstride;   // this warp's buffer
  // each channel's region ends in 16 zero bytes, at `zero`
  const int zero = ((region_elems<H>(G, rho, w, (int)sizeof(T)) *
                     (int)sizeof(T) + 15) & ~15) / (int)sizeof(T);
  if (lane < C)
    *reinterpret_cast<uint4*>(stage + lane * gm.cstride + zero) =
        make_uint4(0u, 0u, 0u, 0u);

  // this lane's column: the staged element of each row (the zero bytes
  // past the window), its mask bits and regions
  int off[W];
  ColMask cm;
  cm.wm = 0u;
  const int rx = x < k ? 0 : (x < k + rho ? 1 : 2);
#pragma unroll
  for (int y = 0; y < W; ++y) {
    off[y] = zero;
    if (x >= w || y >= w) continue;
    const int ry = y < k ? 0 : (y < k + rho ? 1 : 2);
    if (kOne ? ry == 1 && rx == 1 && wmask[(y - 1) * rho + (x - 1)]
             : wmask[y * w + x] != 0)
      cm.wm |= 1u << y;
    if (H == kStrips) {
      // rows 0 and 1 of window q's strips the top and bottom rows, 2 and 3
      // the west and east columns
      const int st = strips_at(G, rho, (int)sizeof(T)) + q * 4 * w;
      if (ry == 0)
        off[y] = st + x;
      else if (ry == 2)
        off[y] = st + w + x;
      else if (rx == 0)
        off[y] = st + 2 * w + (y - 1);
      else if (rx == 2)
        off[y] = st + 3 * w + (y - 1);
      else
        off[y] = q * rho2 + (y - 1) * rho + (x - 1);
    } else if (H == kPieces) {
      const int kw = k * w, rk = rho * k, runs = G * rho2;
      if (ry == 0)
        off[y] = runs + q * kw + y * w + x;
      else if (ry == 2)
        off[y] = runs + G * kw + q * kw + (y - k - rho) * w + x;
      else if (rx == 0)
        off[y] = runs + 2 * G * kw + q * rk + (y - k) * k + x;
      else if (rx == 2)
        off[y] = runs + 2 * G * kw + G * rk + q * rk + (y - k) * k +
                 (x - k - rho);
      else
        off[y] = q * rho2 + (y - k) * rho + (x - k);
    } else {
      // the block of the region: the center, or the slot of direction d
      const int raster = ry * 3 + rx;
      const int d = raster < 4 ? raster : raster - 1;
      const int blk = raster == 4 ? q : G + 8 * q + d;
      off[y] = blk * rho2 + (y - k - (ry - 1) * rho) * rho +
               (x - k - (rx - 1) * rho);
    }
  }
  cm.rows[0] = low_bits(k);
  cm.rows[1] = low_bits(k + rho) & ~low_bits(k);
  cm.rows[2] = low_bits(w) & ~low_bits(k + rho);
  cm.dir[0] = rx;
  cm.dir[1] = rx == 0 ? 3 : (rx == 1 ? 8 : 4);
  cm.dir[2] = 5 + rx;
  // k = 1: only the center is computed under the mask (micro_mask, or
  // window_mask(1)'s center), and it is never gated: the center's bit (8),
  // always set, so no existence is read
  if (KC == 1) cm.dir[0] = cm.dir[1] = cm.dir[2] = 8;
  const bool center = x >= k && x < k + rho;
  // kInKernel: the loads [olo, ohi) of this lane's neighbor block (lanes
  // 8 q + d, d < 8) that hold the rows its window reads
  int olo = 0, ohi = 0;
  if (H == kInKernel && lane < 8 * G) {
    const int d = lane & 7;
    olo = d < 3 ? (rho - k) * rho / gm.per * gm.per : 0;
    ohi = d > 4 ? (k * rho + gm.per - 1) / gm.per * gm.per : rho2;
  }

  const int warps = blockDim.x >> 5, stride = gridDim.x * warps;
  const int first = blockIdx.x * warps + warp;
  Item it0{first / gm.groups, first % gm.groups};
  Item it1 = it0;
  next_item(it1, stride, gm);
  int r0 = group_row<H, G>(nbr, pc, it0, gm, lane);
  int r1 = group_row<H, G>(nbr, pc, it1, gm, lane);
  __syncwarp();
  issue_group<Rule, H, G>(src, pc, stage, it0, r0, olo, ohi, gm, lane);
  while (it0.b < gm.batch) {
    asm volatile("cp.async.wait_group 0;" ::: "memory");
    __syncwarp();
    // the windows' existence bits: lane 8 q + d holds direction d of q
    const unsigned ball = __ballot_sync(
        kFull, H == kPieces ? r0 != 0 : r0 < gm.nb);
    const unsigned e = ((ball >> (8 * q)) & 0xffu) | 0x100u;
    const unsigned colmask = column_mask(cm, e);
    A v[W][C];
    stage_column<Rule, W>(stage, off, gm.cstride, v);
    __syncwarp();   // every lane has read the buffer: it takes the next
                    // group's loads, which fly while this group computes
    issue_group<Rule, H, G>(src, pc, stage, it1, r1, olo, ohi, gm, lane);
    Item it2 = it1;
    next_item(it2, stride, gm);
    const int r2 = group_row<H, G>(nbr, pc, it2, gm, lane);

    substeps<Rule, Rule::kForm, W>(v, colmask, k, ra);

    const int blk = it0.g * G + q;
    if (center && blk < gm.nb) {
      T* to = dst + ((size_t)it0.b * C * gm.nb + blk) * rho2 + (x - k);
#pragma unroll
      for (int y = 0; y < W; ++y) {
        if (y < k || y >= k + rho) continue;
#pragma unroll
        for (int c = 0; c < C; ++c)
          to[(size_t)c * gm.nb * rho2 + (y - k) * rho] = (T)v[y][c];
      }
    }
    it0 = it1; r0 = r1;
    it1 = it2; r1 = r2;
  }
}

// ---------------------------------------------------------------------
// v2's strip gather (see the note at the top of the file).
// ---------------------------------------------------------------------
constexpr int kGatherThreads = 256;

// The halo strips (rows, nb, 4, w), w = rho + 2, of the blocks of `rows`
// (simulation, channel) rows of `src`, as gather_halo_strips_plain in
// squeeze_stencil.py lays them out: row 0 the top (NW's SE cell, N's bottom
// row, NE's SW cell), row 1 the bottom (SW's NE cell, S's top row, SE's NW
// cell), rows 2 and 3 W's east and E's west column, their last two entries
// 0. Direction d (MOORE_DIRS order) reads zeros where bit d of `needs` is
// clear or its neighbor is the ghost (id nb). A thread a block; T is the
// element's bytes (floats move as their bits). R > 0, rho = R known when
// compiled, the 4 w elements assembled in registers, and a warp's 32
// blocks' strips stored through shared memory as one coalesced run of
// 8-byte words: a block of 16 bytes (rho = 4 uint8) loaded whole in one
// aligned 16-byte load and the edges picked in registers, or a row of 16
// bytes (rho = 4 float32) loaded as one, the columns and corners an
// element at a time; R == 0: any rho, an element at a time.
template <class T, int R>
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const T* __restrict__ src, T* __restrict__ strips,
              const int* __restrict__ nbr, long long nb, long long total,
              int rho_, unsigned needs) {
  const long long t0 = (long long)blockIdx.x * kGatherThreads + threadIdx.x;
  if (R == 0 && t0 >= total) return;
  // R > 0: a lane past the blocks reads the last one, and stores nothing
  const long long t = t0 < total ? t0 : total - 1;
  const int rho = R > 0 ? R : rho_, w = rho + 2, rho2 = rho * rho;
  const long long sc = t / nb, blk = t - sc * nb;
  const T* const base = src + sc * nb * rho2;
  const int4 lo = __ldg(reinterpret_cast<const int4*>(nbr) + 2 * blk);
  const int4 hi = __ldg(reinterpret_cast<const int4*>(nbr) + 2 * blk + 1);
  const int ids[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  bool on[8];
#pragma unroll
  for (int d = 0; d < 8; ++d) on[d] = ((needs >> d) & 1u) && ids[d] < nb;
  auto at = [&](int d, int y, int x) -> T {
    return on[d] ? __ldg(base + (long long)ids[d] * rho2 + y * rho + x)
                 : (T)0;
  };
  if constexpr (R > 0) {
    constexpr int kW = R + 2;
    constexpr bool kWhole = R * R * sizeof(T) == 16;
    static_assert(kWhole || R * sizeof(T) == 16, "a block or a row of 16 "
                  "bytes");
    static_assert(4 * kW * sizeof(T) % 8 == 0, "8-byte words");
    union Vec {   // a whole block (kWhole) or one row
      uint4 v;
      T e[16 / sizeof(T)];
    };
    union Out {
      uint2 v[4 * kW * sizeof(T) / 8];
      T e[4 * kW];
    };
    auto vec = [&](int d, int y) {   // row y of neighbor d's block (kWhole:
                                     // the block)
      Vec r;
      r.v = on[d] ? __ldg(reinterpret_cast<const uint4*>(
                              base + (long long)ids[d] * rho2 + y * R))
                  : make_uint4(0u, 0u, 0u, 0u);
      return r;
    };
    Out o;
    if constexpr (kWhole) {
      Vec b[8];
#pragma unroll
      for (int d = 0; d < 8; ++d) b[d] = vec(d, 0);
      o.e[0] = b[0].e[R * R - 1];
      o.e[R + 1] = b[2].e[(R - 1) * R];
      o.e[kW] = b[5].e[R - 1];
      o.e[kW + R + 1] = b[7].e[0];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        o.e[1 + j] = b[1].e[(R - 1) * R + j];
        o.e[kW + 1 + j] = b[6].e[j];
        o.e[2 * kW + j] = b[3].e[j * R + R - 1];
        o.e[3 * kW + j] = b[4].e[j * R];
      }
    } else {
      const Vec n = vec(1, R - 1), s = vec(6, 0);
      o.e[0] = at(0, R - 1, R - 1);
      o.e[R + 1] = at(2, R - 1, 0);
      o.e[kW] = at(5, 0, R - 1);
      o.e[kW + R + 1] = at(7, 0, 0);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        o.e[1 + j] = n.e[j];
        o.e[kW + 1 + j] = s.e[j];
        o.e[2 * kW + j] = at(3, j, R - 1);
        o.e[3 * kW + j] = at(4, j, 0);
      }
    }
#pragma unroll
    for (int j = R; j < kW; ++j) o.e[2 * kW + j] = o.e[3 * kW + j] = (T)0;
    // through shared memory: the warp's 32 blocks' strips are one
    // contiguous run, stored 8 bytes a lane
    constexpr int kV = 4 * kW * sizeof(T) / 8;   // 8-byte words a block
    __shared__ uint2 sh[kGatherThreads * kV];
    const int lane = threadIdx.x & 31;
    uint2* const mine = sh + (threadIdx.x - lane) * kV;
#pragma unroll
    for (int i = 0; i < kV; ++i) mine[lane * kV + i] = o.v[i];
    __syncwarp();
    const long long first = t0 - lane;
    const int n = (int)min(32LL, total - first) * kV;
    uint2* const to = reinterpret_cast<uint2*>(strips + first * 4 * kW);
    for (int i = lane; i < n; i += 32) to[i] = mine[i];
  } else {
    T* const out = strips + t * 4 * w;
    out[0] = at(0, rho - 1, rho - 1);
    out[rho + 1] = at(2, rho - 1, 0);
    out[w] = at(5, 0, rho - 1);
    out[w + rho + 1] = at(7, 0, 0);
    for (int j = 0; j < rho; ++j) {
      out[1 + j] = at(1, rho - 1, j);
      out[w + 1 + j] = at(6, 0, j);
      out[2 * w + j] = at(3, j, rho - 1);
      out[3 * w + j] = at(4, j, 0);
    }
    out[3 * w - 2] = out[3 * w - 1] = out[4 * w - 2] = out[4 * w - 1] = (T)0;
  }
}

template <class T, int R>
int launch_gather_r(const void* src, void* strips, const int* nbr,
                    long long nb, long long total, int rho, unsigned needs,
                    cudaStream_t stream) {
  const long long ctas = (total + kGatherThreads - 1) / kGatherThreads;
  if (ctas >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  gather_kernel<T, R><<<(unsigned)ctas, kGatherThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(strips), nbr, nb, total,
      rho, needs);
  return (int)cudaGetLastError();
}

// The gather of elements of `elem` bytes (1 or 4): the body that knows rho
// for the main paths' rho = 4 (a block of uint8, a row of float32, 16
// bytes) where the tensors are aligned for its loads and stores, else the
// general one.
int launch_gather(const void* src, void* strips, const int* nbr, long long nb,
                  int rows, int rho, int elem, unsigned needs,
                  cudaStream_t stream) {
  if (nb < 1 || rows < 1 || rho < 1 || (elem != 1 && elem != 4) ||
      (unsigned long long)nbr % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)rows * nb;
  const bool four = rho == 4 && (unsigned long long)src % 16 == 0 &&
                    (unsigned long long)strips % 8 == 0;
  if (elem == 1)
    return four ? launch_gather_r<uint8_t, 4>(src, strips, nbr, nb, total,
                                              rho, needs, stream)
                : launch_gather_r<uint8_t, 0>(src, strips, nbr, nb, total,
                                              rho, needs, stream);
  return four ? launch_gather_r<uint32_t, 4>(src, strips, nbr, nb, total, rho,
                                             needs, stream)
              : launch_gather_r<uint32_t, 0>(src, strips, nbr, nb, total, rho,
                                             needs, stream);
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

// The widest of 16, 8 and 4 bytes (at most `cap`) that divides `bytes`
// and the address bits in `addr`, else one element: a lane's load or store
// width.
int vec_width(unsigned long long addr, long long bytes, int elem, int cap) {
  for (int v = 16; v >= 4; v /= 2)
    if (v <= cap && bytes % v == 0 && addr % v == 0) return v;
  return elem;
}

template <class Rule, int H, int NT>
int launch_mxu_nt(const void* src, void* dst, const int* nbr,
                  const uint8_t* wmask, const float* rop, const float* cop,
                  const Pieces& pc, const Geom& gm, int warps,
                  const RuleArgs& ra, cudaStream_t stream) {
  using T = typename Rule::T;
  const size_t smem = (size_t)warps * ((NT == 1 ? 2 : 1) * gm.stage_bytes +
                                       2 * gm.win_bytes);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  auto kernel = mxu_kernel<Rule, H, NT>;
  int rc = set_smem(kernel, smem);
  if (rc) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = (int)cudaGetDevice(&dev)) ||
      (rc = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)) ||
      (rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, warps * 32, smem)))
    return rc;
  const long long items = (long long)gm.n_macro * gm.batch;
  const long long ctas = std::min(items, (long long)std::max(per_sm, 1) * sms);
  kernel<<<(unsigned)ctas, warps * 32, smem, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), nbr, wmask, rop, cop,
      pc, gm, ra);
  return (int)cudaGetLastError();
}

template <class Rule, int H>
int launch_mxu(const void* src, void* dst, const int* nbr,
               const uint8_t* wmask, const float* rop, const float* cop,
               int n_terms, long long nb, int batch, int rho, int k, int P,
               int nt, int spw, int warps, const Pieces& pc,
               const RuleArgs& ra, cudaStream_t stream) {
  using T = typename Rule::T;
  constexpr int C = Rule::C, sz = (int)sizeof(T);
  const int w = rho + 2 * k;
  if (P < 1 || nt < 1 || 8 * nt < w || spw < 1 || spw > 2 ||
      (nt == 1 && spw != 2) || warps < 1 || warps > kMxuWarps)
    return (int)cudaErrorInvalidValue;
  if (nb < 1 || nb >= (1LL << 31) - P) return (int)cudaErrorInvalidValue;
  Geom gm;
  gm.nb = (int)nb;
  gm.n_macro = (int)((nb + P - 1) / P);
  gm.batch = batch;
  gm.rho = rho;
  gm.k = k;
  gm.w = w;
  gm.P = P;
  gm.n_terms = n_terms;
  gm.nt = nt;
  gm.spw = spw;
  unsigned long long in_addr = (unsigned long long)src;
  long long in_bytes = (long long)rho * rho * sz;
  if (H == kPieces) {
    gm.slot_elems = w * w;
    in_addr |= (unsigned long long)pc.top | (unsigned long long)pc.bot |
               (unsigned long long)pc.west | (unsigned long long)pc.east;
    in_bytes = (long long)std::gcd(std::gcd(rho * rho, k * w), rho * k) * sz;
  } else {
    gm.slot_elems = 9 * rho * rho;
  }
  gm.vin = vec_width(in_addr, in_bytes, sz, 16);
  gm.vout = vec_width((unsigned long long)dst, (long long)rho * sz, sz,
                      4 * sz);
  gm.n_in = spw * C * gm.slot_elems / (gm.vin / sz);
  gm.n_out = spw * C * rho * rho / (gm.vout / sz);
  gm.stage_bytes = (spw * C * gm.slot_elems * sz + 15) & ~15;
  gm.win_bytes = spw * C * 64 * nt * nt * (int)sizeof(float);
  if (nt == 1)
    return launch_mxu_nt<Rule, H, 1>(src, dst, nbr, wmask, rop, cop, pc, gm,
                                     warps, ra, stream);
  return launch_mxu_nt<Rule, H, 0>(src, dst, nbr, wmask, rop, cop, pc, gm,
                                   warps, ra, stream);
}

template <class Rule, int H, int W, int KC>
int launch_warp_w(const void* src, void* dst, const int* nbr,
                  const uint8_t* wmask, const Pieces& pc, const WGeom& gm,
                  int warps, const RuleArgs& ra, cudaStream_t stream) {
  using T = typename Rule::T;
  const size_t smem = (size_t)warps * Rule::C * gm.cstride * sizeof(T);
  auto kernel = warp_kernel<Rule, H, W, KC>;
  int rc = set_smem(kernel, smem);
  if (rc) return rc;
  int dev = 0, sms = 0, per_sm = 0;
  if ((rc = (int)cudaGetDevice(&dev)) ||
      (rc = (int)cudaDeviceGetAttribute(
           &sms, cudaDevAttrMultiProcessorCount, dev)) ||
      (rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, warps * 32, smem)))
    return rc;
  const long long items = (long long)gm.groups * gm.batch;
  const long long ctas = std::min((items + warps - 1) / warps,
                                  (long long)std::max(per_sm, 1) * sms);
  kernel<<<(unsigned)ctas, warps * 32, smem, stream>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), nbr, wmask, pc, gm,
      ra);
  return (int)cudaGetLastError();
}

// The warp body's instance of W lanes a window, k = KC when compiled.
template <class Rule, int H, int KC>
int launch_warp(const void* src, void* dst, const int* nbr,
                const uint8_t* wmask, const Pieces& pc, const WGeom& gm,
                int W, int warps, const RuleArgs& ra, cudaStream_t stream) {
  switch (W) {
    case 8:
      return launch_warp_w<Rule, H, 8, KC>(src, dst, nbr, wmask, pc, gm,
                                           warps, ra, stream);
    case 16:
      return launch_warp_w<Rule, H, 16, KC>(src, dst, nbr, wmask, pc, gm,
                                            warps, ra, stream);
    default:
      return launch_warp_w<Rule, H, 32, KC>(src, dst, nbr, wmask, pc, gm,
                                            warps, ra, stream);
  }
}

// v4 and kernel 6 (fused_plan; v3 is v4 at k = 1), and v1 and v2 at k = 1
// (step_plan), with the body their plan picked: W = 0 the CTA body
// (step_kernel, the wide instance), else the warp body with W lanes a
// window (8, 16 or 32, at least w) and `warps` warps a CTA, which the
// launcher checks and lays out. Each channel's staging region
// (region_elems) is 16-byte aligned and followed by 16 zero bytes.
template <class Rule, int H>
int launch_fused(const void* src, void* dst, const int* nbr,
                 const uint8_t* wmask, const Pieces& pc, long long nb,
                 int batch, int rho, int k, int W, int warps,
                 const RuleArgs& ra, cudaStream_t stream) {
  using T = typename Rule::T;
  constexpr int C = Rule::C, sz = (int)sizeof(T);
  const int w = rho + 2 * k;
  if (W == 0)
    return launch_step<Rule, H>(src, dst, nbr, pc.strips, wmask, pc, nb,
                                batch, rho, k, ra, stream);
  if ((W != 8 && W != 16 && W != 32) || w > W || warps < 1 ||
      warps > kWarpWarps || !form_holds(Rule::kForm, ra) ||
      ((H == kWholeBlocks || H == kStrips) && k != 1) ||
      (H == kStrips && !pc.strips))
    return (int)cudaErrorInvalidValue;
  const int G = 32 / W;
  const long long region_bytes =
      (((long long)region_elems<H>(G, rho, w, sz) * sz + 15) & ~15LL) + 16;
  if ((long long)warps * C * region_bytes > (long long)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  // 32-bit geometry: blocks, items and the grid's stride stay below 2^30
  if (nb < 1 || batch < 1 || nb >= (1LL << 30) ||
      (long long)batch * ((nb + G - 1) / G) >= (1LL << 30))
    return (int)cudaErrorInvalidValue;
  WGeom gm;
  gm.nb = (int)nb;
  gm.groups = (int)((nb + G - 1) / G);
  gm.batch = batch;
  gm.rho = rho;
  gm.k = k;
  gm.w = w;
  gm.cstride = (int)(region_bytes / sz);
  const int rho2 = rho * rho, kw = k * w, rk = rho * k;
  unsigned long long in_addr = (unsigned long long)src;
  long long in_bytes = (long long)rho2 * sz;
  if (H == kPieces) {
    in_addr |= (unsigned long long)pc.top | (unsigned long long)pc.bot |
               (unsigned long long)pc.west | (unsigned long long)pc.east;
    in_bytes = (long long)std::gcd(std::gcd(rho2, kw), rk) * sz;
  }
  // kStrips: a run of L elements a block starts at (sc nb + g G) L: its
  // loads as wide as G L (and nb L past one simulation and channel) allow
  auto run_bytes = [&](long long L) {
    const long long g = G * L * sz;
    return (long long)batch * C > 1 ? std::gcd(g, nb * L * sz) : g;
  };
  if (H == kStrips) in_bytes = run_bytes(rho2);
  gm.vin = vec_width(in_addr, in_bytes, sz, 16);
  gm.per = gm.vin / sz;
  gm.svin = vec_width((unsigned long long)pc.strips, run_bytes(4 * w), sz,
                      16);
  gm.sper = gm.svin / sz;
  gm.cpc = G * w * w / gm.per;
  gm.ends[0] = G * rho2 / gm.per;
  gm.ends[1] = gm.ends[0] + G * kw / gm.per;
  gm.ends[2] = gm.ends[1] + G * kw / gm.per;
  gm.ends[3] = gm.ends[2] + G * rk / gm.per;
  // k = 1 when compiled: v1, v2 and any k = 1 launch of kInKernel (v3)
  if constexpr (H == kWholeBlocks || H == kStrips) {
    return launch_warp<Rule, H, 1>(src, dst, nbr, wmask, pc, gm, W, warps,
                                   ra, stream);
  } else {
    if constexpr (H == kInKernel) {
      if (k == 1)
        return launch_warp<Rule, H, 1>(src, dst, nbr, wmask, pc, gm, W,
                                       warps, ra, stream);
    }
    return launch_warp<Rule, H, 0>(src, dst, nbr, wmask, pc, gm, W, warps,
                                   ra, stream);
  }
}

template <int H>
int fused_entry(int rule, const void* src, void* dst, const int* nbr,
                const uint8_t* wmask, const Pieces& pc, long long nb,
                int batch, int rho, int k, int W, int warps, int born,
                int survive, float p0, float p1, float p2, float p3, float wd,
                float wo, float wc, void* stream) {
  RuleArgs ra = make_args(born, survive, p0, p1, p2, p3, wd, wo, wc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SQ_FUSED(RULE)                                                   \
  launch_fused<RULE, H>(src, dst, nbr, wmask, pc, nb, batch, rho, k, W, \
                        warps, ra, s)
  switch (rule) {
    case 0: return SQ_FUSED(Totalistic);
    case 1: return SQ_FUSED(Heat);
    case 2: return SQ_FUSED(GrayScott);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SQ_FUSED
}

template <int H>
int mxu_entry(int rule, const void* src, void* dst, const int* nbr,
              const uint8_t* wmask, const float* rop, const float* cop,
              int n_terms, long long nb, int batch, int rho, int k, int P,
              int nt, int spw, int warps, const Pieces& pc,
              int born, int survive, float p0, float p1, float p2, float p3,
              float wd, float wo, float wc, void* stream) {
  if (n_terms < 1 || n_terms > kMaxTerms) return (int)cudaErrorInvalidValue;
  RuleArgs ra = make_args(born, survive, p0, p1, p2, p3, wd, wo, wc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SQ_MXU(RULE)                                                       \
  launch_mxu<RULE, H>(src, dst, nbr, wmask, rop, cop, n_terms, nb, batch, \
                      rho, k, P, nt, spw, warps, pc, ra, s)
  switch (rule) {
    case 0: return SQ_MXU(Totalistic);
    case 1: return SQ_MXU(Heat);
    case 2: return SQ_MXU(GrayScott);
    default: return (int)cudaErrorInvalidValue;
  }
#undef SQ_MXU
}

}  // namespace

extern "C" {

// v1: one step, the center and its 8 neighbor blocks staged whole, with
// the body (W lanes a window and warps a CTA, or W = 0 for the CTA body)
// that step_plan picked.
int sq_stencil_step_blocks(int rule, const void* src, void* dst,
                           const int* nbr, const uint8_t* micro,
                           long long nb, int batch, int rho, int W,
                           int warps, int born, int survive, float p0,
                           float p1, float p2, float p3, float wd, float wo,
                           float wc, void* stream) {
  return fused_entry<kWholeBlocks>(rule, src, dst, nbr, micro, Pieces{}, nb,
                                   batch, rho, 1, W, warps, born, survive, p0,
                                   p1, p2, p3, wd, wo, wc, stream);
}

// v2: one step from the center and its pre-gathered strips (B, C, nb, 4,
// rho+2); body as for sq_stencil_step_blocks.
int sq_stencil_step_strips(int rule, const void* src, void* dst,
                           const void* strips, const uint8_t* micro,
                           long long nb, int batch, int rho, int W,
                           int warps, int born, int survive, float p0,
                           float p1, float p2, float p3, float wd, float wo,
                           float wc, void* stream) {
  Pieces pc{};
  pc.strips = strips;
  return fused_entry<kStrips>(rule, src, dst, nullptr, micro, pc, nb, batch,
                              rho, 1, W, warps, born, survive, p0, p1, p2, p3,
                              wd, wo, wc, stream);
}

// v2's strip gather: the (rows, nb, 4, rho+2) strips of the (rows, nb, rho,
// rho) state, elements of `elem` bytes (1 or 4), the directions whose bit of
// `needs` is clear left as zeros; one launch.
int sq_gather_halo_strips(const void* src, void* strips, const int* nbr,
                          long long nb, int rows, int rho, int elem,
                          int needs, void* stream) {
  return launch_gather(src, strips, nbr, nb, rows, rho, elem,
                       (unsigned)needs, static_cast<cudaStream_t>(stream));
}

// v3: one step, v4 at k = 1 (its instance compiled at k = 1), with the
// body (W lanes a window and warps a CTA, or W = 0 for the CTA body) that
// fused_plan picked for k = 1.
int sq_stencil_step_fused(int rule, const void* src, void* dst,
                          const int* nbr, const uint8_t* wmask, long long nb,
                          int batch, int rho, int W, int warps, int born,
                          int survive, float p0, float p1, float p2,
                          float p3, float wd, float wo, float wc,
                          void* stream) {
  return fused_entry<kInKernel>(rule, src, dst, nbr, wmask, Pieces{}, nb,
                                batch, rho, 1, W, warps, born, survive, p0,
                                p1, p2, p3, wd, wo, wc, stream);
}

// v4: k exact steps per launch, 1 <= k <= rho, with the body (W lanes a
// window and warps a CTA, or W = 0 for the CTA body) that fused_plan
// picked.
int sq_stencil_step_fused_k(int rule, const void* src, void* dst,
                            const int* nbr, const uint8_t* wmask,
                            long long nb, int batch, int rho, int k, int W,
                            int warps, int born, int survive, float p0,
                            float p1, float p2, float p3, float wd, float wo,
                            float wc, void* stream) {
  return fused_entry<kInKernel>(rule, src, dst, nbr, wmask, Pieces{}, nb,
                                batch, rho, k, W, warps, born, survive, p0,
                                p1, p2, p3, wd, wo, wc, stream);
}

// v5: k exact steps per launch of B simulations, in macro-tiles of P
// slots, with the geometry (tiles a side, slots a warp, warps a CTA) that
// mxu_plan picked.
int sq_stencil_step_mxu(int rule, const void* src, void* dst, const int* nbr,
                        const uint8_t* wmask, const float* rop,
                        const float* cop, int n_terms, long long nb,
                        int batch, int rho, int k, int P, int nt, int spw,
                        int warps, int born, int survive, float p0, float p1,
                        float p2, float p3, float wd, float wo, float wc,
                        void* stream) {
  return mxu_entry<kInKernel>(rule, src, dst, nbr, wmask, rop, cop, n_terms,
                              nb, batch, rho, k, P, nt, spw, warps, Pieces{},
                              born, survive, p0, p1, p2, p3, wd, wo, wc,
                              stream);
}

// Shard-local v4: k exact steps of the nbl blocks of one shard from their
// halo pieces and existence table, 1 <= k <= rho; body as for
// sq_stencil_step_fused_k.
int sq_stencil_step_fused_k_local(int rule, const void* src, void* dst,
                                  const void* top, const void* bot,
                                  const void* west, const void* east,
                                  const int* ex, const uint8_t* wmask,
                                  long long nbl, int batch, int rho, int k,
                                  int W, int warps, int born, int survive,
                                  float p0, float p1, float p2, float p3,
                                  float wd, float wo, float wc,
                                  void* stream) {
  return fused_entry<kPieces>(rule, src, dst, nullptr, wmask,
                              Pieces{top, bot, west, east, ex}, nbl, batch,
                              rho, k, W, warps, born, survive, p0, p1, p2, p3,
                              wd, wo, wc, stream);
}

// Shard-local v5: k exact steps of B simulations over the nbl blocks of one
// shard, in macro-tiles of P slots, from their halo pieces and existence
// table; geometry as for sq_stencil_step_mxu.
int sq_stencil_step_mxu_k_local(int rule, const void* src, void* dst,
                                const void* top, const void* bot,
                                const void* west, const void* east,
                                const int* ex, const uint8_t* wmask,
                                const float* rop, const float* cop,
                                int n_terms, long long nbl, int batch, int rho,
                                int k, int P, int nt, int spw, int warps,
                                int born, int survive, float p0, float p1,
                                float p2, float p3, float wd, float wo,
                                float wc, void* stream) {
  return mxu_entry<kPieces>(rule, src, dst, nullptr, wmask, rop, cop, n_terms,
                            nbl, batch, rho, k, P, nt, spw, warps,
                            Pieces{top, bot, west, east, ex}, born, survive,
                            p0, p1, p2, p3, wd, wo, wc, stream);
}

}  // extern "C"
