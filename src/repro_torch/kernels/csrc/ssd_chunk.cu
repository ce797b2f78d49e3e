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
// Only the lower triangle is formed: above it exp(cs[l] - cs[m]) has a
// positive exponent and overflows, which the reference masks afterwards.
//
// The reference runs one grid step per chunk with every head's x in VMEM
// (1.5 MB at mamba2-780m). Here a CTA owns one chunk and a group of heads,
// grid (chunks, head groups), the wrapper choosing the group so that the
// grid has about two CTAs per SM (5 groups of 10 heads for the 64 chunks of
// mamba2-780m at batch 4, S = 2048). The CTA holds B, C, then one head's x
// (in C's place) and cb in shared memory, 198 KB at L = N = 128, P = 64:
// cb is formed once per CTA, on its triangle, and reused by its heads (5
// times a chunk there, 4% more operations than forming it once). cs is summed
// sequentially per head in float32 by one thread, the order of PyTorch's
// outer-dimension cumsum on the card, so the kernel and its plain version
// see the same decay exponents. A longer chunk (over 128 at N = 128) does
// not fit one CTA's shared memory and is refused. All arithmetic is FP32
// FMA on the CUDA cores with accurate expf. What bounds it on this card:
// its operations (cb, the y triangle and the state) against 67 TFLOP/s; the
// bytes (x in, y_diag and the states out) take 0.6x as long at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kW = 32;               // output columns of one thread item
constexpr size_t kMaxSmem = 232448;  // shared bytes one Hopper CTA can use

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Shared layout, in floats: B (L x NS), C then x (L x max(NS, XS)), cb
// (L x (L + 1)), cs, dt and w (L each). NS and XS pad N and P with zeros to
// whole kW items (NS 4 more, so that rows of B and C fall on other banks).
struct SsdSmem {
  int NS, XS, u, cb, cs, dt, w, total;
};

__host__ __device__ inline SsdSmem ssd_smem(int L, int N, int P) {
  SsdSmem s;
  s.NS = round_up(N, kW) + 4;
  s.XS = round_up(P, kW);
  s.u = L * s.NS;
  s.cb = s.u + L * (s.NS > s.XS ? s.NS : s.XS);
  s.cs = s.cb + L * (L + 1);
  s.dt = s.cs + L;
  s.w = s.dt + L;
  s.total = s.w + L;
  return s;
}

// grid (chunks, head groups): chunk blockIdx.x, heads [h0, h1) of group
// blockIdx.y, HG a group, with the layout ssd_smem in shared memory. One
// CTA an SM: the minimum of 1 keeps the y and state accumulators in
// registers (without it ptxas caps the registers and spills them, 20 %
// slower).
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_kernel(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ a, const float* __restrict__ bm,
    const float* __restrict__ cm, float* __restrict__ y,
    float* __restrict__ st, int L, int H, int P, int N, int HG) {
  extern __shared__ __align__(16) float sm[];
  const long long c = blockIdx.x;
  const int h0 = blockIdx.y * HG, h1 = min(H, h0 + HG);
  const SsdSmem lay = ssd_smem(L, N, P);
  const int NS = lay.NS, XS = lay.XS, LC = L + 1;
  float* Bs = sm;
  float* U = sm + lay.u;  // C, then the head's x
  float* CB = sm + lay.cb;
  float* cs = sm + lay.cs;
  float* dts = sm + lay.dt;
  float* wv = sm + lay.w;
  const int tid = threadIdx.x;

  for (int t = tid; t < L * NS; t += kThreads) {
    const int l = t / NS, n = t - l * NS;
    const bool in = n < N;
    Bs[t] = in ? bm[(c * L + l) * N + n] : 0.f;
    U[t] = in ? cm[(c * L + l) * N + n] : 0.f;
  }
  __syncthreads();

  // cb = C B^T on the lower triangle; item (l, q) forms m = 4q .. 4q + 3
  const int NQ = (L + 3) / 4;
  for (int t = tid; t < L * NQ; t += kThreads) {
    const int l = t % L, q4 = (t / L) * 4;
    if (q4 > l) continue;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const float* crow = U + l * NS;
    for (int n = 0; n < N; n += 4) {
      const float4 cv = *reinterpret_cast<const float4*>(crow + n);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int m = min(q4 + j, L - 1);
        const float4 bv = *reinterpret_cast<const float4*>(Bs + m * NS + n);
        float acc = s[j];
        acc = fmaf(cv.x, bv.x, acc);
        acc = fmaf(cv.y, bv.y, acc);
        acc = fmaf(cv.z, bv.z, acc);
        acc = fmaf(cv.w, bv.w, acc);
        s[j] = acc;
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (q4 + j <= l) CB[l * LC + q4 + j] = s[j];
  }

  for (int h = h0; h < h1; ++h) {
    __syncthreads();  // cb is done; the last head's x, cs and w are read
    for (int t = tid; t < L * XS; t += kThreads) {
      const int l = t / XS, p = t - l * XS;
      U[t] = p < P ? x[((c * L + l) * H + h) * P + p] : 0.f;
    }
    for (int l = tid; l < L; l += kThreads) dts[l] = dt[(c * L + l) * H + h];
    __syncthreads();
    if (tid == 0) {
      const float ah = a[h];
      float acc = 0.f;
      for (int l = 0; l < L; ++l) {
        acc = acc + dts[l] * ah;
        cs[l] = acc;
      }
    }
    __syncthreads();
    for (int l = tid; l < L; l += kThreads)
      wv[l] = expf(cs[L - 1] - cs[l]) * dts[l];
    __syncthreads();

    // y_diag: item (l, g) forms columns g kW .. g kW + kW - 1 of row l
    const int GY = XS / kW;
    for (int t = tid; t < L * GY; t += kThreads) {
      const int l = t % L, g = t / L;
      float acc[kW];
#pragma unroll
      for (int e = 0; e < kW; ++e) acc[e] = 0.f;
      const float csl = cs[l];
      for (int m = 0; m <= l; ++m) {
        const float sc = CB[l * LC + m] * expf(csl - cs[m]) * dts[m];
        const float4* xr =
            reinterpret_cast<const float4*>(U + m * XS + g * kW);
#pragma unroll
        for (int e4 = 0; e4 < kW / 4; ++e4) {
          const float4 xv = xr[e4];
          acc[4 * e4 + 0] = fmaf(sc, xv.x, acc[4 * e4 + 0]);
          acc[4 * e4 + 1] = fmaf(sc, xv.y, acc[4 * e4 + 1]);
          acc[4 * e4 + 2] = fmaf(sc, xv.z, acc[4 * e4 + 2]);
          acc[4 * e4 + 3] = fmaf(sc, xv.w, acc[4 * e4 + 3]);
        }
      }
      float* yr = y + ((c * L + l) * H + h) * P + g * kW;
#pragma unroll
      for (int e = 0; e < kW; ++e)
        if (g * kW + e < P) yr[e] = acc[e];
    }

    // state: item (p, g) forms columns g kW .. g kW + kW - 1 of row p
    const int GS = (NS - 4) / kW;
    for (int t = tid; t < P * GS; t += kThreads) {
      const int p = t % P, g = t / P;
      float acc[kW];
#pragma unroll
      for (int e = 0; e < kW; ++e) acc[e] = 0.f;
      for (int m = 0; m < L; ++m) {
        const float xw = U[m * XS + p] * wv[m];
        const float4* br =
            reinterpret_cast<const float4*>(Bs + m * NS + g * kW);
#pragma unroll
        for (int e4 = 0; e4 < kW / 4; ++e4) {
          const float4 bv = br[e4];
          acc[4 * e4 + 0] = fmaf(xw, bv.x, acc[4 * e4 + 0]);
          acc[4 * e4 + 1] = fmaf(xw, bv.y, acc[4 * e4 + 1]);
          acc[4 * e4 + 2] = fmaf(xw, bv.z, acc[4 * e4 + 2]);
          acc[4 * e4 + 3] = fmaf(xw, bv.w, acc[4 * e4 + 3]);
        }
      }
      float* sr = st + ((c * H + h) * P + p) * (long long)N + g * kW;
#pragma unroll
      for (int e = 0; e < kW; ++e)
        if (g * kW + e < N) sr[e] = acc[e];
    }
  }
}

}  // namespace

extern "C" {

// x (C, L, H, P), dt (C, L, H), a (H), bm and cm (C, L, N) -> y
// (C, L, H, P) and st (C, H, P, N), all float32; HG heads per CTA. The
// chunk's layout (ssd_smem, mirrored by the wrapper) must fit shared memory.
int sq_ssd_chunk(const float* x, const float* dt, const float* a,
                 const float* bm, const float* cm, float* y, float* st,
                 long long n_chunks, int L, int H, int P, int N, int HG,
                 void* stream) {
  if (n_chunks < 1 || n_chunks > 0x7fffffffLL || L < 1 || H < 1 || P < 1 ||
      N < 1 || HG < 1 || (H + HG - 1) / HG > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)ssd_smem(L, N, P).total * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t rc = cudaFuncSetAttribute(
        ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  dim3 grid((unsigned)n_chunks, (unsigned)((H + HG - 1) / HG));
  ssd_chunk_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      x, dt, a, bm, cm, y, st, L, H, P, N, HG);
  return (int)cudaGetLastError();
}

}  // extern "C"
