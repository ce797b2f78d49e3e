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
// Here one thread per coordinate runs the digit loop and sums in integers,
// exact for every level the wrappers accept (s^r < 2^31, compact sides
// below 2^31); the code tables (H_nu (s, s), H_lambda (k, 2)) sit in shared
// memory. What bounds them on this card: each coordinate reads 8 bytes and
// writes 8 (lambda) or 9 (nu), against r division/modulus pairs. The
// divisor (s for nu, k for lambda) is a template constant for the registry's
// fractals, so a pair is a multiply-high and a few integer operations and
// the kernels are bound by bytes; another divisor takes the runtime path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCtas = 132 * 16;  // grid-stride: 16 CTAs per SM

unsigned grid_for(long long count) {
  long long ctas = (count + kThreads - 1) / kThreads;
  return (unsigned)(ctas < kMaxCtas ? ctas : kMaxCtas);
}

// S > 0: s is the constant S; S == 0: s_rt.
template <int S>
__global__ void __launch_bounds__(kThreads)
nu_kernel(const int* __restrict__ ex, const int* __restrict__ ey,
          int* __restrict__ cx, int* __restrict__ cy,
          uint8_t* __restrict__ valid, long long count, int r, int s_rt,
          int k, int n, const int* __restrict__ h_nu) {
  extern __shared__ int hn[];  // (s, s) indexed [y][x]
  const unsigned s = S > 0 ? (unsigned)S : (unsigned)s_rt;
  for (int t = threadIdx.x; t < (int)(s * s); t += blockDim.x)
    hn[t] = h_nu[t];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    const int x = ex[i], y = ey[i];
    bool ok = x >= 0 && x < n && y >= 0 && y < n;
    unsigned ux = (unsigned)min(max(x, 0), n - 1);
    unsigned uy = (unsigned)min(max(y, 0), n - 1);
    long long ax = 0, ay = 0, wx = 1, wy = 1;
    for (int mu = 1; mu <= r; ++mu) {
      const unsigned tx = ux % s, ty = uy % s;
      ux /= s;
      uy /= s;
      int code = hn[ty * s + tx];
      ok = ok && code >= 0;
      code = max(code, 0);
      if (mu & 1) {
        ax += code * wx;
        wx *= k;
      } else {
        ay += code * wy;
        wy *= k;
      }
    }
    cx[i] = (int)ax;
    cy[i] = (int)ay;
    valid[i] = ok;
  }
}

// Floor division of q by d > 0: q becomes floor(q / d), the result is the
// non-negative remainder. Inlined, so a constant d divides by a constant.
__device__ __forceinline__ int floor_divmod(int& q, int d) {
  int quot = q / d;
  int rem = q - quot * d;
  if (rem < 0) {
    rem += d;
    quot -= 1;
  }
  q = quot;
  return rem;
}

// K > 0: k is the constant K; K == 0: k_rt.
template <int K>
__global__ void __launch_bounds__(kThreads)
lambda_kernel(const int* __restrict__ cx, const int* __restrict__ cy,
              int* __restrict__ ex, int* __restrict__ ey, long long count,
              int r, int s, int k_rt, const int* __restrict__ h_lambda) {
  extern __shared__ int hl[];  // (k, 2): tau_x, tau_y of each replica
  const int k = K > 0 ? K : k_rt;
  for (int t = threadIdx.x; t < 2 * k; t += blockDim.x) hl[t] = h_lambda[t];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += stride) {
    int qx = cx[i], qy = cy[i];
    int ax = 0, ay = 0, scale = 1;
    for (int mu = 1; mu <= r; ++mu) {
      const int beta = floor_divmod((mu & 1) ? qx : qy, k);
      ax += hl[2 * beta] * scale;
      ay += hl[2 * beta + 1] * scale;
      if (mu < r) scale *= s;
    }
    ex[i] = ax;
    ey[i] = ay;
  }
}

template <int S>
int launch_nu(const int* ex, const int* ey, int* cx, int* cy, uint8_t* valid,
              long long count, int r, int s, int k, int n, const int* h_nu,
              cudaStream_t stream) {
  nu_kernel<S><<<grid_for(count), kThreads, s * s * sizeof(int), stream>>>(
      ex, ey, cx, cy, valid, count, r, s, k, n, h_nu);
  return (int)cudaGetLastError();
}

template <int K>
int launch_lambda(const int* cx, const int* cy, int* ex, int* ey,
                  long long count, int r, int s, int k, const int* h_lambda,
                  cudaStream_t stream) {
  lambda_kernel<K><<<grid_for(count), kThreads, 2 * k * sizeof(int),
                     stream>>>(cx, cy, ex, ey, count, r, s, k, h_lambda);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// nu(w) over `count` int32 coordinates; n = s^r < 2^31; h_nu (s, s) int32
// on the card. Writes int32 cx, cy and uint8 valid.
int sq_nu_map(const int* ex, const int* ey, int* cx, int* cy, uint8_t* valid,
              long long count, int r, int s, int k, int n, const int* h_nu,
              void* stream) {
  if (count < 1 || r < 0 || s < 2 || k < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (s) {
    case 2: return launch_nu<2>(ex, ey, cx, cy, valid, count, r, s, k, n,
                                h_nu, st);
    case 3: return launch_nu<3>(ex, ey, cx, cy, valid, count, r, s, k, n,
                                h_nu, st);
    default: return launch_nu<0>(ex, ey, cx, cy, valid, count, r, s, k, n,
                                 h_nu, st);
  }
}

// lambda(w) over `count` int32 compact coordinates (any sign); s^r < 2^31;
// h_lambda (k, 2) int32 on the card. Writes int32 ex, ey.
int sq_lambda_map(const int* cx, const int* cy, int* ex, int* ey,
                  long long count, int r, int s, int k, const int* h_lambda,
                  void* stream) {
  if (count < 1 || r < 0 || s < 2 || k < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 3: return launch_lambda<3>(cx, cy, ex, ey, count, r, s, k, h_lambda,
                                    st);
    case 5: return launch_lambda<5>(cx, cy, ex, ey, count, r, s, k, h_lambda,
                                    st);
    case 7: return launch_lambda<7>(cx, cy, ex, ey, count, r, s, k, h_lambda,
                                    st);
    case 8: return launch_lambda<8>(cx, cy, ex, ey, count, r, s, k, h_lambda,
                                    st);
    default: return launch_lambda<0>(cx, cy, ex, ey, count, r, s, k,
                                     h_lambda, st);
  }
}

}  // extern "C"
