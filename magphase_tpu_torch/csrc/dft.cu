// Fused two-stage DFT for Hopper (sm_90a): kernel K5 (rfft and irfft).
//
// Counterpart of the Pallas kernels _rfft_kernel and _irfft_kernel in
// tools/dft_pallas.py (entries rfft_fused, irfft_fused).  For n = n1 * 128,
// input index j = j1*128 + j2 and output index k = k2*n1 + k1:
//
//   X[k2*n1 + k1] = sum_j2 D2[j2,k2] TW[j2,k1] sum_j1 D1[j1,k1] x[j1*128 + j2]
//
// stage 1 (n1-point DFTs over j1), the twiddle, stage 2 (128-point DFTs
// over j2), all in one block per row, in FP32 FMAs on the CUDA cores.  The
// tables (D1, TW, D2) are the tool's, computed in float64 and rounded once
// to float32 on the host, and read through the read-only cache.  The
// inverse takes the h = n/2+1 bins weighted by [1, 2, ..., 2, 1]/n (the
// hermitian mirror folded into the stored bins), zero-padded to n: stage 1
// contracts only the j1 < n1/2 + 1 rows that the padded spectrum occupies,
// and stage 2 computes only the real output.  The forward keeps only the
// bins k < h (k2 < 64, and k2 = 64 for k1 = 0).
//
// What bounds it: FP32 operations of its own form.  A row of n = 4096
// costs ~2.6 MFLOP of the two-stage form against 32 KB of input and
// output, ~80 operations per byte, far above the card's ~20 FP32
// operations per byte of HBM bandwidth.  The DFT itself needs far less: an
// FFT does ~20x fewer operations and is bound by its bytes, so this form
// cannot reach the function's floor.  Design: the row and the (j2, k1)
// planes live in shared memory (the planes with a row pitch of 129
// floats, so that both stages touch distinct banks); each thread holds 8 (fewer for small n1)
// accumulators of one output column and reads the table rows it needs as
// float4 vectors, so each j-step is a few loads against 16-32 FMAs.  No
// tensor cores: TF32 keeps ~3 digits and the port holds K5 to 1e-5.  This
// kernel is on no production path, as the tool is not in the JAX package:
// it is driven by its tests and by chip_smoke.py's lossless witness.
//
// Plain C entry points (loaded with ctypes); each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN2 = 128;       // stage-2 length: j2 and k2 run over 128
constexpr int kPitch = kN2 + 1;  // row pitch of the (k1, j2) planes in smem
constexpr int kThreads = 256;

__host__ __device__ constexpr int clamp_chunk(int c) { return c < 1 ? 1 : (c > 8 ? 8 : c); }

struct Tables {
  const float *d1r, *d1i;  // (n1, n1)   [j1, k1]
  const float *twr, *twi;  // (128, n1)  [j2, k1]
  const float *d2r, *d2i;  // (128, 128) [j2, k2]
};

// v[0..C) = p[0..C), as float4 loads where C is a multiple of 4 (p is then
// 16-byte aligned: every table row and chunk offset is a multiple of 4)
template <int C>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int i = 0; i < C; i += 4) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p + i));
      v[i] = q.x;
      v[i + 1] = q.y;
      v[i + 2] = q.z;
      v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < C; ++i) v[i] = __ldg(p + i);
  }
}

// Stage 1 + twiddle for one row held in smem: B[k1][j2] (pitch kPitch) =
// TW[j2,k1] * sum_{j1 < J1} z[j1*128 + j2] D1[j1,k1], for a real input z = zr
// or a complex one (zr, zi).  Each task is one j2 and C1 consecutive k1.
template <int N1, int J1, bool kComplex>
__device__ __forceinline__ void stage1(const float* zr, const float* zi,
                                       float* br, float* bi, const Tables& t) {
  constexpr int C1 = N1 < 8 ? N1 : 8;
  for (int task = threadIdx.x; task < kN2 * (N1 / C1); task += kThreads) {
    const int j2 = task % kN2;
    const int k1_0 = (task / kN2) * C1;
    float ar[C1], ai[C1];
#pragma unroll
    for (int c = 0; c < C1; ++c) ar[c] = ai[c] = 0.0f;
#pragma unroll 4
    for (int j1 = 0; j1 < J1; ++j1) {
      float dr[C1], di[C1];
      load_row<C1>(t.d1r + j1 * N1 + k1_0, dr);
      load_row<C1>(t.d1i + j1 * N1 + k1_0, di);
      const float xr = zr[j1 * kN2 + j2];
      if constexpr (!kComplex) {
#pragma unroll
        for (int c = 0; c < C1; ++c) {
          ar[c] = fmaf(xr, dr[c], ar[c]);
          ai[c] = fmaf(xr, di[c], ai[c]);
        }
      } else {
        const float xi = zi[j1 * kN2 + j2];
#pragma unroll
        for (int c = 0; c < C1; ++c) {
          ar[c] = fmaf(xr, dr[c], fmaf(-xi, di[c], ar[c]));
          ai[c] = fmaf(xr, di[c], fmaf(xi, dr[c], ai[c]));
        }
      }
    }
    float wr[C1], wi[C1];
    load_row<C1>(t.twr + j2 * N1 + k1_0, wr);
    load_row<C1>(t.twi + j2 * N1 + k1_0, wi);
#pragma unroll
    for (int c = 0; c < C1; ++c) {
      br[(k1_0 + c) * kPitch + j2] = ar[c] * wr[c] - ai[c] * wi[c];
      bi[(k1_0 + c) * kPitch + j2] = ar[c] * wi[c] + ai[c] * wr[c];
    }
  }
}

template <int N1>
__global__ void __launch_bounds__(kThreads)
    rfft_kernel(const float* __restrict__ x, float* __restrict__ re,
                float* __restrict__ im, Tables t) {
  constexpr int N = N1 * kN2;
  constexpr int H = N / 2 + 1;
  constexpr int K2 = 64;                        // k2 < 64 gives k < N/2
  constexpr int C2 = clamp_chunk(N1 / 4);       // k2 per thread
  extern __shared__ float smem[];
  float* xs = smem;                             // the row, then 2H outputs
  float* br = smem + N + 2;                     // (k1, j2) planes
  float* bi = br + N1 * kPitch;
  const int64_t row = blockIdx.x;

  const float* xrow = x + row * N;
  for (int i = threadIdx.x; i < N; i += kThreads) xs[i] = xrow[i];
  __syncthreads();
  stage1<N1, N1, false>(xs, nullptr, br, bi, t);
  __syncthreads();

  // stage 2: C[k1, k2] = sum_j2 B[k1][j2] D2[j2, k2] for k2 < 64; each task
  // is one k1 and C2 consecutive k2; results to xs as re[k], then im[k]
  for (int task = threadIdx.x; task < N1 * (K2 / C2); task += kThreads) {
    const int k1 = task % N1;
    const int k2_0 = (task / N1) * C2;
    float cr[C2], ci[C2];
#pragma unroll
    for (int c = 0; c < C2; ++c) cr[c] = ci[c] = 0.0f;
    const float* bpr = br + k1 * kPitch;
    const float* bpi = bi + k1 * kPitch;
#pragma unroll 2
    for (int j2 = 0; j2 < kN2; ++j2) {
      float dr[C2], di[C2];
      load_row<C2>(t.d2r + j2 * kN2 + k2_0, dr);
      load_row<C2>(t.d2i + j2 * kN2 + k2_0, di);
      const float b_r = bpr[j2], b_i = bpi[j2];
#pragma unroll
      for (int c = 0; c < C2; ++c) {
        cr[c] = fmaf(b_r, dr[c], fmaf(-b_i, di[c], cr[c]));
        ci[c] = fmaf(b_r, di[c], fmaf(b_i, dr[c], ci[c]));
      }
    }
#pragma unroll
    for (int c = 0; c < C2; ++c) {
      const int k = (k2_0 + c) * N1 + k1;
      xs[k] = cr[c];
      xs[H + k] = ci[c];
    }
  }
  // the Nyquist bin k = N/2 (k2 = 64, k1 = 0), by the first warp
  if (threadIdx.x < 32) {
    float sr = 0.0f, si = 0.0f;
    for (int j2 = threadIdx.x; j2 < kN2; j2 += 32) {
      const float dr = __ldg(t.d2r + j2 * kN2 + K2);
      const float di = __ldg(t.d2i + j2 * kN2 + K2);
      const float b_r = br[j2], b_i = bi[j2];
      sr = fmaf(b_r, dr, fmaf(-b_i, di, sr));
      si = fmaf(b_r, di, fmaf(b_i, dr, si));
    }
    for (int off = 16; off > 0; off >>= 1) {
      sr += __shfl_xor_sync(0xffffffffu, sr, off);
      si += __shfl_xor_sync(0xffffffffu, si, off);
    }
    if (threadIdx.x == 0) {
      xs[N / 2] = sr;
      xs[H + N / 2] = si;
    }
  }
  __syncthreads();
  float* rrow = re + row * H;
  float* irow = im + row * H;
  for (int k = threadIdx.x; k < H; k += kThreads) {
    rrow[k] = xs[k];
    irow[k] = xs[H + k];
  }
}

template <int N1>
__global__ void __launch_bounds__(kThreads)
    irfft_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                 const float* __restrict__ w, float* __restrict__ y,
                 Tables t) {
  constexpr int N = N1 * kN2;
  constexpr int H = N / 2 + 1;
  constexpr int J1 = N1 / 2 + 1;                // j1 rows the spectrum fills
  constexpr int C2 = clamp_chunk(N1 / 2);       // k2 per thread
  extern __shared__ float smem[];
  float* zs_r = smem;                           // J1*128 each; then the output
  float* zs_i = smem + J1 * kN2;
  float* br = smem + 2 * J1 * kN2;
  float* bi = br + N1 * kPitch;
  const int64_t row = blockIdx.x;

  // the weighted half spectrum, zero-padded to J1*128 bins
  const float* zrow_r = zr + row * H;
  const float* zrow_i = zi + row * H;
  for (int j = threadIdx.x; j < J1 * kN2; j += kThreads) {
    float a = 0.0f, b = 0.0f;
    if (j < H) {
      const float wj = __ldg(w + j);
      a = zrow_r[j] * wj;
      b = zrow_i[j] * wj;
    }
    zs_r[j] = a;
    zs_i[j] = b;
  }
  __syncthreads();
  stage1<N1, J1, true>(zs_r, zs_i, br, bi, t);
  __syncthreads();

  // stage 2, real part only: y[k2*N1 + k1] = sum_j2 Br D2r - Bi D2i over all
  // 128 k2; each task is one k1 and C2 consecutive k2; results to smem
  float* ys = smem;
  for (int task = threadIdx.x; task < N1 * (kN2 / C2); task += kThreads) {
    const int k1 = task % N1;
    const int k2_0 = (task / N1) * C2;
    float cr[C2];
#pragma unroll
    for (int c = 0; c < C2; ++c) cr[c] = 0.0f;
    const float* bpr = br + k1 * kPitch;
    const float* bpi = bi + k1 * kPitch;
#pragma unroll 2
    for (int j2 = 0; j2 < kN2; ++j2) {
      float dr[C2], di[C2];
      load_row<C2>(t.d2r + j2 * kN2 + k2_0, dr);
      load_row<C2>(t.d2i + j2 * kN2 + k2_0, di);
      const float b_r = bpr[j2], b_i = bpi[j2];
#pragma unroll
      for (int c = 0; c < C2; ++c)
        cr[c] = fmaf(b_r, dr[c], fmaf(-b_i, di[c], cr[c]));
    }
#pragma unroll
    for (int c = 0; c < C2; ++c) ys[(k2_0 + c) * N1 + k1] = cr[c];
  }
  __syncthreads();
  float* yrow = y + row * N;
  for (int i = threadIdx.x; i < N; i += kThreads) yrow[i] = ys[i];
}

template <int N1>
cudaError_t launch_rfft(const float* x, float* re, float* im, const Tables& t,
                        int rows, cudaStream_t stream) {
  const int smem = (N1 * kN2 + 2 + 2 * N1 * kPitch) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      rfft_kernel<N1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  rfft_kernel<N1><<<rows, kThreads, smem, stream>>>(x, re, im, t);
  return cudaGetLastError();
}

template <int N1>
cudaError_t launch_irfft(const float* zr, const float* zi, const float* w,
                         float* y, const Tables& t, int rows,
                         cudaStream_t stream) {
  const int smem =
      (2 * (N1 / 2 + 1) * kN2 + 2 * N1 * kPitch) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      irfft_kernel<N1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  irfft_kernel<N1><<<rows, kThreads, smem, stream>>>(zr, zi, w, y, t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (rows, n1*128) -> re, im (rows, n1*64 + 1); n1 in {2, 4, ..., 64}
int mp_rfft_fused(const float* x, float* re, float* im, const float* d1r,
                  const float* d1i, const float* twr, const float* twi,
                  const float* d2r, const float* d2i, int rows, int n1,
                  void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const Tables t{d1r, d1i, twr, twi, d2r, d2i};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n1) {
    case 2: return (int)launch_rfft<2>(x, re, im, t, rows, s);
    case 4: return (int)launch_rfft<4>(x, re, im, t, rows, s);
    case 8: return (int)launch_rfft<8>(x, re, im, t, rows, s);
    case 16: return (int)launch_rfft<16>(x, re, im, t, rows, s);
    case 32: return (int)launch_rfft<32>(x, re, im, t, rows, s);
    case 64: return (int)launch_rfft<64>(x, re, im, t, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// zr, zi (rows, n1*64 + 1), w (n1*64 + 1) -> y (rows, n1*128)
int mp_irfft_fused(const float* zr, const float* zi, const float* w,
                   float* y, const float* d1r, const float* d1i,
                   const float* twr, const float* twi, const float* d2r,
                   const float* d2i, int rows, int n1, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const Tables t{d1r, d1i, twr, twi, d2r, d2i};
  cudaStream_t s = (cudaStream_t)stream;
  switch (n1) {
    case 2: return (int)launch_irfft<2>(zr, zi, w, y, t, rows, s);
    case 4: return (int)launch_irfft<4>(zr, zi, w, y, t, rows, s);
    case 8: return (int)launch_irfft<8>(zr, zi, w, y, t, rows, s);
    case 16: return (int)launch_irfft<16>(zr, zi, w, y, t, rows, s);
    case 32: return (int)launch_irfft<32>(zr, zi, w, y, t, rows, s);
    case 64: return (int)launch_irfft<64>(zr, zi, w, y, t, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
