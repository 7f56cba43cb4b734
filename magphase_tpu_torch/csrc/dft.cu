// Real DFT for Hopper (sm_90a) as a radix-16 Stockham FFT in registers and
// shared memory: kernel K5 (rfft and irfft).
//
// Counterpart of the Pallas kernels _rfft_kernel and _irfft_kernel in
// tools/dft_pallas.py (entries rfft_fused, irfft_fused), which compute the
// same function as a two-stage matmul DFT.  This kernel computes it by
// another factorisation:
//
//   forward  x (rows, n) -> (re, im) (rows, h = n/2+1): the real row of n
//            is the complex row z[j] = x[2j] + i x[2j+1] of m = n/2
//            points; Z = FFT_m(z); then for k = 0..m, with Z[m] = Z[0],
//            X[k] = (Z[k] + conj Z[m-k])/2 - i W_n^k (Z[k] - conj Z[m-k])/2.
//   inverse  (re, im) -> y (rows, n): Im X[0] and Im X[m] are dropped (as
//            np.fft.irfft drops them); V[k] = (X[k] + conj X[m-k]) +
//            i W_n^-k (X[k] - conj X[m-k]); v = IFFT_m(V) unnormalised;
//            y[2j] = Re v[j] / n, y[2j+1] = Im v[j] / n (1/n is a power of
//            two, so the one scaling rounds nothing).
//
// FFT_m: T = m/16 threads serve a row and each holds 16 complex points in
// registers.  A pass of radix R multiplies each of its butterflies' R legs
// by the pass's twiddles and runs a hard-coded radix-R butterfly in
// registers; between passes the points go through shared memory in
// Stockham order, so no bit-reversal pass is needed.  The pass next to the
// bins (the forward's last, the inverse's first) gives each thread the two
// butterflies that hold bins k and m - k, so the pairing of k with m - k
// happens in registers.  The twiddles are a table (fft_twiddles in
// kernels/dft.py: float64, rounded once to float32), read through the
// read-only cache: per pass (R-1)*Ns entries W_{Ns R}^{r k}, then W_n^k
// for k <= m/2 (W_n^{m-k} = -conj W_n^k gives the rest).
//
// What bounds it: bytes.  A row of n = 4096 reads 16 KB and writes 16 KB;
// an FFT's ~2.5 n log2 n operations are ~3.7 per byte, far under the
// card's ~20 FP32 operations per byte of HBM bandwidth.  So the design
// keeps device memory to one read and one write, coalesced: the forward
// loads the row as float2 straight into registers (neighbouring threads on
// neighbouring addresses), the inverse stores it from registers the same
// way.  The bin planes' rows of h floats start only 4-byte aligned: the
// forward stages them in shared memory and stores their aligned middle as
// float4 (scalar stores there were slower on the card); the inverse loads
// them as scalars straight into registers (staging them cost more than it
// saved, as the loads then all finish before any arithmetic starts).  Two
// exchange buffers per row, so one barrier per exchange; each holds one
// float2 of padding per 16, so the stride-16 writes of the first pass and
// the contiguous reads hit distinct banks.  Rows with m < 2048 share a
// block, so that every block has 4 warps or more; __launch_bounds__ asks
// for 5 blocks of 128 threads per SM.  No tensor cores (TF32 keeps ~3
// digits), no atomics: two launches on one input are bitwise equal.  This
// kernel is on no production path, as the tool is not in the JAX package:
// it is driven by its tests and by chip_smoke.py's lossless witness.
//
// Plain C entry points (loaded with ctypes); each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kP = 16;            // complex points per thread
constexpr int kMinThreads = 128;  // rows share a block up to this many

// The plan of FFT_m for m = 2^L, forward: passes of radix 16 (and one of
// 2 or 4 where log2 m asks for it), then a tail pass of radix 2, 4 or 8;
// the inverse runs the same radices in reverse order.  The tail pass, the
// one next to the bins, has 2 or more butterflies per thread, so a thread
// can own both butterflies whose legs hold bins k and m - k.
__host__ __device__ constexpr int tail_bits(int L) {
  return L % 4 == 1 ? 1 : L % 4 == 2 ? 2 : 3;
}
__host__ __device__ constexpr int num_passes(int L) {
  return (L - tail_bits(L) + 3) / 4 + 1;
}
__host__ __device__ constexpr int fwd_radix(int L, int p) {
  return p == num_passes(L) - 1 ? 1 << tail_bits(L)
         : p < (L - tail_bits(L)) / 4 ? 16
                                      : 1 << ((L - tail_bits(L)) % 4);
}
__host__ __device__ constexpr int radix(int L, bool inv, int p) {
  return fwd_radix(L, inv ? num_passes(L) - 1 - p : p);
}
__host__ __device__ constexpr int stride_before(int L, bool inv, int p) {
  return p == 0 ? 1 : stride_before(L, inv, p - 1) * radix(L, inv, p - 1);
}
// offset of pass p's twiddles in the table (pass 0, Ns = 1, has none);
// p = num_passes(L) gives the offset of the W_n^k entries
__host__ __device__ constexpr int tw_offset(int L, bool inv, int p) {
  return p <= 1 ? 0
                : tw_offset(L, inv, p - 1) +
                      (radix(L, inv, p - 1) - 1) * stride_before(L, inv, p - 1);
}

template <int L>
struct Shape {
  static constexpr int M = 1 << L;          // complex points per row
  static constexpr int T = M / kP;          // threads per row
  static constexpr int ROWS = T >= kMinThreads ? 1 : kMinThreads / T;
  static constexpr int THREADS = T * ROWS;
  static constexpr int PITCH = M + M / 16;  // padded float2 per buffer
  // two exchange buffers per row, so one barrier per exchange suffices
  static constexpr int SMEM = ROWS * 2 * PITCH * (int)sizeof(float2);
};

__device__ __forceinline__ int pad(int q) { return q + (q >> 4); }

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// a * W_16^e (forward, e^{-2 pi i e/16}) or its conjugate (inverse), for a
// compile-time e in [0, 8): the unit and -i/+i cases move no data
template <bool INV>
__device__ __forceinline__ float2 rot16(float2 a, int e) {
  constexpr float c1 = 0.923879532511286756f;  // cos(pi/8)
  constexpr float s1 = 0.382683432365089772f;  // sin(pi/8)
  constexpr float h = 0.707106781186547524f;   // sqrt(1/2)
  if (e == 0) return a;
  if (e == 4) return INV ? make_float2(-a.y, a.x) : make_float2(a.y, -a.x);
  float c = 0.0f, s = 0.0f;
  switch (e) {
    case 1: c = c1; s = s1; break;
    case 2: c = h; s = h; break;
    case 3: c = s1; s = c1; break;
    case 5: c = -s1; s = c1; break;
    case 6: c = -h; s = h; break;
    case 7: c = -c1; s = s1; break;
  }
  return cmul(a, make_float2(c, INV ? s : -s));
}

__host__ __device__ constexpr int bit_reverse(int i, int bits) {
  return bits == 0 ? 0 : ((i & 1) << (bits - 1)) | bit_reverse(i >> 1, bits - 1);
}

// in-register DFT of R points, natural order in and out (radix-2 steps on
// compile-time indices: the permutation is register renaming).  The inner
// loop's trip count does not depend on the step, so both loops unroll
// fully and every index into t[] and every rot16 case is a constant.
template <int R, bool INV>
__device__ __forceinline__ void butterfly(float2 (&a)[R]) {
  constexpr int BITS = R == 16 ? 4 : R == 8 ? 3 : R == 4 ? 2 : 1;
  float2 t[R];
#pragma unroll
  for (int i = 0; i < R; ++i) t[bit_reverse(i, BITS)] = a[i];
#pragma unroll
  for (int step = 0; step < BITS; ++step) {
    const int half = 1 << step;
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {  // pairs (g + q, g + q + half)
      const int q = i & (half - 1);
      const int lo = 2 * (i - q) + q;
      const float2 u = t[lo];
      const float2 w = rot16<INV>(t[lo + half], q * (8 / half));
      t[lo] = make_float2(u.x + w.x, u.y + w.y);
      t[lo + half] = make_float2(u.x - w.x, u.y - w.y);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) a[i] = t[i];
}

// Butterfly b of thread j in pass PASS.  In the tail pass thread j owns the
// pairs (a, NB - a) for a = j + c*T (a = 0 pairs with NB/2 instead; both
// pair within themselves), at b = 2c and 2c + 1: the legs of a hold bins
// k = a + r*NB, and those of its partner bins m - k.  In the other passes
// thread j owns j + b*T.
template <int L, bool INV, int PASS>
__device__ __forceinline__ int butterfly_of(int j, int b) {
  constexpr int T = Shape<L>::T;
  constexpr int NB = Shape<L>::M / radix(L, INV, PASS);
  if constexpr (PASS != (INV ? 0 : num_passes(L) - 1)) {
    return j + b * T;
  } else {
    const int a = j + (b / 2) * T;
    return b % 2 == 0 ? a : a == 0 ? NB / 2 : NB - a;
  }
}

// Stockham pass PASS of FFT_m and the ones after it.  Butterfly jj's R legs
// are points jj + r*m/R, held by its thread in slots b + r*(16/R); its
// outputs go to expand(jj) + r*Ns, expand(jj) = (jj/Ns)*Ns*R + jj%Ns.  The
// last pass (Ns*R = m) keeps them in the slots they came from; the others
// write them to exchange buffer PASS % 2, which the next pass reads its
// legs from.
template <int L, bool INV, int PASS>
__device__ __forceinline__ void fft_passes(float2 (&v)[kP], float2* buf,
                                           int j,
                                           const float2* __restrict__ tw) {
  constexpr int M = Shape<L>::M, PITCH = Shape<L>::PITCH;
  constexpr int R = radix(L, INV, PASS);
  constexpr int NS = stride_before(L, INV, PASS);
  constexpr int B = kP / R;
  constexpr bool LAST = PASS + 1 == num_passes(L);
  if constexpr (PASS > 0) {
    const float2* src = buf + ((PASS - 1) % 2) * PITCH;
#pragma unroll
    for (int b = 0; b < B; ++b) {
      const int jj = butterfly_of<L, INV, PASS>(j, b);
#pragma unroll
      for (int r = 0; r < R; ++r) v[b + r * B] = src[pad(jj + r * (M / R))];
    }
  }
  const float2* twp = tw + tw_offset(L, INV, PASS);
  float2* dst = buf + (PASS % 2) * PITCH;
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int jj = butterfly_of<L, INV, PASS>(j, b);
    const int k = jj & (NS - 1);
    float2 a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = v[b + r * B];
    if constexpr (NS > 1) {
#pragma unroll
      for (int r = 1; r < R; ++r)
        a[r] = cmul(a[r], __ldg(twp + (r - 1) * NS + k));
    }
    butterfly<R, INV>(a);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (LAST)
        v[b + r * B] = a[r];
      else
        dst[pad((jj - k) * R + k + r * NS)] = a[r];
    }
  }
  if constexpr (!LAST) {
    __syncthreads();
    fft_passes<L, INV, PASS + 1>(v, buf, j, tw);
  }
}

// W_n^k for 0 <= k < m from the table's k <= m/2 entries
template <int L>
__device__ __forceinline__ float2 post_twiddle(const float2* __restrict__ w,
                                               int k) {
  constexpr int M = 1 << L;
  if (k <= M / 2) return __ldg(w + k);
  const float2 c = __ldg(w + (M - k));
  return make_float2(-c.x, c.y);
}

// X[k] and X[m-k] from a = Z[k], b = Z[m-k] and w = W_n^k:
// X[k] = (S - i w D)/2 and X[m-k] = conj(S + i w D)/2, where
// S = a + conj b and D = a - conj b
template <int M>
__device__ __forceinline__ void store_bin_pair(float2 a, float2 b, float2 w,
                                               int k, float* rrow,
                                               float* irow) {
  const float sr = a.x + b.x, si = a.y - b.y;
  const float2 q = cmul(w, make_float2(a.x - b.x, a.y + b.y));
  rrow[k] = 0.5f * (sr + q.y);
  irow[k] = 0.5f * (si - q.x);
  rrow[M - k] = 0.5f * (sr - q.y);
  irow[M - k] = -0.5f * (si + q.x);
}

// V[k] and V[m-k] from a = X[k], b = X[m-k] and w = W_n^-k:
// V[k] = S + i w D and V[m-k] = conj S + i conj(w D), with S and D as above
__device__ __forceinline__ void spectrum_pair(float2 a, float2 b, float2 w,
                                              float2& vk, float2& vmk) {
  const float sr = a.x + b.x, si = a.y - b.y;
  const float2 q = cmul(w, make_float2(a.x - b.x, a.y + b.y));
  vk = make_float2(sr - q.y, si + q.x);
  vmk = make_float2(sr + q.y, q.x - si);
}

// A row of h bin floats starts only 4-byte aligned in its plane.  In
// shared memory the forward stages it at the same offset modulo 16 bytes
// (element i at s[i + lag], lag = the row's address / 4 mod 4), so that the
// row's 16-byte aligned middle moves as float4, neighbouring threads on
// neighbouring addresses; the head and tail (at most 3 floats each) move
// as scalars.
__device__ __forceinline__ int lag_of(const float* row) {
  return (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
}

template <int H, int T>
__device__ __forceinline__ void plane_to_global(const float* s, float* row,
                                                int j) {
  const int lag = lag_of(row);
  const int head = (4 - lag) & 3;
  const int quads = (H - head) / 4;
  const int tail = head + 4 * quads;
  if (j < head) row[j] = s[lag + j];
  const float4* s4 = reinterpret_cast<const float4*>(s + lag + head);
  float4* g4 = reinterpret_cast<float4*>(row + head);
#pragma unroll
  for (int q = j; q < quads; q += T) g4[q] = s4[q];
  if (j < H - tail) row[tail + j] = s[lag + tail + j];
}

template <int L>
__global__ void __launch_bounds__(Shape<L>::THREADS, 640 / Shape<L>::THREADS)
    rfft_kernel(const float* __restrict__ x, float* __restrict__ re,
                float* __restrict__ im, const float2* __restrict__ tw,
                int rows) {
  constexpr int M = Shape<L>::M, T = Shape<L>::T, H = M + 1;
  constexpr int P = num_passes(L), PITCH = Shape<L>::PITCH;
  constexpr int R = radix(L, false, P - 1);  // the tail pass
  constexpr int B = kP / R, NB = M / R;
  extern __shared__ float2 smem[];
  const int lr = threadIdx.x / T, j = threadIdx.x % T;
  const int64_t row = (int64_t)blockIdx.x * Shape<L>::ROWS + lr;
  const bool live = row < rows;

  // a padding row of a partly filled block computes on the last row
  float2 v[kP];
  const float2* xrow =
      reinterpret_cast<const float2*>(x) + (live ? row : rows - 1) * M;
#pragma unroll
  for (int s = 0; s < kP; ++s) v[s] = __ldg(xrow + j + s * T);
  float2* buf = smem + lr * 2 * PITCH;
  fft_passes<L, false, 0>(v, buf, j, tw);

  // slots b + r*B hold Z[butterfly_of(j, b) + r*NB]: pair k with m - k into
  // the bin planes, staged in the buffer the last pass did not read from
  const int64_t out = (live ? row : rows - 1) * H;
  float* sr = reinterpret_cast<float*>(buf + ((P - 1) % 2) * PITCH);
  float* si = sr + ((H + 6) & ~3);
  float* rrow = sr + lag_of(re + out);
  float* irow = si + lag_of(im + out);
  const float2* w = tw + tw_offset(L, false, P);
#pragma unroll
  for (int c = 0; c < B / 2; ++c) {
    const int a = j + c * T;
    if (a != 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = a + r * NB;
        store_bin_pair<M>(v[2 * c + r * B], v[2 * c + 1 + (R - 1 - r) * B],
                          post_twiddle<L>(w, k), k, rrow, irow);
      }
    } else {  // butterflies 0 and NB/2 pair within themselves
      rrow[0] = v[0].x + v[0].y;
      irow[0] = 0.0f;
      rrow[M] = v[0].x - v[0].y;
      irow[M] = 0.0f;
#pragma unroll
      for (int r = 1; r < R / 2; ++r)
        store_bin_pair<M>(v[r * B], v[(R - r) * B],
                          post_twiddle<L>(w, r * NB), r * NB, rrow, irow);
      rrow[M / 2] = v[(R / 2) * B].x;  // X[m/2] = conj Z[m/2]
      irow[M / 2] = -v[(R / 2) * B].y;
#pragma unroll
      for (int r = 0; r < R / 2; ++r) {
        const int k = NB / 2 + r * NB;
        store_bin_pair<M>(v[1 + r * B], v[1 + (R - 1 - r) * B],
                          post_twiddle<L>(w, k), k, rrow, irow);
      }
    }
  }
  __syncthreads();
  if (!live) return;
  plane_to_global<H, T>(sr, re + out, j);
  plane_to_global<H, T>(si, im + out, j);
}

template <int L>
__global__ void __launch_bounds__(Shape<L>::THREADS, 640 / Shape<L>::THREADS)
    irfft_kernel(const float* __restrict__ zr, const float* __restrict__ zi,
                 float* __restrict__ y, const float2* __restrict__ tw,
                 int rows) {
  constexpr int M = Shape<L>::M, T = Shape<L>::T, H = M + 1;
  constexpr int R = radix(L, true, 0);  // the tail pass comes first
  constexpr int B = kP / R, NB = M / R;
  extern __shared__ float2 smem[];
  const int lr = threadIdx.x / T, j = threadIdx.x % T;
  const int64_t row = (int64_t)blockIdx.x * Shape<L>::ROWS + lr;
  const bool live = row < rows;

  // V[k] for the bins of the first pass's butterflies, straight from the
  // planes (a padding row of a partly filled block reads the last row)
  const int64_t src = (live ? row : rows - 1) * H;
  const float* xr = zr + src;
  const float* xi = zi + src;
  const float2* w = tw + tw_offset(L, true, num_passes(L));
  auto bin = [&](int k) { return make_float2(__ldg(xr + k), __ldg(xi + k)); };
  float2 v[kP];
#pragma unroll
  for (int c = 0; c < B / 2; ++c) {
    const int a = j + c * T;
    if (a != 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int k = a + r * NB;
        spectrum_pair(bin(k), bin(M - k), post_twiddle<L>(w, k),
                      v[2 * c + r * B], v[2 * c + 1 + (R - 1 - r) * B]);
      }
    } else {  // butterflies 0 and NB/2; Im X[0] and Im X[m] are not read
      const float x0 = __ldg(xr), xm = __ldg(xr + M);
      v[0] = make_float2(x0 + xm, x0 - xm);
#pragma unroll
      for (int r = 1; r < R / 2; ++r)
        spectrum_pair(bin(r * NB), bin(M - r * NB),
                      post_twiddle<L>(w, r * NB), v[r * B], v[(R - r) * B]);
      float2 unused;
      spectrum_pair(bin(M / 2), bin(M / 2), post_twiddle<L>(w, M / 2),
                    v[(R / 2) * B], unused);
#pragma unroll
      for (int r = 0; r < R / 2; ++r) {
        const int k = NB / 2 + r * NB;
        spectrum_pair(bin(k), bin(M - k), post_twiddle<L>(w, k),
                      v[1 + r * B], v[1 + (R - 1 - r) * B]);
      }
    }
  }
  fft_passes<L, true, 0>(v, smem + lr * 2 * Shape<L>::PITCH, j, tw);

  if (!live) return;
  constexpr float inv_n = 1.0f / (2 * M);
  float2* yrow = reinterpret_cast<float2*>(y) + row * M;
#pragma unroll
  for (int s = 0; s < kP; ++s)
    yrow[j + s * T] = make_float2(v[s].x * inv_n, v[s].y * inv_n);
}

template <int L>
cudaError_t launch_rfft(const float* x, float* re, float* im,
                        const float2* tw, int rows, cudaStream_t stream) {
  using S = Shape<L>;
  cudaError_t e = cudaFuncSetAttribute(
      rfft_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (e != cudaSuccess) return e;
  const int blocks = (rows + S::ROWS - 1) / S::ROWS;
  rfft_kernel<L><<<blocks, S::THREADS, S::SMEM, stream>>>(x, re, im, tw,
                                                          rows);
  return cudaGetLastError();
}

template <int L>
cudaError_t launch_irfft(const float* zr, const float* zi, float* y,
                         const float2* tw, int rows, cudaStream_t stream) {
  using S = Shape<L>;
  cudaError_t e = cudaFuncSetAttribute(
      irfft_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (e != cudaSuccess) return e;
  const int blocks = (rows + S::ROWS - 1) / S::ROWS;
  irfft_kernel<L><<<blocks, S::THREADS, S::SMEM, stream>>>(zr, zi, y, tw,
                                                           rows);
  return cudaGetLastError();
}

template <typename K>
cudaError_t occupancy(K kernel, int threads, int rows_per_block, int smem,
                      int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  out[0] = threads;
  out[1] = rows_per_block;
  out[2] = smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 3, kernel,
                                                       threads, smem);
}

template <int L>
cudaError_t occupancy_of(bool inverse, int* out) {
  using S = Shape<L>;
  return inverse ? occupancy(irfft_kernel<L>, S::THREADS, S::ROWS, S::SMEM, out)
                 : occupancy(rfft_kernel<L>, S::THREADS, S::ROWS, S::SMEM, out);
}

}  // namespace

extern "C" {

// x (rows, n) -> re, im (rows, n/2 + 1); tw = fft_twiddles(n, False);
// n in {256, 512, ..., 8192}
int mp_rfft_fused(const float* x, float* re, float* im, const float* tw,
                  int rows, int n, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const float2* t = reinterpret_cast<const float2*>(tw);
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 256: return (int)launch_rfft<7>(x, re, im, t, rows, s);
    case 512: return (int)launch_rfft<8>(x, re, im, t, rows, s);
    case 1024: return (int)launch_rfft<9>(x, re, im, t, rows, s);
    case 2048: return (int)launch_rfft<10>(x, re, im, t, rows, s);
    case 4096: return (int)launch_rfft<11>(x, re, im, t, rows, s);
    case 8192: return (int)launch_rfft<12>(x, re, im, t, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// zr, zi (rows, n/2 + 1) -> y (rows, n); tw = fft_twiddles(n, True)
int mp_irfft_fused(const float* zr, const float* zi, float* y,
                   const float* tw, int rows, int n, void* stream) {
  if (rows <= 0) return (int)cudaGetLastError();
  const float2* t = reinterpret_cast<const float2*>(tw);
  cudaStream_t s = (cudaStream_t)stream;
  switch (n) {
    case 256: return (int)launch_irfft<7>(zr, zi, y, t, rows, s);
    case 512: return (int)launch_irfft<8>(zr, zi, y, t, rows, s);
    case 1024: return (int)launch_irfft<9>(zr, zi, y, t, rows, s);
    case 2048: return (int)launch_irfft<10>(zr, zi, y, t, rows, s);
    case 4096: return (int)launch_irfft<11>(zr, zi, y, t, rows, s);
    case 8192: return (int)launch_irfft<12>(zr, zi, y, t, rows, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out[4] = threads per block, rows per block, dynamic shared memory bytes,
// resident blocks per SM, of the n-point forward or inverse kernel
int mp_dft_occupancy(int n, int inverse, int* out) {
  switch (n) {
    case 256: return (int)occupancy_of<7>(inverse, out);
    case 512: return (int)occupancy_of<8>(inverse, out);
    case 1024: return (int)occupancy_of<9>(inverse, out);
    case 2048: return (int)occupancy_of<10>(inverse, out);
    case 4096: return (int)occupancy_of<11>(inverse, out);
    case 8192: return (int)occupancy_of<12>(inverse, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
