// Pitch-synchronous framing and overlap-add kernels for Hopper (sm_90a).
//
// Counterparts of the Pallas kernels in
// magphase_tpu/pallas_kernels/framing_pallas.py:
//   mp_frames  <- _frames_kernel (K1): windowed, delay-compensated frames
//   mp_ola     <- _ola_kernel    (K2): PSOLA overlap-add
//              <- _ola_ar_kernel (K3): the same with the anti-ringing window
//                                      applied to each frame at load time
//
// What bounds them: all three move far more bytes than they compute on, so
// the bound is device-memory bandwidth (each input read once, each output
// written once).  The overlap-add kernels compute one output element per
// thread, so neighbouring threads touch neighbouring addresses on both
// sides.
//
// K1 writes the (B, F, N) frames, the largest array of the analysis, and
// most of it is zeros: a frame holds about two pitch periods of signal in
// N samples, and rows past nfrms hold nothing.  With one thread per
// element the kernel spent its time on 64-bit index arithmetic, on
// re-reading the row's scalars and on 4-byte stores, at a fifth of the
// bandwidth bound.  So K1 gives one block to each frame row:
// - the row's scalars are read once, and no division or modulo by N or F
//   is left per element (q = p + L with one conditional subtraction of N);
// - each thread stores float4 quads (rows are 16-byte aligned when
//   N % 4 == 0), as streaming stores: the output is far larger than the L2
//   cache and is read by a later kernel, while the signal that the block
//   gathers from should stay there;
// - a quad that lies wholly in the row's zero span, or in a row past
//   nfrms, is stored as zeros with no arithmetic, and only the window half
//   that q lies in is divided out.
// The TPU kernels' aligned-window loads and lane rotations are not needed
// here: the GPU gathers at element granularity.
//
// The window formulas are those of magphase_tpu_torch/core/windows.py.
// Every multiply and add that feeds an output is rounded on its own
// (__fmul_rn / __fadd_rn, never contracted into an FMA), so the kernels
// compute the same float32 values as the plain torch versions in
// magphase_tpu_torch/kernels/framing.py.  Build without --use_fast_math:
// cosf, sqrtf and the divisions must be the IEEE / full-accuracy forms.
//
// Plain C entry points (loaded with ctypes); each launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr int kThreads = 256;

// h(t): half-window profile, t in [0, 1] measured edge -> peak.
// 0 = hanning, 1 = bartlett^2.5 (as t*t*sqrt(t)), 2 = boxcar.
__device__ __forceinline__ float half_profile(float t, int fam) {
  if (fam == 0) {
    return __fsub_rn(0.5f, __fmul_rn(0.5f, cosf(__fmul_rn(kPi, t))));
  }
  if (fam == 1) {
    float tc = fminf(fmaxf(t, 0.0f), 1.0f);
    return __fmul_rn(__fmul_rn(tc, tc), sqrtf(tc));
  }
  return 1.0f;
}

// Asymmetric window of left length L and right length R at offset q
// (windows.py:asym_win_value).  Integers below 2^24 are exact in float32.
__device__ __forceinline__ float asym_win(int q, int L, int R, int fam) {
  float qf = (float)q, Lf = (float)L, Rf = (float)R;
  float t;
  if (qf <= Lf) {
    t = Lf > 0.0f ? __fdiv_rn(qf, fmaxf(Lf, 1.0f)) : 1.0f;
  } else {
    t = Rf > 0.0f ? __fdiv_rn(__fsub_rn(__fadd_rn(Lf, Rf), qf), fmaxf(Rf, 1.0f))
                  : 1.0f;
  }
  return half_profile(t, fam);
}

// Centred anti-ringing window (framing.py:apply_anti_ringing): raised
// hanning at att=1 (equal to hanning) of lengths (wl, wr) with its peak at
// N/2; outside its support the fill value h(t(q=0)), i.e. 0 for wl > 0
// and 1 for wl == 0.
__device__ __forceinline__ float anti_ring_win(int p, int wl, int wr, int N) {
  int q = p - (N / 2 - wl);
  if (q >= 0 && q <= wl + wr) return asym_win(q, wl, wr, 0);
  return wl > 0 ? 0.0f : 1.0f;
}

// The scalars of one frame row, read once per block.
struct FrameRow {
  const float* sig;  // the utterance's signal row
  int pm, L, R, ns, fam, N;
  bool wraps_once;  // 0 <= L < N and R >= 0: q = p + L, less N at most once
};

// One element of K1: out[b,f,p] = sig[b, clip(pm-L+q, 0, n_sig-1)] * w(q)
// with q = (p+L) mod N, and 0 where q >= L+R+1.
__device__ __forceinline__ float frame_elem(const FrameRow& r, int p) {
  int q;
  if (r.wraps_once) {
    q = p + r.L;
    if (q >= r.N) q -= r.N;
  } else {
    q = (int)((((int64_t)p + r.L) % r.N + r.N) % r.N);
  }
  if (q >= r.L + r.R + 1) return 0.0f;
  const int idx = min(max(r.pm - r.L + q, 0), r.ns - 1);
  return __fmul_rn(r.sig[idx], asym_win(q, r.L, r.R, r.fam));
}

// K1.  One block per frame row (b, f), striding over rows where the grid
// is capped.  In output order a row with 0 <= L < N and R >= 0 is: the
// right half p in [0, R] (q = L + p), a zero span p in (R, N - L), and the
// left half p in [N - L, N) (q = p + L - N); the zero span is empty when
// L + R + 1 >= N.  kVec: N % 4 == 0 and `out` 16-byte aligned, so every
// row is, and a thread stores float4 quads; else single elements.  The
// window family is fam_v where voi[b,f] > 0, else fam_u.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    frames_kernel(const float* __restrict__ sig, const int* __restrict__ pm,
                  const int* __restrict__ Lv, const int* __restrict__ Rv,
                  const float* __restrict__ voi,
                  const int* __restrict__ nfrms,
                  const int* __restrict__ n_sig, float* __restrict__ out,
                  int B, int F, int S, int N, int fam_v, int fam_u) {
  const int64_t rows = (int64_t)B * F;
  for (int64_t bf = blockIdx.x; bf < rows; bf += gridDim.x) {
    const int b = (int)(bf / F);
    const int f = (int)(bf - (int64_t)b * F);
    float* row = out + bf * N;
    // every scalar is read at once, whether the row is live or not
    FrameRow r;
    r.N = N;
    r.sig = sig + (int64_t)b * S;
    r.L = Lv[bf];
    r.R = Rv[bf];
    r.pm = pm[bf];
    r.ns = min(n_sig[b], S);
    r.fam = voi[bf] > 0.0f ? fam_v : fam_u;
    r.wraps_once = r.L >= 0 && r.L < N && r.R >= 0;
    const bool live = f < nfrms[b];
    if (kVec) {
      float4* row4 = reinterpret_cast<float4*>(row);
      for (int j = threadIdx.x; j < N / 4; j += kThreads) {
        const int p = 4 * j;
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        const bool zero_quad =
            !live || (r.wraps_once && p > r.R && p + 3 < N - r.L);
        if (!zero_quad) {
          v.x = frame_elem(r, p);
          v.y = frame_elem(r, p + 1);
          v.z = frame_elem(r, p + 2);
          v.w = frame_elem(r, p + 3);
        }
        __stcs(row4 + j, v);  // written once, read by a later kernel
      }
    } else {
      for (int p = threadIdx.x; p < N; p += kThreads)
        __stcs(row + p, live ? frame_elem(r, p) : 0.0f);
    }
  }
}

// K2 / K3.  Gather form of the overlap-add: out[b,o] is the sum, in
// increasing f from 0.0f, of frames[b,f,o-starts[b,f]] over the valid
// frames f < nfrms[b] whose window [starts, starts+N) covers o.  Requires
// starts[b, :nfrms[b]] non-decreasing, so those frames are one contiguous
// run found by binary search.  No atomics: the sum order is fixed, and the
// result equals an in-order scatter-add bit for bit, run after run.
__global__ void ola_kernel(const float* __restrict__ frames,
                           const int* __restrict__ starts,
                           const int* __restrict__ nfrms,
                           const int* __restrict__ wl,
                           const int* __restrict__ wr,
                           float* __restrict__ out, int B, int F, int N, int O,
                           int anti_ring) {
  const int64_t total = (int64_t)B * O;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int o = (int)(i % O);
    const int b = (int)(i / O);
    const int* st = starts + (int64_t)b * F;
    const int nf = min(nfrms[b], F);
    // first frame whose window reaches o: starts[f] + N > o
    int lo = 0, hi = nf;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (st[mid] <= o - N) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    float acc = 0.0f;
    for (int f = lo; f < nf && st[f] <= o; ++f) {
      const int p = o - st[f];
      const int64_t bf = (int64_t)b * F + f;
      float v = frames[bf * N + p];
      if (anti_ring) v = __fmul_rn(v, anti_ring_win(p, wl[bf], wr[bf], N));
      acc = __fadd_rn(acc, v);
    }
    out[i] = acc;
  }
}

unsigned int capped(int64_t blocks) {
  const int64_t cap = (int64_t)1 << 30;
  return (unsigned int)(blocks < cap ? blocks : cap);
}

unsigned int grid_for(int64_t total) {
  return capped((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int mp_frames(const float* sig, const int* pm, const int* L, const int* R,
              const float* voi, const int* nfrms, const int* n_sig,
              float* out, int B, int F, int S, int N, int fam_v, int fam_u,
              void* stream) {
  const int64_t rows = (int64_t)B * F;
  if (rows > 0 && N > 0) {
    const bool vec = N % 4 == 0 && (uintptr_t)out % 16 == 0;
    auto kernel = vec ? frames_kernel<true> : frames_kernel<false>;
    kernel<<<capped(rows), kThreads, 0, (cudaStream_t)stream>>>(
        sig, pm, L, R, voi, nfrms, n_sig, out, B, F, S, N, fam_v, fam_u);
  }
  return (int)cudaGetLastError();
}

int mp_ola(const float* frames, const int* starts, const int* nfrms,
           const int* wl, const int* wr, float* out, int B, int F, int N,
           int O, int anti_ring, void* stream) {
  const int64_t total = (int64_t)B * O;
  if (total > 0) {
    ola_kernel<<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        frames, starts, nfrms, wl, wr, out, B, F, N, O, anti_ring);
  }
  return (int)cudaGetLastError();
}

const char* mp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
