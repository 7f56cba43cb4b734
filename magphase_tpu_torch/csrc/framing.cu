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
// written once).
//
// The overlap-add (K2) reads every valid frame element once and writes
// every output sample once.  With one thread per output sample it was
// latency-bound: each sample searched `starts` on its own and then walked
// its ~N/shift covering frames with one dependent load in flight at a time.
// So K2 gives one block to each tile of the output of one utterance: the
// tile's run of covering frames is found once, staged in shared memory,
// and each thread loads its samples of two frames at once before it adds
// them, in frame order (details at ola_kernel); that leaves it bound by
// the bytes of the frames.  K3 is K2 with the anti-ringing window applied
// to each element at load time.  The window (an IEEE division and a
// full-accuracy cosf, some 60 SASS instructions on the path taken) covers
// about half of a frame's elements at the serving geometry, and that
// instruction issue, on top of K2's bytes, is what bounds K3.  So the
// window is computed only inside its support, from per-frame scalars
// staged beside the starts, and K3 loads one frame at a time.
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
// starts[b, :nfrms[b]] non-decreasing, so the frames that meet any range of
// o are one contiguous run.  No atomics: the sum order is fixed, and the
// result equals an in-order scatter-add bit for bit, run after run.
//
// One block per (output tile of kOlaTile samples, utterance b).  Warp w
// owns the kOlaSeg samples [seg_lo, seg_lo + kOlaSeg) of the tile, lane l
// the samples seg_lo + l + 32 k, k < kOlaSpan: for one frame a warp reads
// 32 consecutive floats per load and stores 32 consecutive floats.
// - The tile's run [f_lo, f_hi) is found once per block, by two warps
//   (warp_first_above), not once per sample.
// - The run goes through shared memory in chunks of kOlaChunk frames (a run
//   may be as long as F where starts repeat): their starts and, for K3,
//   their window scalars, so no element does per-frame arithmetic.
// - Each warp takes the part of the chunk that meets its segment (a
//   contiguous range, by two ballots) and issues the loads of kUnroll
//   frames for all its samples before it adds them, in frame order.  An
//   element outside a frame loads nothing and adds +0.0f, which leaves the
//   sum's bits as they are (the sum starts at +0.0f and cannot become -0.0f).
// - Frames are read once (__ldcs) and the output written once (__stcs).
constexpr int kOlaWarps = 8;
constexpr int kOlaThreads = 32 * kOlaWarps;
constexpr int kOlaSpan = 8;                       // samples per lane
constexpr int kOlaSeg = 32 * kOlaSpan;            // samples per warp
constexpr int kOlaTile = kOlaWarps * kOlaSeg;     // samples per block
constexpr int kOlaChunk = 64;                     // frames staged at a time
constexpr int kOlaUnroll = 2;                     // frames loaded together

// First f in [0, n) with st[f] > x, n if none, for st non-decreasing over
// [0, n); called by one whole warp, each step probing 32 evenly spaced
// entries (two steps for n <= 1024).
__device__ int warp_first_above(const int* __restrict__ st, int n,
                                int64_t x, int lane) {
  int lo = 0, hi = max(n, 0);  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int idx = lo + lane * step;
    const bool at_or_below = idx < hi && (int64_t)__ldg(st + idx) <= x;
    const int c = __popc(__ballot_sync(0xffffffffu, at_or_below));
    if (c == 0) {
      hi = lo;
    } else {
      hi = min(lo + c * step, hi);
      lo += (c - 1) * step + 1;
    }
  }
  return lo;
}

// The centred anti-ringing window of K3 (framing.py:apply_anti_ringing):
// raised hanning at att=1 (equal to hanning) of lengths (wl, wr) with its
// peak at N/2, i.e. asym_win(q, wl, wr, hanning) at q = p - (N/2 - wl) for
// q in [0, wl + wr], and outside that support the fill value h(t(q=0)): 0
// for wl > 0, 1 for wl == 0.  ArWin holds one frame's scalars, computed
// once per frame.
struct alignas(16) ArWin {
  int c0, span;
  float wlf, wrf, wl1, wr1, lr, fill;  // wl, wr, max(wl,1), max(wr,1), wl+wr
};

__device__ __forceinline__ ArWin ar_win(int wl, int wr, int N) {
  ArWin w;
  w.c0 = N / 2 - wl;
  w.span = wl + wr;
  w.wlf = (float)wl;
  w.wrf = (float)wr;
  w.wl1 = fmaxf(w.wlf, 1.0f);
  w.wr1 = fmaxf(w.wrf, 1.0f);
  w.lr = __fadd_rn(w.wlf, w.wrf);
  w.fill = wl > 0 ? 0.0f : 1.0f;
  return w;
}

// The window at frame position p: inside the support the operations of
// asym_win (one IEEE division, a full-accuracy cosf), outside the fill
// with no arithmetic.
__device__ __forceinline__ float ar_value(const ArWin& w, int p) {
  const int q = p - w.c0;
  if (q < 0 || q > w.span) return w.fill;
  const float qf = (float)q;
  const bool left = qf <= w.wlf;
  const float len = left ? w.wlf : w.wrf;
  const float t = len > 0.0f ? __fdiv_rn(left ? qf : __fsub_rn(w.lr, qf),
                                         left ? w.wl1 : w.wr1)
                             : 1.0f;
  return half_profile(t, 0);
}

template <bool kAR>
__global__ void __launch_bounds__(kOlaThreads)
    ola_kernel(const float* __restrict__ frames,
               const int* __restrict__ starts, const int* __restrict__ nfrms,
               const int* __restrict__ wl, const int* __restrict__ wr,
               float* __restrict__ out, int B, int F, int N, int O) {
  __shared__ int s_run[2];
  __shared__ int s_st[kOlaChunk];
  __shared__ ArWin s_win[kAR ? kOlaChunk : 1];
  // K3 loads one frame at a time: its window code is inlined once per
  // element loaded together, and with two frames' copies the kernel ran
  // slower on an H100, not faster (K2 gains from the second frame)
  constexpr int kUnroll = kAR ? 1 : kOlaUnroll;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile_lo = blockIdx.x * kOlaTile;
  const int seg_lo = tile_lo + warp * kOlaSeg;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    const int64_t row = (int64_t)b * F;
    if (warp < 2) {
      // f_lo: the first frame that reaches the tile, st + N > tile_lo;
      // f_hi: the first that starts past it, st >= tile_lo + kOlaTile
      const int nf = min(nfrms[b], F);
      const int64_t x = warp == 0 ? (int64_t)tile_lo - N
                                  : (int64_t)tile_lo + kOlaTile - 1;
      const int f = warp_first_above(starts + row, nf, x, lane);
      if (lane == 0) s_run[warp] = f;
    }
    __syncthreads();
    const int f_lo = s_run[0], f_hi = s_run[1];
    float acc[kOlaSpan];
#pragma unroll
    for (int k = 0; k < kOlaSpan; ++k) acc[k] = 0.0f;
    for (int c = f_lo; c < f_hi; c += kOlaChunk) {
      const int nc = min(kOlaChunk, f_hi - c);
      if (threadIdx.x < nc) {
        const int64_t bf = row + c + threadIdx.x;
        s_st[threadIdx.x] = starts[bf];
        if (kAR) s_win[threadIdx.x] = ar_win(wl[bf], wr[bf], N);
      }
      __syncthreads();
      // the chunk's frames that meet this warp's segment: a contiguous
      // range [j0, j1] of the chunk, since starts are non-decreasing
      unsigned m[kOlaChunk / 32];
#pragma unroll
      for (int h = 0; h < kOlaChunk / 32; ++h) {
        const int j = 32 * h + lane;
        const bool meets = j < nc && (int64_t)s_st[j] + N > seg_lo &&
                           s_st[j] < (int64_t)seg_lo + kOlaSeg;
        m[h] = __ballot_sync(0xffffffffu, meets);
      }
      int j0 = nc, j1 = -1;
#pragma unroll
      for (int h = kOlaChunk / 32 - 1; h >= 0; --h)
        if (m[h]) j0 = 32 * h + __ffs(m[h]) - 1;
#pragma unroll
      for (int h = 0; h < kOlaChunk / 32; ++h)
        if (m[h]) j1 = 32 * h + 31 - __clz(m[h]);
      for (int j = j0; j <= j1; j += kUnroll) {
        float v[kUnroll][kOlaSpan];
        int p0[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool live = j + u <= j1;
          p0[u] = seg_lo + lane - (live ? s_st[j + u] : 0);
          const float* fr = frames + (row + c + j + u) * N;
#pragma unroll
          for (int k = 0; k < kOlaSpan; ++k) {
            const int p = p0[u] + 32 * k;
            const bool in = live && p >= 0 && p < N &&
                            seg_lo + lane + 32 * k < O;
            v[u][k] = in ? __ldcs(fr + p) : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool live = j + u <= j1;
          const ArWin w = s_win[kAR && live ? j + u : 0];
#pragma unroll
          for (int k = 0; k < kOlaSpan; ++k) {
            float x = v[u][k];
            // an element outside the frame is 0 and its window value is
            // finite, so its product adds +0.0f as well
            if (kAR && live) x = __fmul_rn(x, ar_value(w, p0[u] + 32 * k));
            acc[k] = __fadd_rn(acc[k], x);
          }
        }
      }
      __syncthreads();
    }
    float* dst = out + (int64_t)b * O;
#pragma unroll
    for (int k = 0; k < kOlaSpan; ++k) {
      const int o = seg_lo + lane + 32 * k;
      if (o < O) __stcs(dst + o, acc[k]);
    }
    __syncthreads();  // s_run is written again for the next b
  }
}

unsigned int capped(int64_t blocks) {
  const int64_t cap = (int64_t)1 << 30;
  return (unsigned int)(blocks < cap ? blocks : cap);
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
  if (O > 0x7fffffff - kOlaTile) return (int)cudaErrorInvalidValue;
  if (B > 0 && O > 0) {
    const dim3 grid((unsigned int)((O + kOlaTile - 1) / kOlaTile),
                    (unsigned int)min(B, 65535));
    auto kernel = anti_ring ? ola_kernel<true> : ola_kernel<false>;
    kernel<<<grid, kOlaThreads, 0, (cudaStream_t)stream>>>(
        frames, starts, nfrms, wl, wr, out, B, F, N, O);
  }
  return (int)cudaGetLastError();
}

const char* mp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
