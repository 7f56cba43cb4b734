// Epoch-placement walk for Hopper (sm_90a): kernel K4.
//
// Counterpart of the Pallas kernel _walk_kernel in
// magphase_tpu/pallas_kernels/walk_pallas.py (entry place_epochs_pallas),
// which restates place_epochs_kernel of
// magphase_tpu/epochs/placement_device.py.  Per utterance, from t = 0:
// look up the tracker frame of t, take the period fs/f0 (voiced) or the
// 5 ms unvoiced step, clip it to fs/50, and place the next mark at the
// FIRST minimum of the low-passed signal y_snap in [lo, hi) (voiced) or at
// t + unv_step (unvoiced), with the two-phase window (+-35% for the first
// marks of a voiced run, +-15% after) and the monotonic guard.
//
// What bounds it: a serial chain.  Each mark's position is the start of
// the next window, so an utterance costs n_marks x (one dependent frame
// lookup + one window load + one reduction); bytes are tiny (the windows
// read, the tracks and the marks).  Design: one warp walks one utterance
// (one warp per block; utterances are independent, so nothing crosses
// blocks).  All 32 lanes carry the same scalar state; they read the
// <= snap_w-sample window with coalesced strided loads straight from
// global memory (the rows stay in L2), and a __shfl_xor_sync butterfly on
// (value, position) gives the minimum with ties to the lower position --
// jnp.argmin's first-index rule.  Lane 0 writes each mark and flag.  The
// TPU kernel's lane-aligned window, SMEM tracks and mark*2+flag packing
// exist for VMEM/SMEM and one read-modify-write and are not carried over.
//
// Exactness: the float steps are the JAX walk's float32 operations, each
// rounded on its own: __fdiv_rn for t/frame_step and fs/max(f0, 1),
// __fmul_rn for mult*period, then floorf and truncation toward zero.  The
// host passes every constant already rounded to float32 (frame_step,
// fs, fs/50, the four window multipliers) and unv_step as Python's
// round(0.005*fs) (half to even).  Build without --use_fast_math.
//
// Plain C entry point (loaded with ctypes); it launches on the given
// stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

struct WalkParams {
  int B, S, T, m_max, snap_w, unv_step, onset_marks;
  float frame_step, fs, p_max, lo_wide, hi_wide, lo_run, hi_run;
};

__global__ void walk_kernel(const float* __restrict__ y_snap,
                            const float* __restrict__ f0,
                            const float* __restrict__ voiced,
                            const int* __restrict__ n_sigs,
                            const int* __restrict__ n_frames,
                            int* __restrict__ marks,
                            float* __restrict__ flags,
                            int* __restrict__ n_marks, WalkParams p) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x;
  if (b >= p.B) return;
  const float* y = y_snap + (int64_t)b * p.S;
  const float* f0b = f0 + (int64_t)b * p.T;
  const float* vb = voiced + (int64_t)b * p.T;
  int* mk = marks + (int64_t)b * p.m_max;
  float* fl = flags + (int64_t)b * p.m_max;

  // the arrays past n_marks stay zero, as in the JAX walk
  for (int i = lane; i < p.m_max; i += 32) {
    mk[i] = 0;
    fl[i] = 0.0f;
  }
  __syncwarp();

  const int n_sig = n_sigs[b];
  const int fr_max = max(n_frames[b] - 1, 0);
  int t = 0, nm = 0, run_len = 0, prev = -1;
  while (true) {
    int fr = (int)__fdiv_rn((float)t, p.frame_step);
    fr = min(max(fr, 0), fr_max);
    const float f0v = f0b[fr];
    const bool is_voi = (vb[fr] > 0.0f) && (f0v > 0.0f);
    float period =
        is_voi ? __fdiv_rn(p.fs, fmaxf(f0v, 1.0f)) : (float)p.unv_step;
    period = fminf(period, p.p_max);
    const bool wide = run_len < p.onset_marks;
    const float lo_mult = wide ? p.lo_wide : p.lo_run;
    const float hi_mult = wide ? p.hi_wide : p.hi_run;
    const int p_lo = (int)floorf(__fmul_rn(lo_mult, period));
    const int p_hi = (int)floorf(__fmul_rn(hi_mult, period));
    const int lo = t + p_lo;
    const int hi = min(n_sig - 1, t + p_hi);

    int nxt;
    if (is_voi) {
      // the JAX walk's slice [lo_slice, lo_slice + snap_w), masked to
      // [max(lo, 0), hi); an all-masked window gives lo_slice (argmin of
      // all-inf), which `ok` below never writes
      const int lo_slice = min(max(lo, 0), p.S - p.snap_w);
      const int w_lo = max(lo, 0);
      float best = INFINITY;
      int best_pos = lo_slice;
      for (int k = lane; k < p.snap_w; k += 32) {
        const int pos = lo_slice + k;
        if (pos >= w_lo && pos < hi) {
          const float v = y[pos];
          if (v < best) {  // strict: a lane keeps its first minimum
            best = v;
            best_pos = pos;
          }
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, best, off);
        const int op = __shfl_xor_sync(kFull, best_pos, off);
        if (ov < best || (ov == best && op < best_pos)) {
          best = ov;
          best_pos = op;
        }
      }
      nxt = best_pos;
    } else {
      nxt = t + p.unv_step;
    }
    const int min_adv = is_voi ? max(1, p_lo) : 1;
    if (nxt <= prev) nxt = prev + min_adv;
    const bool ok = (nxt < n_sig - 1) && (hi > lo + 1) && (nm < p.m_max);
    if (!ok) break;
    if (lane == 0) {
      mk[nm] = nxt;
      fl[nm] = is_voi ? 1.0f : 0.0f;
    }
    ++nm;
    prev = nxt;
    t = nxt;
    run_len = is_voi ? run_len + 1 : 0;
  }
  if (lane == 0) n_marks[b] = nm;
}

}  // namespace

extern "C" {

int mp_walk(const float* y_snap, const float* f0, const float* voiced,
            const int* n_sigs, const int* n_frames, int* marks, float* flags,
            int* n_marks, int B, int S, int T, int m_max, int snap_w,
            int unv_step, int onset_marks, float frame_step, float fs,
            float p_max, float lo_wide, float hi_wide, float lo_run,
            float hi_run, void* stream) {
  if (B > 0) {
    WalkParams p{B,          S,  T,     m_max,   snap_w,  unv_step, onset_marks,
                 frame_step, fs, p_max, lo_wide, hi_wide, lo_run,   hi_run};
    walk_kernel<<<B, 32, 0, (cudaStream_t)stream>>>(
        y_snap, f0, voiced, n_sigs, n_frames, marks, flags, n_marks, p);
  }
  return (int)cudaGetLastError();
}

const char* mp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
