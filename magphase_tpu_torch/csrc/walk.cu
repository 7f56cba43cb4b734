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
// What bounds it: a serial chain, not bytes and not operations.  Each
// mark's position is the start of the next window, so an utterance costs
// n_marks x (the time of one step of one warp), whatever the card's memory
// rate; utterances are independent, one block each, and a batch is far
// fewer blocks than the card has SMs.  On the card a step is bound by the
// walker warp's dependent instructions, so the design takes everything it
// can off that warp's step:
//
// - No global memory on the chain.  The block first turns its f0/voiced
//   rows into a table in shared memory, one entry per tracker frame (in a
//   scratch row of global memory instead, kTabShared false, where the
//   table of a very long utterance does not fit beside the ring: the step
//   then reads its word through L1): the
//   window offsets floor(lo_mult * period) and floor(hi_mult * period) of
//   both window phases and the voiced bit.  These are the walk's own
//   float32 operations (__fdiv_rn, fminf, __fmul_rn, floorf), done once
//   per frame instead of once per step, so the results are the same bits
//   and one IEEE division leaves the chain.
// - A ring of the signal in shared memory, filled ahead of the walker.
//   The walk is monotone and a window reaches at most
//   floor(hi_wide * p_max) samples beyond t, so the ring (a power-of-two
//   number of samples, position mod ring length) needs to hold only
//   [t, t + ring).  Three producer warps copy the row in chunks of kChunk
//   samples with cp.async, 16 bytes a lane (rows start 16-byte aligned and
//   lie `pitch` samples apart, a multiple of 4: the wrapper copies a batch
//   that is not so into one that is), chunk c by warp 1 + c % 3.  A
//   producer may fill
//   chunk c once (c + 1) * kChunk - ring <= the walker's published t (it
//   overwrites nothing at or beyond t), and publishes c + 1 in the
//   chunk's slot of s_ready; the walker waits on that number before the
//   first window that reaches into the chunk, which in practice happens
//   only at the very start.  Nothing behind t is ever read: the searched
//   span starts at lo >= t.
// - Only the searched span [lo, hi) is read (kTrips trips of 32 lanes are
//   loaded before they are compared), not the snap_w-wide slice that the
//   masked argmin of the JAX walk is defined on.  The span is cut to the
//   slice's end, so that the result is the slice's argmin for any input;
//   an empty span gives lo_slice, the argmin of an all-inf slice, which
//   `ok` then rejects.
// - The minimum takes two redux.sync instead of a ten-shuffle butterfly:
//   each lane keeps its first minimum (strict <), maps it to an
//   order-preserving unsigned key (-0 folded to +0, so that equal values
//   have equal keys), __reduce_min_sync gives the least key, and a second
//   __reduce_min_sync the least position among the lanes that hold it:
//   ties go to the lower position, jnp.argmin's first-index rule.
// - The frame index trunc(t / frame_step) is a multiply-high and a shift
//   where that is the same number (frame_of: an integer frame step, as
//   every tracker rate gives, and positions below 2^24), else the IEEE
//   division.
// - The walker keeps 32 marks in its lanes and stores them with one
//   coalesced store; the zero fill of marks/flags past n_marks is done by
//   the whole block after the walk, from n_marks on.
//
// What is left on the chain per step: the frame index, one shared read of
// the table (the word of the window phase), the window's shared reads,
// the key, two redux and the guards.  chain_probe_kernel below runs the
// skeleton alone (frame index, table word, one window read, key, two
// redux) and gives the card's time per step of it: the walk's own bound.
// The probe's loop is part of the yardstick: K4's bound and its share of
// it are read against this body, so an edit of it is a change of the
// measure, after which every figure of K4 is read anew.
//
// Exactness: the float steps are the JAX walk's float32 operations, each
// rounded on its own: __fdiv_rn for t/frame_step and fs/max(f0, 1),
// __fmul_rn for mult*period, then floorf and truncation toward zero.  The
// host passes every constant already rounded to float32 (frame_step,
// fs, fs/50, the four window multipliers) and unv_step as Python's
// round(0.005*fs) (half to even).  Build without --use_fast_math.
//
// Plain C entry points (loaded with ctypes); each launches on the given
// stream, does not synchronise, and returns a cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // warp 0 walks, warps 1-3 fill the ring
constexpr int kProducers = kThreads / 32 - 1;
constexpr int kChunkLog2 = 11;  // kernels/walk.py: CHUNK
constexpr int kChunk = 1 << kChunkLog2;
constexpr int kMaxChunks = 16;  // ring <= 32,768 samples
constexpr int kTrips = 4;       // window trips of 32 lanes loaded at once

struct WalkParams {
  int B, S, pitch, T, m_max, snap_w, unv_step, onset_marks, ring_log2;
  unsigned step_magic;
  int step_shift;
  float frame_step, fs, p_max, lo_wide, hi_wide, lo_run, hi_run;
};

// The tracker frame of position t >= 0: trunc(t / frame_step) in float32,
// as the JAX walk computes it.  kIntStep: frame_step is an integer s >= 2
// and every t is below 2^24 - s, where that float quotient truncates to
// the integer quotient t / s (the float result is within half an ulp of
// the real quotient, which lies at least 1/s below the next integer),
// taken as a multiply-high and a shift with the host's magic number.
template <bool kIntStep>
__device__ __forceinline__ int frame_of(int t, const WalkParams& p) {
  if (kIntStep)
    return (int)(__umulhi((unsigned)t, p.step_magic) >> p.step_shift);
  return max((int)__fdiv_rn((float)t, p.frame_step), 0);
}

// float -> unsigned with the same order (for every non-NaN value), -0 as
// +0 (-0 + 0 rounds to +0, every other value to itself): all bits flipped
// where the sign is set, else the sign bit set
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));
  return u ^ ((unsigned)((int)u >> 31) | 0x80000000u);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One table entry: x = p_lo | voiced << 15 | p_hi << 16 of the wide
// (onset) window, y = the same of the run window.  Offsets are below 2^15
// (the wrapper checks floor(hi_wide * p_max)).
__device__ __forceinline__ uint2 step_entry(float f0v, float vv,
                                            const WalkParams& p) {
  const bool is_voi = (vv > 0.0f) && (f0v > 0.0f);
  float period =
      is_voi ? __fdiv_rn(p.fs, fmaxf(f0v, 1.0f)) : (float)p.unv_step;
  period = fminf(period, p.p_max);
  const unsigned lo_w = (unsigned)(int)floorf(__fmul_rn(p.lo_wide, period));
  const unsigned hi_w = (unsigned)(int)floorf(__fmul_rn(p.hi_wide, period));
  const unsigned lo_r = (unsigned)(int)floorf(__fmul_rn(p.lo_run, period));
  const unsigned hi_r = (unsigned)(int)floorf(__fmul_rn(p.hi_run, period));
  const unsigned voi_bit = is_voi ? 0x8000u : 0u;
  return make_uint2(lo_w | voi_bit | (hi_w << 16),
                    lo_r | voi_bit | (hi_r << 16));
}

// Copy chunk c of the row, cut to `lim` samples (a multiple of 4), into
// its place in the ring.
__device__ __forceinline__ void copy_chunk(float* ring, int mask,
                                            const float* y, int c, int lim,
                                            int lane) {
  const int base = c << kChunkLog2;
  const int n = min(kChunk, lim - base);
  for (int i = lane * 4; i < n; i += 128)
    cp_async16(ring + ((base + i) & mask), y + base + i);
}

// kTabShared: the frame table lies in shared memory behind the ring, else
// in row b of tab_global (B x T entries of scratch).
template <bool kIntStep, bool kTabShared>
__global__ void __launch_bounds__(kThreads)
    walk_kernel(const float* __restrict__ y_snap, const float* __restrict__ f0,
                const float* __restrict__ voiced,
                const int* __restrict__ n_sigs,
                const int* __restrict__ n_frames, int* __restrict__ marks,
                float* __restrict__ flags, int* __restrict__ n_marks,
                uint2* tab_global, WalkParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ volatile int s_t;     // the walker's position: nothing below it
                                   // is read again
  __shared__ volatile int s_done;  // the walk has ended
  __shared__ volatile int s_ready[kMaxChunks];  // c + 1 once chunk c is in
  __shared__ int s_nm;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int ring_n = 1 << p.ring_log2;
  const int mask = ring_n - 1;
  const int slots = ring_n >> kChunkLog2;
  float* ring = reinterpret_cast<float*>(smem);
  uint2* tab = kTabShared ? reinterpret_cast<uint2*>(ring + ring_n)
                          : tab_global + (int64_t)b * p.T;

  const float* y = y_snap + (int64_t)b * p.pitch;
  const float* f0b = f0 + (int64_t)b * p.T;
  const float* vb = voiced + (int64_t)b * p.T;
  int* mk = marks + (int64_t)b * p.m_max;
  float* fl = flags + (int64_t)b * p.m_max;
  const int n_sig = n_sigs[b];
  // no window reaches position n_sig - 1 or beyond, nor S
  const int lim = min(p.pitch, (max(n_sig, 0) + 3) & ~3);

  // the producers' first chunks fit the empty ring: start them before
  // anything else
  int c = warp - 1;
  if (warp > 0 && (c << kChunkLog2) < lim)
    copy_chunk(ring, mask, y, c, lim, lane);
  for (int i = tid; i < p.T; i += kThreads)
    tab[i] = step_entry(f0b[i], vb[i], p);
  if (tid < kMaxChunks) s_ready[tid] = 0;
  if (tid == 0) {
    s_t = 0;
    s_done = 0;
  }
  __syncthreads();

  int nm = 0;
  if (warp == 0) {
    // ---- the walker: all 32 lanes carry the same scalar state
    const int fr_max = min(max(n_frames[b] - 1, 0), p.T - 1);
    const unsigned* tab32 = reinterpret_cast<const unsigned*>(tab);
    // The table word of position `pos` in window phase `phase`
    // (0 wide, 1 run): p_lo | voiced << 15 | p_hi << 16.
    auto lookup = [&](int pos, int phase) {
      return tab32[2 * min(frame_of<kIntStep>(pos, p), fr_max) + phase];
    };
    int t = 0, run_len = 0, prev = -1;
    // every sample of [t, ready_upto) has been seen in the ring
    int ready_upto = 0;
    // lane i keeps mark 32 j + i until the warp stores 32 marks at once
    int my_mark = 0;
    float my_flag = 0.0f;
    unsigned w = lookup(0, 0 < p.onset_marks ? 0 : 1);
    while (true) {
      const bool is_voi = (w & 0x8000u) != 0u;
      const int p_lo = (int)(w & 0x7fffu);
      const int p_hi = (int)(w >> 16);
      const int lo = t + p_lo;  // >= t >= 0
      const int hi = min(n_sig - 1, t + p_hi);

      int nxt;
      if (is_voi) {
        // the JAX walk's slice [lo_slice, lo_slice + snap_w), masked to
        // [lo, hi): only the span itself is read
        const int lo_slice = min(lo, p.S - p.snap_w);
        const int hi_read = min(hi, lo_slice + p.snap_w);
        if (hi_read > ready_upto && hi_read > lo) {
          // chunks wholly below lo are never read: skip them unseen
          ready_upto = max(ready_upto, lo & ~(kChunk - 1));
          while (hi_read > ready_upto) {
            const int ch = ready_upto >> kChunkLog2;
            while (s_ready[ch & (slots - 1)] != ch + 1) {
            }
            __threadfence_block();
            ready_upto += kChunk;
          }
        }
        // kTrips trips of 32 lanes at a time: the loads are independent,
        // and each compare keeps the earlier position on a tie, so a lane
        // ends with its first minimum
        float best = INFINITY;
        int best_pos = lo_slice;
        int p0 = lo + lane;
        do {
          float v[kTrips];
          int q[kTrips];
#pragma unroll
          for (int k = 0; k < kTrips; ++k) {
            const float x = ring[(p0 + 32 * k) & mask];
            v[k] = p0 + 32 * k < hi_read ? x : INFINITY;
            q[k] = p0 + 32 * k;
          }
#pragma unroll
          for (int half = 1; half < kTrips; half *= 2) {
#pragma unroll
            for (int k = 0; k < kTrips; k += 2 * half) {
              if (v[k + half] < v[k]) {
                v[k] = v[k + half];
                q[k] = q[k + half];
              }
            }
          }
          if (v[0] < best) {
            best = v[0];
            best_pos = q[0];
          }
          p0 += 32 * kTrips;
        } while (p0 - lane < hi_read);
        const unsigned key = order_key(best);  // +inf where nothing read
        const unsigned kmin = __reduce_min_sync(kFull, key);
        nxt = (int)__reduce_min_sync(
            kFull, key == kmin ? (unsigned)best_pos : 0xffffffffu);
      } else {
        nxt = t + p.unv_step;
      }
      if (nxt <= prev) nxt = prev + (is_voi ? max(1, p_lo) : 1);
      const bool ok = (nxt < n_sig - 1) && (hi > lo + 1) && (nm < p.m_max);
      if (!ok) break;
      // the next step's table word first: its read is under way during
      // the bookkeeping
      run_len = is_voi ? run_len + 1 : 0;
      w = lookup(nxt, run_len < p.onset_marks ? 0 : 1);
      if ((nm & 31) == lane) {
        my_mark = nxt;
        my_flag = is_voi ? 1.0f : 0.0f;
      }
      ++nm;
      if ((nm & 31) == 0) {
        mk[nm - 32 + lane] = my_mark;
        fl[nm - 32 + lane] = my_flag;
      }
      s_t = nxt;  // every lane, the same value
      prev = nxt;
      t = nxt;
    }
    if (lane < (nm & 31)) {
      mk[(nm & ~31) + lane] = my_mark;
      fl[(nm & ~31) + lane] = my_flag;
    }
    if (lane == 0) {
      s_done = 1;
      s_nm = nm;
    }
  } else {
    // ---- a producer: chunks c, c + 3, ... as the walker makes room
    bool first = true;
    for (; (c << kChunkLog2) < lim; c += kProducers) {
      if (!first) {
        const int need = ((c + 1) << kChunkLog2) - ring_n;
        bool room = true;
        while (s_t < need) {
          if (s_done) {
            room = false;
            break;
          }
          __nanosleep(200);
        }
        // one verdict for the warp: the lanes read s_t at different times
        if (!__all_sync(kFull, room)) break;
        copy_chunk(ring, mask, y, c, lim, lane);
      }
      first = false;
      cp_async_wait_all();
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        s_ready[c & (slots - 1)] = c + 1;
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();

  // the arrays past n_marks are zero, as in the JAX walk
  nm = s_nm;
  for (int i = nm + tid; i < p.m_max; i += kThreads) {
    mk[i] = 0;
    fl[i] = 0.0f;
  }
  if (tid == 0) n_marks[b] = nm;
}

// The chain of one walk step and nothing else, for one warp with its data
// resident in shared memory: the frame of t (frame_of), the clamp, one
// word of the table, one window read per lane, the key, two redux.
// `steps` steps, each starting where the last one ended.  Its time per
// step is the least a step of walk_kernel can take on this card; out[0]
// gets the final position and out[1] the SM cycles the loop took.
constexpr int kProbeRing = 4096;
constexpr int kProbeFrames = 1024;

template <bool kIntStep>
__global__ void chain_probe_kernel(int steps, WalkParams p,
                                   int* __restrict__ out) {
  __shared__ float ring[kProbeRing];
  __shared__ unsigned tab[kProbeFrames];
  const int lane = threadIdx.x;
  for (int i = lane; i < kProbeRing; i += 32)
    ring[i] = (float)((i * 2654435761u) >> 16) - 32768.0f;
  for (int i = lane; i < kProbeFrames; i += 32) {
    const unsigned lo = 150u + (unsigned)(i % 97);
    tab[i] = lo | 0x8000u | ((lo + 32u) << 16);
  }
  __syncwarp();
  int t = 0;
  const long long c0 = clock64();
  for (int s = 0; s < steps; ++s) {
    const int fr = min(frame_of<kIntStep>(t, p), kProbeFrames - 1);
    const int pos = t + (int)(tab[fr] & 0x7fffu) + lane;
    const unsigned key = order_key(ring[pos & (kProbeRing - 1)]);
    const unsigned kmin = __reduce_min_sync(kFull, key);
    t = (int)__reduce_min_sync(kFull,
                               key == kmin ? (unsigned)pos : 0xffffffffu);
  }
  const long long c1 = clock64();
  if (lane == 0) {
    out[0] = t;
    out[1] = (int)min(c1 - c0, (long long)INT32_MAX);
  }
}

// the ring holds the producers' first chunks at least, and has a slot of
// s_ready for each of its chunks
bool ring_ok(int ring_log2) {
  static_assert(kProducers + 1 <= 4 && kMaxChunks == 16, "ring bounds");
  return ring_log2 >= kChunkLog2 + 2 && ring_log2 <= kChunkLog2 + 4;
}

int ring_bytes(int ring_log2) {
  return (1 << ring_log2) * (int)sizeof(float);
}

int smem_bytes(int ring_log2, int T) {
  return ring_bytes(ring_log2) + T * (int)sizeof(uint2);
}

}  // namespace

extern "C" {

// step_magic/step_shift: the frame index as
// umulhi(t, step_magic) >> step_shift where the host found that exact
// (kernels/walk.py: frame_divider), step_magic == 0 for the float division.
// Rows of y_snap start 16-byte aligned, `pitch` samples apart (a multiple
// of 4, >= S).  tab_global: null for the frame table in shared memory, else
// B x T x 8 bytes of scratch for it (T beyond mp_walk_max_shared_frames).
int mp_walk(const float* y_snap, const float* f0, const float* voiced,
            const int* n_sigs, const int* n_frames, int* marks, float* flags,
            int* n_marks, void* tab_global, int B, int S, int pitch, int T,
            int m_max, int snap_w, int unv_step, int onset_marks, int ring_log2,
            unsigned step_magic, int step_shift, float frame_step, float fs,
            float p_max, float lo_wide, float hi_wide, float lo_run,
            float hi_run, void* stream) {
  if (!ring_ok(ring_log2) || (uintptr_t)y_snap % 16 != 0 || pitch % 4 != 0 ||
      pitch < S)
    return (int)cudaErrorInvalidValue;
  if (B > 0) {
    WalkParams p{B,          S,           pitch,     T,          m_max,
                 snap_w,     unv_step,    onset_marks, ring_log2,
                 step_magic, step_shift,  frame_step, fs,        p_max,
                 lo_wide,    hi_wide,     lo_run,    hi_run};
    auto kernel =
        tab_global ? (step_magic ? walk_kernel<true, false>
                                 : walk_kernel<false, false>)
                   : (step_magic ? walk_kernel<true, true>
                                 : walk_kernel<false, true>);
    const int smem =
        tab_global ? ring_bytes(ring_log2) : smem_bytes(ring_log2, T);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
        y_snap, f0, voiced, n_sigs, n_frames, marks, flags, n_marks,
        static_cast<uint2*>(tab_global), p);
  }
  return (int)cudaGetLastError();
}

// *out = the most tracker frames whose table the current card lets a block
// keep in shared memory beside this ring
int mp_walk_max_shared_frames(int ring_log2, int* out) {
  if (!ring_ok(ring_log2)) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, walk_kernel<true, true>);
  if (e != cudaSuccess) return (int)e;
  const int room = optin - (int)attr.sharedSizeBytes - ring_bytes(ring_log2);
  *out = room > 0 ? room / (int)sizeof(uint2) : 0;
  return (int)cudaSuccess;
}

// out[3] = threads per block, dynamic shared memory bytes, resident blocks
// per SM, of walk_kernel with this ring and T tracker frames, the table in
// shared memory where in_shared is set
int mp_walk_occupancy(int ring_log2, int T, int in_shared, int* out) {
  if (!ring_ok(ring_log2)) return (int)cudaErrorInvalidValue;
  auto kernel = in_shared ? walk_kernel<true, true> : walk_kernel<true, false>;
  const int smem = in_shared ? smem_bytes(ring_log2, T) : ring_bytes(ring_log2);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = kThreads;
  out[1] = smem;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(out + 2, kernel,
                                                            kThreads, smem);
}

// One warp runs `steps` steps of the walk's dependent skeleton, with the
// frame index taken as mp_walk takes it for these arguments; out[2] gets
// the final position (so that nothing is optimised away) and the SM cycles
// of the loop.
int mp_walk_chain_probe(int steps, unsigned step_magic, int step_shift,
                        float frame_step, int* out, void* stream) {
  WalkParams p{};
  p.step_magic = step_magic;
  p.step_shift = step_shift;
  p.frame_step = frame_step;
  auto kernel = step_magic ? chain_probe_kernel<true>
                           : chain_probe_kernel<false>;
  kernel<<<1, 32, 0, (cudaStream_t)stream>>>(steps, p, out);
  return (int)cudaGetLastError();
}

const char* mp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
