// Viterbi pass of the pitch tracker for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  The JAX package runs this DP on the device as
// one lax.scan over frames and a second one for the backtrack
// (magphase_tpu/epochs/tracker.py:_viterbi); the port's plain version,
// kernels/viterbi.py:viterbi_plain, is a Python loop over frames of about
// ten small launches a frame, so that a batch of 3.5 s utterances costs
// some 7,000 launches.  This kernel runs the whole DP, forward pass and
// backtrack, in one launch.
//
// Per utterance, 16 states (N_CAND = 15 voiced candidates, state 15
// unvoiced); local (T, 16) and ll (T, 16) float32 rows, valid (T):
//
//   delta = local[0]
//   for t = 1 .. T-1:
//     trans[i][j] = 0                                    if !valid[t]
//                 = TRANS_W * |ll[t-1][i] - ll[t][j]|    if i, j < 15
//                 = 0                                    if i = j = 15
//                 = VUV_COST                             otherwise
//     tot[i][j]   = delta[i] + trans[i][j]
//     back[t][j]  = the first i of the least tot[i][j]
//     delta[j]    = min_i tot[i][j] + local[t][j]
//     delta      -= min_j delta
//   states[T-1] = the first j of the least delta; states[t-1] =
//   back[t][states[t]].
//
// What bounds it: a serial chain, not bytes and not operations.  Each
// frame's delta needs the last one's, so an utterance costs T x (the
// latency of one step), and a batch of 24 is far fewer warps than the
// card has SMs.  The design keeps everything it can off that chain:
//
// - One half-warp per utterance, lane j owning destination state j, two
//   utterances a block of one warp.  One exchange a frame: lane j writes
//   its new cost d[j] and its log2 lag into a 32-float row of shared
//   memory, __syncwarp, and every lane reads the whole row back (eight
//   16-byte loads).  Each lane then holds all 16 costs and lags: it takes
//   the row minimum, normalises all 16 costs and forms its transitions
//   from all 16 lags itself, with no shuffle and no second exchange.  The
//   rows are double-buffered, so one __syncwarp a frame orders them.
// - The loads leave the chain: the frame rows of the next kChunk steps
//   are loaded into registers while this chunk's steps run.
// - On the chain per frame: the store, the __syncwarp and the loads of
//   the row, a four-level min tree and the subtraction, the adds of the
//   transitions, a four-level argmin tree and the add of the local cost.
//   The transitions themselves depend on the lags alone.
// - The back-pointers go to a (B, T, 16) byte workspace in global memory,
//   byte j of frame t written by lane j: there is no cap on T.  The
//   backtrack's loads do not depend on the path: lane j loads its own
//   bytes of the next kBackChunk frames ahead, and each step is one
//   shuffle, state = __shfl_sync(back[t][lane], state).  Lane j keeps the
//   state of frame g + j and the half-warp stores 16 frames' states at
//   once.
//
// viterbi_probe_kernel runs the forward step, exchange included, on
// register data alone, with no global load or store: the chain's own time
// per step on this card, the yardstick of the kernel's bound beside its
// bytes.
//
// Exactness: every operation is the plain version's float32 operation,
// rounded on its own: __fsub_rn, fabsf, __fmul_rn, __fadd_rn (no FMA
// contraction of delta + TRANS_W * jump), with TRANS_W and VUV_COST passed
// as the float32 values torch multiplies and fills with.  Minima are exact.
// Ties go to the first index, as torch.min(dim) and jnp.argmin give them:
// each argmin tree takes the right half's value only where it is strictly
// less.  A NaN counts as less than every number (the first NaN wins, and a
// NaN in a row makes its minimum NaN), as torch.min and jnp.argmin treat
// it.  Build without --use_fast_math.
//
// Plain C entry points (loaded with ctypes); each launches on the given
// stream, does not synchronise, and returns a cudaError_t.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStates = 16;    // kernels/viterbi.py: N_STATES
constexpr int kUnvoiced = kStates - 1;
constexpr int kThreads = 32;   // two utterances a block
constexpr int kPerBlock = kThreads / kStates;
constexpr int kChunk = 8;      // forward steps whose rows are loaded ahead
constexpr int kBackChunk = 16; // backtrack steps whose bytes are loaded ahead

// a lies before b in the order of torch.min: NaN first, then ascending.
// !(a >= b) is a < b or either NaN; b == b rules out a NaN b.  Bitwise &,
// so that the compiler makes predicates and selects, not branches.
__device__ __forceinline__ bool before(float a, float b) {
  return !(a >= b) & (b == b);
}

// The first index of the least of v[0..15] in that order, by a tree whose
// left half holds the lower indices: the right half wins only where
// strictly before.  v is overwritten.
__device__ __forceinline__ int first_argmin(float (&v)[kStates]) {
  int idx[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) idx[i] = i;
#pragma unroll
  for (int s = 1; s < kStates; s *= 2) {
#pragma unroll
    for (int k = 0; k < kStates; k += 2 * s) {
      const bool p = before(v[k + s], v[k]);
      v[k] = p ? v[k + s] : v[k];
      idx[k] = p ? idx[k + s] : idx[k];
    }
  }
  return idx[0];
}

// Every lane reads the half-warp's row (16 costs, 16 log2 lags) into
// delta and llp.
__device__ __forceinline__ void read_row(const float* row,
                                         float (&delta)[kStates],
                                         float (&llp)[kStates]) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int q = 0; q < kStates / 4; ++q) {
    const float4 d = r4[q], l = r4[kStates / 4 + q];
    delta[4 * q] = d.x;
    delta[4 * q + 1] = d.y;
    delta[4 * q + 2] = d.z;
    delta[4 * q + 3] = d.w;
    llp[4 * q] = l.x;
    llp[4 * q + 1] = l.y;
    llp[4 * q + 2] = l.z;
    llp[4 * q + 3] = l.w;
  }
}

// One frame of the forward pass in lane j of the half-warp `mask`: delta
// and llp hold the last frame's normalised costs and log2 lags of all 16
// states, ll_j, loc_j and v are this frame's.  Exchanges the new costs
// through `row` (32 floats of shared memory, not the last frame's) and
// leaves this frame's normalised costs and lags in delta and llp.
// Returns lane j's back-pointer.
__device__ __forceinline__ int forward_step(float (&delta)[kStates],
                                            float (&llp)[kStates], float ll_j,
                                            float loc_j, bool v, int j,
                                            float* row, unsigned mask,
                                            float trans_w, float vuv_cost) {
  float tot[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    float tr;
    if (i < kUnvoiced && j < kUnvoiced)
      tr = __fmul_rn(trans_w, fabsf(__fsub_rn(llp[i], ll_j)));
    else
      tr = (i == kUnvoiced && j == kUnvoiced) ? 0.0f : vuv_cost;
    tot[i] = __fadd_rn(delta[i], v ? tr : 0.0f);
  }
  const int bi = first_argmin(tot);
  row[j] = __fadd_rn(tot[0], loc_j);
  row[kStates + j] = ll_j;
  __syncwarp(mask);
  read_row(row, delta, llp);
  // the row minimum, NaN if any cost is NaN (the order of the tree does
  // not change a minimum)
  float m[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) m[i] = delta[i];
#pragma unroll
  for (int s = 1; s < kStates; s *= 2) {
#pragma unroll
    for (int k = 0; k < kStates; k += 2 * s)
      m[k] = before(m[k + s], m[k]) ? m[k + s] : m[k];
  }
#pragma unroll
  for (int i = 0; i < kStates; ++i) delta[i] = __fsub_rn(delta[i], m[0]);
  return bi;
}

// local, ll: (B, T, 16) float32; valid: (B, T) bytes 0/1; back: (B, T, 16)
// bytes of workspace (frame 0's unused); states: (B, T) int64.
__global__ void __launch_bounds__(kThreads)
    viterbi_kernel(const float* __restrict__ local,
                   const float* __restrict__ ll,
                   const unsigned char* __restrict__ valid,
                   unsigned char* back, long long* __restrict__ states, int B,
                   int T, float trans_w, float vuv_cost) {
  __shared__ __align__(16) float s_rows[kPerBlock][2][2 * kStates];
  const int lane = threadIdx.x & 31;
  const int j = lane % kStates;
  const int half = lane / kStates;
  const int b = blockIdx.x * kPerBlock + half;
  if (b >= B) return;  // the other half-warp syncs only among its own
  const unsigned mask = 0xffffu << (half * kStates);
  const size_t row = (size_t)b * T;
  const float* loc_b = local + row * kStates + j;
  const float* ll_b = ll + row * kStates + j;
  const unsigned char* v_b = valid + row;
  unsigned char* back_b = back + row * kStates + j;

  // frame 0: the local costs as they are, and the lags, to every lane
  float delta[kStates], llp[kStates];
  s_rows[half][0][j] = loc_b[0];
  s_rows[half][0][kStates + j] = ll_b[0];
  __syncwarp(mask);
  read_row(s_rows[half][0], delta, llp);

  // forward pass, the rows of the next chunk in flight during this one
  float c_loc[kChunk], c_ll[kChunk];
  bool c_v[kChunk];
#pragma unroll
  for (int u = 0; u < kChunk; ++u) {
    const int t = min(1 + u, T - 1);
    c_loc[u] = loc_b[(size_t)t * kStates];
    c_ll[u] = ll_b[(size_t)t * kStates];
    c_v[u] = v_b[t] != 0;
  }
  for (int t0 = 1; t0 < T; t0 += kChunk) {
    float n_loc[kChunk], n_ll[kChunk];
    bool n_v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = min(t0 + kChunk + u, T - 1);
      n_loc[u] = loc_b[(size_t)t * kStates];
      n_ll[u] = ll_b[(size_t)t * kStates];
      n_v[u] = v_b[t] != 0;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + u;
      if (t < T) {
        const int bi = forward_step(delta, llp, c_ll[u], c_loc[u], c_v[u], j,
                                    s_rows[half][t & 1], mask, trans_w,
                                    vuv_cost);
        back_b[(size_t)t * kStates] = (unsigned char)bi;
      }
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      c_loc[u] = n_loc[u];
      c_ll[u] = n_ll[u];
      c_v[u] = n_v[u];
    }
  }

  // the last frame's state: the first of the least costs, in every lane
  int state = first_argmin(delta);

  // backtrack: lane j keeps the state of frame g + j of the group of 16
  // frames from g, stored when the walk reaches g
  long long* out = states + row;
  int mine = 0;
  int t_hi = T - 1;  // the frame whose state is `state`
  if (j == (t_hi & (kStates - 1))) mine = state;
  if ((t_hi & (kStates - 1)) == 0 && t_hi + j < T) out[t_hi + j] = mine;
  // (frame 0's bytes are never written: a load clamped to them is unused)
  int c_bp[kBackChunk];
#pragma unroll
  for (int u = 0; u < kBackChunk; ++u)
    c_bp[u] = back_b[(size_t)max(t_hi - u, 0) * kStates];
  for (; t_hi >= 1; t_hi -= kBackChunk) {
    int n_bp[kBackChunk];
#pragma unroll
    for (int u = 0; u < kBackChunk; ++u)
      n_bp[u] = back_b[(size_t)max(t_hi - kBackChunk - u, 0) * kStates];
#pragma unroll
    for (int u = 0; u < kBackChunk; ++u) {
      const int t = t_hi - u;  // frame t's state -> frame t - 1's
      if (t >= 1) {
        state = __shfl_sync(mask, c_bp[u], state, kStates);
        const int g = t - 1;
        if (j == (g & (kStates - 1))) mine = state;
        if ((g & (kStates - 1)) == 0 && g + j < T) out[g + j] = mine;
      }
    }
#pragma unroll
    for (int u = 0; u < kBackChunk; ++u) c_bp[u] = n_bp[u];
  }
}

// The forward step's chain on register data: one half-warp runs `steps`
// steps, the exchange through shared memory included, with frame rows made
// from the step's index (no global load or store), and writes the last
// costs plus the sum of the back-pointers (so that nothing is optimised
// away) and the SM cycles of the loop.
__global__ void viterbi_probe_kernel(int steps, float trans_w, float vuv_cost,
                                     float* out_delta, long long* out_cycles) {
  __shared__ __align__(16) float s_rows[2][2 * kStates];
  const int j = threadIdx.x;
  const unsigned mask = 0xffffu;
  float delta[kStates], llp[kStates];
#pragma unroll
  for (int i = 0; i < kStates; ++i) {
    delta[i] = 0.25f * (float)i;
    llp[i] = 6.0f + 0.125f * (float)i;
  }
  int acc = 0;
  const long long c0 = clock64();
  for (int t = 1; t < steps; ++t) {
    const float ll_j = 6.0f + 0.0625f * (float)((t * 7 + j * 13) & 31);
    const float loc_j = 0.03125f * (float)((t * 5 + j * 3) & 15);
    acc += forward_step(delta, llp, ll_j, loc_j, (t & 63) != 0, j,
                        s_rows[t & 1], mask, trans_w, vuv_cost);
  }
  const long long c1 = clock64();
  out_delta[j] = __fadd_rn(delta[j], (float)acc);
  if (j == 0) *out_cycles = c1 - c0;
}

}  // namespace

extern "C" {

int mp_viterbi(const float* local, const float* ll, const void* valid,
               void* back, long long* states, int B, int T, float trans_w,
               float vuv_cost, void* stream) {
  if (T < 1 || B < 0) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int blocks = (B + kPerBlock - 1) / kPerBlock;
    viterbi_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        local, ll, static_cast<const unsigned char*>(valid),
        static_cast<unsigned char*>(back), states, B, T, trans_w, vuv_cost);
  }
  return (int)cudaGetLastError();
}

int mp_viterbi_probe(int steps, float trans_w, float vuv_cost,
                     float* out_delta, long long* out_cycles, void* stream) {
  if (steps < 1) return (int)cudaErrorInvalidValue;
  viterbi_probe_kernel<<<1, kStates, 0, (cudaStream_t)stream>>>(
      steps, trans_w, vuv_cost, out_delta, out_cycles);
  return (int)cudaGetLastError();
}

const char* mp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
