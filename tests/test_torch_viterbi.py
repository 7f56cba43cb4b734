"""The tracker's Viterbi pass (kernels/viterbi.py) against the JAX package.

On the CPU the wrapper runs its plain version, which is held to the JAX
``_viterbi`` (vmapped over the batch) on inputs full of ties, where only
the first-index rule decides the path.  A numpy model of the CUDA kernel's
schedule (csrc/viterbi.cu: the argmin and minimum trees, the exchanged
rows, the chunked backtrack and its grouped stores) is held to the plain
version bit for bit.  The kernel itself against the plain version runs
where a card is present (marker ``cuda``) and skips elsewhere.
"""
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from magphase_tpu.epochs import tracker as jt
from magphase_tpu_torch.epochs import tracker as tt
from magphase_tpu_torch.kernels import viterbi as KV

FS_A = 16000.0
K = tt.N_CAND
f32 = np.float32


def _random(rng, B, T):
    """Candidates as the tracker gives them: NCCF peaks in (-1, 1] with
    non-peaks at -2.0, fractional lags over the 50-400 Hz range."""
    vals = rng.uniform(-0.5, 1.0, (B, T, K)).astype(f32)
    vals[rng.random((B, T, K)) < 0.3] = -2.0
    lags = rng.uniform(40.0, 320.0, (B, T, K)).astype(f32)
    return vals, lags


def _case(name, seed=0):
    """(vals (B, T, K), lags (B, T, K), valid (B, T)) of one input kind."""
    rng = np.random.default_rng(seed)
    B, T = 3, 40
    valid = np.ones((B, T), bool)
    if name == "all_minus_two":
        # every candidate a non-peak: all voiced states cost 1e6 alike
        vals = np.full((B, T, K), -2.0, f32)
        lags = np.broadcast_to(rng.integers(40, 320, (B, T, 1)),
                               (B, T, K)).astype(f32)
    elif name == "equal_local":
        # every candidate of a frame alike, one lag an utterance: voiced
        # states tie everywhere, and the voiced frames' cost is below the
        # unvoiced state's
        vals = np.broadcast_to(rng.uniform(0.3, 0.99, (B, T, 1)),
                               (B, T, K)).astype(f32)
        lags = np.broadcast_to(rng.integers(40, 320, (B, 1, 1)),
                               (B, T, K)).astype(f32)
    elif name == "few_values":
        # values and lags from small sets: exact ties in costs and jumps
        vals = rng.choice(np.asarray([-2.0, 0.5, 0.8], f32), (B, T, K))
        lags = rng.choice(np.asarray([50.0, 100.0, 200.0], f32), (B, T, K))
    elif name == "invalid_tail":
        vals, lags = _random(rng, B, T)
        valid &= np.arange(T)[None, :] < np.asarray([T, 25, 7])[:, None]
    elif name in ("T1", "T2"):
        vals, lags = _random(rng, B, int(name[1:]))
        valid = np.ones((B, int(name[1:])), bool)
    elif name == "random":
        vals, lags = _random(rng, B, T)
    else:
        raise ValueError(name)
    return (np.ascontiguousarray(vals), np.ascontiguousarray(lags),
            np.ascontiguousarray(valid))


TIE_CASES = ("all_minus_two", "equal_local", "few_values", "invalid_tail",
             "T2")


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_states(vals, lags, valid):
    return np.asarray(jax.vmap(functools.partial(jt._viterbi, fs_a=FS_A))(
        jnp.asarray(vals), jnp.asarray(lags), jnp.asarray(valid)))


@pytest.fixture
def plain_calls(monkeypatch):
    """Records each call of viterbi_plain that the wrapper makes."""
    calls = []
    orig = KV.viterbi_plain

    def spy(*args):
        calls.append(args)
        return orig(*args)

    monkeypatch.setattr(KV, "viterbi_plain", spy)
    return calls


@pytest.mark.parametrize("name", TIE_CASES + ("random",))
def test_plain_viterbi_matches_jax_on_ties(name, plain_calls):
    """The port's _viterbi on the CPU (the wrapper's plain version) gives
    the JAX package's states, equal, on inputs where ties decide the path:
    both take the first index of a tie, in the forward minima and in the
    final argmin."""
    vals, lags, valid = _case(name)
    got = tt._viterbi(_t(vals), _t(lags), _t(valid), fs_a=FS_A)
    assert len(plain_calls) == 1
    assert got.dtype == torch.int64 and got.shape == valid.shape
    np.testing.assert_array_equal(got.numpy(), _jax_states(vals, lags, valid))


def test_one_frame_takes_the_first_least_local_cost(plain_calls):
    """T = 1: no transition, the state is the first index of the least
    local cost.  The JAX _viterbi takes T >= 2 (its backtrack starts from
    the last step of its scan, and a scan over T - 1 = 0 frames has none;
    the tracker's frame buckets are 128 and up), so the DP's definition is
    the reference here; ties are made by repeating the least cost."""
    vals, lags, valid = _case("T1")
    vals[1, 0, 3:] = vals[1, 0, 2]
    lags[1, 0, 3:] = lags[1, 0, 2]
    local, _ = tt._dp_costs(_t(vals), _t(lags), _t(valid), fs_a=FS_A)
    got = tt._viterbi(_t(vals), _t(lags), _t(valid), fs_a=FS_A)
    assert len(plain_calls) == 1 and got.shape == (3, 1)
    np.testing.assert_array_equal(got.numpy()[:, 0],
                                  np.argmin(local.numpy()[:, 0], axis=1))


def test_equal_local_costs_take_the_first_voiced_state():
    """Where every voiced state of a frame costs the same, the path takes
    state 0 or the unvoiced state, nothing else: the first-index rule."""
    vals, lags, valid = _case("equal_local")
    got = tt._viterbi(_t(vals), _t(lags), _t(valid), fs_a=FS_A).numpy()
    assert np.isin(got, (0, K)).all() and (got == 0).any()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch(
        plain_calls):
    """A CPU tensor goes to viterbi_plain, and no kernel launch is
    counted; the result is the plain version's."""
    vals, lags, valid = _case("random", seed=4)
    local, ll_all = tt._dp_costs(_t(vals), _t(lags), _t(valid), fs_a=FS_A)
    before = KV.viterbi.launches
    got = KV.viterbi(local, ll_all, _t(valid))
    assert KV.launch_counts() == {"viterbi": before}
    assert len(plain_calls) == 1 and plain_calls[0][0] is local
    np.testing.assert_array_equal(
        got.numpy(), _jax_states(vals, lags, valid))


def test_costs_are_the_jax_packages():
    """The transition costs the kernel is given are the JAX tracker's."""
    assert (KV.TRANS_W, KV.VUV_COST) == (jt.TRANS_W, jt.VUV_COST)
    assert KV.N_STATES == jt.N_CAND + 1
    assert KV._costs() == (float(f32(0.6)), float(f32(0.2)))


# ---------------------------------------------------------------------------
# a numpy model of the CUDA kernel's schedule

def _before(a, b):
    """csrc/viterbi.cu's order: NaN first, then ascending."""
    return ~(a >= b) & (b == b)


def _first_argmin(v):
    """The kernel's argmin tree over the leading axis of v (16, ...): the
    right half wins only where strictly before."""
    v, idx = list(v), [np.full(v[0].shape, i) for i in range(len(v))]
    s = 1
    while s < len(v):
        for k in range(0, len(v), 2 * s):
            take = _before(v[k + s], v[k])
            v[k] = np.where(take, v[k + s], v[k])
            idx[k] = np.where(take, idx[k + s], idx[k])
        s *= 2
    return v[0], idx[0]


def _kernel_model(local, ll, valid, chunk=16):
    """csrc/viterbi.cu step by step, the 16 lanes of a half-warp as a
    vector: the forward step (transitions from the exchanged row, the
    argmin tree, the new costs and lags exchanged, their minimum by a tree
    and the normalisation), the final argmin tree, and the backtrack with
    its clamped prefetch, one shuffle a frame and the stores of 16 frames
    at once.  Frames no store reaches stay -1."""
    B, T, S = local.shape
    lanes = np.arange(S)
    tw, vuv = (f32(c) for c in KV._costs())
    out = np.full((B, T), -1, np.int64)
    for b in range(B):
        back = np.zeros((T, S), np.int64)
        delta, llp = local[b, 0].copy(), ll[b, 0].copy()   # the row
        for t in range(1, T):
            tot = []
            for i in range(S):
                if i < S - 1:
                    tr = np.where(lanes < S - 1,
                                  tw * np.abs(llp[i] - ll[b, t]), vuv)
                else:
                    tr = np.where(lanes == S - 1, f32(0), vuv)
                tr = tr.astype(f32) if valid[b, t] else np.zeros(S, f32)
                tot.append(delta[i] + tr)
            best, back[t] = _first_argmin(tot)
            row = best + local[b, t]           # lane j's d[j]: the row
            m = list(row)
            s = 1
            while s < S:
                for k in range(0, S, 2 * s):
                    m[k] = np.where(_before(m[k + s], m[k]), m[k + s], m[k])
                s *= 2
            delta, llp = row - m[0], ll[b, t]
        st = int(_first_argmin(list(delta))[1])
        mine = np.zeros(S, np.int64)
        t_hi = T - 1
        mine[t_hi % S] = st
        if t_hi % S == 0:
            keep = t_hi + lanes < T
            out[b, (t_hi + lanes)[keep]] = mine[keep]
        c_bp = [back[max(t_hi - u, 0)] for u in range(chunk)]
        while t_hi >= 1:
            n_bp = [back[max(t_hi - chunk - u, 0)] for u in range(chunk)]
            for u in range(chunk):
                t = t_hi - u
                if t >= 1:
                    st = int(c_bp[u][st])
                    g = t - 1
                    mine[g % S] = st
                    if g % S == 0:
                        keep = g + lanes < T
                        out[b, (g + lanes)[keep]] = mine[keep]
            c_bp = n_bp
            t_hi -= chunk
    return out


@pytest.mark.parametrize("T", [1, 2, 15, 16, 17, 33, 40])
@pytest.mark.parametrize("name", ["random", "few_values", "equal_local",
                                  "invalid_tail", "nan"])
def test_kernel_model_matches_plain(name, T):
    """The kernel's schedule gives the plain version's states, bitwise, at
    frame counts around the chunk and store-group edges; 'nan' puts NaNs
    into the costs (the first NaN wins, as in torch.min)."""
    vals, lags, valid = _case("random" if name == "nan" else name, seed=T)
    local, ll_all = tt._dp_costs(_t(vals[:, :T]), _t(lags[:, :T]),
                                 _t(valid[:, :T]), fs_a=FS_A)
    local = local.numpy().copy()
    if name == "nan":
        rng = np.random.default_rng(T)
        local[rng.random(local.shape) < 0.02] = np.nan
    ll_all = ll_all.numpy()
    ref = KV.viterbi_plain(_t(local), _t(ll_all), _t(valid[:, :T])).numpy()
    np.testing.assert_array_equal(
        _kernel_model(local, ll_all, valid[:, :T]), ref)


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,B,T", [("random", 24, 768),
                                      ("all_minus_two", 3, 40),
                                      ("equal_local", 3, 40),
                                      ("few_values", 3, 40),
                                      ("invalid_tail", 3, 40),
                                      ("T1", 3, 1), ("T2", 3, 2),
                                      ("long", 3, 4500)])
def test_cuda_viterbi_kernel_matches_plain(cuda_device, name, B, T):
    """The kernel's states on the card equal the plain version's on the
    card, bitwise, with one launch counted."""
    if name == "long":
        rng = np.random.default_rng(7)
        vals, lags = _random(rng, B, T)
        valid = np.arange(T)[None, :] < np.asarray([T, T - 300, 1000])[:, None]
    elif name == "random":
        vals, lags = _random(np.random.default_rng(8), B, T)
        valid = np.ones((B, T), bool)
    else:
        vals, lags, valid = _case(name)
    d = cuda_device
    local, ll_all = tt._dp_costs(_t(vals).to(d), _t(lags).to(d),
                                 _t(valid).to(d), fs_a=FS_A)
    v = _t(valid).to(d)
    before = KV.viterbi.launches
    got = KV.viterbi(local, ll_all, v)
    ref = KV.viterbi_plain(local, ll_all, v)
    torch.cuda.synchronize()
    assert KV.viterbi.launches == before + 1
    assert torch.equal(got, ref)
