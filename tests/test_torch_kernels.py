"""The port's kernels (K1 frames, K2 ola, K3 ola_anti_ring, K4 walk)
against the JAX package.

On the CPU the wrappers run their plain torch versions; these are compared
with the JAX XLA path and with the Pallas kernels in interpret mode.  The
CUDA kernels against the plain versions run where a card is present
(marker ``cuda``) and skip elsewhere.
"""
import functools
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from magphase_tpu.core import framing as jframing
from magphase_tpu.core.windows import BOXCAR, HANNING, VOI_NOISE
from magphase_tpu.epochs import placement_device as jpd
from magphase_tpu.pallas_kernels.framing_pallas import (frames_pallas,
                                                        ola_pallas,
                                                        pad_signal)
from magphase_tpu.pallas_kernels.walk_pallas import place_epochs_pallas
from magphase_tpu.parallel import analysis_batch as jab
from magphase_tpu.utils.tracker_eval import make_stimulus
from magphase_tpu_torch.core import framing as tframing
from magphase_tpu_torch.core import windows as tW
from magphase_tpu_torch.epochs import placement_device as tpd
from magphase_tpu_torch.kernels import framing as K
from magphase_tpu_torch.kernels import walk as K4

B, F, N, S = 3, 64, 512, 8192

# K1 window families: (voiced, unvoiced); equal ids mean no per-frame select
FAMILIES = [(HANNING, HANNING), (VOI_NOISE, HANNING), (BOXCAR, BOXCAR),
            (VOI_NOISE, VOI_NOISE)]


def _frames_inputs(seed=0):
    rng = np.random.default_rng(seed)
    sig = rng.standard_normal((B, S)).astype(np.float32)
    pm = np.cumsum(rng.integers(60, 120, (B, F)), axis=1).astype(np.int32)
    nfrms = np.asarray([F, F - 10, 7], np.int32)
    n_sig = np.asarray([S - 100, S - 1000, S], np.int32)
    voi = (rng.random((B, F)) > 0.4).astype(np.float32)
    return sig, pm, nfrms, n_sig, voi


def _port_frames(sig, pm, nfrms, n_sig, voi, fams):
    voiced = torch.from_numpy(voi > 0) if fams[0] != fams[1] else None
    fr, L, R, valid = tframing.pitch_sync_frames_batch(
        torch.from_numpy(sig), torch.from_numpy(pm), torch.from_numpy(nfrms),
        torch.from_numpy(n_sig), N, win_family=fams[0], voiced=voiced,
        win_family_unvoiced=fams[1] if voiced is not None else None)
    return fr.numpy(), L.numpy(), R.numpy()


@pytest.mark.parametrize("fams", FAMILIES)
def test_frames_plain_matches_jax_xla(fams):
    """K1 plain vs framing.pitch_sync_frames (the JAX XLA path).  Bound
    1e-6: the only ops not rounded identically are the windows' cos and
    sqrt (<= 1 ulp apart between libms, i.e. <= 6e-8 on a window value
    <= 1, times a signal of |x| < 6)."""
    sig, pm, nfrms, n_sig, voi = _frames_inputs()
    got, _, _ = _port_frames(sig, pm, nfrms, n_sig, voi, fams)
    ref = []
    for b in range(B):
        kw = {}
        if fams[0] != fams[1]:
            kw = dict(voiced=jnp.asarray(voi[b] > 0),
                      win_family_unvoiced=fams[1])
        fr, _, _, _ = jframing.pitch_sync_frames(
            jnp.asarray(sig[b]), jnp.asarray(pm[b]), jnp.int32(nfrms[b]),
            jnp.int32(n_sig[b]), N, fams[0], **kw)
        ref.append(np.asarray(fr))
    np.testing.assert_allclose(got, np.stack(ref), rtol=0, atol=1e-6)


@pytest.mark.parametrize("fams", FAMILIES[:3])
def test_frames_plain_matches_pallas_interpret(fams):
    """K1 plain vs the Pallas kernel in interpret mode.  Bound 1e-5: the
    Pallas body computes bartlett^2.5 as power(t, 2.5) where the XLA path
    and the port use t*t*sqrt(t) (fault F1, up to 3.5e-6 apart)."""
    sig, pm, nfrms, n_sig, voi = _frames_inputs(1)
    n_sig = np.minimum(n_sig, S)
    got, L, R = _port_frames(sig, pm, nfrms, n_sig, voi, fams)
    ref = np.asarray(frames_pallas(
        jnp.asarray(pad_signal(sig, N)), jnp.asarray(pm),
        jnp.asarray(L.astype(np.int32)), jnp.asarray(R.astype(np.int32)),
        jnp.asarray(voi), jnp.asarray(nfrms), fft_len=N,
        fam_voiced=fams[0], fam_unvoiced=fams[1]))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def _ola_inputs(seed=2):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((B, F, N)).astype(np.float32)
    shifts = rng.integers(60, 120, (B, F)).astype(np.int32)
    pm = np.cumsum(shifts, axis=1).astype(np.int32)
    nfrms = np.asarray([F, F - 5, 3], np.int32)
    return frames, shifts, pm, nfrms


OUT_LEN = 16384


def test_ola_plain_matches_jax_xla():
    """K2 plain vs framing.ola_centered (XLA scatter-add).  Bound 1e-5:
    the XLA CPU scatter need not add the overlapping frames in frame order,
    so sums may differ in the last bits."""
    frames, _, pm, nfrms = _ola_inputs()
    got = tframing.ola_centered_batch(torch.from_numpy(frames),
                                      torch.from_numpy(pm),
                                      torch.from_numpy(nfrms), OUT_LEN)
    ref = np.stack([np.asarray(jframing.ola_centered(
        jnp.asarray(frames[b]), jnp.asarray(pm[b]), jnp.int32(nfrms[b]),
        OUT_LEN)) for b in range(B)])
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_ola_plain_matches_pallas_interpret():
    """K2 plain vs the Pallas OLA kernel in interpret mode (same layout
    offset as core/framing.py's TPU branch), bound 1e-5 as above."""
    frames, _, pm, nfrms = _ola_inputs(3)
    got = K.ola(torch.from_numpy(frames),
                torch.from_numpy(pm - N // 2), torch.from_numpy(nfrms),
                out_len=OUT_LEN).numpy()
    ref = np.asarray(ola_pallas(jnp.asarray(frames),
                                jnp.asarray(pm - N // 2 + N),
                                jnp.asarray(nfrms), fft_len=N,
                                out_len_pad=OUT_LEN + 4 * N))[:, N:N + OUT_LEN]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_ola_anti_ring_plain_matches_pallas_interpret():
    """K3 plain vs ola_pallas(anti_ring=True) in interpret mode.  Bound
    1e-5: the window's cos differs by <= 1 ulp between libms, and the sums
    may be ordered differently."""
    frames, shifts, pm, nfrms = _ola_inputs(4)
    wl, wr = tframing.ar_winlens(torch.from_numpy(shifts),
                                 torch.from_numpy(nfrms))
    got = K.ola_anti_ring(torch.from_numpy(frames),
                          torch.from_numpy(pm - N // 2),
                          torch.from_numpy(nfrms), wl.to(torch.int32),
                          wr.to(torch.int32), out_len=OUT_LEN).numpy()
    jwl, jwr = jax.vmap(jframing.ar_winlens)(jnp.asarray(shifts),
                                            jnp.asarray(nfrms))
    ref = np.asarray(ola_pallas(
        jnp.asarray(frames), jnp.asarray(pm - N // 2 + N), jnp.asarray(nfrms),
        jwl.astype(jnp.int32), jwr.astype(jnp.int32), fft_len=N,
        out_len_pad=OUT_LEN + 4 * N, anti_ring=True))[:, N:N + OUT_LEN]
    np.testing.assert_array_equal(np.asarray(jwl), wl.numpy())
    np.testing.assert_array_equal(np.asarray(jwr), wr.numpy())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_ola_plain_is_the_in_order_float32_sum():
    """K2's contract, bitwise: each output sample is the float32 sum from
    0.0 of the covering frames in increasing frame order (what the CUDA
    gather computes), with samples outside [0, out_len) dropped."""
    frames, _, pm, nfrms = _ola_inputs(5)
    starts = pm - N // 2
    out_len = int(pm.max()) // 2          # cut inside the signal
    ref = np.zeros((B, out_len), np.float32)
    for b in range(B):
        for f in range(nfrms[b]):
            for p in range(N):
                o = starts[b, f] + p
                if 0 <= o < out_len:
                    ref[b, o] = np.float32(ref[b, o] + frames[b, f, p])
    got = K.ola(torch.from_numpy(frames), torch.from_numpy(starts),
                torch.from_numpy(nfrms), out_len=out_len).numpy()
    np.testing.assert_array_equal(got, ref)


def test_ola_anti_ring_is_window_then_ola():
    """K3's plain version equals the two-pass form bitwise: anti-ringing
    window (core/framing.apply_anti_ringing), then K2."""
    frames, shifts, pm, nfrms = _ola_inputs(6)
    fr, sh, p_, nf = (torch.from_numpy(a) for a in (frames, shifts, pm,
                                                    nfrms))
    fused = tframing.ola_centered_batch(fr, p_, nf, OUT_LEN, ar_shifts=sh)
    two_pass = tframing.ola_centered_batch(
        tframing.apply_anti_ringing(fr, sh, nf), p_, nf, OUT_LEN)
    assert torch.equal(fused, two_pass)


def test_anti_ring_window_matches_generic_centr_win():
    """The specialised anti-ringing window (per-frame fill) is bitwise the
    generic centr_win_value(RAISED_HANNING, att=1, fill_bound=True),
    degenerate rows included."""
    rng = np.random.default_rng(7)
    shifts = torch.from_numpy(rng.integers(20, 90, (2, 24)).astype(np.int32))
    shifts[:, -2:] = 0
    for nfrms in (24, 20, 1):
        nf = torch.tensor([nfrms, nfrms])
        wl, wr = tframing.ar_winlens(shifts, nf)
        got = tW.anti_ring_window(wl, wr, 256)
        ref = tW.centr_win_value(torch.arange(256), wl[..., None],
                                 wr[..., None], 256, tW.RAISED_HANNING,
                                 att=1.0, fill_bound=True)
        assert torch.equal(got, ref)


@pytest.mark.parametrize("family", [HANNING, VOI_NOISE, BOXCAR])
def test_asym_window_matches_jax(family):
    """windows.asym_win_value vs the JAX package: bitwise for boxcar; within
    1 ulp of a value <= 1 (6e-8) for hanning and bartlett^2.5, whose cos
    and sqrt come from different libms (torch's CPU sqrt is not correctly
    rounded; XLA's and CUDA's are)."""
    from magphase_tpu.core import windows as jW
    q = np.arange(0, 400)[None, :]
    L = np.asarray([[0], [1], [37], [150], [199]])
    R = np.asarray([[0], [250], [1], [60], [199]])
    got = tW.asym_win_value(torch.from_numpy(q), torch.from_numpy(L),
                            torch.from_numpy(R), family).numpy()
    ref = np.asarray(jW.asym_win_value(jnp.asarray(q), jnp.asarray(L),
                                       jnp.asarray(R), family))
    if family != BOXCAR:
        np.testing.assert_allclose(got, ref, rtol=0, atol=6e-8)
    else:
        np.testing.assert_array_equal(got, ref)


def test_wrappers_take_plain_path_on_cpu_and_refuse_other_devices():
    """A CPU tensor runs the plain version and launches nothing; a tensor
    on any device other than CPU or CUDA is refused."""
    K.reset_launch_counts()
    K4.reset_launch_counts()
    frames, _, pm, nfrms = _ola_inputs(8)
    K.ola(torch.from_numpy(frames), torch.from_numpy(pm - N // 2),
          torch.from_numpy(nfrms), out_len=OUT_LEN)
    assert K.launch_counts() == {"frames": 0, "ola": 0, "ola_anti_ring": 0}
    meta = torch.empty(B, F, N, device="meta")
    with pytest.raises(ValueError):
        K.ola(meta, torch.empty(B, F, dtype=torch.int32, device="meta"),
              torch.empty(B, dtype=torch.int32, device="meta"), out_len=16)
    y = torch.zeros(2, 4096)
    tracks = torch.zeros(2, 16)
    n_sig = torch.tensor([4000, 100], dtype=torch.int32)
    n_frm = torch.tensor([16, 2], dtype=torch.int32)
    kw = dict(fs=16000, m_max=128, frame_step=80.0, snap_w=256)
    K4.walk(y, tracks, tracks, n_sig, n_frm, **kw)
    assert K4.launch_counts() == {"walk": 0}
    with pytest.raises(ValueError):
        K4.walk(y.to("meta"), tracks.to("meta"), tracks.to("meta"),
                n_sig.to("meta"), n_frm.to("meta"), **kw)


# ---------------------------------------------------------------------------
# K4, the epoch walk: the plain version against the JAX XLA walk and the
# Pallas walk in interpret mode, on the walk inputs of the JAX tracker

def _walk_inputs(signals, fs):
    """(y_snap, f0, voiced, n_sigs, n_frames) numpy from the JAX tracker on
    the padded batch, and the batch's walk capacity m_max."""
    _, (sigs, n_sigs, n_frames), _, Tmax, m_max, _ = jab._host_signal_batch(
        list(signals), fs, None, fft_len=4096)
    y, f0, voi = jax.vmap(functools.partial(
        jpd._track_one, fs=fs, n_frames_max=Tmax))(
        jab._sigs_f32(jnp.asarray(sigs)), jnp.asarray(n_frames))
    return (tuple(np.asarray(a) for a in (y, f0, voi, n_sigs, n_frames)),
            m_max)


def _walk_cases():
    rng = np.random.RandomState(0)
    mixed = [(0.2, None, None), (0.3, 140, 200), (0.15, None, None),
             (0.3, 220, 110), (0.1, None, None)]
    voiced = [make_stimulus(48000, mixed, seed=1)[0],
              make_stimulus(48000, [(0.5, 90, 180)], seed=2)[0]]
    return {
        "voiced_unvoiced": (voiced, 48000, None),
        "noise_and_silence": ([rng.uniform(-0.3, 0.3, 48000), np.zeros(1024)],
                              48000, None),
        "capacity_hit": (voiced, 48000, 128),
        "16k": ([make_stimulus(16000, mixed, seed=3)[0],
                 make_stimulus(16000, [(0.4, 300, 150)], seed=4)[0]], 16000,
                None),
    }


@pytest.mark.parametrize("case", ["voiced_unvoiced", "noise_and_silence",
                                  "capacity_hit", "16k"])
def test_walk_plain_matches_jax_xla_and_pallas(case):
    """K4's plain version is bitwise equal to place_epochs_kernel (vmapped)
    and to place_epochs_pallas in interpret mode: marks, flags, n_marks."""
    signals, fs, m_cap = _walk_cases()[case]
    arrs, m_max = _walk_inputs(signals, fs)
    m_max = m_cap or m_max
    kw = dict(fs=fs, m_max=m_max, frame_step=jpd._walk_frame_step(fs))
    ref = jax.vmap(functools.partial(jpd.place_epochs_kernel, **kw))(
        *(jnp.asarray(a) for a in arrs))
    pallas = place_epochs_pallas(*(jnp.asarray(a) for a in arrs),
                                 snap_w=jpd._snap_win(fs), **kw)
    got = K4.walk(*(torch.from_numpy(a) for a in arrs),
                  snap_w=tpd._snap_win(fs), **kw)
    if case == "capacity_hit":
        assert int(np.asarray(ref[2]).max()) == 128
    for g, r, p in zip(got, ref, pallas):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_array_equal(g.numpy(), np.asarray(p))


@pytest.mark.parametrize("fs", [16000, 44100, 48000])
def test_walk_frame_index_survives_xla_reciprocal(fs):
    """XLA compiles the JAX walk's t / frame_step as t times the float32
    reciprocal; K4 and its plain version divide.  The truncated frame index
    is the same for every mark position t < 2^21 (~44 s at 48 kHz)."""
    step = jpd._walk_frame_step(fs)
    t = np.arange(2 ** 21, dtype=np.int32)
    ref = np.asarray(jax.jit(lambda a: (a.astype(jnp.float32) / step)
                             .astype(jnp.int32))(t))
    tt = torch.from_numpy(t).to(torch.float32)
    got = (tt / torch.full_like(tt, step)).to(torch.int32).numpy()
    np.testing.assert_array_equal(got, ref)


def test_walk_constants_round_as_the_jax_walk():
    """unv_step rounds half to even (Python's round), as the JAX walk
    computes it: 220 at 44.1 kHz, where C's roundf would give 221."""
    assert K4.walk_constants(44100, 222.0)["unv_step"] == 220
    assert K4.walk_constants(48000, 240.0)["unv_step"] == 240
    c = K4.walk_constants(48000, 240.0)
    assert c["p_max"] == np.float32(960.0)
    assert c["lo_wide"] == np.float32(0.65) and c["hi_run"] == np.float32(1.15)


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fams", FAMILIES)
def test_cuda_frames_kernel_matches_plain(cuda_device, fams):
    """K1 on the card vs its plain version on the card: 1e-6 (the window
    is rounded op by op as the plain version rounds it)."""
    sig, pm, nfrms, n_sig, voi = _frames_inputs(9)
    d = cuda_device
    t = [torch.from_numpy(a).to(d) for a in (sig, pm, nfrms, n_sig, voi)]
    _, L, R, _ = tframing.frame_geometry_batch(t[1], t[2], t[3])
    args = (t[0], t[1], L.to(torch.int32).contiguous(),
            R.to(torch.int32).contiguous(), t[4], t[2], t[3])
    kw = dict(fft_len=N, fam_voiced=fams[0], fam_unvoiced=fams[1])
    before = K.frames.launches
    got = K.frames(*args, **kw)
    ref = K.frames_plain(*args, **kw)
    torch.cuda.synchronize()
    assert K.frames.launches == before + 1
    assert float((got - ref).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_cuda_ola_kernels_match_plain(cuda_device):
    """K2 on the card is bitwise its plain version; K3 within 1e-6."""
    frames, shifts, pm, nfrms = _ola_inputs(10)
    d = cuda_device
    fr = torch.from_numpy(frames).to(d)
    st = torch.from_numpy(pm - N // 2).to(d)
    nf = torch.from_numpy(nfrms).to(d)
    assert torch.equal(K.ola(fr, st, nf, out_len=OUT_LEN),
                       K.ola_plain(fr, st, nf, out_len=OUT_LEN))
    wl, wr = tframing.ar_winlens(torch.from_numpy(shifts).to(d), nf)
    wl, wr = wl.to(torch.int32).contiguous(), wr.to(torch.int32).contiguous()
    got = K.ola_anti_ring(fr, st, nf, wl, wr, out_len=OUT_LEN)
    ref = K.ola_anti_ring_plain(fr, st, nf, wl, wr, out_len=OUT_LEN)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["voiced_unvoiced", "noise_and_silence",
                                  "capacity_hit", "16k"])
def test_cuda_walk_kernel_matches_plain(cuda_device, case):
    """K4 on the card is bitwise its plain version on the card."""
    signals, fs, m_cap = _walk_cases()[case]
    arrs, m_max = _walk_inputs(signals, fs)
    kw = dict(fs=fs, m_max=m_cap or m_max,
              frame_step=tpd._walk_frame_step(fs), snap_w=tpd._snap_win(fs))
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    before = K4.walk.launches
    got = K4.walk(*t, **kw)
    ref = K4.walk_plain(*t, **kw)
    torch.cuda.synchronize()
    assert K4.walk.launches == before + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _assert_walk_kernel_is_plain(t, kw):
    """K4 on CUDA tensors ``t`` equals its plain version bit for bit, and
    a second launch writes the same bytes."""
    got = K4.walk(*t, **kw)
    again = K4.walk(*t, **kw)
    ref = K4.walk_plain(*t, **kw)
    torch.cuda.synchronize()
    for g, a, r in zip(got, again, ref):
        assert torch.equal(g, r)
        assert torch.equal(g, a)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "empty_span", "n_sig_near_S"])
def test_cuda_walk_kernel_matches_plain_on_synthetic_rows(cuda_device, case):
    """K4 on the card on the rows that tie, end in an empty span and reach
    the end of the padded row, repeated to a batch of 7 (no multiple of
    anything), one row shifted by a sample."""
    arrs, fs, _ = _synthetic_walk_case(case)
    reps = [np.concatenate([a, a, a, a[:1]]) for a in arrs]
    reps[0][3] = np.roll(reps[0][3], 1)
    t = [torch.from_numpy(a).to(cuda_device) for a in reps]
    kw = dict(fs=fs, m_max=tpd.placement_m_max(reps[0].shape[1], fs),
              frame_step=tpd._walk_frame_step(fs), snap_w=tpd._snap_win(fs))
    _assert_walk_kernel_is_plain(t, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("fs", [16000, 48000])
def test_cuda_walk_kernel_at_its_smallest_shapes(cuda_device, fs):
    """K4 on the card with S == snap_w, T == 1 and m_max == 1, on a voiced
    and an unvoiced row and one whose signal ends inside the first window;
    and with rows that are not 16-byte aligned (a view one sample into a
    longer buffer, S no multiple of 4), which the wrapper copies into
    aligned ones."""
    rng = np.random.default_rng(14)
    snap_w = tpd._snap_win(fs)
    y = torch.from_numpy(rng.standard_normal((3, snap_w)).astype(np.float32))
    f0 = torch.tensor([[100.0], [0.0], [100.0]])
    voi = torch.tensor([[1.0], [0.0], [1.0]])
    n_sig = torch.tensor([snap_w, snap_w, fs // 100 + 5], dtype=torch.int32)
    n_frm = torch.ones(3, dtype=torch.int32)
    t = [a.to(cuda_device) for a in (y, f0, voi, n_sig, n_frm)]
    for m_max in (1, 64):
        got = _assert_walk_kernel_is_plain(
            t, dict(fs=fs, m_max=m_max, frame_step=tpd._walk_frame_step(fs),
                    snap_w=snap_w))
        assert int(got[2][2]) <= 1 and int(got[2].max()) >= 1
    # rows 4 bytes off a 16-byte boundary
    S_odd = 4 * snap_w + 1
    buf = torch.from_numpy(rng.standard_normal(3 * S_odd + 1).astype(
        np.float32)).to(cuda_device)
    y_odd = buf[1:].view(3, S_odd)
    assert y_odd.data_ptr() % 16 != 0 and y_odd.is_contiguous()
    T = S_odd // int(tpd._walk_frame_step(fs)) + 1
    t = [y_odd, torch.full((3, T), 150.0, device=cuda_device),
         torch.ones(3, T, device=cuda_device),
         torch.tensor([S_odd, S_odd - 7, 900], dtype=torch.int32,
                      device=cuda_device),
         torch.full((3,), T, dtype=torch.int32, device=cuda_device)]
    _assert_walk_kernel_is_plain(
        t, dict(fs=fs, m_max=256, frame_step=tpd._walk_frame_step(fs),
                snap_w=snap_w))


@pytest.mark.cuda
def test_cuda_walk_kernel_on_an_utterance_beyond_the_shared_table(
        cuda_device):
    """K4 on the card on 150 s of signal, T = 30,000 tracker frames: the
    frame table no longer fits in shared memory beside the ring and lies
    in global memory; bitwise the plain version all the same, next to a
    short row of the same batch."""
    rng = np.random.default_rng(17)
    fs, T = 48000, 30000
    step = int(tpd._walk_frame_step(fs))
    S = T * step
    ring_log2 = K4.ring_geometry(fs)["ring"].bit_length() - 1
    assert T > K4.max_shared_frames(cuda_device, ring_log2) >= 640
    assert not K4.kernel_occupancy(fs, T, cuda_device)["table_in_shared"]
    y = rng.standard_normal((2, S)).astype(np.float32)
    f0 = rng.uniform(55.0, 70.0, (2, T)).astype(np.float32)
    voiced = (rng.random((2, T)) > 0.02).astype(np.float32)
    n_sig = np.asarray([S - 11, 5 * fs], np.int32)
    n_frm = (n_sig // step + 1).clip(max=T).astype(np.int32)
    t = [torch.from_numpy(a).to(cuda_device)
         for a in (y, f0, voiced, n_sig, n_frm)]
    got = _assert_walk_kernel_is_plain(
        t, dict(fs=fs, m_max=tpd.placement_m_max(S, fs),
                frame_step=float(step), snap_w=tpd._snap_win(fs)))
    assert int(got[2][0]) > 8000 > int(got[2][1]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,frames_per_row", [(1024, 64), (2048, 64),
                                              (4096, 64), (510, 64),
                                              (4096, 1)])
def test_cuda_frames_kernel_writes_every_element(cuda_device, n,
                                                 frames_per_row):
    """K1 on the card against its plain version at fft lengths 1024, 2048
    and 4096, at a length that is no multiple of 4 (single-element stores)
    and with one frame per utterance, into memory that held NaN before:
    every element is written, and none differs by more than 1e-6."""
    sig, pm, nfrms, n_sig, voi = _frames_inputs(15)
    Fr = frames_per_row
    d = cuda_device
    pm, voi = pm[:, :Fr].copy(), voi[:, :Fr].copy()
    nfrms = np.minimum(nfrms, Fr).astype(np.int32)
    t = [torch.from_numpy(a).to(d) for a in (sig, pm, nfrms, n_sig, voi)]
    _, L, R, _ = tframing.frame_geometry_batch(t[1], t[2], t[3])
    args = (t[0], t[1], L.to(torch.int32).contiguous(),
            R.to(torch.int32).contiguous(), t[4], t[2], t[3])
    kw = dict(fft_len=n, fam_voiced=VOI_NOISE, fam_unvoiced=HANNING)
    ref = K.frames_plain(*args, **kw)
    # the caching allocator hands the wrapper's torch.empty this block
    poison = torch.full((B, Fr, n), float("nan"), device=d)
    ptr = poison.data_ptr()
    del poison
    got = K.frames(*args, **kw)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr
    assert not bool(torch.isnan(got).any())
    assert float((got - ref).abs().max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("fams", FAMILIES)
def test_cuda_frames_kernel_row_cases_match_plain(cuda_device, fams):
    """K1 on the card on the rows of ``_ROW_CASES`` (boundaries inside
    quads and on their edges, no zero span, L = 0, rows on the general
    path, rows past nfrms) against its plain version: 1e-6."""
    arrs = _row_case_inputs(16)
    t = [torch.from_numpy(a).to(cuda_device) for a in arrs]
    kw = dict(fft_len=N, fam_voiced=fams[0], fam_unvoiced=fams[1])
    got = K.frames(*t, **kw)
    ref = K.frames_plain(*t, **kw)
    torch.cuda.synchronize()
    assert float((got - ref).abs().max()) <= 1e-6


# ---------------------------------------------------------------------------
# numpy models of the index schemes that csrc/walk.cu and csrc/framing.cu
# run on the card, held against the plain versions here on the CPU

def _order_key(v):
    """The walk kernel's order-preserving map of float32 to uint32: -0
    folded to +0, then the bits inverted where the sign is set, else the
    sign bit set."""
    u = np.asarray(v, np.float32).view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0
    neg = (u & np.uint32(0x80000000)) != 0
    return np.where(neg, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def test_walk_order_key_orders_as_float_compare():
    """key(a) < key(b) iff a < b and key(a) == key(b) iff a == b, for every
    pair of non-NaN float32 values, -0 and +0 and the infinities included."""
    rng = np.random.default_rng(11)
    v = np.concatenate([
        rng.standard_normal(200).astype(np.float32),
        rng.integers(0, 2 ** 32, 200, dtype=np.uint64).astype(np.uint32)
        .view(np.float32),
        np.asarray([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45], np.float32)])
    v = v[~np.isnan(v)]
    k = _order_key(v)
    np.testing.assert_array_equal(k[:, None] < k[None, :],
                                  v[:, None] < v[None, :])
    np.testing.assert_array_equal(k[:, None] == k[None, :],
                                  v[:, None] == v[None, :])
    assert _order_key(np.float32(np.inf)) == 0xff800000


def _walk_model(y, f0, voiced, n_sig, n_frames, *, fs, m_max, frame_step,
                snap_w, eager):
    """One utterance as csrc/walk.cu walks it: the per-frame table of
    window offsets, the frame index by multiply-high where the host found
    that exact, the ring (position mod ring length) with its chunks,
    refill threshold and ready numbers, the searched span only, and the
    minimum as least key, then least position among the lanes holding it.
    ``eager`` fills every chunk as soon as the threshold allows (the
    producers far ahead: a chunk overwritten too early shows as a wrong
    position in the slot); otherwise a chunk is filled only when the
    walker waits for it (the producers as late as can be: a chunk the
    threshold does not allow yet would hang the kernel, and asserts here).
    Returns (marks, flags, n_marks, stats)."""
    f32 = np.float32
    c = K4.walk_constants(fs, frame_step)
    g = K4.ring_geometry(fs)
    ring_n, chunk, reach = g["ring"], g["chunk"], g["reach"]
    mask, slots = ring_n - 1, ring_n // chunk
    S, T = len(y), len(f0)
    n_sig, n_frames = int(n_sig), int(n_frames)

    is_voi_t = (voiced > 0) & (f0 > 0)
    period = np.where(is_voi_t, c["fs"] / np.maximum(f0, f32(1.0)),
                      f32(c["unv_step"])).astype(f32)
    period = np.minimum(period, c["p_max"])
    tab = {k: np.floor(c[k] * period).astype(np.int64)
           for k in ("lo_wide", "hi_wide", "lo_run", "hi_run")}
    assert all(int(v.max()) < 2 ** 15 for v in tab.values())

    ring = np.full(ring_n, np.nan, f32)
    ring_pos = np.full(ring_n, -1, np.int64)
    ready = np.zeros(slots, np.int64)
    filled = set()
    lim = min(S, max(n_sig, 0))
    state = dict(s_t=0)

    def fill(ch):
        assert ch * chunk < lim and ch not in filled
        # the first chunks of the three producers go into the empty ring;
        # later ones wait for the walker's published position
        assert ch < 3 or (ch + 1) * chunk - ring_n <= state["s_t"], \
            "the walker waits for a chunk that may not be filled yet"
        pos = np.arange(ch * chunk, min((ch + 1) * chunk, lim))
        ring[pos & mask] = y[pos]
        ring_pos[pos & mask] = pos
        ready[ch % slots] = ch + 1
        filled.add(ch)

    def fill_allowed():
        ch = 0
        while ch * chunk < lim:
            if ch not in filled and (
                    ch < 3 or (ch + 1) * chunk - ring_n <= state["s_t"]):
                fill(ch)
            ch += 1

    marks = np.zeros(m_max, np.int32)
    flags = np.zeros(m_max, f32)
    stats = dict(empty=0, ties=0, clamped=0, max_reach=0, waits=0)
    fr_max = min(max(n_frames - 1, 0), T - 1)
    divider = K4.frame_divider(frame_step, S)
    t, nm, run_len, prev, ready_upto = 0, 0, 0, -1, 0
    if eager:
        fill_allowed()
    while True:
        if divider:
            fr = (t * divider[0]) >> (32 + divider[1])
        else:
            fr = max(int(f32(t) / c["frame_step"]), 0)
        fr = min(fr, fr_max)
        is_voi = bool(is_voi_t[fr])
        wide = run_len < c["onset_marks"]
        p_lo = int(tab["lo_wide" if wide else "lo_run"][fr])
        p_hi = int(tab["hi_wide" if wide else "hi_run"][fr])
        lo = t + p_lo
        hi = min(n_sig - 1, t + p_hi)
        if is_voi:
            lo_slice = min(lo, S - snap_w)
            hi_read = min(hi, lo_slice + snap_w)
            stats["clamped"] += lo_slice < lo
            if hi_read > lo:
                ready_upto = max(ready_upto, lo & ~(chunk - 1))
                while hi_read > ready_upto:
                    ch = ready_upto // chunk
                    if ready[ch % slots] != ch + 1:
                        stats["waits"] += 1
                        fill(ch)
                    ready_upto += chunk
            else:
                stats["empty"] += 1
            best = np.full(32, np.inf, f32)
            best_pos = np.full(32, lo_slice, np.int64)
            for pos in range(lo, hi_read):
                assert t <= pos < t + reach, "a read outside [t, t + reach)"
                assert ring_pos[pos & mask] == pos, "a stale ring slot"
                lane = (pos - lo) % 32
                v = ring[pos & mask]
                if v < best[lane]:
                    best[lane], best_pos[lane] = v, pos
            stats["max_reach"] = max(stats["max_reach"], hi_read - t)
            key = _order_key(best)
            holders = best_pos[key == key.min()]
            stats["ties"] += len(holders) > 1 and hi_read > lo
            nxt = int(holders.min())
        else:
            nxt = t + c["unv_step"]
        min_adv = max(1, p_lo) if is_voi else 1
        if nxt <= prev:
            nxt = prev + min_adv
        if not (nxt < n_sig - 1 and hi > lo + 1 and nm < m_max):
            break
        marks[nm], flags[nm] = nxt, f32(is_voi)
        nm += 1
        prev = t = nxt
        state["s_t"] = nxt
        run_len = run_len + 1 if is_voi else 0
        if eager:
            fill_allowed()
    return marks, flags, nm, stats


def _synthetic_walk_case(name):
    """(y, f0, voiced, n_sigs, n_frames) at 48 kHz, S = 32768 (twice the
    ring), voiced throughout, and the event the case must show."""
    rng = np.random.default_rng(12)
    S, T, fs = 32768, 160, 48000
    f0 = np.full((2, T), 120.0, np.float32)
    f0[1] = np.linspace(60.0, 390.0, T)
    voiced = np.ones((2, T), np.float32)
    y = rng.standard_normal((2, S)).astype(np.float32)
    n_sigs = np.asarray([S - 3000, S - 5000], np.int32)
    if name == "ties":
        # three levels and zeros of both signs: most windows tie
        y = np.round(y).clip(-1, 1)
        y[0] = np.where(y[0] < 0, np.float32(-0.0), np.abs(y[0]))
        y[0, ::7] = 0.0
        event = "ties"
    elif name == "empty_span":
        # the last window starts at or beyond n_sig - 1
        n_sigs = np.asarray([20000, 9001], np.int32)
        y[:, ::3] -= 4.0
        event = "empty"
    else:                                   # "n_sig_near_S"
        n_sigs = np.asarray([S, S - 1], np.int32)
        event = "clamped"
    n_frames = np.minimum(n_sigs // 240 + 1, T).astype(np.int32)
    return (y, f0, voiced, n_sigs, n_frames), fs, event


@pytest.mark.parametrize("eager", [False, True], ids=["late", "ahead"])
@pytest.mark.parametrize("case", ["voiced_unvoiced", "noise_and_silence",
                                  "capacity_hit", "16k", "ties", "empty_span",
                                  "n_sig_near_S"])
def test_walk_ring_model_matches_plain(case, eager):
    """The walk as the CUDA kernel schedules it (``_walk_model``) gives
    walk_plain's marks, flags and n_marks bit for bit, with the producers
    as late and as far ahead as the protocol lets them be; no read leaves
    [t, t + reach), no slot is read stale, and the walker never waits for a
    chunk that the refill threshold forbids."""
    event = None
    if case in _walk_cases():
        signals, fs, m_cap = _walk_cases()[case]
        arrs, m_max = _walk_inputs(signals, fs)
        m_max = m_cap or m_max
    else:
        arrs, fs, event = _synthetic_walk_case(case)
        m_max = tpd.placement_m_max(arrs[0].shape[1], fs)
    kw = dict(fs=fs, m_max=m_max, frame_step=tpd._walk_frame_step(fs),
              snap_w=tpd._snap_win(fs))
    ref = [r.numpy() for r in K4.walk_plain(
        *(torch.from_numpy(np.array(a)) for a in arrs), **kw)]
    seen = dict(empty=0, ties=0, clamped=0, max_reach=0, waits=0)
    for b in range(arrs[0].shape[0]):
        marks, flags, nm, stats = _walk_model(*(a[b] for a in arrs), **kw,
                                              eager=eager)
        assert nm == ref[2][b]
        np.testing.assert_array_equal(marks, ref[0][b])
        np.testing.assert_array_equal(flags, ref[1][b])
        for k, v in stats.items():
            seen[k] = max(seen[k], v)
    assert seen["max_reach"] <= K4.ring_geometry(fs)["reach"]
    assert seen["waits"] == 0 if eager else seen["waits"] > 0 or \
        case == "noise_and_silence"
    if event:
        assert seen[event] > 0, f"the case shows no {event} event"


@pytest.mark.parametrize("S,offset", [(768, 0), (768, 1), (769, 0),
                                      (770, 2), (771, 4)])
def test_walk_aligned_rows_keeps_or_copies(S, offset):
    """The rows the walk kernel copies 16 bytes at a time: the batch itself
    where its rows start 16-byte aligned a multiple of 4 samples apart,
    else a copy that is so, with the same first S columns and zeros
    behind them."""
    rng = np.random.default_rng(18)
    buf = torch.from_numpy(rng.standard_normal(3 * S + 8).astype(np.float32))
    # torch's CPU buffers start 64-byte aligned
    assert buf.data_ptr() % 16 == 0
    y = buf[offset:offset + 3 * S].view(3, S)
    rows = K4.aligned_rows(y)
    assert rows.data_ptr() % 16 == 0 and rows.shape[1] % 4 == 0
    assert rows.shape[1] - S in range(4) and rows.is_contiguous()
    assert torch.equal(rows[:, :S], y)
    assert not bool(rows[:, S:].any())
    assert (rows is y) == (S % 4 == 0 and offset % 4 == 0)


@pytest.mark.parametrize("fs", [8000, 16000, 22050, 44100, 48000, 96000])
def test_walk_ring_holds_a_window_and_a_chunk(fs):
    """The ring is a power of two, a whole number of chunks the kernel has
    ready slots for, holds the producers' first three chunks, and leaves
    room for the chunk under the far end of any window to be filled while
    the walker stands at t: reach + chunk <= ring."""
    g = K4.ring_geometry(fs)
    assert g["ring"] & (g["ring"] - 1) == 0
    assert 4 * g["chunk"] <= g["ring"] <= K4.MAX_CHUNKS * g["chunk"]
    assert g["reach"] + g["chunk"] <= g["ring"]
    assert g["reach"] >= tpd._snap_win(fs) - 128


@pytest.mark.parametrize("step", [2, 3, 80, 160, 222, 240, 441, 480, 4096,
                                  99991])
def test_walk_frame_divider_is_the_float32_division(step):
    """The kernel's multiply-high frame index equals the truncated float32
    quotient, as numpy and the plain walk divide, for every position up to
    the largest S the divider accepts; and the divider refuses a step that
    is no integer, a step below 2 and rows too long for the argument."""
    S_top = 2 ** 24 - step - 1
    magic, shift = K4.frame_divider(float(step), S_top)
    assert 0 < magic < 2 ** 32 and 0 <= shift < 32
    t = np.arange(S_top + 1, dtype=np.uint64)
    got = (t * np.uint64(magic)) >> np.uint64(32 + shift)
    ref = (t.astype(np.float32) / np.float32(step)).astype(np.int64)
    np.testing.assert_array_equal(got.astype(np.int64), ref)
    assert K4.frame_divider(float(step), S_top + 1) is None
    assert K4.frame_divider(step + 0.5, 1000) is None
    assert K4.frame_divider(1.0, 1000) is None


# K1's row split: rows of (L, R) that put the boundaries of the right
# half, the zero span and the left half inside quads, on quad edges, make
# the zero span empty, or leave the kernel's fast path
_ROW_CASES = {
    "typical": (100, 130), "L0": (0, 50), "R0": (100, 0), "L0_R0": (0, 0),
    "straddle": (101, 6), "on_quad_edges": (128, 127),
    "no_zero_span": (300, 300), "exactly_full": (255, 256),
    "L_is_N_minus_1": (511, 3), "L_is_N": (512, 10), "L_negative": (-3, 40),
    "R_negative": (40, -2),
}


def _row_case_inputs(seed):
    """(sig, pm, L, R, voi, nfrms, n_sig) for two utterances whose frames
    are the rows of ``_ROW_CASES`` and two ordinary rows, which lie past
    nfrms in the first utterance; the second signal ends early."""
    rng = np.random.default_rng(seed)
    rows = list(_ROW_CASES.values())
    Fr = len(rows) + 2
    L = np.full((2, Fr), 90, np.int32)
    R = np.full((2, Fr), 80, np.int32)
    L[:, :len(rows)] = [r[0] for r in rows]
    R[:, :len(rows)] = [r[1] for r in rows]
    return (rng.standard_normal((2, S)).astype(np.float32),
            np.stack([np.linspace(40, S - 200, Fr),
                      np.linspace(5, 3000, Fr)]).astype(np.int32), L, R,
            (rng.random((2, Fr)) > 0.5).astype(np.float32),
            np.asarray([len(rows), Fr], np.int32),
            np.asarray([S, 2500], np.int32))


def _frames_row_model(sig_row, pm, L, R, ns, n, fam, live):
    """One output row as csrc/framing.cu writes it: quads when n % 4 == 0
    (a quad wholly in the zero span or in a dead row stored as zeros with no
    arithmetic), single elements else; q by one conditional subtraction on
    the fast path, by the double modulo on the general one.  Returns the
    row and the number of elements it did arithmetic for."""
    wraps_once = live and 0 <= L < n and R >= 0
    p = np.arange(n)
    computed = np.full(n, live)
    if n % 4 == 0 and live and wraps_once:
        p0 = p - p % 4
        computed = ~((p0 > R) & (p0 + 3 < n - L))
    if wraps_once:
        q = p + L
        q = np.where(q >= n, q - n, q)
        assert np.all((0 <= q) & (q < n))
    else:
        q = ((p + L) % n + n) % n
    in_frame = computed & (q < L + R + 1)
    idx = np.minimum(np.maximum(pm - L + q, 0), ns - 1)
    win = tW.asym_win_value(torch.from_numpy(q), torch.tensor(L),
                            torch.tensor(R), fam).numpy()
    row = np.where(in_frame, sig_row[idx] * win, np.float32(0.0))
    return row.astype(np.float32), int(computed.sum())


@pytest.mark.parametrize("n", [512, 510])
@pytest.mark.parametrize("fams", FAMILIES)
def test_frames_row_split_model_matches_plain(fams, n):
    """The row split of the CUDA K1 (``_frames_row_model``) is bitwise
    frames_plain for every row case and window family, for quads
    (n % 4 == 0) and single elements, with a row past nfrms; and the fast
    path does arithmetic for no more than the frame's support rounded out
    to quads."""
    arrs = _row_case_inputs(13)
    sig, pm, L, R, voi, nfrms, n_sig = arrs
    Fr = L.shape[1]
    ref = K.frames_plain(*(torch.from_numpy(a) for a in arrs), fft_len=n,
                         fam_voiced=fams[0], fam_unvoiced=fams[1]).numpy()
    for b in range(2):
        for f in range(Fr):
            live = f < nfrms[b]
            fam = fams[0] if voi[b, f] > 0 else fams[1]
            row, n_comp = _frames_row_model(
                sig[b], int(pm[b, f]), int(L[b, f]), int(R[b, f]),
                min(int(n_sig[b]), S), n, fam, live)
            np.testing.assert_array_equal(row, ref[b, f], err_msg=f"{b},{f}")
            lf, rf = int(L[b, f]), int(R[b, f])
            if not live:
                assert not row.any()
            elif n % 4 == 0 and 0 <= lf < n and rf >= 0:
                assert n_comp <= min(n, lf + rf + 1 + 2 * 3)


# ---------------------------------------------------------------------------
# K2 / K3 on the card: the tiled gather of csrc/framing.cu (ola_kernel) as a
# numpy model, and the same edge cases kernel against plain on the card

def _ola_kernel_constants():
    """The tiling constants of csrc/framing.cu: (warps, samples per lane,
    frames per shared chunk, frames loaded together); a warp's segment is
    32 samples per lane, a block's tile the warps' segments."""
    src = K.SOURCE.read_text()
    c = dict(re.findall(r"constexpr int (kOla\w+) = ([^;]+);", src))
    assert c["kOlaSeg"] == "32 * kOlaSpan"
    assert c["kOlaTile"] == "kOlaWarps * kOlaSeg"
    return tuple(int(c[k]) for k in ("kOlaWarps", "kOlaSpan", "kOlaChunk",
                                     "kOlaUnroll"))


def _warp_first_above(st, n, x):
    """warp_first_above: the first f in [0, n) with st[f] > x (n if none),
    by 32 evenly spaced probes a step, counted as the kernel's ballot."""
    lo, hi, steps = 0, max(n, 0), 0
    while lo < hi:
        step = (hi - lo + 31) // 32
        idx = lo + np.arange(32) * step
        probed = idx < hi
        c = int(np.sum(probed & (st[np.where(probed, idx, 0)] <= x)))
        if c == 0:
            hi = lo
        else:
            hi = min(lo + c * step, hi)
            lo += (c - 1) * step + 1
        steps += 1
    return lo, steps


def _ola_tile_model(frames, starts, nfrms, out_len):
    """K2 as csrc/framing.cu computes it: one block per (tile, b) finds the
    tile's run by two warp searches and stages it in chunks; each warp
    walks the chunk's frames that meet its segment, kUnroll at a time, and
    adds every element in frame order, +0.0f where it lies outside the
    frame or past out_len.  Returns the output and the most search steps."""
    warps, span, chunk, unroll = _ola_kernel_constants()
    seg = 32 * span
    tile = warps * seg
    B, F, N = frames.shape
    out = np.zeros((B, out_len), np.float32)
    zero = np.float32(0.0)
    max_steps = 0
    for b in range(B):
        nf = min(int(nfrms[b]), F)
        st = starts[b].astype(np.int64)
        for tile_lo in range(0, out_len, tile):
            f_lo, s0 = _warp_first_above(st, nf, tile_lo - N)
            f_hi, s1 = _warp_first_above(st, nf, tile_lo + tile - 1)
            max_steps = max(max_steps, s0, s1)
            for w in range(warps):
                o = tile_lo + w * seg + np.arange(seg)
                acc = np.zeros(seg, np.float32)
                for c in range(f_lo, f_hi, chunk):
                    s_st = st[c:c + min(chunk, f_hi - c)]
                    meets = np.flatnonzero((s_st + N > o[0])
                                           & (s_st < o[0] + seg))
                    if len(meets) == 0:
                        continue
                    j1 = meets[-1]
                    for j in range(meets[0], j1 + 1, unroll):
                        vals = []
                        for u in range(unroll):
                            live = j + u <= j1
                            p = o - (s_st[j + u] if live else 0)
                            ok = live & (p >= 0) & (p < N) & (o < out_len)
                            f = min(c + j + u, F - 1)
                            vals.append(np.where(
                                ok, frames[b, f, np.clip(p, 0, N - 1)], zero))
                        for v in vals:                 # loads, then adds
                            acc = (acc + v).astype(np.float32)
                keep = o < out_len
                out[b, o[keep]] = acc[keep]
    return out, max_steps


def _ola_case(name):
    """(frames, starts, nfrms, wl, wr, out_len) of one edge case."""
    rng = np.random.default_rng(sorted(_OLA_CASES).index(name) + 40)
    Bc, Fc, Nc, out_len = _OLA_CASES[name]
    shifts = rng.integers(40, 140, (Bc, Fc))
    starts = np.cumsum(shifts, axis=1) - Nc // 2
    nfrms = np.full(Bc, Fc)
    frames = rng.standard_normal((Bc, Fc, Nc)).astype(np.float32)
    if name == "nfrms_0":
        nfrms[0] = 0
    elif name == "nfrms_above_F":
        nfrms[:] = Fc + 7
    elif name == "negative_starts":
        starts -= 900
    elif name == "starts_past_O":
        starts[1] += out_len - starts[1, Fc // 2]
    elif name == "equal_runs":
        # runs of one start longer than a shared chunk, one of them across
        # a tile edge, and a short one
        starts = np.sort(np.concatenate([
            np.full(150, 700), np.full(90, 2040),
            np.full(3, 2500), rng.integers(0, 4000, Fc - 243)]))[None, :]
    elif name == "neg_zero_nan":
        frames[0, :, ::3] = -0.0
        frames[0, 5, 17] = np.nan
        frames[1, 2, 100:110] = np.inf
        frames[1, 3, 100:110] = -0.0
        nfrms[1] = 5
    wl = rng.integers(0, Nc // 2 + 40, (Bc, Fc))
    wr = rng.integers(0, Nc // 2 + 40, (Bc, Fc))
    wl[:, ::7] = 0
    i32 = np.int32
    return (frames, starts.astype(i32), nfrms.astype(i32), wl.astype(i32),
            wr.astype(i32), out_len)


# name -> (B, F, N, out_len)
_OLA_CASES = {
    "typical": (3, 96, 512, 5000), "nfrms_0": (2, 40, 256, 3000),
    "nfrms_above_F": (2, 40, 256, 3000), "negative_starts": (2, 40, 512, 3000),
    "starts_past_O": (2, 60, 256, 2100), "equal_runs": (1, 260, 128, 4100),
    "O_below_N": (2, 12, 512, 300), "F_1": (2, 1, 512, 2048),
    "neg_zero_nan": (2, 30, 256, 2500),
}


def _bits(x):
    """float32 bit patterns, every NaN as the one quiet NaN."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return np.where(np.isnan(x), np.uint32(0x7FC00000), b)


@pytest.mark.parametrize("case", sorted(_OLA_CASES))
def test_ola_tile_model_matches_plain(case):
    """The tiled gather of the CUDA K2 (``_ola_tile_model``) is bitwise
    ola_plain, -0.0 and NaN included, on every edge case; its run search
    takes at most two warp steps a block for F <= 1024."""
    frames, starts, nfrms, _, _, out_len = _ola_case(case)
    ref = K.ola_plain(*(torch.from_numpy(a) for a in (frames, starts,
                                                      nfrms)),
                      out_len=out_len).numpy()
    got, steps = _ola_tile_model(frames, starts, nfrms, out_len)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert steps <= 2
    if case == "neg_zero_nan":
        assert np.isnan(ref).any() and not np.signbit(ref[ref == 0]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_OLA_CASES))
def test_cuda_ola_kernels_edge_cases_match_plain(cuda_device, case):
    """The same edge cases on the card: K2 bitwise its plain version (NaN
    as NaN), K3 within 1e-6 of its plain version."""
    frames, starts, nfrms, wl, wr, out_len = _ola_case(case)
    fr, st, nf, wl_, wr_ = (torch.from_numpy(a).to(cuda_device)
                            for a in (frames, starts, nfrms, wl, wr))
    got = K.ola(fr, st, nf, out_len=out_len)
    ref = K.ola_plain(fr, st, nf, out_len=out_len)
    np.testing.assert_array_equal(_bits(got.cpu().numpy()),
                                  _bits(ref.cpu().numpy()))
    got = K.ola_anti_ring(fr, st, nf, wl_, wr_, out_len=out_len).cpu()
    ref = K.ola_anti_ring_plain(fr, st, nf, wl_, wr_, out_len=out_len).cpu()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-6,
                               equal_nan=True)
