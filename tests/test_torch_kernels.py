"""The port's kernels (K1 frames, K2 ola, K3 ola_anti_ring, K4 walk)
against the JAX package.

On the CPU the wrappers run their plain torch versions; these are compared
with the JAX XLA path and with the Pallas kernels in interpret mode.  The
CUDA kernels against the plain versions run where a card is present
(marker ``cuda``) and skip elsewhere.
"""
import functools

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
