"""The port's host utilities against the JAX package's: the tracker's
ground truth (utils/tracker_eval.py), futil, parallel_map and plotting
(numpy copies; bitwise)."""
import os

import numpy as np
import pytest

from magphase_tpu.utils import futil as jfutil
from magphase_tpu.utils import parallel_map as jpm
from magphase_tpu.utils import tracker_eval as jte
from magphase_tpu_torch.utils import futil as tfutil
from magphase_tpu_torch.utils import parallel_map as tpm
from magphase_tpu_torch.utils import plotting as tplot
from magphase_tpu_torch.utils import tracker_eval as tte

FS = 16000
SEGS = [(0.2, None, None), (0.4, 110, 170), (0.1, None, None),
        (0.3, 210, 140)]


@pytest.mark.parametrize("fs,seed", [(16000, 0), (48000, 3)])
def test_stimulus_and_degradations_match_jax(fs, seed):
    got = tte.make_stimulus(fs, SEGS, seed=seed)
    ref = jte.make_stimulus(fs, SEGS, seed=seed)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == ref[2]
    t = np.linspace(0, 1.0, 97)
    np.testing.assert_array_equal(got[3](t), ref[3](t))
    if fs != FS:
        return
    for kw in (dict(snr_db=10.0), dict(rt60_s=0.3), dict(snr_db=20.0,
                                                         rt60_s=0.2)):
        np.testing.assert_array_equal(
            tte.degrade_stimulus(got[0], fs, seed=seed, **kw),
            jte.degrade_stimulus(ref[0], fs, seed=seed, **kw))


def test_tracker_metrics_match_jax():
    """The metrics of a perturbed copy of the true marks (jitter, a
    dropped run, flipped voicing) are the JAX module's, bit for bit."""
    sig, gci, intervals, f0_at = tte.make_stimulus(FS, SEGS, seed=1)
    rng = np.random.default_rng(2)
    pm = np.sort(np.concatenate([gci + rng.normal(0, 2e-4, len(gci)),
                                 np.arange(0.0, 0.2, 0.005)]))
    pm = np.delete(pm, np.arange(40, 48))
    voi = tte._in_intervals(pm, intervals, guard=0.0)
    voi[rng.random(len(voi)) < 0.05] ^= True
    total = len(sig) / FS
    for tol in (0.2, 0.05):
        got = tte.tracker_metrics(pm, voi, gci, intervals, f0_at, total,
                                  gpe_tol=tol)
        ref = jte.tracker_metrics(pm, voi, gci, intervals, f0_at, total,
                                  gpe_tol=tol)
        assert got == ref


def test_futil_matches_jax(tmp_path):
    x = np.asarray([0.5, 1.5, 2.5, -0.5, 2.4999, 7.51])
    np.testing.assert_array_equal(tfutil.round_to_int(x),
                                  jfutil.round_to_int(x))
    np.testing.assert_array_equal(
        tfutil.indexes_to_one_zero_vector([1, 4.0, 7], 9),
        jfutil.indexes_to_one_zero_vector([1, 4.0, 7], 9))
    for p in ("/a/b/c.wav", "c.tar.gz", "dir/", "noext"):
        assert tfutil.fileparts(p) == jfutil.fileparts(p)
    assert tfutil.ins_pid("d/f.lab") == jfutil.ins_pid("d/f.lab")
    assert tfutil.ins_date_time("d/f.lab", "x").startswith("d/f_x_")
    assert tfutil.is_mutable([]) and not tfutil.is_mutable(())
    txt = tmp_path / "one.txt"
    txt.write_text("hello\n")
    np.testing.assert_array_equal(
        tfutil.read_text_file2(str(txt), dtype="string"),
        jfutil.read_text_file2(str(txt), dtype="string"))
    a, b = np.arange(5.0), np.arange(5.0)
    guard = tfutil.DimProtect(a, b)
    assert a.shape == b.shape == (5, 1)
    guard.end(a, b)
    assert a.shape == (5,)


def test_run_multithreaded_matches_jax():
    def f(a, b, c):
        return a * b + c
    for args in (([1, 2, 3], 10, [4, 5, 6]), (2, [1.5, 2.5], 0)):
        assert tpm.run_multithreaded(f, *args, n_workers=3) == \
            jpm.run_multithreaded(f, *args, n_workers=3)
    with pytest.raises(ValueError):
        tpm.run_multithreaded(f, 1, 2, 3)


def test_plotting_writes_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    m = np.random.default_rng(0).standard_normal((40, 12))
    out = tplot.plotm(m, out_file=str(tmp_path / "m.png"))
    sig = np.sin(np.arange(2000) / 20.0)
    out2 = tplot.plot_pitch_marks(sig, [100, 400, 1999, 2500],
                                  out_file=str(tmp_path / "pm.png"))
    for p in (out, out2):
        assert os.path.getsize(p) > 1000
