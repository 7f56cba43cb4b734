"""EST pitch-mark (epoch) file I/O — REAPER ``.est`` format.

The reference parses REAPER output with ``la.read_reaper_est_file``
(the reference's src/libaudio.py:421-447), including two workarounds for
REAPER bugs: dropping non-monotonic pitch marks and clipping marks past the
end of the signal.  We reproduce those exactly, and add a writer so the
built-in epoch tracker can emit interchangeable files (numpy-only copy of
magphase_tpu/io/est.py).
"""
from __future__ import annotations

import numpy as np


def read_est_file(est_file: str) -> np.ndarray:
    """Read the first two columns of a generic EST file
    (libaudio.py:402-416)."""
    header_size = 1
    with open(est_file) as fid:
        for line in fid:
            if line == "EST_Header_End\n":
                break
            header_size += 1
    return np.loadtxt(est_file, skiprows=header_size, usecols=[0, 1])


def read_reaper_est_file(est_file: str, check_len_smpls: int = -1,
                         fs: int = -1, skiprows: int = 7,
                         usecols=(0, 1)) -> tuple[np.ndarray, np.ndarray]:
    """Parse a REAPER .est file -> (pitch-mark times [s], voicing flags).

    Mirrors libaudio.py:421-447 including the REAPER-bug guards.
    """
    if check_len_smpls > 0 and fs == -1:
        raise ValueError("If check_len_smpls given, fs must be provided as well.")

    m_data = np.loadtxt(est_file, skiprows=skiprows, usecols=usecols)
    m_data = np.atleast_2d(m_data)
    v_pm_sec = m_data[:, 0]
    v_voi = m_data[:, 1]

    # Guard 1: drop non-monotonic pitch marks.
    vb_correct = np.hstack((True, np.diff(v_pm_sec) > 0))
    v_pm_sec = v_pm_sec[vb_correct]
    v_voi = v_voi[vb_correct]

    # Guard 2: clip marks at/after the final sample.
    if check_len_smpls > 0:
        v_pm_smpls = np.round(v_pm_sec * fs).astype(int)
        if v_pm_smpls[-1] >= (check_len_smpls - 1):
            vb2 = v_pm_smpls < (check_len_smpls - 1)
            v_pm_sec = v_pm_sec[vb2]
            v_voi = v_voi[vb2]

    return v_pm_sec, v_voi


def write_reaper_est_file(est_file: str, v_pm_sec: np.ndarray,
                          v_voi: np.ndarray) -> None:
    """Write epochs in REAPER-compatible .est ASCII format (7 header lines)."""
    n = len(v_pm_sec)
    with open(est_file, "w") as f:
        f.write("EST_File Track\n")
        f.write("DataType ascii\n")
        f.write("NumFrames %d\n" % n)
        f.write("NumChannels 0\n")
        f.write("NumAuxChannels 0\n")
        f.write("EqualSpace 0\n")
        f.write("EST_Header_End\n")
        for t, v in zip(v_pm_sec, v_voi):
            f.write("%f %d %f\n" % (t, int(v), 1.0))
