"""HTS label-alignment utilities for the Merlin TTS workflow (numpy copy
of magphase_tpu/io/labels.py).

References:
  get_num_of_frms_per_state      magphase.py:2111-2150
  get_num_of_frms_per_phon_unit  magphase.py:2158-2194
  frame_to_state_mapping / 2     magphase.py:2080-2097, 2049-2076
  convert_label_state_align_to_var_frame_rate  libaudio.py:687-708

Label times are in HTK 100 ns units (divide by 1e4 -> ms).
"""
from __future__ import annotations

import numpy as np


def load_state_times(lab_file: str) -> np.ndarray:
    """(n_states, 2) start/end times in 100 ns units (first two columns)."""
    return np.loadtxt(lab_file, usecols=(0, 1))


def get_num_of_frms_per_state(v_shift, lab_state_align_file: str, fs: int,
                              b_prevent_zeros: bool = False,
                              n_states_x_phone: int = 5,
                              nfrms_tolerance: int = 6) -> np.ndarray:
    """Count pitch-synchronous frames whose epoch falls inside each HTS
    state interval (magphase.py:2111-2150)."""
    m_labs_ms = load_state_times(lab_state_align_file) / 10000.0
    v_ep_ms = np.cumsum(np.asarray(v_shift, np.float64)) * 1000.0 / fs

    n_states = m_labs_ms.shape[0]
    # vectorised interval counting (the reference loops over states)
    inside = (m_labs_ms[:, 0][:, None] <= v_ep_ms[None, :]) & \
             (v_ep_ms[None, :] < m_labs_ms[:, 1][:, None])
    v_nfrms = inside.sum(axis=1).astype(np.float64)

    nfrms_diff = len(v_ep_ms) - v_nfrms.sum()
    if 0 < nfrms_diff <= nfrms_tolerance:
        v_nfrms[-1] += nfrms_diff
    if v_nfrms.sum() != len(v_ep_ms):
        raise ValueError("Total number of frames is different to the number "
                         "of frames of the shifts.")
    m_ph = v_nfrms.reshape(n_states // n_states_x_phone, n_states_x_phone)
    if np.any(m_ph.sum(axis=1) == 0.0):
        raise ValueError("There is some phoneme(s) that do(es) not contain "
                         "any frame.")
    if b_prevent_zeros:
        v_nfrms[v_nfrms == 0] = 1
    return v_nfrms


def get_num_of_frms_per_phon_unit(v_shift, in_lab_aligned_file: str, fs: int,
                                  n_lines_x_unit: int = 5,
                                  nfrms_tolerance: int = 1) -> np.ndarray:
    """Per-phone frame counts (magphase.py:2158-2194)."""
    m_labs_ms = load_state_times(in_lab_aligned_file) / 10000.0
    v_ep_ms = np.cumsum(np.asarray(v_shift, np.float64)) * 1000.0 / fs

    n_states = m_labs_ms.shape[0]
    inside = (m_labs_ms[:, 0][:, None] <= v_ep_ms[None, :]) & \
             (v_ep_ms[None, :] < m_labs_ms[:, 1][:, None])
    v_nfrms = inside.sum(axis=1).astype(np.float64)

    nfrms_diff = len(v_ep_ms) - v_nfrms.sum()
    if 0 < nfrms_diff <= nfrms_tolerance:
        v_nfrms[-1] += nfrms_diff
    if v_nfrms.sum() != len(v_ep_ms):
        raise ValueError("Total number of frames is different to the number "
                         "of frames of the shifts.")
    m_ph = v_nfrms.reshape(n_states // n_lines_x_unit, n_lines_x_unit)
    v_ph = m_ph.sum(axis=1)
    if np.any(v_ph == 0.0):
        raise ValueError("There is some phoneme(s) that do(es) not contain "
                         "any frame.")
    return v_ph


def frame_to_state_mapping(shift_file: str, lab_file: str, fs: int,
                           states_per_phone: int = 5,
                           b_refine: bool = False) -> np.ndarray:
    """Map each pitch-sync frame to its state index within the phone
    (magphase.py:2080-2097; b_refine adds the fractional position as in
    frame_to_state_mapping2, magphase.py:2049-2076)."""
    from .featfile import read_binfile
    v_shift = read_binfile(shift_file, dim=1)
    v_pm_ms = 1000.0 * np.cumsum(v_shift) / fs
    m_state_ms = load_state_times(lab_file) / 10000.0

    nfrms = len(v_pm_ms)
    v_st = np.zeros(nfrms)
    for f in range(nfrms):
        nx = np.where(v_pm_ms[f] >= m_state_ms[:, 0])[0][-1]
        v_st[f] = nx % states_per_phone
        if b_refine:
            ln = m_state_ms[nx, 1] - m_state_ms[nx, 0]
            v_st[f] += (v_pm_ms[f] - m_state_ms[nx, 0]) / ln
    if b_refine:
        np.clip(v_st, 0, states_per_phone, out=v_st)
    return v_st


def convert_label_state_align_to_var_frame_rate(in_lab_st_file: str,
                                                v_dur_state,
                                                out_lab_st_file: str) -> None:
    """Rewrite HTS state-aligned label times so each state spans
    nfrms x 5 ms (libaudio.py:687-708)."""
    shift_ms = 5.0
    labels = []
    with open(in_lab_st_file) as f:
        for line in f:
            parts = line.split(" ")
            if len(parts) >= 3:
                labels.append(parts[2].rstrip("\n"))
    v_dur_ns = np.asarray(v_dur_state, np.float64) * shift_ms * 10000
    v_cum = np.cumsum(np.hstack((0, v_dur_ns))).astype(np.int64)
    with open(out_lab_st_file, "w") as f:
        for i, lab in enumerate(labels):
            f.write("%d %d %s\n" % (v_cum[i], v_cum[i + 1], lab))
