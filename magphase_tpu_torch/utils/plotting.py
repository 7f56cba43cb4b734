"""Debug plotting helpers (copy of magphase_tpu/utils/plotting.py;
libplot.py parity).

The reference ships ``libplot.py`` — a thin matplotlib wrapper adding
``lp.plotm`` (feature-matrix heatmap, libplot.py:16-21) and
``lp.plot_pitch_marks`` (signal + epoch overlay, libplot.py:24-30).
Matplotlib is imported lazily with the Agg backend so the package never
requires a display (the reference hard-codes Qt4Agg, libplot.py:4-6), nor
matplotlib itself until a plot is asked for: where it is not installed, a
plot raises ImportError saying so.
"""
from __future__ import annotations

import numpy as np


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("magphase_tpu_torch.utils.plotting needs "
                          "matplotlib, which is not installed") from e
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


def plotm(m_data, aspect: str = "auto", out_file: str | None = None):
    """Feature-matrix heatmap, frames on x (libplot.py:16-21: imshow of the
    transposed matrix, origin at the bottom)."""
    plt = _plt()
    fig, ax = plt.subplots()
    im = ax.imshow(np.asarray(m_data).T, aspect=aspect, origin="lower",
                   interpolation="nearest", cmap="viridis")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel("frame")
    ax.set_ylabel("bin")
    if out_file:
        fig.savefig(out_file, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_file
    return fig


def plot_pitch_marks(v_sig, v_pm_smpls, out_file: str | None = None):
    """Waveform with epoch positions overlaid (libplot.py:24-30)."""
    plt = _plt()
    v_sig = np.asarray(v_sig)
    v_pm = np.asarray(v_pm_smpls).astype(int)
    v_pm = v_pm[(v_pm >= 0) & (v_pm < len(v_sig))]
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.plot(v_sig, linewidth=0.6)
    ax.plot(v_pm, v_sig[v_pm], "rx", markersize=4)
    ax.set_xlabel("sample")
    if out_file:
        fig.savefig(out_file, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return out_file
    return fig
