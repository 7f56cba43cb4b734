"""The port's examples (magphase_tpu_torch/examples): the serving step
against the JAX example's, and the four demos on synthetic speech on the
CPU."""
import os
import runpy

import jax
import numpy as np
import pytest
import torch

from magphase_tpu_torch.examples import (compare_mags,
                                         demo_copy_synthesis_lossless,
                                         demo_copy_synthesis_low_dim,
                                         run_experiment, serving_on_device)
from magphase_tpu_torch.examples import _common
from magphase_tpu_torch.io import read_wav, write_binfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLE = os.path.join(REPO, "examples", "serving_on_device.py")
# PCM16 codes between the two serving steps: their float32 waveforms agree
# within 1e-5 of the peak (test_torch_slice.py), 0.33 codes after the 0.98
# peak normalisation, so rounding moves a sample by at most one code
TOL_PCM_CODES = 1


def test_serving_step_matches_jax():
    """params_from_jax carries the JAX example's weights across: at B=2,
    F=64, hidden=64 the port's tts_step gives the JAX step's lengths and
    its PCM16 within TOL_PCM_CODES, and meets that example test's asserts
    (tests/test_serving_example.py)."""
    ns = runpy.run_path(JAX_EXAMPLE)
    ns["B"], ns["F"] = 2, 64
    params = ns["init_acoustic_params"](jax.random.PRNGKey(0), hidden=64)
    ling = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                        (2, 64, ns["LING_DIM"])))
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(2), 2))
    ref, ref_lens = (np.asarray(x) for x in ns["build_tts_step"]()(
        params, ling, keys))

    model = serving_on_device.AcousticModel(hidden=64)
    model.load_state_dict(serving_on_device.params_from_jax(params))
    pcm, lens = serving_on_device.tts_step(
        model, torch.from_numpy(ling.copy()),
        torch.from_numpy(keys.astype(np.int64)),
        serving_on_device.synthesis_tables("cpu"))
    pcm, lens = pcm.numpy(), lens.numpy()
    np.testing.assert_array_equal(lens, ref_lens)
    assert pcm.dtype == np.int16 and pcm.shape == ref.shape
    assert np.abs(pcm.astype(np.int32) - ref).max() <= TOL_PCM_CODES
    for b in range(2):
        n = int(lens[b])
        assert n > 64 * 100
        x = pcm[b, :n].astype(np.float64) / 32768.0
        assert 0.5 < np.abs(x).max() <= 1.0
        assert np.std(x) > 1e-3
        assert np.all(pcm[b, n + 1:] == 0)


def test_serving_example_runs(tmp_path):
    serving_on_device.B, serving_on_device.F = 2, 32
    try:
        assert serving_on_device.main(["--device", "cpu", "--out-dir",
                                       str(tmp_path)]) == 0
    finally:
        serving_on_device.B, serving_on_device.F = 8, 256
    sig, fs = read_wav(str(tmp_path / "serving_demo.wav"))
    assert fs == 48000 and np.std(sig) > 1e-3


def test_lossless_demo_reconstructs(tmp_path):
    """The lossless demo on synthetic speech: p99 |syn - sig| < one PCM16
    step, and the wav written."""
    wav = _common.synthetic_wav(str(tmp_path), "syn", seed=1)
    sig, syn, fs = demo_copy_synthesis_lossless.copy_synthesis(
        wav, torch.device("cpu"))
    n = min(len(sig), len(syn))
    assert abs(len(sig) - len(syn)) < fs // 100
    assert np.percentile(np.abs(syn[:n] - sig[:n]), 99) < 2.0 ** -15
    assert demo_copy_synthesis_lossless.main(
        [wav, str(tmp_path), "--device", "cpu"]) == 0
    assert (tmp_path / "syn_copy_syn_lossless.wav").exists()


def test_low_dim_demo_runs(tmp_path):
    wav = _common.synthetic_wav(str(tmp_path), "syn")
    assert demo_copy_synthesis_low_dim.main([wav, str(tmp_path),
                                             "--device", "cpu"]) == 0
    out = tmp_path / "syn_copy_syn_low_dim_mag_dim_100_ph_dim_45_const_rate_0.wav"
    sig, fs = read_wav(str(out))
    assert fs == 48000 and np.all(np.isfinite(sig)) and np.std(sig) > 1e-3


def test_run_experiment_on_synthetic_speech(tmp_path, capsys):
    assert run_experiment.main(["--out-dir", str(tmp_path), "--limit", "1",
                                "--mag-dim", "20", "--phase-dim", "10",
                                "--device", "cpu"]) == 0
    assert "piecewise MSD" in capsys.readouterr().out
    sig, _ = read_wav(str(tmp_path / "synthetic_0.wav"))
    assert np.std(sig) > 1e-3


def test_compare_mags(tmp_path, capsys):
    rng = np.random.default_rng(0)
    a = np.exp(rng.standard_normal((30, 8))).astype(np.float32)
    write_binfile(a, str(tmp_path / "a.mag"))
    write_binfile(a * 1.1220185, str(tmp_path / "b.mag"))    # +1 dB
    args = [str(tmp_path / "a.mag"), str(tmp_path / "b.mag"), "--dim", "8",
            "--device", "cpu"]
    assert compare_mags.main(args) == 0
    out = capsys.readouterr().out
    assert "mean |diff|  :    1.000 dB" in out
    pytest.importorskip("matplotlib")
    assert compare_mags.main(args + ["--plot-dir", str(tmp_path / "p")]) == 0
    assert (tmp_path / "p" / "diff_db.png").exists()


def test_examples_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        _common.device("cuda")
    assert _common.device("cpu").type == "cpu"
