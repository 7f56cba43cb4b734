"""Kernel K5, the fused two-stage DFT (magphase_tpu_torch/kernels/dft.py),
against the JAX package's ``rfft_fused``/``irfft_fused``
(tools/dft_pallas.py, Pallas in interpret mode on the CPU) and numpy.

Bounds, those of the tool's own tests (tests/test_dft_pallas.py): the
forward within 1e-5 of the spectrum's peak, the inverse within 1e-6
absolute on unit-scale spectra.  Both implementations sum in float32 in
another order, so they agree to round-off, not bitwise; the constant
tables are carried across bit for bit.  The CUDA kernel against the plain
version runs where a card is present (marker ``cuda``).
"""
import importlib.util
import pathlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from magphase_tpu.core import matfft
from magphase_tpu_torch.kernels import dft as K5

_spec = importlib.util.spec_from_file_location(
    "dft_pallas", pathlib.Path(__file__).resolve().parents[1] / "tools"
    / "dft_pallas.py")
DP = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(DP)

TOL_FWD_REL = 1e-5          # of the spectrum's peak
TOL_INV_ABS = 1e-6


def _x(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize("n", [2048, 4096])
@pytest.mark.parametrize("inverse", [False, True])
def test_tables_are_the_tools_bitwise(n, inverse):
    """D1, TW^T and D2 equal the tool's _consts_128 bit for bit, and the
    fold weights equal core/matfft.py's hermitian_fold_weights."""
    for got, ref in zip(K5.dft_tables(n, inverse),
                        DP._consts_128(n, inverse)):
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(K5.hermitian_fold_weights(n),
                                  matfft.hermitian_fold_weights(n))


@pytest.mark.parametrize("n", [2048, 4096])
def test_rfft_plain_matches_pallas_and_numpy(n):
    """6 rows: the plain forward against rfft_fused in interpret mode and
    against np.fft.rfft, each within 1e-5 of the spectrum's peak."""
    x = _x(0, (6, n))
    re, im = (a.numpy() for a in K5.rfft_fused(torch.from_numpy(x), n))
    p_re, p_im = (np.asarray(a) for a in DP.rfft_fused(jnp.asarray(x), n))
    ref = np.fft.rfft(x)
    scale = np.abs(ref).max()
    assert re.shape == im.shape == (6, n // 2 + 1)
    for got, want in ((re, p_re), (im, p_im), (re, ref.real),
                      (im, ref.imag)):
        assert np.abs(got - want).max() / scale < TOL_FWD_REL


@pytest.mark.parametrize("n", [2048, 4096])
def test_irfft_plain_matches_pallas_and_numpy(n):
    """6 rows of unit-scale bins: the plain inverse against irfft_fused in
    interpret mode and against np.fft.irfft, within 1e-6 absolute."""
    h = n // 2 + 1
    zr, zi = _x(1, (6, h)), _x(2, (6, h))
    y = K5.irfft_fused(torch.from_numpy(zr), torch.from_numpy(zi), n).numpy()
    p_y = np.asarray(DP.irfft_fused(jnp.asarray(zr), jnp.asarray(zi), n))
    ref = np.fft.irfft(zr + 1j * zi, n=n)
    assert y.shape == (6, n)
    assert np.abs(y - p_y).max() < TOL_INV_ABS
    assert np.abs(y - ref).max() < TOL_INV_ABS


def test_lead_dims_and_round_trip():
    """A (2, 3, n) input keeps its leading dims both ways, the forward
    matches the tool there, and the round trip returns the input within
    1e-4 (the tool's own bound; measured 2.1e-6)."""
    n = 2048
    x = _x(2, (2, 3, n))
    re, im = K5.rfft_fused(torch.from_numpy(x), n)
    assert re.shape == im.shape == (2, 3, n // 2 + 1)
    p_re, p_im = DP.rfft_fused(jnp.asarray(x), n)
    scale = np.abs(np.asarray(p_re)).max()
    assert np.abs(re.numpy() - np.asarray(p_re)).max() / scale < TOL_FWD_REL
    assert np.abs(im.numpy() - np.asarray(p_im)).max() / scale < TOL_FWD_REL
    y = K5.irfft_fused(re, im, n)
    assert y.shape == x.shape
    assert np.abs(y.numpy() - x).max() < 1e-4


@pytest.mark.parametrize("n", [256, 1024, 8192])
def test_other_lengths_match_numpy(n):
    """Every power of two from 256 to N_MAX: forward and inverse against
    numpy, at the bounds above."""
    x = _x(3, (3, n))
    re, im = K5.rfft_fused(torch.from_numpy(x), n)
    ref = np.fft.rfft(x)
    scale = np.abs(ref).max()
    assert np.abs(re.numpy() - ref.real).max() / scale < TOL_FWD_REL
    assert np.abs(im.numpy() - ref.imag).max() / scale < TOL_FWD_REL
    h = n // 2 + 1
    zr, zi = _x(4, (3, h)), _x(5, (3, h))
    y = K5.irfft_fused(torch.from_numpy(zr), torch.from_numpy(zi), n)
    assert np.abs(y.numpy() - np.fft.irfft(zr + 1j * zi, n=n)).max() \
        < TOL_INV_ABS


def test_irfft_drops_the_imaginary_part_of_dc_and_nyquist():
    """As np.fft.irfft: Im of bin 0 and bin n/2 does not reach the output
    (the real-part-only form reads them as cos terms), bit for bit."""
    n = 2048
    h = n // 2 + 1
    zr, zi = _x(6, (4, h)), _x(7, (4, h))
    zi2 = zi.copy()
    zi2[:, 0] += 5.0
    zi2[:, -1] -= 3.0
    y = K5.irfft_fused(torch.from_numpy(zr), torch.from_numpy(zi), n)
    y2 = K5.irfft_fused(torch.from_numpy(zr), torch.from_numpy(zi2), n)
    assert torch.equal(y, y2)
    ref = np.fft.irfft(zr + 1j * zi2, n=n)
    assert np.abs(y2.numpy() - ref).max() < TOL_INV_ABS


@pytest.mark.parametrize("n", [100, 128, 3000, 16384, 2048.0, -256])
def test_lengths_outside_the_kernel_raise(n):
    """n must be a power of two from 256 to N_MAX (8192): anything else
    raises ValueError in both directions."""
    with pytest.raises(ValueError):
        K5.rfft_fused(torch.zeros(2, 256), n)
    with pytest.raises(ValueError):
        K5.irfft_fused(torch.zeros(2, 129), torch.zeros(2, 129), n)


def test_shape_mismatch_raises_and_cpu_launches_nothing():
    """A last dim other than n (forward) or n/2+1 (inverse) raises; CPU
    tensors take the plain version and launch nothing; a tensor on any
    device other than CPU or CUDA is refused."""
    K5.reset_launch_counts()
    with pytest.raises(ValueError):
        K5.rfft_fused(torch.zeros(2, 2048), 4096)
    with pytest.raises(ValueError):
        K5.irfft_fused(torch.zeros(2, 1025), torch.zeros(2, 1024), 2048)
    re, im = K5.rfft_fused(torch.zeros(2, 2048), 2048)
    K5.irfft_fused(re, im, 2048)
    assert K5.launch_counts() == {"rfft_fused": 0, "irfft_fused": 0}
    with pytest.raises(ValueError):
        K5.rfft_fused(torch.zeros(2, 2048, device="meta"), 2048)


# ---------------------------------------------------------------------------
# on the card: the kernel against its plain version

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192])
def test_cuda_dft_kernels_match_plain(cuda_device, n):
    """K5a within 1e-5 of the peak and K5b within 1e-6 absolute of their
    plain versions on the card, on 37 rows (an odd count) of unit-scale
    data; one launch each."""
    h = n // 2 + 1
    x = torch.from_numpy(_x(8, (37, n))).to(cuda_device)
    zr = torch.from_numpy(_x(9, (37, h))).to(cuda_device)
    zi = torch.from_numpy(_x(10, (37, h))).to(cuda_device)
    before = K5.launch_counts()
    re, im = K5.rfft_fused(x, n)
    y = K5.irfft_fused(zr, zi, n)
    p_re, p_im = K5.rfft_fused_plain(x, n)
    p_y = K5.irfft_fused_plain(zr, zi, n)
    torch.cuda.synchronize()
    after = K5.launch_counts()
    assert after == {k: v + 1 for k, v in before.items()}
    scale = float(torch.maximum(p_re.abs().max(), p_im.abs().max()))
    assert float((re - p_re).abs().max()) / scale < TOL_FWD_REL
    assert float((im - p_im).abs().max()) / scale < TOL_FWD_REL
    assert float((y - p_y).abs().max()) < TOL_INV_ABS
