"""Kernel K5, the fused two-stage DFT (magphase_tpu_torch/kernels/dft.py),
against the JAX package's ``rfft_fused``/``irfft_fused``
(tools/dft_pallas.py, Pallas in interpret mode on the CPU) and numpy.

Bounds, those of the tool's own tests (tests/test_dft_pallas.py): the
forward within 1e-5 of the spectrum's peak, the inverse within 1e-6
absolute on unit-scale spectra.  Both implementations sum in float32 in
another order, so they agree to round-off, not bitwise; the constant
tables are carried across bit for bit.  The CUDA kernel (a radix-16
Stockham FFT, not the tool's two-stage form) is held against the plain
version where a card is present (marker ``cuda``); on the CPU its twiddle
table is checked entry by entry and, through a numpy model of the
kernel's schedule, against np.fft.
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


LENGTHS = [256, 512, 1024, 2048, 4096, 8192]


@pytest.mark.parametrize("n", LENGTHS)
def test_fft_twiddles_are_float64_exp_rounded_once(n):
    """The kernel's twiddle table, both signs, bit for bit: each pass's
    W_{Ns R}^{r k} and then W_n^k for k <= n/4, each np.exp in float64
    rounded once to float32."""
    for inverse in (False, True):
        plan = K5.fft_plan(n, inverse)
        assert np.prod(plan) == n // 2
        assert all(r in (2, 4, 8, 16) for r in plan)
        sign = 1.0 if inverse else -1.0
        want, ns = [], 1
        for r in plan:
            for rr in range(1, r if ns > 1 else 1):
                for k in range(ns):
                    want.append(np.exp(sign * 2j * np.pi * rr * k / (ns * r)))
            ns *= r
        want += [np.exp(sign * 2j * np.pi * k / n) for k in range(n // 4 + 1)]
        want = np.array(want)
        got = K5.fft_twiddles(n, inverse)
        assert got.dtype == np.float32 and got.shape == (len(want), 2)
        np.testing.assert_array_equal(got[:, 0], want.real.astype(np.float32))
        np.testing.assert_array_equal(got[:, 1], want.imag.astype(np.float32))


def _stockham(z, tw, plan, inverse):
    """FFT of the complex rows z (rows, m) in csrc/dft.cu's pass order and
    index scheme, with its table tw: pass of radix R over butterflies jj <
    m/R, legs jj + r*m/R times tw[off + (r-1)*Ns + jj%Ns], outputs to
    (jj - jj%Ns)*R + jj%Ns + r*Ns.  Returns the spectrum and the offset of
    the W_n^k entries."""
    m = z.shape[-1]
    ns, off = 1, 0
    for r in plan:
        jj = np.arange(m // r)
        k = jj % ns
        legs = np.arange(r)[:, None]
        a = z[:, jj[None, :] + legs * (m // r)]             # (rows, R, m/R)
        if ns > 1:
            a[:, 1:] *= tw[off + (legs[1:] - 1) * ns + k[None, :]]
            off += (r - 1) * ns
        a = np.fft.ifft(a, axis=1) * r if inverse else np.fft.fft(a, axis=1)
        out = np.empty_like(z)
        out[:, (jj - k)[None, :] * r + k[None, :] + legs * ns] = a
        z, ns = out, ns * r
    return z, off


def _post(tw, off, m):
    """W_n^k for k < m from the table's k <= m/2 entries."""
    k = np.arange(m)
    w = tw[off + np.minimum(k, m - k)]
    return np.where(k <= m // 2, w, -np.conj(w))


@pytest.mark.parametrize("n", LENGTHS)
def test_twiddles_drive_the_kernels_schedule(n):
    """A numpy model of the kernel: the half-length packing, the Stockham
    passes with fft_twiddles, the pairing of k with m - k, in float64,
    gives np.fft.rfft and np.fft.irfft (Im of DC and Nyquist dropped)."""
    m = n // 2
    x = _x(11, (3, n)).astype(np.float64)
    tw = K5.fft_twiddles(n, False).astype(np.float64) @ [1, 1j]
    z, off = _stockham(x[:, 0::2] + 1j * x[:, 1::2], tw, K5.fft_plan(n),
                       False)
    a, b = z, np.conj(z[:, (m - np.arange(m)) % m])
    X = 0.5 * (a + b) - 0.5j * _post(tw, off, m) * (a - b)
    X = np.concatenate([X, (z[:, :1].real - z[:, :1].imag)], axis=1)
    ref = np.fft.rfft(x)
    assert np.abs(X - ref).max() / np.abs(ref).max() < 1e-6

    h = m + 1
    Xin = _x(12, (3, h)) + 1j * _x(13, (3, h))
    Xd = Xin.copy()
    Xd[:, [0, -1]] = Xd[:, [0, -1]].real
    tw = K5.fft_twiddles(n, True).astype(np.float64) @ [1, 1j]
    off = len(tw) - (m // 2 + 1)
    a, b = Xd[:, :m], np.conj(Xd[:, m - np.arange(m)])
    V = (a + b) + 1j * _post(tw, off, m) * (a - b)
    v, _ = _stockham(V, tw, K5.fft_plan(n, True), True)
    y = np.stack([v.real, v.imag], -1).reshape(3, n) / n
    assert np.abs(y - np.fft.irfft(Xin, n=n)).max() < 1e-7


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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 512, 2048, 4096])
@pytest.mark.parametrize("rows", [1, 37, 203])
def test_cuda_dft_ragged_row_counts(cuda_device, n, rows):
    """1, 37 and 203 rows: where several rows share a block (n < 4096),
    37 and 203 leave its last block partly empty; both kernels still match
    their plain versions on every row."""
    h = n // 2 + 1
    x = torch.from_numpy(_x(14, (rows, n))).to(cuda_device)
    zr = torch.from_numpy(_x(15, (rows, h))).to(cuda_device)
    zi = torch.from_numpy(_x(16, (rows, h))).to(cuda_device)
    re, im = K5.rfft_fused(x, n)
    p_re, p_im = K5.rfft_fused_plain(x, n)
    y = K5.irfft_fused(zr, zi, n)
    p_y = K5.irfft_fused_plain(zr, zi, n)
    torch.cuda.synchronize()
    scale = float(torch.maximum(p_re.abs().max(), p_im.abs().max()))
    assert float((re - p_re).abs().max()) / scale < TOL_FWD_REL
    assert float((im - p_im).abs().max()) / scale < TOL_FWD_REL
    assert float((y - p_y).abs().max()) < TOL_INV_ABS


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 2048, 8192])
def test_cuda_irfft_drops_the_imaginary_part_of_dc_and_nyquist(cuda_device,
                                                               n):
    """On the card as on the CPU: Im of bin 0 and bin n/2 does not reach
    the output, bit for bit, and the output is np.fft.irfft's."""
    h = n // 2 + 1
    zr, zi = _x(17, (5, h)), _x(18, (5, h))
    zi2 = zi.copy()
    zi2[:, 0] += 5.0
    zi2[:, -1] -= 3.0
    t = lambda a: torch.from_numpy(a).to(cuda_device)
    y = K5.irfft_fused(t(zr), t(zi), n)
    y2 = K5.irfft_fused(t(zr), t(zi2), n)
    assert torch.equal(y, y2)
    ref = np.fft.irfft(zr + 1j * zi2, n=n)
    assert np.abs(y2.cpu().numpy() - ref).max() < TOL_INV_ABS


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 4096])
def test_cuda_dft_launches_are_bitwise_repeatable(cuda_device, n):
    """No atomics and a fixed order of operations: two launches on the
    same input give the same bits, both ways."""
    h = n // 2 + 1
    x = torch.from_numpy(_x(19, (300, n))).to(cuda_device)
    zr = torch.from_numpy(_x(20, (300, h))).to(cuda_device)
    zi = torch.from_numpy(_x(21, (300, h))).to(cuda_device)
    a, b = K5.rfft_fused(x, n), K5.rfft_fused(x, n)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert torch.equal(K5.irfft_fused(zr, zi, n), K5.irfft_fused(zr, zi, n))


@pytest.mark.cuda
def test_cuda_lead_dims_and_an_unaligned_view(cuda_device):
    """A (2, 3, n) input keeps its leading dims both ways and gives the
    rows of the (6, n) call bitwise; input views that start one float into
    their storage (not 8-byte aligned for the forward's float2 loads, and
    bin planes at another offset modulo 16 bytes) give the same bits as
    aligned copies."""
    n = 4096
    h = n // 2 + 1
    x = torch.from_numpy(_x(22, (2, 3, n))).to(cuda_device)
    re, im = K5.rfft_fused(x, n)
    assert re.shape == im.shape == (2, 3, h)
    re2, im2 = K5.rfft_fused(x.reshape(6, n), n)
    assert torch.equal(re.reshape(6, h), re2)
    assert torch.equal(im.reshape(6, h), im2)
    y = K5.irfft_fused(re, im, n)
    assert y.shape == (2, 3, n)
    assert torch.equal(y.reshape(6, n), K5.irfft_fused(re2, im2, n))
    assert float((y - x).abs().max()) < 1e-4
    flat = torch.from_numpy(_x(23, (1, 4 * n + 1))).to(cuda_device)
    view = flat[0, 1:].reshape(4, n)
    assert view.is_contiguous() and view.data_ptr() % 8 == 4
    got, want = K5.rfft_fused(view, n), K5.rfft_fused(view.clone(), n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    planes = torch.from_numpy(_x(24, (2, 4 * h + 1))).to(cuda_device)
    zr, zi = (p[1:].reshape(4, h) for p in planes)
    assert torch.equal(K5.irfft_fused(zr, zi, n),
                       K5.irfft_fused(zr.clone(), zi.clone(), n))
