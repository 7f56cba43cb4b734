"""WAV file I/O without external dependencies (numpy-only copy of
magphase_tpu/io/wav.py: the names its io package exports, and
write_wav_pcm16).

The reference uses python-soundfile (libsndfile) via ``la.read_audio_file`` /
``la.write_audio_file`` (the reference's src/libaudio.py:343-365).  soundfile
reads PCM16 into float64 in [-1, 1) by dividing by 32768, and
``write_audio_file`` peak-normalises to 0.98 by default before writing.

This is a minimal, numpy-only RIFF/WAVE codec supporting PCM 16/24/32-bit and
IEEE float32/float64, mono or multi-channel.
"""
from __future__ import annotations

import struct

import numpy as np

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _unpack_fmt(body: bytes, chunk_sz: int):
    """fmt chunk fields, resolving WAVE_FORMAT_EXTENSIBLE's sub-format."""
    fmt = struct.unpack("<HHIIHH", body[:16])
    if fmt[0] == _WAVE_FORMAT_EXTENSIBLE and chunk_sz >= 40 and \
            len(body) >= 26:
        sub = struct.unpack("<H", body[24:26])[0]
        fmt = (sub,) + fmt[1:]
    return fmt


def read_wav(path: str, always_2d: bool = False) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float64 signal in [-1, 1), sample_rate).

    Matches soundfile's default scaling: int16/32768, int24/8388608,
    int32/2147483648; float data passed through.
    """
    with open(path, "rb") as f:
        data = f.read()

    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        chunk_id = data[pos:pos + 4]
        chunk_sz = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + chunk_sz]
        if chunk_id == b"fmt ":
            fmt = _unpack_fmt(body, chunk_sz)
        elif chunk_id == b"data":
            raw = body
        pos += 8 + chunk_sz + (chunk_sz & 1)  # chunks are word-aligned

    if fmt is None or raw is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, n_ch, fs, _byte_rate, _block_align, bits = fmt

    if audio_fmt == _WAVE_FORMAT_PCM:
        if bits == 16:
            sig = np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
        elif bits == 24:
            b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
            ints = (b[:, 0].astype(np.int32)
                    | (b[:, 1].astype(np.int32) << 8)
                    | (b[:, 2].astype(np.int32) << 16))
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            sig = ints.astype(np.float64) / 8388608.0
        elif bits == 32:
            sig = np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
        elif bits == 8:
            sig = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_fmt == _WAVE_FORMAT_IEEE_FLOAT:
        dtype = "<f4" if bits == 32 else "<f8"
        sig = np.frombuffer(raw, dtype=dtype).astype(np.float64)
    else:
        raise ValueError(f"{path}: unsupported WAVE format 0x{audio_fmt:04x}")

    if n_ch > 1:
        sig = sig.reshape(-1, n_ch)
    elif always_2d:
        sig = sig.reshape(-1, 1)
    return sig, fs


def read_wav_info(path: str) -> tuple[int, int]:
    """(n_samples, sample_rate) from the header alone — no sample decode.

    Cheap length probe for length-sorted corpus batching (homogeneous
    chunks reuse one compiled program and minimise padding)."""
    with open(path, "rb") as f:
        head = f.read(12)
        if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data_size = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            chunk_id = hdr[:4]
            chunk_sz = struct.unpack("<I", hdr[4:])[0]
            if chunk_id == b"fmt ":
                body = f.read(min(chunk_sz, 40))
                fmt = _unpack_fmt(body, chunk_sz)
                f.seek(chunk_sz - len(body) + (chunk_sz & 1), 1)
            else:
                if chunk_id == b"data":
                    data_size = chunk_sz
                f.seek(chunk_sz + (chunk_sz & 1), 1)
            if fmt is not None and data_size is not None:
                break
    if fmt is None or data_size is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    _fmt, n_ch, fs, _rate, block_align, _bits = fmt
    return data_size // max(block_align, 1), fs


def write_wav(path: str, sig: np.ndarray, fs: int, subtype: str = "PCM_16") -> None:
    """Write a WAV file.  ``subtype``: 'PCM_16' (default, matches soundfile's
    default for .wav) or 'FLOAT'."""
    sig = np.asarray(sig)
    if sig.ndim == 1:
        n_ch = 1
    else:
        n_ch = sig.shape[1]

    if subtype == "PCM_16":
        # soundfile/libsndfile float->int16: scale by 32768, clip, round-to-nearest
        scaled = np.clip(np.rint(sig * 32768.0), -32768, 32767).astype("<i2")
        raw = scaled.tobytes()
        bits, afmt = 16, _WAVE_FORMAT_PCM
    elif subtype == "FLOAT":
        raw = sig.astype("<f4").tobytes()
        bits, afmt = 32, _WAVE_FORMAT_IEEE_FLOAT
    else:
        raise ValueError(f"unsupported subtype {subtype}")

    block_align = n_ch * bits // 8
    byte_rate = fs * block_align
    hdr = b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, afmt, n_ch, fs, byte_rate,
                                 block_align, bits)
    hdr += b"data" + struct.pack("<I", len(raw))
    with open(path, "wb") as f:
        f.write(hdr + raw)


def write_wav_pcm16(path: str, pcm: np.ndarray, fs: int) -> None:
    """Write already-quantised int16 mono samples as a PCM16 WAV.

    Counterpart of the device-side peak-norm + quantise
    (parallel.batch._pcm16_kernel): the host only writes raw frames."""
    raw = np.ascontiguousarray(pcm, "<i2").tobytes()
    block_align = 2
    hdr = b"RIFF" + struct.pack("<I", 36 + len(raw)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, _WAVE_FORMAT_PCM, 1, fs,
                                 fs * block_align, block_align, 16)
    hdr += b"data" + struct.pack("<I", len(raw))
    with open(path, "wb") as f:
        f.write(hdr + raw)


def write_audio_file(path: str, sig: np.ndarray, fs: int,
                     norm: float | None = 0.98) -> None:
    """Peak-normalising wav writer (libaudio.py:352-365 semantics)."""
    sig = np.asarray(sig, dtype=np.float64)
    if norm is not None:
        peak = np.max(np.abs(sig))
        if peak > 0:
            sig = norm * sig / peak
    write_wav(path, sig, fs)


def read_audio_file(path: str, **kw) -> tuple[np.ndarray, int]:
    return read_wav(path, **kw)
