"""Parameter file I/O, byte-compatible with tools/parameterio.cpp.

Tagged little-endian binary formats: "F0  " (NOF/FP + doubles),
"SPEC"/"AP  " (NOF/FP/FFT/NOD/FS + row-major doubles).  NOD == 0 means
raw fft_size//2+1 dimensions.  These are the reference's checkpoint
format: an analysis run persisted to disk and synthesis resumed later.
"""

import struct

import numpy as np


def _write_tag_int(f, tag, value):
    f.write(tag)
    f.write(struct.pack("<i", int(value)))


def _write_tag_double(f, tag, value):
    f.write(tag)
    f.write(struct.pack("<d", float(value)))


def write_f0(filename, f0, frame_period, temporal_positions=None,
             text=False):
    """WriteF0 (tools/parameterio.cpp:59-88)."""
    f0 = np.asarray(f0, np.float64)
    if text:
        if temporal_positions is None:
            temporal_positions = np.arange(len(f0)) * frame_period / 1000.0
        with open(filename, "w", newline="") as f:
            for t, v in zip(temporal_positions, f0):
                f.write("%.5f %.5f\r\n" % (t, v))
        return
    with open(filename, "wb") as f:
        f.write(b"F0  ")
        _write_tag_int(f, b"NOF ", len(f0))
        _write_tag_double(f, b"FP  ", frame_period)
        f.write(f0.tobytes())


def read_f0(filename):
    """ReadF0 (tools/parameterio.cpp:90-117).
    Returns (temporal_positions, f0)."""
    with open(filename, "rb") as f:
        if f.read(4) != b"F0  ":
            raise ValueError("header error")
        assert f.read(4) == b"NOF "
        n = struct.unpack("<i", f.read(4))[0]
        assert f.read(4) == b"FP  "
        frame_period = struct.unpack("<d", f.read(8))[0]
        f0 = np.frombuffer(f.read(8 * n), np.float64)
    tp = np.arange(n) / 1000.0 * frame_period
    return tp, f0.copy()


def _write_matrix(filename, magic, data, fs, frame_period, fft_size,
                  number_of_dimensions):
    data = np.asarray(data, np.float64)
    nod = number_of_dimensions
    cols = fft_size // 2 + 1 if nod == 0 else nod
    assert data.shape[1] >= cols
    with open(filename, "wb") as f:
        f.write(magic)
        _write_tag_int(f, b"NOF ", data.shape[0])
        _write_tag_double(f, b"FP  ", frame_period)
        _write_tag_int(f, b"FFT ", fft_size)
        _write_tag_int(f, b"NOD ", nod)
        _write_tag_int(f, b"FS  ", fs)
        f.write(np.ascontiguousarray(data[:, :cols]).tobytes())


def _read_matrix(filename, magic):
    with open(filename, "rb") as f:
        if f.read(4) != magic:
            raise ValueError("header error")
        assert f.read(4) == b"NOF "
        n = struct.unpack("<i", f.read(4))[0]
        assert f.read(4) == b"FP  "
        frame_period = struct.unpack("<d", f.read(8))[0]
        assert f.read(4) == b"FFT "
        fft_size = struct.unpack("<i", f.read(4))[0]
        assert f.read(4) == b"NOD "
        nod = struct.unpack("<i", f.read(4))[0]
        assert f.read(4) == b"FS  "
        fs = struct.unpack("<i", f.read(4))[0]
        cols = fft_size // 2 + 1 if nod == 0 else nod
        data = np.frombuffer(f.read(8 * n * cols), np.float64)
    return (data.reshape(n, cols).copy(),
            dict(fs=fs, frame_period=frame_period, fft_size=fft_size,
                 number_of_dimensions=nod))


def write_spectral_envelope(filename, spectrogram, fs, frame_period,
                            fft_size=None, number_of_dimensions=0):
    if fft_size is None:
        fft_size = 2 * (np.asarray(spectrogram).shape[1] - 1)
    _write_matrix(filename, b"SPEC", spectrogram, fs, frame_period, fft_size,
                  number_of_dimensions)


def read_spectral_envelope(filename):
    return _read_matrix(filename, b"SPEC")


def write_aperiodicity(filename, aperiodicity, fs, frame_period,
                       fft_size=None, number_of_dimensions=0):
    if fft_size is None:
        fft_size = 2 * (np.asarray(aperiodicity).shape[1] - 1)
    _write_matrix(filename, b"AP  ", aperiodicity, fs, frame_period,
                  fft_size, number_of_dimensions)


def read_aperiodicity(filename):
    return _read_matrix(filename, b"AP  ")


def write_npz(filename, f0, fs, frame_period, fft_size, *,
              spectrogram=None, aperiodicity=None, coded_sp=None,
              coded_ap=None, dtype=np.float32):
    """Array-native corpus output: one .npz per utterance.

    The reference's tagged files are the interop checkpoint format; this
    is the compact production format for sharded corpus runs (float32,
    optionally codec-compressed sp/ap — ~10-40x smaller than the f64
    tagged triple).  No reference analogue (SURVEY §5 checkpoint/resume
    names npz/zarr as the array-native companion format).
    """
    arrays = {"f0": np.asarray(f0, dtype),
              "fs": np.int32(fs),
              "frame_period": np.float64(frame_period),
              "fft_size": np.int32(fft_size)}
    for name, a in (("spectrogram", spectrogram),
                    ("aperiodicity", aperiodicity),
                    ("coded_sp", coded_sp), ("coded_ap", coded_ap)):
        if a is not None:
            arrays[name] = np.asarray(a, dtype)
    np.savez(filename, **arrays)


def read_npz(filename):
    """Returns the raw dict written by write_npz (arrays + scalars)."""
    with np.load(filename) as z:
        return {k: z[k] for k in z.files}


def load_npz_parameters(filename, device=None):
    """Read an npz parameter file and return full-resolution
    (f0, spectrogram, aperiodicity, info) as numpy arrays — decoding
    coded sp/ap through the codec (models/codec.py, on ``device``: the
    GPU unless given) when the compact form was stored."""
    d = read_npz(filename)
    fs = int(d["fs"])
    fft_size = int(d["fft_size"])
    info = dict(fs=fs, frame_period=float(d["frame_period"]),
                fft_size=fft_size)
    if "spectrogram" in d:
        sp = d["spectrogram"]
    else:
        from ..models.codec import decode_spectral_envelope
        sp = decode_spectral_envelope(
            d["coded_sp"].astype(np.float64), fs, fft_size,
            device=device).cpu().numpy()
    if "aperiodicity" in d:
        ap = d["aperiodicity"]
    else:
        from ..models.codec import decode_aperiodicity
        ap = decode_aperiodicity(
            d["coded_ap"].astype(np.float64), fs, fft_size,
            device=device).cpu().numpy()
    return d["f0"].astype(np.float64), sp, ap, info


def get_header_information(filename, parameter):
    """GetHeaderInformation (tools/parameterio.cpp:119-144)."""
    tag = parameter.encode() if isinstance(parameter, str) else parameter
    with open(filename, "rb") as f:
        for _ in range(13):
            chunk = f.read(4)
            if len(chunk) < 4:
                break
            if chunk != tag:
                continue
            if tag == b"FP  ":
                return struct.unpack("<d", f.read(8))[0]
            return float(struct.unpack("<i", f.read(4))[0])
    return 0.0
