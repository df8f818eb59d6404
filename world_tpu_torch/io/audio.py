"""Wav I/O, byte-compatible with the reference tools.

The reference reader (tools/audioio.cpp) is a minimal RIFF parser: mono
only, 8/16/24/32-bit integer PCM, scaling by 2^(nbit-1); the writer emits
16-bit PCM with clipping at [-32768, 32767] and scaling by 32767.  We
reproduce the exact sample scaling so round-trips match the C++ bit for
bit.
"""

import struct

import numpy as np


def _parse_header(head):
    """Validate the RIFF/fmt header and walk chunks to the data chunk.
    Returns (data_payload_offset, n_bytes, fs, nbit).  Walking 8-byte
    chunk headers (id + size) skips LIST/INFO metadata correctly — a
    substring search for b"data" can match inside another chunk's
    payload.  Raises ValueError for anything malformed (including a
    truncated header, so callers need not handle struct.error)."""
    if len(head) < 44:
        raise ValueError("truncated wav header")
    if head[:4] != b"RIFF" or head[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    if head[12:16] != b"fmt " or struct.unpack("<I", head[16:20])[0] != 16:
        raise ValueError("unsupported fmt chunk")
    fmt, channels = struct.unpack("<HH", head[20:24])
    if fmt != 1:
        raise ValueError("only integer PCM supported")
    if channels != 1:
        raise ValueError("only mono supported")
    fs = struct.unpack("<I", head[24:28])[0]
    nbit = struct.unpack("<H", head[34:36])[0]
    if nbit not in (8, 16, 24, 32):
        raise ValueError(f"unsupported bit depth {nbit}")
    pos = 36  # first chunk after the 16-byte fmt payload
    while pos + 8 <= len(head):
        cid = head[pos: pos + 4]
        size = struct.unpack("<I", head[pos + 4: pos + 8])[0]
        if cid == b"data":
            return pos + 8, size, fs, nbit
        pos += 8 + size + (size & 1)  # chunks are word-aligned
    raise ValueError("no data chunk")


def wavread(filename):
    """Read a mono PCM wav.  Returns (x float64 in [-1,1], fs, nbit)."""
    with open(filename, "rb") as f:
        data = f.read()
    payload, n_bytes, fs, nbit = _parse_header(data)
    qbyte = nbit // 8
    n = n_bytes // qbyte
    raw = np.frombuffer(data[payload: payload + n * qbyte], np.uint8)
    raw = raw.reshape(n, qbyte).astype(np.float64)
    # little-endian signed integer, matching tools/audioio.cpp:239-249
    top = raw[:, -1]
    sign_bias = np.where(top >= 128, 2.0 ** (nbit - 1), 0.0)
    raw[:, -1] = np.where(top >= 128, top - 128, top)
    weights = 256.0 ** np.arange(qbyte)
    val = raw @ weights
    x = (val - sign_bias) / 2.0 ** (nbit - 1)
    return x, fs, nbit


def wavwrite(x, fs, filename):
    """Write 16-bit mono PCM exactly like tools/audioio.cpp:115-170."""
    x = np.asarray(x, np.float64)
    pcm = np.clip((x * 32767).astype(np.int64), -32768, 32767) \
        .astype(np.int16)
    n = len(pcm)
    with open(filename, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + n * 2))
        f.write(b"WAVEfmt ")
        f.write(struct.pack("<IHHIIHH", 16, 1, 1, fs, fs * 2, 2, 16))
        f.write(b"data")
        f.write(struct.pack("<I", n * 2))
        f.write(pcm.tobytes())


def get_audio_length(filename):
    try:
        x, _, _ = wavread(filename)
    except (ValueError, OSError):
        return -1
    return len(x)


def peek_header(filename):
    """Parse only the RIFF header: returns (n_samples, fs) without
    reading the sample data.  Used by the corpus runner to assign bucket
    lengths before the threaded batch loader reads the audio.
    Raises ValueError on malformed/unsupported files (same conditions as
    wavread).  Reads the file incrementally while walking chunks, so
    arbitrarily large metadata (LIST/INFO) before the data chunk is
    skipped without loading the audio."""
    with open(filename, "rb") as f:
        head = f.read(4096)
        while True:
            try:
                _, n_bytes, fs, nbit = _parse_header(head)
                return n_bytes // (nbit // 8), fs
            except ValueError as e:
                # "no data chunk" may just mean it lies beyond what was
                # read so far: extend the window until the file ends.
                # Any other failure is structural — fail fast.
                if "no data chunk" not in str(e):
                    raise
                more = f.read(len(head))
                if not more:
                    raise
                head += more
