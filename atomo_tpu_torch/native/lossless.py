"""ctypes binding of the port's lossless byte codec (``lossless.cc``).

The port's own copy of ``atomo_tpu/native/lossless.py``, with the same wire
format, byte for byte (one header, then one LZ stream):

    magic   4s  b"ALZ1"
    flags   u8  bit 0: byte-shuffled; bit 1: stored raw (incompressible)
    typesz  u8  element size of the byte shuffle
    rawlen  u64 little-endian decompressed size
    payload     LZ stream, or the raw bytes when stored

``compress(data, typesize=8) -> bytes`` / ``decompress(blob) -> bytes``, as
the reference's blosc wrappers (src/utils.py:3-16). A corrupt header or
stream raises ``ValueError``; ``rawlen`` is checked against a scan of the
stream before anything of that size is allocated.

The library is built with ``g++ -O3 -shared -fPIC`` at first use (never at
import), into ``build/native/`` at the repo root (git-ignored), under a name
that carries a hash of the source and flags. Each process compiles to a name
of its own and renames it into place, so processes that build at once never
write the same file and a reader never sees a half-written library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "lossless.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
MAGIC = b"ALZ1"
HEADER = struct.Struct("<4sBBQ")
SHUFFLED, STORED = 1, 2

_lock = threading.Lock()
_lib = None
_U8P = ctypes.POINTER(ctypes.c_uint8)


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"liblossless-{digest.hexdigest()[:12]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.tmp{os.getpid()}.so")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never sees a half-written library


def _load() -> ctypes.CDLL:
    """The loaded library, built on first use. Raises ``OSError`` (no
    ``g++``, a load failure) or ``RuntimeError`` (a failed compile)."""
    global _lib
    with _lock:
        if _lib is None:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            i64 = ctypes.c_int64
            for fn, res, args in (
                ("atomo_lz_bound", i64, [i64]),
                ("atomo_lz_compress", i64, [_U8P, i64, _U8P, i64]),
                ("atomo_lz_decompress", i64, [_U8P, i64, _U8P, i64]),
                ("atomo_lz_scan", i64, [_U8P, i64]),
                ("atomo_shuffle", None, [_U8P, i64, _U8P, ctypes.c_int32]),
                ("atomo_unshuffle", None, [_U8P, i64, _U8P, ctypes.c_int32]),
            ):
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = args
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U8P)


def _buffer(data: bytes, n: int) -> np.ndarray:
    """``data`` as a uint8 array of at least one byte (a valid pointer)."""
    return np.frombuffer(data, np.uint8) if n else np.zeros(1, np.uint8)


def compress(data: bytes, typesize: int = 8, shuffle: bool = True) -> bytes:
    """Byte-shuffle (elements of ``typesize`` bytes) and LZ-compress
    ``data``; an incompressible input is stored raw."""
    lib = _load()
    n = len(data)
    src = _buffer(data, n)
    if shuffle and typesize > 1 and n >= typesize:
        stage = np.empty(n, np.uint8)
        lib.atomo_shuffle(_ptr(src), n, _ptr(stage), typesize)
        flags = SHUFFLED
    else:
        stage, flags, typesize = src, 0, 1
    cap = int(lib.atomo_lz_bound(n))
    out = np.empty(cap, np.uint8)
    written = int(lib.atomo_lz_compress(_ptr(stage), n, _ptr(out), cap))
    if written < 0:
        raise RuntimeError("atomo_lz_compress failed")
    if written >= n:  # incompressible: store raw (blosc does the same)
        return HEADER.pack(MAGIC, flags | STORED, typesize, n) + stage[:n].tobytes()
    return HEADER.pack(MAGIC, flags, typesize, n) + out[:written].tobytes()


def decompress(blob: bytes) -> bytes:
    """Inverse of :func:`compress`; raises ``ValueError`` on a corrupt
    header or stream."""
    lib = _load()
    if len(blob) < HEADER.size:
        raise ValueError("truncated atomo lossless blob")
    magic, flags, typesize, rawlen = HEADER.unpack_from(blob)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic!r}")
    payload = memoryview(blob)[HEADER.size:]
    n_in = len(payload)
    src = _buffer(payload, n_in)
    if flags & STORED:
        if n_in != rawlen:
            raise ValueError(f"corrupt stored blob: {n_in} != {rawlen}")
        out = src[:rawlen]
    else:
        # rawlen comes from the file: check it against the stream (a scan
        # that writes nothing) before allocating rawlen bytes
        scanned = int(lib.atomo_lz_scan(_ptr(src), n_in))
        if scanned < 0:
            raise ValueError("corrupt stream: malformed token")
        if scanned != rawlen:
            raise ValueError(f"corrupt header: stream decodes to {scanned} bytes, "
                             f"header claims {rawlen}")
        out = np.empty(max(rawlen, 1), np.uint8)
        got = int(lib.atomo_lz_decompress(_ptr(src), n_in, _ptr(out), rawlen))
        if got != rawlen:
            raise ValueError(f"corrupt stream: decoded {got} of {rawlen} bytes")
    if flags & SHUFFLED:
        final = np.empty(max(rawlen, 1), np.uint8)
        lib.atomo_unshuffle(_ptr(np.ascontiguousarray(out)), rawlen, _ptr(final), typesize)
        return final[:rawlen].tobytes()
    return out[:rawlen].tobytes()
