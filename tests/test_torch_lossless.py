"""The port's lossless codec against the JAX package's, byte for byte.

``atomo_tpu_torch/native/lossless.py`` keeps its own copy of
``lossless.cc``; on the same inputs it must write the same bytes as
``atomo_tpu.native.lossless.compress`` (header, shuffle, LZ stream, stored
raw), and each side must decompress the other's output. The JAX side runs
from a private build in the test's temporary directory (its ``_LIB_PATH``
and ``_lib`` patched), so its shared library in the package is never
touched. Corrupt headers and streams raise ``ValueError``. The port's build
is race-free: processes that build at once into one empty directory all
load a whole library.
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import atomo_tpu.native.lossless as jax_lossless
from atomo_tpu_torch.native import lossless

ROOT = Path(__file__).resolve().parents[1]
_RS = np.random.RandomState(0)
DATA = {
    "random": _RS.randn(5000).astype(np.float32).tobytes(),
    "zeros": bytes(40_000),
    "incompressible": _RS.randint(0, 256, 4099, dtype=np.uint8).tobytes(),
    "empty": b"",
    "structured": np.arange(10_000, dtype=np.float64).tobytes() + b"tail",
}


@pytest.fixture(scope="module")
def jax_codec(tmp_path_factory):
    lib = tmp_path_factory.mktemp("jax_native") / "libatomo_native.so"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_lossless, "_LIB_PATH", str(lib))
        mp.setattr(jax_lossless, "_lib", None)
        yield jax_lossless


@pytest.mark.parametrize("typesize", [1, 4, 8])
@pytest.mark.parametrize("name", sorted(DATA))
def test_bytes_match_the_jax_codec(jax_codec, name, typesize):
    data = DATA[name]
    ours = lossless.compress(data, typesize=typesize)
    assert ours == jax_codec.compress(data, typesize=typesize)
    assert lossless.decompress(ours) == data
    assert jax_codec.decompress(ours) == data


@pytest.mark.parametrize("shuffle", [True, False])
def test_each_side_reads_the_other(jax_codec, shuffle):
    data = DATA["structured"]
    assert lossless.decompress(jax_codec.compress(data, 8, shuffle)) == data
    assert jax_codec.decompress(lossless.compress(data, 8, shuffle)) == data


def test_stored_raw_and_compressible_flags():
    raw = lossless.compress(DATA["incompressible"], typesize=1)
    assert raw[4] & lossless.STORED and len(raw) == len(DATA["incompressible"]) + 14
    packed = lossless.compress(DATA["zeros"], typesize=4)
    assert not packed[4] & lossless.STORED and len(packed) < 100


def _blob():
    return lossless.compress(DATA["structured"], typesize=8)


CORRUPT = {
    "truncated_header": lambda b: b[:10],
    "bad_magic": lambda b: b"NOPE" + b[4:],
    "rawlen_too_large": lambda b: b[:6] + struct.pack("<Q", 1 << 40) + b[14:],
    "rawlen_too_small": lambda b: b[:6] + struct.pack("<Q", 8) + b[14:],
    "malformed_token": lambda b: b[:14] + b"\x07" + b[15:],
    "truncated_stream": lambda b: b[:-3],
    "stored_length": lambda b: lossless.compress(DATA["incompressible"], 1)[:-1],
}


@pytest.mark.parametrize("how", sorted(CORRUPT))
def test_corrupt_input_raises_valueerror(how):
    with pytest.raises(ValueError):
        lossless.decompress(CORRUPT[how](_blob()))


def test_concurrent_builds_do_not_race(tmp_path):
    """Four processes build the library at once into one empty directory:
    each writes its own temporary file and renames it into place, so every
    one loads a whole library and round-trips."""
    code = ("import sys; from pathlib import Path; "
            "import atomo_tpu_torch.native.lossless as L; L.BUILD_DIR = Path(sys.argv[1]); "
            "d = bytes(range(256)) * 64; assert L.decompress(L.compress(d)) == d")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path / "native")], env=env,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    built = sorted(f.name for f in (tmp_path / "native").iterdir())
    assert built == [lossless.library_path().name]  # no temporary file left behind
