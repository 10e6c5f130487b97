"""The host runtime in C++ (smc_native.cpp), built with g++ at first use
and loaded through ctypes (counterpart of tpu_smc.native): the CSV
formatters, glibc's rand() with the reference's Box-Muller
(NativeGlibcRandom) and the reference-semantics CNA oracle
(cluster_analysis_ref).

The library is compiled with `g++ -O2 -shared -fPIC` into the package's
git-ignored `_build/`, named by the source's hash, so an edited source
rebuilds and an unchanged one loads at once. A failed build raises with
the compiler's log: there is no quiet fallback, the writers of io.py
and the wall draws of rng.py call this library and nothing else. The
plain Python versions the tests hold it against are io.fixed3_csv,
io.local_rows_plain and rng.GlibcRandom.

Each formatter returns bytes byte-identical to tpu_smc's writers
(C `sprintf`: "%0.3f," positions, "%0.12f," last_state, "i, j, k, n,
mu\\n" voxel rows).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "smc_native.cpp"
_BUILD = Path(__file__).resolve().parents[1] / "_build"


class _Lib:
    """The loaded library (one per process) and its build's record."""
    lib = None
    path: Path | None = None
    seconds = 0.0
    buf = None          # the formatters' output buffer, reused


def build() -> ctypes.CDLL:
    """Compile smc_native.cpp unless a library of the same source exists,
    and load it. Raises RuntimeError with the compiler's output when g++
    is missing or fails."""
    if _Lib.lib is not None:
        return _Lib.lib
    import time

    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = _BUILD / f"smc_native_{tag}.so"
    t0 = time.perf_counter()
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the native CSV formatters "
                               "(tpu_smc_torch/native) cannot be built")
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        res = subprocess.run([gxx, "-O2", "-shared", "-fPIC", "-std=c++17",
                              str(_SRC), "-o", str(tmp)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}) building "
                               f"{_SRC.name}:\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.format_local_rows.argtypes = [P, P, I, I, ctypes.c_char_p, L]
    lib.format_local_rows.restype = L
    for name in ("format_positions_row", "format_last_state"):
        fn = getattr(lib, name)
        fn.argtypes = [P, L, ctypes.c_char_p, L]
        fn.restype = L
    lib.glibc_srand.argtypes = [P, ctypes.c_uint32]
    lib.glibc_srand.restype = None
    lib.glibc_rand.argtypes = [P]
    lib.glibc_rand.restype = ctypes.c_uint32
    lib.glibc_rand_fill.argtypes = [P, P, L]
    lib.glibc_rand_fill.restype = None
    lib.glibc_box_muller.argtypes = [P, ctypes.c_double, L, P]
    lib.glibc_box_muller.restype = None
    lib.cluster_analysis_ref.argtypes = [P, I, ctypes.c_double,
                                         ctypes.c_double, P]
    lib.cluster_analysis_ref.restype = None
    _Lib.lib, _Lib.path = lib, so
    _Lib.seconds = time.perf_counter() - t0
    return lib


def _call(fn, cap: int, *args) -> bytes:
    """fn(*args, buf, cap) into the process's reused output buffer of at
    least `cap` bytes (a fresh one per call pays its page faults on every
    row), doubled until the output fits."""
    while True:
        if _Lib.buf is None or len(_Lib.buf) < cap:
            _Lib.buf = ctypes.create_string_buffer(cap)
        cap = len(_Lib.buf)
        n = fn(*args, _Lib.buf, cap)
        if n >= 0:
            return ctypes.string_at(_Lib.buf, n)
        cap *= 2


def format_local_rows(density, mobility, ncx: int, ncz: int) -> bytes:
    """The voxel rows 'i, j, k, n, mu' of an [ncx, ncx, ncz] grid pair."""
    lib = build()
    d = np.ascontiguousarray(np.asarray(density).reshape(-1), np.uint64)
    m = np.ascontiguousarray(np.asarray(mobility).reshape(-1), np.uint64)
    if d.size != ncx * ncx * ncz or m.size != d.size:
        raise ValueError(f"voxel grids of {d.size} and {m.size} values for "
                         f"{ncx} x {ncx} x {ncz}")
    return _call(lib.format_local_rows, 40 * d.size + 64,
                 d.ctypes.data, m.ctypes.data, ncx, ncz)


def format_positions_row(r) -> bytes:
    """One positions row: '%0.3f,' of every value, then a newline."""
    flat = np.ascontiguousarray(np.asarray(r).reshape(-1), np.float64)
    return _call(build().format_positions_row, 16 * flat.size + 64,
                 flat.ctypes.data, flat.size)


def format_last_state(r) -> bytes:
    """The last_state row: '%0.12f,' of every value."""
    flat = np.ascontiguousarray(np.asarray(r).reshape(-1), np.float64)
    return _call(build().format_last_state, 24 * flat.size + 64,
                 flat.ctypes.data, flat.size)


class NativeGlibcRandom:
    """glibc rand()/srand() (TYPE_3) in C++, bit for bit
    rng.GlibcRandom, the plain version the tests hold it against."""

    STATE_BYTES = 128           # smc_native.cpp GlibcRng

    def __init__(self, seed: int = 1):
        self._lib = build()
        self._state = ctypes.create_string_buffer(self.STATE_BYTES)
        self._lib.glibc_srand(self._state, seed & 0xFFFFFFFF)

    def rand(self) -> int:
        return int(self._lib.glibc_rand(self._state))

    def rand_array(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint32)
        self._lib.glibc_rand_fill(self._state, out.ctypes.data, n)
        return out

    def box_muller(self, sigma: float, length: int) -> np.ndarray:
        """vecBoxMuller (matematicose.c:183-193), the odd tail 0.0."""
        out = np.empty(length, dtype=np.float64)
        self._lib.glibc_box_muller(self._state, sigma, length,
                                   out.ctypes.data)
        return out


def cluster_analysis_ref(r, n: int, box_l: float,
                         cutoff: float) -> np.ndarray:
    """The reference's CNA (SMC.c:971-1045, aliased triangular index) of
    one configuration r [n, 3]: [(n*n - n) / 2, 3] int32 rows (bonded,
    common neighbours, bonds among them)."""
    flat = np.ascontiguousarray(np.asarray(r, np.float64).reshape(-1))
    if flat.size != 3 * n:
        raise ValueError(f"{flat.size} coordinates for {n} particles")
    out = np.zeros(((n * n - n) // 2, 3), dtype=np.int32)
    build().cluster_analysis_ref(flat.ctypes.data, n, box_l, cutoff,
                                 out.ctypes.data)
    return out
