"""Native host runtime (C++ via ctypes).

Builds ``hostinfo.cpp`` on first use into the package directory (the
built library is not tracked in git); all
entry points degrade gracefully to Python fallbacks when a compiler is
unavailable, mirroring how the reference makes MPI/HDF5 optional
(cloudsc_mpi_mod.F90 no-op wrappers).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile
import time

__all__ = ["hostinfo"]

_DIR = pathlib.Path(__file__).resolve().parent
_SO = _DIR / "libcloudsc2host.so"
_SRC = _DIR / "hostinfo.cpp"


class _HostInfo:
    def __init__(self):
        self._lib = None
        self._tried = False

    def _load(self):
        if self._tried:
            return self._lib
        self._tried = True
        try:
            if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
                try:
                    # build into a private file and rename it into place:
                    # concurrent test workers may all build at once, and
                    # none may load a half-written library
                    fd, tmp = tempfile.mkstemp(dir=_DIR, suffix=".so.tmp")
                    os.close(fd)
                    try:
                        subprocess.run(
                            ["g++", "-O2", "-shared", "-fPIC", str(_SRC),
                             "-o", tmp],
                            check=True,
                            capture_output=True,
                        )
                        os.replace(tmp, _SO)
                    finally:
                        if os.path.exists(tmp):
                            os.unlink(tmp)
                except Exception:
                    # no compiler / read-only install dir: a stale
                    # prebuilt .so still beats the Python fallbacks
                    if not _SO.exists():
                        raise
            lib = ctypes.CDLL(str(_SO))
            lib.cloudsc2_sched_getcpu.restype = ctypes.c_int
            lib.cloudsc2_monotonic_ns.restype = ctypes.c_int64
            lib.cloudsc2_energy_uj.restype = ctypes.c_int64
            lib.cloudsc2_expand_f64.argtypes = [
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_void_p,
                ctypes.c_int64,
                ctypes.c_int64,
            ]
            self._lib = lib
        except Exception:
            self._lib = None
        return self._lib

    def sched_getcpu(self) -> int:
        lib = self._load()
        return int(lib.cloudsc2_sched_getcpu()) if lib else -1

    def monotonic_ns(self) -> int:
        lib = self._load()
        return int(lib.cloudsc2_monotonic_ns()) if lib else time.monotonic_ns()

    def energy_uj(self) -> int:
        lib = self._load()
        return int(lib.cloudsc2_energy_uj()) if lib else -1

    def expand_f64(self, src, dst) -> bool:
        """Cyclic column expansion dst[c] = src[c % n]; both row-major
        (cols, depth) float64.  Returns False if the native lib is
        unavailable (caller falls back to numpy tiling)."""
        import numpy as np

        lib = self._load()
        if lib is None:
            return False
        src = np.ascontiguousarray(src, dtype=np.float64)
        assert dst.flags["C_CONTIGUOUS"] and dst.dtype == np.float64
        # shape agreement guards the C memcpy sweep (a trailing-shape
        # mismatch would be an out-of-bounds write, not an exception)
        assert src.shape[0] > 0, "expand_f64: empty source"
        assert dst.shape[1:] == src.shape[1:], (dst.shape, src.shape)
        depth = int(np.prod(src.shape[1:], dtype=np.int64)) if src.ndim > 1 else 1
        lib.cloudsc2_expand_f64(
            src.ctypes.data,
            src.shape[0],
            dst.ctypes.data,
            dst.shape[0],
            depth,
        )
        return True


hostinfo = _HostInfo()
