"""ctypes loader for the C++ fast oracle (built from msm_tpu/oracle/cpp).

The shared library is compiled from the tracked sources on first use (one
C++ compiler call, no build system needed). ``native_available`` says
whether it built; ``best_msm`` falls back to the pure-python oracle when it
did not, while callers that must not fall back (large-size verification)
call ``require_native``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess

from msm_tpu.params import BN254, CurveSpec
from msm_tpu.oracle.pyecc import Curve, JPoint

_LIB = None
_LIB_ERROR: str | None = None
_LIB_TRIED = False

#: curves with a native entry point -> bytes per serialized field element
FIELD_BYTES = {"bn254": 32, "bls12_381": 48}

_DIR = os.path.join(os.path.dirname(__file__), "cpp")
_SOURCES = ("msm_oracle.cpp", "msm_curve.inc")


def _lib_path() -> str:
    return os.path.join(_DIR, "libmsm_oracle.so")


def _build(path: str) -> None:
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found (set CXX)")
    # no -march=native: a portable binary avoids SIGILL if it is copied
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(
        [cxx, "-O3", "-fPIC", "-std=c++17", "-pthread", "-shared",
         "-o", tmp, os.path.join(_DIR, "msm_oracle.cpp")],
        check=True, capture_output=True, text=True, timeout=300,
    )
    os.replace(tmp, path)  # atomic: concurrent builders never see half a file


def _load():
    global _LIB, _LIB_ERROR, _LIB_TRIED
    if _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    path = _lib_path()
    newest_src = max(os.path.getmtime(os.path.join(_DIR, s)) for s in _SOURCES)
    try:
        # build, or rebuild after source edits — a stale .so must never
        # silently win over the sources
        if not os.path.exists(path) or newest_src > os.path.getmtime(path):
            _build(path)
        lib = ctypes.CDLL(path)
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        _LIB_ERROR = getattr(e, "stderr", None) or repr(e)
        return None
    for name in FIELD_BYTES:
        fn = getattr(lib, f"msm_{name}")
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),  # points: n * 2FB bytes (x||y LE)
            ctypes.POINTER(ctypes.c_uint8),  # scalars: n * 32 bytes LE
            ctypes.c_size_t,  # n
            ctypes.POINTER(ctypes.c_uint8),  # out: 3FB bytes (x||y||z LE)
        ]
    _LIB = lib
    return _LIB


def native_available(curve: CurveSpec = BN254) -> bool:
    return curve.name in FIELD_BYTES and _load() is not None


def require_native(curve: CurveSpec = BN254) -> None:
    """Raise unless the C++ oracle serves ``curve`` (no python fallback)."""
    if curve.name not in FIELD_BYTES:
        raise RuntimeError(f"no native oracle for curve {curve.name}")
    if _load() is None:
        raise RuntimeError(f"native oracle failed to build: {_LIB_ERROR}")


def native_msm(points: list[JPoint], scalars: list[int], curve: CurveSpec = BN254) -> JPoint:
    """Run the C++ Pippenger oracle. points are JPoints (any Z); they are
    normalized to affine before the FFI call."""
    require_native(curve)
    fb = FIELD_BYTES[curve.name]
    cv = Curve(curve)
    n = len(points)
    pbuf = bytearray(2 * fb * n)
    sbuf = bytearray(32 * n)
    for i, (pt, k) in enumerate(zip(points, scalars)):
        if pt.is_identity():
            # encode identity as (0, 0): the C++ side treats x=y=0 as infinity
            x, y = 0, 0
        elif pt.z == 1:
            x, y = pt.x, pt.y  # already affine — skip the modular inverse
        else:
            x, y = cv.to_affine(pt)
        o = 2 * fb * i
        pbuf[o : o + fb] = x.to_bytes(fb, "little")
        pbuf[o + fb : o + 2 * fb] = y.to_bytes(fb, "little")
        sbuf[32 * i : 32 * i + 32] = (k % curve.order).to_bytes(32, "little")
    obuf = (ctypes.c_uint8 * (3 * fb))()
    rc = getattr(_LIB, f"msm_{curve.name}")(
        (ctypes.c_uint8 * len(pbuf)).from_buffer(pbuf),
        (ctypes.c_uint8 * len(sbuf)).from_buffer(sbuf),
        n,
        obuf,
    )
    if rc != 0:
        raise RuntimeError(f"native msm failed rc={rc}")
    raw = bytes(obuf)
    x = int.from_bytes(raw[0:fb], "little")
    y = int.from_bytes(raw[fb : 2 * fb], "little")
    z = int.from_bytes(raw[2 * fb : 3 * fb], "little")
    return JPoint(x, y, z)
