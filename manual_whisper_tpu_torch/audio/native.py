"""ctypes bindings of the native audio frontend (port of the JAX
``audio/native.py``).

Shared libraries, built with g++ from the port's own copies of the
C++ sources in ``manual_whisper_tpu_torch/native/`` (the JAX package's
Makefile flags, ``-O3 -fPIC -std=c++17 -shared``):

- ``libmwx_audio``: WAV and FLAC decode to mono float32 and the polyphase
  resampler (``mwx_audio.cpp`` + ``mwx_flac.cpp``), no dependency;
- ``libmwx_ffdec``: compressed containers (m4a/mp3/ogg/...) through the
  system FFmpeg libraries (``mwx_ffdec.cpp``), built best-effort: where
  the libav* headers or libraries are missing it does not build and the
  feature is unavailable (``get_ffdec()`` returns None);
- ``libmwx_zstd``: the zstd decoder and CRC-32C that ``ocdbt.py`` reads the
  JAX package's orbax checkpoints with (``mwx_zstd.cpp``), no dependency.

Each library is built on first use into ``_kernels/`` (git-ignored) under
a name carrying a hash of its sources and flags, so an edited source is
rebuilt and a stale library never loaded.  A build writes to a name of
its own and ``os.replace``s it into place, so processes building at once
(test workers) never load a half-written file.  As in the JAX package,
an audio library that cannot be built or loaded makes its functions return
None and the callers fall back (``audio/io.py``); ``ocdbt.py`` raises
instead when ``libmwx_zstd`` does not build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import signal
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "native"
BUILD_DIR = PACKAGE_DIR / "_kernels"

CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-shared"]
# library -> (sources, link flags)
LIBRARIES = {
    "mwx_audio": (("mwx_audio.cpp", "mwx_flac.cpp"), ()),
    "mwx_ffdec": (("mwx_ffdec.cpp",),
                  ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")),
    "mwx_zstd": (("mwx_zstd.cpp",), ()),
}
# compiler output of the last failed build, by library (for start-up logs)
build_errors: Dict[str, str] = {}

_lib = None
_lib_lock = threading.Lock()
_load_attempted = False

_ffdec = None
_ffdec_attempted = False
_ffdec_lock = threading.Lock()   # NOT _lib_lock: an ffdec build must not
#                                  block concurrent WAV/FLAC decodes
# Lazy-path build cap: the first get_ffdec() on a host without a built
# library can sit on a serving request (upload validation consults
# decodable_suffixes()); keep that stall short and do the full-length
# build at startup via warm_native_libs() instead.
_LAZY_BUILD_TIMEOUT = 20.0
_FULL_BUILD_TIMEOUT = 120.0


def library_path(name: str) -> Path:
    """Where library ``name`` is built: ``_kernels/lib<name>-<hash>.so``."""
    sources, ldflags = LIBRARIES[name]
    h = hashlib.sha256()
    for src in sources:
        h.update((SOURCE_DIR / src).read_bytes())
    h.update(" ".join(CXXFLAGS + list(ldflags)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str, timeout: float = _FULL_BUILD_TIMEOUT) -> Optional[Path]:
    """Build library ``name`` unless it is built; its path, or None when
    g++ fails or exceeds ``timeout`` (the compiler is stopped then)."""
    target = library_path(name)
    if target.exists():
        return target
    sources, ldflags = LIBRARIES[name]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(
        f".{target.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXXFLAGS, "-o", str(tmp),
           *(str(SOURCE_DIR / s) for s in sources), *ldflags]
    try:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    except OSError as exc:
        build_errors[name] = str(exc)
        return None
    try:
        out, _ = proc.communicate(timeout=timeout)
        if proc.returncode != 0:
            build_errors[name] = out.decode(errors="replace")[-2000:]
            return None
        os.replace(tmp, target)
        return target
    except subprocess.TimeoutExpired:
        # the whole process group: g++ and the cc1plus/ld it started
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        build_errors[name] = f"g++ exceeded {timeout:.0f} s"
        return None
    finally:
        tmp.unlink(missing_ok=True)


def get_lib():
    """Load (building on first use) libmwx_audio, or None."""
    global _lib, _load_attempted
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _load_attempted:
            return None
        _load_attempted = True
        path = build("mwx_audio")
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            build_errors["mwx_audio"] = str(exc)
            return None
        lib.mwx_decode_wav.restype = ctypes.c_int
        lib.mwx_decode_wav.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.mwx_resample.restype = ctypes.c_int
        lib.mwx_resample.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mwx_decode_flac.restype = ctypes.c_int
        lib.mwx_decode_flac.argtypes = lib.mwx_decode_wav.argtypes
        lib.mwx_free.restype = None
        lib.mwx_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _decode(fn, free, data: bytes, what: str) -> Tuple[np.ndarray, int]:
    out = ctypes.POINTER(ctypes.c_float)()
    out_len = ctypes.c_int64()
    sr = ctypes.c_int32()
    rc = fn(data, len(data), ctypes.byref(out), ctypes.byref(out_len),
            ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"{what} failed with code {rc}")
    try:
        arr = np.ctypeslib.as_array(out, shape=(out_len.value,)).copy()
    finally:
        free(out)
    return arr, int(sr.value)


def native_decode_wav(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """Decode WAV bytes -> (mono float32, sample_rate), or None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    return _decode(lib.mwx_decode_wav, lib.mwx_free, data, "mwx_decode_wav")


def native_decode_flac(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """Decode FLAC bytes -> (mono float32, sample_rate), or None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    return _decode(lib.mwx_decode_flac, lib.mwx_free, data,
                   "mwx_decode_flac")


def warm_native_libs() -> None:
    """Build and load both native libraries with the full build budget.

    Call at process start (server ``serve()``) so the first request never
    pays a C++ compile; after this, request-path calls return a cached
    library or None."""
    get_lib()
    get_ffdec(build_timeout=_FULL_BUILD_TIMEOUT)


def get_ffdec(build_timeout: float = _LAZY_BUILD_TIMEOUT):
    """Load (building on first use) libmwx_ffdec, or None.

    Separate from libmwx_audio so the dependency-free WAV/FLAC frontend
    never gains a link-time FFmpeg requirement; it builds only on hosts
    with the libav* headers and libraries."""
    global _ffdec, _ffdec_attempted
    with _ffdec_lock:
        if _ffdec is not None:
            return _ffdec
        if _ffdec_attempted:
            return None
        _ffdec_attempted = True
        path = build("mwx_ffdec", timeout=build_timeout)
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            build_errors["mwx_ffdec"] = str(exc)
            return None
        lib.mwx_decode_any.restype = ctypes.c_int
        lib.mwx_decode_any.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.mwx_encode_fixture.restype = ctypes.c_int
        lib.mwx_encode_fixture.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.mwx_ffdec_free.restype = None
        lib.mwx_ffdec_free.argtypes = [ctypes.c_void_p]
        _ffdec = lib
        return _ffdec


def native_decode_any(data: bytes) -> Optional[Tuple[np.ndarray, int]]:
    """Decode any compressed container (m4a/mp3/ogg/...) -> (mono float32,
    sample_rate); None when the ffdec lib is unavailable; raises
    ValueError on undecodable bytes."""
    lib = get_ffdec()
    if lib is None:
        return None
    return _decode(lib.mwx_decode_any, lib.mwx_ffdec_free, data,
                   "mwx_decode_any")


def native_encode_fixture(pcm: np.ndarray, sr: int, format_name: str,
                          codec_name: str = "") -> Optional[bytes]:
    """Encode mono float32 PCM into a compressed container (a test fixture
    maker: mp3/ipod(m4a)/ogg); None when the ffdec lib is unavailable."""
    lib = get_ffdec()
    if lib is None:
        return None
    pcm = np.ascontiguousarray(pcm, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_len = ctypes.c_uint64()
    rc = lib.mwx_encode_fixture(
        pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), pcm.size, sr,
        format_name.encode(), codec_name.encode(),
        ctypes.byref(out), ctypes.byref(out_len))
    if rc != 0:
        raise ValueError(f"mwx_encode_fixture({format_name!r}) failed "
                         f"with code {rc}")
    try:
        data = ctypes.string_at(out, out_len.value)
    finally:
        lib.mwx_ffdec_free(out)
    return data


def native_resample(audio: np.ndarray, sr_in: int, sr_out: int
                    ) -> Optional[np.ndarray]:
    """Resample via the native library, or None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    audio = np.ascontiguousarray(audio, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    out_n = ctypes.c_int64()
    rc = lib.mwx_resample(
        audio.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        audio.size, sr_in, sr_out, ctypes.byref(out), ctypes.byref(out_n))
    if rc != 0:
        raise ValueError(f"mwx_resample failed with code {rc}")
    try:
        arr = np.ctypeslib.as_array(out, shape=(out_n.value,)).copy()
    finally:
        lib.mwx_free(out)
    return arr
