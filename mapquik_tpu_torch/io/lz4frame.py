"""Minimal LZ4 frame (de)compression via ctypes on the system liblz4 (the
port's copy of `mapquik_tpu.io.lz4frame`).

The reference decompresses .lz4 inputs via the lzzzz crate (src/main.rs:69-74);
this binds the same liblz4 LZ4F_* frame API directly — no Python lz4 package
needed. Streaming decompression in fixed chunks; compression provided for tests
and tooling.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import io
from typing import Optional

_LZ4F_VERSION = 100
_CHUNK = 1 << 20

_lib: Optional[ctypes.CDLL] = None
_lib_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    for name in ("liblz4.so.1", "liblz4.so", ctypes.util.find_library("lz4")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
            lib.LZ4F_isError.restype = ctypes.c_uint
            lib.LZ4F_isError.argtypes = [ctypes.c_size_t]
            lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
            lib.LZ4F_createDecompressionContext.argtypes = [
                ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint,
            ]
            lib.LZ4F_freeDecompressionContext.restype = ctypes.c_size_t
            lib.LZ4F_freeDecompressionContext.argtypes = [ctypes.c_void_p]
            lib.LZ4F_decompress.restype = ctypes.c_size_t
            lib.LZ4F_decompress.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t),
                ctypes.c_void_p,
            ]
            lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
            lib.LZ4F_compressFrameBound.argtypes = [ctypes.c_size_t, ctypes.c_void_p]
            lib.LZ4F_compressFrame.restype = ctypes.c_size_t
            lib.LZ4F_compressFrame.argtypes = [
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.c_void_p,
            ]
            _lib = lib
            return _lib
        except OSError:
            continue
    return None


def available() -> bool:
    return _load() is not None


def compress(data: bytes) -> bytes:
    """One-shot LZ4 frame compression (tests / tooling)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("liblz4 not available")
    bound = lib.LZ4F_compressFrameBound(len(data), None)
    dst = ctypes.create_string_buffer(bound)
    n = lib.LZ4F_compressFrame(dst, bound, data, len(data), None)
    if lib.LZ4F_isError(n):
        raise RuntimeError(f"LZ4F_compressFrame error code {n}")
    return dst.raw[:n]


def decompress_stream(f, chunk: int = _CHUNK):
    """Yield decompressed byte chunks from an LZ4-frame file object."""
    lib = _load()
    if lib is None:
        raise RuntimeError("liblz4 not available")
    ctx = ctypes.c_void_p()
    err = lib.LZ4F_createDecompressionContext(ctypes.byref(ctx), _LZ4F_VERSION)
    if lib.LZ4F_isError(err):
        raise RuntimeError(f"LZ4F context error code {err}")
    try:
        dst = ctypes.create_string_buffer(chunk)
        while True:
            src = f.read(chunk)
            if not src:
                break
            consumed = 0
            while consumed < len(src):
                src_size = ctypes.c_size_t(len(src) - consumed)
                dst_size = ctypes.c_size_t(chunk)
                rc = lib.LZ4F_decompress(
                    ctx, dst, ctypes.byref(dst_size),
                    src[consumed:], ctypes.byref(src_size), None,
                )
                if lib.LZ4F_isError(rc):
                    raise RuntimeError(f"LZ4F_decompress error code {rc}")
                consumed += src_size.value
                if dst_size.value:
                    yield dst.raw[: dst_size.value]
    finally:
        lib.LZ4F_freeDecompressionContext(ctx)


def open_lz4(path: str):
    """File-like object reading decompressed bytes from an .lz4 frame file."""
    raw = open(path, "rb")

    class _Reader(io.RawIOBase):
        def __init__(self):
            self._gen = decompress_stream(raw)
            self._buf = b""

        def readable(self):
            return True

        def readinto(self, b):
            while len(self._buf) < len(b):
                try:
                    self._buf += next(self._gen)
                except StopIteration:
                    break
            n = min(len(b), len(self._buf))
            b[:n] = self._buf[:n]
            self._buf = self._buf[n:]
            return n

        def close(self):
            raw.close()
            super().close()

    return io.BufferedReader(_Reader())
