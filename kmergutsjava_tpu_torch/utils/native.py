"""ctypes loaders for the host C++ components (feeder, FASTA parser,
grouping core, scatter/verify helpers).

The C++ is host code shared with the JAX package: it is compiled by path
from ``kmergutsjava_tpu/native/*.cpp`` (read only, never written to) into
this package's own git-ignored ``build/`` directory. Each loader builds its
shared library on demand with g++ and returns None when no toolchain is
available, so callers fall back to their numpy twins.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(os.path.dirname(_PKG_DIR), "kmergutsjava_tpu",
                        "native")
BUILD_DIR = os.path.join(_PKG_DIR, "build")

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U16P = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def stale(out: str, sources) -> bool:
    """True when ``out`` is missing or older than any existing source."""
    if not os.path.exists(out):
        return True
    newest = max(os.path.getmtime(s) for s in sources if os.path.exists(s))
    return os.path.getmtime(out) < newest


def compile_to(cmd_head, out: str) -> None:
    """Run ``cmd_head + [tmp]`` and move ``tmp`` onto ``out`` atomically, so
    concurrent processes building the same library never load a partial
    file. Raises CalledProcessError (with the compiler's stderr) or
    OSError."""
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    try:
        subprocess.run(list(cmd_head) + [tmp], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _build(name: str) -> Optional[ctypes.CDLL]:
    src = os.path.join(_SRC_DIR, name + ".cpp")
    so = os.path.join(BUILD_DIR, name + ".so")
    try:
        if stale(so, (src, os.path.join(_SRC_DIR, "threading.h"))):
            compile_to(["g++", "-O3", "-shared", "-fPIC", "-pthread", src,
                        "-o"], so)
        return ctypes.CDLL(so)
    except Exception:
        return None


_libs: dict = {}


def _load(name: str, env_off: str, bind) -> Optional[ctypes.CDLL]:
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        if not os.environ.get(env_off):
            lib = _build(name)
            if lib is not None:
                try:
                    bind(lib)
                except Exception:
                    lib = None
        _libs[name] = lib
        return lib


def _bind_feeder(lib) -> None:
    for fname in ("feeder_aa", "feeder_dna"):
        fn = getattr(lib, fname)
        fn.restype = ctypes.c_int64
        fn.argtypes = [_U8P, _I64P, _I64P, ctypes.c_int64, _I64P,
                       _U8P, _I64P, _I32P, _I32P]


def load_feeder() -> Optional[ctypes.CDLL]:
    return _load("feeder", "KMER_NO_NATIVE_FEEDER", _bind_feeder)


def _bind_scatter(lib) -> None:
    fn = lib.table_place
    fn.restype = ctypes.c_int64
    fn.argtypes = [_I64P, _I64P, ctypes.c_int64, ctypes.c_int64, _I64P]
    fn = lib.table_fill
    fn.restype = None
    fn.argtypes = [_I64P, _I64P, ctypes.c_int64, _I64P, _I32P, _I32P, _I32P,
                   _F32P, _U8P]
    fn = lib.emit_hits
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        _I64P, _I64P, _I64P, _I64P,                   # v, cnt, pos, slots
        ctypes.c_int64,                               # n
        _I32P, _I32P, _I32P, _F32P,                   # table columns
        _I64P, _I64P, _I32P, _I32P, _I32P, _F32P,     # hit columns out
        _I64P,                                        # hit values out
    ]
    fn = lib.gather_resolve_slots
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        _I64P, _I32P, _U8P, _U8P,                     # v, homes, off, state
        ctypes.c_int64,                               # n
        _I64P, ctypes.c_int64, ctypes.c_int64,        # hk, hk_len, full_w
        _I64P,                                        # slots out
    ]
    fn = lib.scatter_chunk
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        _I64P, ctypes.c_int64,                        # values, n
        ctypes.c_int64, ctypes.c_int64,               # num_sigs, channels
        ctypes.c_int64, ctypes.c_int64,               # block, rows
        ctypes.c_int64,                               # fp_mod
        _U16P, _U8P,                                  # tiles, occ (mutated)
        _I64P, _I64P, _I32P,                          # homes, flat, shift out
    ]
    fn = lib.resolve_slots
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        _I64P, _I64P, _I64P, _I32P,                   # v, homes, flat, shift
        ctypes.c_int64,                               # n
        _I32P, _U8P,                                  # kernel output, fe
        _I64P, ctypes.c_int64,                        # hk, hk_len
        ctypes.c_int64, ctypes.c_int64,               # w, full_w
        _I64P,                                        # slots out
    ]


def load_scatter() -> Optional[ctypes.CDLL]:
    """Native table builder (table_place/table_fill), the sparse lookup's
    verify/compact pass (gather_resolve_slots/emit_hits) and the stream
    lookup's tile scatter and decode (scatter_chunk/resolve_slots)."""
    return _load("scatter", "KMER_NO_NATIVE_SCATTER", _bind_scatter)


def _bind_grouping(lib) -> None:
    fn = lib.group_batch
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        _I64P, _I32P, _I32P, _I32P, _F32P,           # hit columns
        _I64P, ctypes.c_int64,                        # bounds
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32,                               # params
        _I64P, _I64P, _I64P, _I32P, _I32P, _F32P,     # call records
        _I32P, _I32P, _I32P,                          # nupd + updates
        ctypes.c_int64, ctypes.c_int64,               # capacities
    ]
    fn = lib.jweight
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_float, _U8P]
    fn = lib.emit_report
    fn.restype = ctypes.c_int64
    fn.argtypes = [
        _U8P, _I64P, _I64P,                           # ids blob/off, seq_len
        ctypes.c_int64, ctypes.c_int32, _I64P,        # n_seq, frames, batch
        _I64P, _I64P, _I64P, _I32P, _I32P, _F32P,     # call_off + call cols
        _I64P, _I32P, _I32P,                          # upd_base + updates
        _U8P, _I64P,                                  # function blob/off
        _U8P, ctypes.c_int64,                         # out buffer, capacity
    ]


def load_grouping() -> Optional[ctypes.CDLL]:
    """Native batch grouping core; None without g++."""
    return _load("grouping", "KMER_NO_NATIVE_GROUPING", _bind_grouping)


def _bind_fasta(lib) -> None:
    fn = lib.parse_fasta
    fn.restype = ctypes.c_int64
    fn.argtypes = [_U8P, ctypes.c_int64, _I64P, ctypes.c_int64, _U8P, _I64P]


def load_fasta() -> Optional[ctypes.CDLL]:
    """Native bulk FASTA parser; None without g++."""
    return _load("fasta", "KMER_NO_NATIVE_FASTA", _bind_fasta)
