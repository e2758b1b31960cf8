"""ctypes loaders for the host C++ components (feeder, FASTA parser,
grouping core, scatter/verify helpers).

The C++ is this package's own: ``native/*.cpp`` (and ``native/threading.h``)
ship as package data and are compiled with g++ on first use into the
package's git-ignored ``build/`` directory, or, where that is not writable,
into ``~/.cache/kmergutsjava_tpu_torch``; the CUDA kernels are built into the
same directory (``lookup/tilejoin.py`` ``build_cuda_library``).

A loader returns None, so that its callers take their numpy twins, in two
cases only: no g++ on ``PATH`` (and no library built already), or the
library's ``KMER_NO_NATIVE_*`` switch set. A missing source, a failed
compile or a failed bind raises NativeBuildError: a copy of the package
that cannot build its host code never runs silently on the slower twins.
``status()`` tells, for each library, whether it loaded, from where, and
why not.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_lock = threading.Lock()

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG_DIR, "native")
_HEADER = os.path.join(_SRC_DIR, "threading.h")


class NativeBuildError(RuntimeError):
    """A host library's source is missing, g++ refused it, or the library
    did not load or bind."""


def _writable(path: str) -> bool:
    """Writable by this process, and not marked read-only by its mode bits
    (a directory made read-only is left alone even by root, whom access()
    lets write anywhere)."""
    return os.access(path, os.W_OK) and bool(os.stat(path).st_mode & 0o222)


def _build_dir() -> str:
    own = os.path.join(_PKG_DIR, "build")
    if _writable(own if os.path.isdir(own) else _PKG_DIR):
        return own
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "kmergutsjava_tpu_torch")


BUILD_DIR = _build_dir()

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_U16P = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def stale(out: str, sources) -> bool:
    """True when ``out`` is missing or older than any existing source."""
    if not os.path.exists(out):
        return True
    times = [os.path.getmtime(s) for s in sources if os.path.exists(s)]
    return bool(times) and os.path.getmtime(out) < max(times)


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


def _so_path(name: str) -> str:
    return os.path.join(BUILD_DIR, name + ".so")


def _build(name: str) -> Optional[ctypes.CDLL]:
    """The library, built first when it is older than its sources; None
    when it needs a build and there is no g++ on PATH."""
    src = os.path.join(_SRC_DIR, name + ".cpp")
    so = _so_path(name)
    missing = [p for p in (src, _HEADER) if not os.path.exists(p)]
    if missing:
        raise NativeBuildError(f"missing native source {', '.join(missing)}")
    if stale(so, (src, _HEADER)):
        if shutil.which("g++") is None:
            return None
        try:
            compile_to(["g++", "-O3", "-shared", "-fPIC", "-pthread", src,
                        "-o"], so)
        except subprocess.CalledProcessError as ex:
            raise NativeBuildError(
                f"g++ failed on {src}:\n{ex.stderr}") from ex
        except OSError as ex:
            raise NativeBuildError(f"cannot build {so}: {ex}") from ex
    try:
        return ctypes.CDLL(so)
    except OSError as ex:
        raise NativeBuildError(f"cannot load {so}: {ex}") from ex


# name -> the loaded library, or None with the reason in _why, or the
# NativeBuildError raised again on every later call
_libs: dict = {}
_why: dict = {}


def _load(name: str, env_off: str, bind) -> Optional[ctypes.CDLL]:
    with _lock:
        if name not in _libs:
            _libs[name] = _try_load(name, env_off, bind)
        lib = _libs[name]
        if isinstance(lib, NativeBuildError):
            raise lib
        return lib


def _try_load(name: str, env_off: str, bind):
    if os.environ.get(env_off):
        _why[name] = f"{env_off} is set"
        return None
    try:
        lib = _build(name)
        if lib is None:
            _why[name] = "no g++ on PATH"
            return None
        try:
            bind(lib)
        except AttributeError as ex:
            raise NativeBuildError(
                f"cannot bind {_so_path(name)}: {ex}") from ex
        return lib
    except NativeBuildError as ex:
        _why[name] = str(ex)
        return ex


def _bind_feeder(lib) -> None:
    fn = lib.feeder_count
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int32, _U8P, _I64P, _I64P,     # aa, seqs, records
                   ctypes.c_int64, _I64P]                  # nrec, counts out
    fn = lib.feeder_write
    fn.restype = ctypes.c_int64
    fn.argtypes = [ctypes.c_int32, _U8P, _I64P, _I64P,     # aa, seqs, records
                   ctypes.c_int64, _I64P, ctypes.c_int64,  # nrec, counts, cid
                   _I64P, _I64P, _I64P]                    # columns out


def load_feeder() -> Optional[ctypes.CDLL]:
    """Native feeder (a chunk's count pass, then its write pass)."""
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
    fn = lib.emit_hits_at
    fn.restype = None
    fn.argtypes = [
        _I64P, _I64P, _I64P,                          # v, cnt, pos
        _I32P, _I32P,                                 # hit query, slot
        ctypes.c_int64, ctypes.c_int64,               # k, base
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
    lookup's tile scatter and decode (scatter_chunk/resolve_slots on the
    host, emit_hits_at after the resolve on the card)."""
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
    fn = lib.join_ids
    fn.restype = ctypes.c_int64
    fn.argtypes = [_U8P, _I64P, ctypes.c_int64, _U8P]


def load_fasta() -> Optional[ctypes.CDLL]:
    """Native bulk FASTA parser; None without g++."""
    return _load("fasta", "KMER_NO_NATIVE_FASTA", _bind_fasta)


_LOADERS = {"feeder": load_feeder, "scatter": load_scatter,
            "grouping": load_grouping, "fasta": load_fasta}


def status() -> dict:
    """For each host library (building it where needed): whether it
    loaded, its source and ``.so`` paths, and why not (None when
    loaded)."""
    out = {}
    for name, loader in _LOADERS.items():
        try:
            loaded = loader() is not None
        except NativeBuildError:
            loaded = False
        out[name] = {"loaded": loaded,
                     "source": os.path.join(_SRC_DIR, name + ".cpp"),
                     "so": _so_path(name),
                     "why_not": None if loaded else _why.get(name)}
    return out
