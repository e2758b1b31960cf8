"""Call grouping on the device (B11): the reference's gatherHits /
processSetOfHits state machine (ref KmerGutsJava.java:457-514, :385-455)
over a batch of containers, as a hand-written CUDA kernel, its plain
PyTorch twin, the wrapper that picks between them by the tensors' device,
and the host decode of its records into report lines.

Replaces the device program that the JAX package writes in XLA for the
TPU, ``calls/scan_machine.py`` ``_scan_container`` (a ``lax.scan`` over one
container's hits) vmapped by ``scan_containers``. The machine's state is
bounded (19 ints and the float32 running weight: the state indices below
are the JAX module's), so it runs one step a hit; the OTU counter folds the
oI values of counted hits, which no bounded state holds, so the device
emits per call the list's start step and the last counted step, plus a
per-step appended flag, and the host rebuilds each call's counted oIs from
them and folds the counter (``gather_hits_scan_batch``).

The batch is ragged: ``hits`` int32 ``[n, 5]`` (position, oI,
avgOffFromEnd, fI and the float32 weight's bits; each container's hits in
position order) and ``offsets`` int64 ``[C + 1]``. Container c runs
``len_c + 1`` steps, step ``len_c`` being the final flush, as in the JAX
step numbering; its step s is output row ``offsets[c] + c + s``. Outputs:
``flags`` u8 ``[n + C]`` (bit 0: appended, bit 1: a CALL emitted) and
``recs`` int32 ``[n + C, 7]`` (fi, start, end, count, start step, end
step, the weight's bits), defined at emitting steps only (the twin writes
0 elsewhere). The JAX package pads containers into power-of-two buckets so
that XLA reuses compiled shapes; the port takes the ragged batch as it is.
The kernel takes the containers longest first (``length_order``), so that
the longest chains start first; output rows do not move.

The kernel (``csrc/scan_machine.cu``) is compiled with nvcc for sm_90a into
a plain-C shared library on first use and loaded with ctypes; nothing is
built or imported for CUDA when this module is imported.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..constants import K, MAX_HITS_PER_SEQ
from ..lookup.tilejoin import KernelError, build_cuda_library
from ..utils.javafmt import jformat
from .grouping import GroupingParams

# state indices (the JAX module's, :44-59)
(S_LEN,        # list length
 S_FIRST,      # first list position (hits[0].from0InProt)
 S_LASTPOS,    # last appended position
 S_LASTFI,     # last appended fI
 S_LASTAVG,    # last appended avgOffFromEnd
 S_L2FI,       # second-to-last fI
 S_CURFI,      # currentFI
 S_CNT,        # count of currentFI hits in list
 S_LASTCUR,    # position of last currentFI hit
 S_LASTCURSTEP,  # step index of last currentFI hit
 S_STARTSTEP,  # step index of first list element
 S_L2POS, S_L2AVG, S_L2OI, S_L2STEP,   # second-to-last hit fields
 S_L1POS, S_L1AVG, S_L1OI, S_L1STEP,   # last hit fields
 ) = range(19)
STATE_INTS = 19
REC_INTS = 7
HIT_COLS = 5  # pos, oi, avg, fi, weight bits
# the twin's state moves: a kept seed pair (process), the last hit's fields
# shifted to the second-to-last (append), the appended hit's fields
_KEEP_DST = [S_CURFI, S_FIRST, S_LASTCUR, S_LASTCURSTEP, S_STARTSTEP]
_KEEP_SRC = [S_LASTFI, S_L2POS, S_L1POS, S_L1STEP, S_L2STEP]
_SHIFT_DST = [S_L2FI, S_L2POS, S_L2AVG, S_L2OI, S_L2STEP]
_SHIFT_SRC = [S_LASTFI, S_L1POS, S_L1AVG, S_L1OI, S_L1STEP]
_LAST_DST = [S_LASTFI, S_LASTPOS, S_LASTAVG, S_L1POS, S_L1AVG, S_L1OI,
             S_L1STEP]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "scan_machine.cu")

# kernel launches since import (or since a caller reset it to 0); counted
# only where the wrapper launches the CUDA kernel, never for the twin
launches = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def load_kernel() -> ctypes.CDLL:
    """Build (once per process, and only when the source is newer than the
    library) and load the kernel library. Raises KernelError."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = build_cuda_library(SOURCE)
        p, i32 = ctypes.c_void_p, ctypes.c_int32
        lib.scan_machine.restype = ctypes.c_int
        lib.scan_machine.argtypes = [p, ctypes.c_int64, p, p,
                                     ctypes.c_int64, i32, ctypes.c_float,
                                     i32, i32, p, p, p]
        _lib = lib
        return lib


def pack_containers(containers: Sequence[Tuple]
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(hits int32 [n, 5], offsets int64 [C + 1]) of a list of containers,
    each (pos, oi, avg, fi, wt) arrays in position order."""
    lens = np.array([len(c[0]) for c in containers], np.int64)
    offsets = np.zeros(len(containers) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    hits = np.empty((int(offsets[-1]), HIT_COLS), np.int32)
    for (pos, oi, avg, fi, wt), a, b in zip(containers, offsets[:-1],
                                            offsets[1:]):
        hits[a:b, 0] = pos
        hits[a:b, 1] = oi
        hits[a:b, 2] = avg
        hits[a:b, 3] = fi
        hits[a:b, 4] = np.asarray(wt, np.float32).view(np.int32)
    return hits, offsets


def length_order(offsets: torch.Tensor) -> torch.Tensor:
    """The containers of a batch longest first, ties in batch order: int32
    [C] on offsets' device, the order in which the kernel's warps take
    them. The lengths are sorted as int32 (the kernel's own width), which
    halves the radix passes of an int64 sort."""
    lens = (offsets[1:] - offsets[:-1]).to(torch.int32)
    return torch.argsort(lens, descending=True, stable=True).to(torch.int32)


def scan_containers_reference(hits: torch.Tensor, offsets: torch.Tensor, *,
                              min_hits: int, min_weighted: int, max_gap: int,
                              order_constraint: bool
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: the JAX step function in torch, one
    step at a time across the containers. Containers run in order of
    decreasing length, so the ones still running at step s are a prefix.
    Returns (flags u8 [n + C], recs int32 [n + C, 7]) on hits' device, the
    records 0 at steps that do not emit."""
    dev = hits.device
    n = hits.shape[0]
    c = offsets.numel() - 1
    flags = torch.zeros(n + c, dtype=torch.uint8, device=dev)
    recs = torch.zeros((n + c, REC_INTS), dtype=torch.int32, device=dev)
    if c <= 0:
        return flags, recs
    lens_h = (offsets[1:] - offsets[:-1]).cpu().numpy()
    order = np.argsort(-lens_h, kind="stable")
    running = np.searchsorted(-lens_h[order], -np.arange(lens_h.max() + 2),
                              side="right")  # containers with len >= s
    perm = torch.from_numpy(order).to(dev)
    first = offsets[:-1][perm]
    lens = (offsets[1:] - offsets[:-1])[perm]
    base = first + perm
    wts = hits[:, 4].contiguous().view(torch.float32)
    st = torch.zeros((c, STATE_INTS), dtype=torch.int32, device=dev)
    wcur = torch.zeros(c, dtype=torch.float32, device=dev)
    min_w = torch.tensor(np.float32(min_weighted), device=dev)

    def weight_at(first_k, lens_k, step):
        if n == 0:
            return torch.zeros(step.shape, dtype=torch.float32, device=dev)
        s = torch.minimum(step.to(torch.int64).clamp(min=0),
                          (lens_k - 1).clamp(min=0))
        return wts[(first_k + s).clamp(max=n - 1)]

    def process(S, W, m, first_k, lens_k):
        """processSetOfHits on the rows ``m``: (emit, rec) from the state
        as it is, then the seed pair kept or the list cleared."""
        ok = (S[:, S_CNT] >= min_hits) & (W >= min_w)
        rec = torch.stack([S[:, S_CURFI], S[:, S_FIRST],
                           S[:, S_LASTCUR] + (K - 1), S[:, S_CNT],
                           S[:, S_STARTSTEP], S[:, S_LASTCURSTEP],
                           W.view(torch.int32)], dim=1)
        keep = m & (S[:, S_L2FI] != S[:, S_CURFI]) \
            & (S[:, S_L2FI] == S[:, S_LASTFI])
        w2 = (torch.zeros_like(W)
              + weight_at(first_k, lens_k, S[:, S_L2STEP])) \
            + weight_at(first_k, lens_k, S[:, S_L1STEP])
        new = S.clone()
        new[:, _KEEP_DST] = S[:, _KEEP_SRC]
        new = torch.where(keep[:, None], new, S)
        new[:, S_LEN] = torch.where(keep, 2, 0)
        new[:, S_CNT] = new[:, S_LEN]
        S.copy_(torch.where(m[:, None], new, S))
        W.copy_(torch.where(keep, w2, torch.where(m, 0.0, W)))
        return ok & m, rec

    for s in range(int(lens_h.max()) + 1):
        k = int(running[s])
        S, W = st[:k], wcur[:k]
        first_k, lens_k = first[:k], lens[:k]
        hit = lens_k > s
        if n:
            j = (first_k + torch.minimum(lens_k - 1, torch.full_like(
                lens_k, s)).clamp(min=0)).clamp(max=n - 1)
            row = hits[j]
            p, o, a, f = row[:, 0], row[:, 1], row[:, 2], row[:, 3]
            w = wts[j]
        else:
            p = o = a = f = torch.zeros(k, dtype=torch.int32, device=dev)
            w = torch.zeros(k, dtype=torch.float32, device=dev)
        emit = torch.zeros(k, dtype=torch.bool, device=dev)
        rec = torch.zeros((k, REC_INTS), dtype=torch.int32, device=dev)

        def fire(m):
            """process() on the rows ``m``, if any; a step keeps the record
            of its first emission, as the JAX step does."""
            nonlocal emit, rec
            if bool(m.any()):
                e, r = process(S, W, m, first_k, lens_k)
                rec = torch.where((e & ~emit)[:, None], r, rec)
                emit = emit | e

        # gap close (ref :477-484)
        gap = hit & (S[:, S_LEN] > 0) & (S[:, S_LASTPOS] + max_gap < p)
        if bool(gap.any()):
            drop = gap & (S[:, S_LEN] < min_hits)
            fire(gap & (S[:, S_LEN] >= min_hits))
            S[:, S_LEN] = torch.where(drop, 0, S[:, S_LEN])
            S[:, S_CNT] = torch.where(drop, 0, S[:, S_CNT])
            W.copy_(torch.where(drop, 0.0, W))
        # currentFI reset on an empty list (ref :486-488)
        S[:, S_CURFI] = torch.where(hit & (S[:, S_LEN] == 0), f,
                                    S[:, S_CURFI])
        # order constraint (ref :490-494)
        if order_constraint:
            collinear = (f == S[:, S_LASTFI]) & (
                ((p - S[:, S_LASTPOS]) - (S[:, S_LASTAVG] - a)).abs() <= 20)
            accept = hit & ((S[:, S_LEN] == 0) | collinear)
        else:
            accept = hit
        # append (ref :496-502)
        app = accept & (S[:, S_LEN] < MAX_HITS_PER_SEQ - 2)
        cur = f == S[:, S_CURFI]
        W.copy_(torch.where(app & cur, W + w, W))
        step = torch.full_like(p, s)
        new = S.clone()
        empty = S[:, S_LEN] == 0
        new[:, S_FIRST] = torch.where(empty, p, S[:, S_FIRST])
        new[:, S_STARTSTEP] = torch.where(empty, step, S[:, S_STARTSTEP])
        new[:, S_LEN] += 1
        new[:, _SHIFT_DST] = S[:, _SHIFT_SRC]
        new[:, _LAST_DST] = torch.stack([f, p, a, p, a, o, step], dim=1)
        new[:, S_CNT] += cur.to(torch.int32)
        new[:, S_LASTCUR] = torch.where(cur, p, S[:, S_LASTCUR])
        new[:, S_LASTCURSTEP] = torch.where(cur, step, S[:, S_LASTCURSTEP])
        S.copy_(torch.where(app[:, None], new, S))
        # pair trigger (ref :503-508), checked even when the append was
        # capped
        fire(accept & (S[:, S_LEN] > 1) & (S[:, S_CURFI] != f)
             & (S[:, S_L2FI] == S[:, S_LASTFI]))
        # final flush at the sentinel step (ref :511-513)
        fire(~hit & (S[:, S_LEN] >= min_hits))
        rows = base[:k] + s
        flags[rows] = app.to(torch.uint8) | (emit.to(torch.uint8) << 1)
        recs[rows] = rec * emit[:, None].to(torch.int32)
    return flags, recs


def _check(hits, offsets, order) -> None:
    if hits.dtype != torch.int32 or hits.dim() != 2 \
            or hits.shape[1] != HIT_COLS or not hits.is_contiguous():
        raise KernelError(f"hits must be a contiguous int32 [n, {HIT_COLS}] "
                          f"tensor, got {hits.dtype} {tuple(hits.shape)}")
    if offsets.dtype != torch.int64 or offsets.dim() != 1 \
            or offsets.numel() < 1 or not offsets.is_contiguous():
        raise KernelError("offsets must be a contiguous 1-D int64 tensor of "
                          f"C + 1 entries, got {offsets.dtype} "
                          f"{tuple(offsets.shape)}")
    if offsets.device != hits.device:
        raise KernelError(f"offsets are on {offsets.device}, hits on "
                          f"{hits.device}")
    if order is not None and (
            order.dtype != torch.int32 or order.dim() != 1
            or order.numel() != offsets.numel() - 1
            or not order.is_contiguous() or order.device != hits.device):
        raise KernelError(f"order must be a contiguous int32 tensor of the "
                          f"{offsets.numel() - 1} containers on "
                          f"{hits.device}, got {order.dtype} "
                          f"{tuple(order.shape)} on {order.device}")


def scan_containers(hits: torch.Tensor, offsets: torch.Tensor, *,
                    min_hits: int, min_weighted: int, max_gap: int,
                    order_constraint: bool,
                    order: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The machine over every container of the ragged batch: (flags u8
    [n + C], recs int32 [n + C, 7]) on the inputs' device. CPU tensors run
    the plain twin; CUDA tensors launch the kernel on the current stream
    (or raise KernelError). ``order`` is the order in which the kernel
    takes the containers (a permutation; ``length_order(offsets)`` when
    not given); it moves no output. The records of steps that do not emit
    are left as they are on the card (the twin's are 0)."""
    global launches
    _check(hits, offsets, order)
    kw = dict(min_hits=min_hits, min_weighted=min_weighted, max_gap=max_gap,
              order_constraint=order_constraint)
    dev = hits.device
    if dev.type == "cpu":
        return scan_containers_reference(hits, offsets, **kw)
    if dev.type != "cuda":
        raise KernelError(f"no scan machine kernel for device {dev}")
    n, c = hits.shape[0], offsets.numel() - 1
    flags = torch.empty(n + c, dtype=torch.uint8, device=dev)
    recs = torch.empty((n + c, REC_INTS), dtype=torch.int32, device=dev)
    if c == 0:
        return flags, recs
    if hits.data_ptr() % 16:
        raise KernelError("hits must start on a 16-byte boundary on the "
                          "card (the kernel copies whole 16-byte blocks)")
    if order is None:
        order = length_order(offsets)
    lib = load_kernel()
    rc = lib.scan_machine(hits.data_ptr(), n, offsets.data_ptr(),
                          order.data_ptr(), c,
                          int(min_hits), float(np.float32(min_weighted)),
                          int(max_gap), int(bool(order_constraint)),
                          flags.data_ptr(), recs.data_ptr(),
                          torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise KernelError(f"scan machine kernel launch failed: CUDA error "
                          f"{rc}")
    with _lock:
        launches += 1
    return flags, recs


def gather_hits_scan_batch(containers: List[Tuple], functions: Sequence[str],
                           p: GroupingParams, device: str = "cuda"):
    """Run a batch of containers through the machine on ``device``.

    ``containers``: list of (pos, oi, avg, fi, wt) numpy arrays (sorted by
    position). Returns a list (per container) of (call_lines, otu_updates)
    where otu_updates is [(oi, inc), ...] in fold order; the caller applies
    them to its per-sequence counter with _otu_add_batch. Only the flags
    and the emitting steps' records are read back."""
    from ..lookup.sparse import _device_fault, torch_device

    if p.debug or p.min_hits < 2:
        raise ValueError("scan machine supports non-debug, min_hits >= 2")
    hits, offsets = pack_containers(containers)
    dev = torch_device(device)
    with _device_fault("run", "scan machine"):
        flags_d, recs_d = scan_containers(
            torch.from_numpy(hits).to(dev), torch.from_numpy(offsets).to(dev),
            min_hits=p.min_hits, min_weighted=p.min_weighted_hits,
            max_gap=p.max_gap, order_constraint=p.order_constraint)
        emitting = torch.nonzero(flags_d & 2).squeeze(1)
        recs = recs_d[emitting].cpu().numpy()
        flags = flags_d.cpu().numpy()
    rows = emitting.cpu().numpy()
    c = len(containers)
    base = offsets[:-1] + np.arange(c)
    owner = np.searchsorted(base, rows, side="right") - 1
    appended = (flags & 1).astype(bool)
    oi_col, fi_col = hits[:, 1], hits[:, 3]
    results = [([], []) for _ in range(c)]
    for i, rec in zip(owner.tolist(), recs):
        lines, updates = results[i]
        call_fi, start, end, count, sstep, estep, wbits = (int(x) for x in rec)
        weight = np.int32(wbits).view(np.float32)
        lines.append("CALL\t%d\t%d\t%d\t%d\t%s\t%s" % (
            start, end, count, call_fi, functions[call_fi],
            jformat(float(weight))))
        # counted hits: appended steps in [sstep, estep] with the call's
        # function index, in order (ref :411-439)
        h0, b0 = int(offsets[i]), int(base[i])
        sel = np.nonzero(appended[b0 + sstep: b0 + estep + 1]
                         & (fi_col[h0 + sstep: h0 + estep + 1] == call_fi))[0]
        ois = oi_col[h0 + sstep: h0 + estep + 1][sel]
        if len(ois):
            bounds = np.concatenate(
                [[0], np.nonzero(np.diff(ois))[0] + 1, [len(ois)]])
            for x, y in zip(bounds[:-1], bounds[1:]):
                updates.append((int(ois[x]), int(y - x)))
    return results
