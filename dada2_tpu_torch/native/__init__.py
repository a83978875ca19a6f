"""Native (C++) host runtime components, loaded through ctypes.

The shared library is compiled on demand with g++ (no pybind11 in this
environment) and cached next to the source; every native entry point has a
pure-Python fallback, so a missing toolchain only costs speed.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

from .. import trace
from ..trace import PHASES

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "io_native.cpp"),
         os.path.join(_HERE, "rmath_native.cpp"),
         os.path.join(_HERE, "lambda_native.cpp"),
         os.path.join(_HERE, "shuffle_native.cpp")]
_HDRS = [os.path.join(_HERE, "rmath_ppois.h")]
_LIB = os.path.join(_HERE, "io_native.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_failed = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-ffp-contract=off",
             "-shared", "-fPIC", "-o", _LIB] + _SRCS + ["-lz"],
            check=True, capture_output=True)
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The native library, building it if needed; None if unavailable.

    DADA2_TPU_NATIVE=0 and the module-level _failed flag are honored on
    EVERY call (not just the first), so the pure-Python fallback can be
    forced at any point — the parity tests rely on this."""
    global _lib, _failed
    if _failed or os.environ.get("DADA2_TPU_NATIVE", "1") == "0":
        return None
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None or _failed:
            return _lib
        with PHASES("build.native"):
            fresh = (os.path.exists(_LIB) and
                     all(os.path.getmtime(_LIB) >= os.path.getmtime(f)
                         for f in _SRCS + _HDRS))
            trace.attrs(built=not fresh)
            if not fresh and not _build():
                _failed = True
                return None
            try:
                lib = ctypes.CDLL(_LIB)
            except OSError:
                _failed = True
                return None
        lib.derep_fastq_native.restype = ctypes.c_void_p
        lib.derep_fastq_native.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                           ctypes.c_int]
        lib.dr_error.restype = ctypes.c_char_p
        lib.dr_error.argtypes = [ctypes.c_void_p]
        for fn in ("dr_nuniq", "dr_nreads"):
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = [ctypes.c_void_p]
        lib.dr_maxlen.restype = ctypes.c_int
        lib.dr_maxlen.argtypes = [ctypes.c_void_p]
        lib.dr_fill.restype = None
        lib.dr_fill.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_void_p]
        lib.dr_free.restype = None
        lib.dr_free.argtypes = [ctypes.c_void_p]
        V, I = ctypes.c_void_p, ctypes.c_int64
        lib.lam_dense_i8.restype = None
        lib.lam_dense_i8.argtypes = [I, I, V, V, V, I, V, V, I, V]
        lib.lam_dense_i64.restype = None
        lib.lam_dense_i64.argtypes = [I, I, V, V, V, I, V, V, I, V]
        lib.lam_subs.restype = None
        lib.lam_subs.argtypes = [I, V, V, V, I, V, V, I, V, V, I, V]
        lib.lam_gapless.restype = None
        lib.lam_gapless.argtypes = [I, I, V, V, V, I, V, V, I, V]
        lib.dada2_shuffle_best.restype = None
        lib.dada2_shuffle_best.argtypes = [I, V, V, ctypes.c_double, I,
                                           V, V, V, V, V, V, V, V, V]
        lib.dada2_shuffle_move.restype = None
        lib.dada2_shuffle_move.argtypes = [I, V, V, V, V, V, V, V, V, V]
        lib.dada2_exp_neg_batch.restype = None
        lib.dada2_exp_neg_batch.argtypes = [V, V, I]
        _lib = lib
        return _lib


def _ptr(a):
    """The address of a numpy array's data, for a c_void_p argument (the
    plain integer: ctypes' data_as costs several microseconds a call,
    and the engine's shuffle passes make thousands)."""
    return a.ctypes.data


def lam_dense_native(tvec, idx, quals, lens, err):
    """Native batch of the sequential-f64 lambda product over dense
    transition rows; returns float64[m] or None if the library is
    unavailable or tvec's dtype has no native entry."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    if tvec.dtype == np.int8:
        fn = lib.lam_dense_i8
    elif tvec.dtype == np.int64:
        fn = lib.lam_dense_i64
    else:
        return None
    m, L = tvec.shape
    out = np.empty(m, np.float64)
    tvec = np.ascontiguousarray(tvec)
    idx = np.ascontiguousarray(idx, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    err = np.ascontiguousarray(err, np.float64)
    if quals is None:
        qp, W = None, 0
    else:
        qp, W = _ptr(quals), quals.shape[1]
    fn(m, L, _ptr(tvec), _ptr(idx), qp, W, _ptr(lens), _ptr(err),
       err.shape[1], _ptr(out))
    return out


def lam_subs_native(idx, seqs, quals, lens, subs, counts, err):
    """Native lambda from substitution tiles (t = 5*s1 except tile
    entries); returns float64[m] or None."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    m, K = subs.shape
    out = np.empty(m, np.float64)
    idx = np.ascontiguousarray(idx, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    subs = np.ascontiguousarray(subs, np.uint16)
    counts = np.ascontiguousarray(counts, np.int64)
    err = np.ascontiguousarray(err, np.float64)
    qp = _ptr(quals) if quals is not None else None
    lib.lam_subs(m, _ptr(idx), _ptr(seqs), qp, seqs.shape[1], _ptr(lens),
                 _ptr(subs), K, _ptr(counts), _ptr(err), err.shape[1],
                 _ptr(out))
    return out


def shuffle_best_native(c0lam, c0ham, c0reads, offs, idx, lam, ham,
                        bireads):
    """Native fused best-E scan for Engine.shuffle (strict >, ascending
    cluster order — bit-identical to the numpy per-cluster loop).
    Returns (best_i, best_lam, best_ham, emax) or None."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    n = len(c0lam)
    nclust = len(bireads)
    c0lam = np.ascontiguousarray(c0lam, np.float64)
    c0ham = np.ascontiguousarray(c0ham, np.int64)
    offs = np.ascontiguousarray(offs, np.int64)
    idx = np.ascontiguousarray(idx, np.int64)
    lam = np.ascontiguousarray(lam, np.float64)
    ham = np.ascontiguousarray(ham, np.int64)
    bireads = np.ascontiguousarray(bireads, np.float64)
    best_i = np.empty(n, np.int64)
    best_lam = np.empty(n, np.float64)
    best_ham = np.empty(n, np.int64)
    emax = np.empty(n, np.float64)
    lib.dada2_shuffle_best(
        n, _ptr(c0lam), _ptr(c0ham), float(c0reads), nclust, _ptr(offs),
        _ptr(idx), _ptr(lam), _ptr(ham), _ptr(bireads), _ptr(best_i),
        _ptr(best_lam), _ptr(best_ham), _ptr(emax))
    return best_i, best_lam, best_ham, emax


def shuffle_move_native(pop_raws, app_raws, app_tgts, ptrs, lens, reads,
                        cluster_of, slot_of, raw_reads):
    """Native surgery for Membership.move, in place: pops pop_raws in
    order, then appends app_raws to app_tgts in order. ptrs holds the
    address of each cluster's slot array, every one large enough for its
    appends. Returns True, or None if the library is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    for a in (lens, reads, cluster_of, slot_of):
        if a.dtype != np.int64 or not a.flags.c_contiguous:
            raise ValueError("shuffle_move_native updates C-contiguous "
                             "int64 arrays in place")
    if ptrs.dtype != np.uintp or len(ptrs) < len(lens):
        raise ValueError("ptrs must hold one address per cluster")
    pop_raws = np.ascontiguousarray(pop_raws, np.int64)
    app_raws = np.ascontiguousarray(app_raws, np.int64)
    app_tgts = np.ascontiguousarray(app_tgts, np.int64)
    raw_reads = np.ascontiguousarray(raw_reads, np.int64)
    ptrs = np.ascontiguousarray(ptrs)
    m = len(pop_raws)
    if len(app_raws) != m or len(app_tgts) != m:
        raise ValueError("every mover is popped once and appended once")
    lib.dada2_shuffle_move(m, _ptr(pop_raws), _ptr(app_raws),
                           _ptr(app_tgts), _ptr(ptrs), _ptr(lens),
                           _ptr(reads), _ptr(cluster_of), _ptr(slot_of),
                           _ptr(raw_reads))
    return True


def exp_neg_native(E):
    """libm exp(-E) batch (bit-identical to [math.exp(-e) for e in E]:
    both call libm's exp), GIL-free; float64[n] or None."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    E = np.ascontiguousarray(E, np.float64)
    out = np.empty(len(E), np.float64)
    lib.dada2_exp_neg_batch(_ptr(E), _ptr(out), len(E))
    return out


def lam_gapless_native(center, idx, seqs, quals, lens, err):
    """Native lambda for pad-to-length (gapless) pairs vs one center;
    returns float64[m] or None."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    m = len(idx)
    out = np.empty(m, np.float64)
    idx = np.ascontiguousarray(idx, np.int64)
    lens = np.ascontiguousarray(lens, np.int32)
    err = np.ascontiguousarray(err, np.float64)
    qp = _ptr(quals) if quals is not None else None
    lib.lam_gapless(m, int(center), _ptr(idx), _ptr(seqs), qp,
                    seqs.shape[1], _ptr(lens), _ptr(err), err.shape[1],
                    _ptr(out))
    return out


def derep_fastq_native(path: str, chunk_size: int = 1_000_000,
                       phred_offset: int = 33):
    """Dereplicate a fastq file with the C++ loader.

    Returns (uniq_seqs list[str], counts int64[n], quals float64[n, L]
    (mean, NaN-padded), read_map int64[nreads]) or None if the native
    library is unavailable."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return None
    handle = lib.derep_fastq_native(path.encode(), chunk_size,
                                    int(phred_offset))
    try:
        err = lib.dr_error(handle)
        if err:
            raise ValueError(f"{err.decode()} in {path!r}")
        n = lib.dr_nuniq(handle)
        nreads = lib.dr_nreads(handle)
        ml = lib.dr_maxlen(handle)
        seqs = ctypes.create_string_buffer(int(n * ml))
        counts = np.zeros(n, np.int64)
        quals = np.zeros((n, ml))
        rmap = np.zeros(nreads, np.int64)
        lib.dr_fill(handle, seqs,
                    counts.ctypes.data_as(ctypes.c_void_p),
                    quals.ctypes.data_as(ctypes.c_void_p),
                    rmap.ctypes.data_as(ctypes.c_void_p))
        raw = seqs.raw
        out_seqs = [raw[i * ml:(i + 1) * ml].rstrip(b"\x00").decode("ascii")
                    for i in range(n)]
        return out_seqs, counts, quals, rmap
    finally:
        lib.dr_free(handle)
