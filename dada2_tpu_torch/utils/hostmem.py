"""Host allocator tuning for large-array workloads.

The engine's host side (rawset packing, exact-lambda products, shuffle
bookkeeping) allocates tens-of-MB numpy temporaries every round. glibc
malloc serves allocations above M_MMAP_THRESHOLD (128KB default) with
fresh anonymous mmaps and returns them to the kernel on free, so every
round re-pays the first-touch page faults — on lazily-backed VM memory
(this rig) that is ~100x slower than the compute itself: a 43MB
``np.floor(q + 0.5)`` measures ~4s cold vs ~20ms on reused heap pages.

Raising M_MMAP_THRESHOLD/M_TRIM_THRESHOLD keeps big buffers on the
heap, where freed pages are faulted once and reused for the rest of
the process. This is process-wide allocator policy, applied once at
package import; DADA2_TPU_MALLOC_TUNE=0 disables it.

The reference leans on R's gc-managed heap plus per-alignment C++
buffers small enough to stay under the mmap threshold, so it never
hits this cliff; a tensor-batched engine does, hence the explicit
policy here.
"""
from __future__ import annotations

import ctypes
import os

# glibc malloc.h mallopt parameter codes
M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3

_done = False


def tune_malloc(threshold: int = 1 << 30) -> bool:
    """Raise glibc's mmap/trim thresholds so large numpy temporaries
    reuse already-faulted heap pages instead of fresh mmaps. Idempotent;
    returns True if applied. No-op (False) on non-glibc platforms or
    when DADA2_TPU_MALLOC_TUNE=0."""
    global _done
    if _done:
        return True
    if os.environ.get("DADA2_TPU_MALLOC_TUNE", "1") == "0":
        return False
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        mallopt = libc.mallopt
    except (OSError, AttributeError):
        return False
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt.restype = ctypes.c_int
    ok = bool(mallopt(M_MMAP_THRESHOLD, threshold))
    ok = bool(mallopt(M_TRIM_THRESHOLD, threshold)) and ok
    _done = ok
    return ok


def prefault(nbytes: int) -> None:
    """Fault in ~nbytes of heap in the CALLING thread's malloc arena and
    free it, so the thread's next large allocations reuse warm pages.
    Only useful after tune_malloc() (otherwise the buffer is mmap'd and
    returned to the kernel on free)."""
    import numpy as np

    buf = np.empty(max(nbytes, 1), dtype=np.uint8)
    buf[:: 4096] = 0  # touch every page
    del buf
