"""Minimal reader for R serialization (.rda / .rds), XDR binary format.

Supports just enough of R's serialization format (version 2/3) to load the
numeric matrices bundled as package data (tperr1, errBalancedF/R) — REALSXP,
INTSXP, STRSXP, VECSXP, LGLSXP, pairlists, symbols and attributes.
"""
from __future__ import annotations

import gzip
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# SEXP type codes
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
CHARSXP = 9
LGLSXP = 10
INTSXP = 13
REALSXP = 14
STRSXP = 16
VECSXP = 19
REFSXP = 255
NILVALUE_SXP = 254
GLOBALENV_SXP = 253
MISSINGARG_SXP = 251
BASENAMESPACE_SXP = 252
NAMESPACESXP = 21
ALTREP_SXP = 238
ATTRLISTSXP = 239  # not real; placeholder


class RObject:
    def __init__(self, value: Any, attributes: Optional[Dict[str, Any]] = None):
        self.value = value
        self.attributes = attributes or {}

    def __repr__(self):
        return f"RObject({type(self.value).__name__}, attrs={list(self.attributes)})"


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.refs: List[Any] = []

    def _read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        self.pos += n
        return b

    def i4(self) -> int:
        return struct.unpack(">i", self._read(4))[0]

    def f8(self, n: int) -> np.ndarray:
        return np.frombuffer(self._read(8 * n), dtype=">f8").astype(np.float64)

    def i4v(self, n: int) -> np.ndarray:
        return np.frombuffer(self._read(4 * n), dtype=">i4").astype(np.int32)

    def read_header(self):
        magic = self._read(2)
        if magic != b"X\n":
            raise ValueError("Only XDR-format R serialization is supported")
        version = self.i4()
        self.i4()  # writer version
        self.i4()  # min reader version
        if version >= 3:
            n = self.i4()
            self._read(n)  # native encoding

    def item(self):
        flags = self.i4()
        stype = flags & 255
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if stype == NILVALUE_SXP or stype == NILSXP:
            return None
        if stype == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.i4()
            return self.refs[idx - 1]
        if stype == SYMSXP:
            name = self.item()
            self.refs.append(name)
            return name
        if stype == CHARSXP:
            n = self.i4()
            if n == -1:
                return None
            return self._read(n).decode("utf-8", "replace")
        if stype == LISTSXP:
            attr = self.item() if has_attr else None
            tag = self.item() if has_tag else None
            car = self.item()
            cdr = self.item()
            return ("pairlist", tag, car, cdr, attr)
        if stype in (LGLSXP, INTSXP):
            n = self.i4()
            v = self.i4v(n)
            obj = RObject(v if stype == INTSXP else (v != 0))
            self._attrs(obj, has_attr)
            return obj
        if stype == REALSXP:
            n = self.i4()
            obj = RObject(self.f8(n))
            self._attrs(obj, has_attr)
            return obj
        if stype == STRSXP:
            n = self.i4()
            obj = RObject([self.item() for _ in range(n)])
            self._attrs(obj, has_attr)
            return obj
        if stype == VECSXP:
            n = self.i4()
            obj = RObject([self.item() for _ in range(n)])
            self._attrs(obj, has_attr)
            return obj
        raise ValueError(f"Unsupported SEXP type {stype} in R data file")

    def _attrs(self, obj: RObject, has_attr: bool):
        if not has_attr:
            return
        a = self.item()
        while a is not None:
            _, tag, car, cdr, _ = a
            obj.attributes[tag] = car
            a = cdr


def _to_python(obj):
    if not isinstance(obj, RObject):
        return obj
    val = obj.value
    dim = obj.attributes.get("dim")
    if dim is not None and isinstance(val, np.ndarray):
        shape = tuple(int(x) for x in dim.value)
        val = val.reshape(shape, order="F")  # R matrices are column-major
    names = obj.attributes.get("dimnames")
    out = {"value": val}
    if names is not None:
        out["dimnames"] = [
            None if d is None else list(d.value) for d in names.value
        ]
        return out
    return val


def load_rda(path: str) -> Dict[str, Any]:
    """Load all objects from an .rda file into a dict name -> value."""
    with open(path, "rb") as fh:
        head = fh.read(2)
        fh.seek(0)
        data = gzip.open(fh).read() if head == b"\x1f\x8b" else fh.read()
    if not data.startswith((b"RDX2\n", b"RDX3\n")):
        raise ValueError("Not an R .rda file")
    r = _Reader(data[5:])
    r.read_header()
    out: Dict[str, Any] = {}
    item = r.item()
    while item is not None:
        kind, tag, car, cdr, _ = item
        out[tag] = _to_python(car)
        item = cdr
    return out


def load_rds(path: str):
    with open(path, "rb") as fh:
        head = fh.read(2)
        fh.seek(0)
        data = gzip.open(fh).read() if head == b"\x1f\x8b" else fh.read()
    r = _Reader(data)
    r.read_header()
    return _to_python(r.item())
