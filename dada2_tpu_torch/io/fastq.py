"""Streaming fastq(.gz) reader/writer.

Host-side I/O stage feeding the device pipeline (reference uses
ShortRead::FastqStreamer, R/sequenceIO.R:56-64). Reads are yielded in chunks
to bound peak memory, mirroring the reference's n=1e6 chunking.
"""
from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np

PHRED_OFFSET = 33


@dataclass
class FastqChunk:
    ids: List[bytes]          # header lines without '@'
    seqs: List[bytes]
    quals: List[bytes]        # raw phred+33 bytes

    def __len__(self):
        return len(self.seqs)


def _open(path: str, mode: str = "rb"):
    if path.endswith(".gz"):
        return gzip.open(path, mode)
    if path.endswith(".bz2"):
        import bz2
        return bz2.open(path, mode)
    return open(path, mode)


def stream_fastq(path: str, n: int = 1_000_000) -> Iterator[FastqChunk]:
    """Yield chunks of up to n reads."""
    with _open(path) as fh:
        fh = io.BufferedReader(fh) if not isinstance(fh, io.BufferedReader) else fh
        ids: List[bytes] = []
        seqs: List[bytes] = []
        quals: List[bytes] = []
        while True:
            h = fh.readline()
            if not h:
                break
            s = fh.readline().rstrip(b"\r\n")
            plus = fh.readline()
            q = fh.readline().rstrip(b"\r\n")
            if not q and not s:
                break
            if not h.startswith(b"@"):
                raise ValueError(f"Malformed fastq record in {path!r}")
            ids.append(h[1:].rstrip(b"\r\n"))
            seqs.append(s)
            quals.append(q)
            if len(seqs) >= n:
                yield FastqChunk(ids, seqs, quals)
                ids, seqs, quals = [], [], []
        if seqs:
            yield FastqChunk(ids, seqs, quals)


def read_fastq(path: str) -> FastqChunk:
    ids: List[bytes] = []
    seqs: List[bytes] = []
    quals: List[bytes] = []
    for ch in stream_fastq(path):
        ids += ch.ids
        seqs += ch.seqs
        quals += ch.quals
    return FastqChunk(ids, seqs, quals)


def write_fastq(path: str, ids, seqs, quals, append: bool = False,
                compress: bool | None = None) -> None:
    if compress is None:
        compress = path.endswith(".gz")
    mode = "ab" if append else "wb"
    raw = open(path, mode)
    # compresslevel 6 matches R's zlib default (writeFastq); one joined
    # buffer per chunk instead of a write() per record
    fh = (gzip.GzipFile(fileobj=raw, mode=mode, compresslevel=6)
          if compress else raw)
    try:
        parts = []
        for i, s, q in zip(ids, seqs, quals):
            if isinstance(i, str):
                i = i.encode()
            if isinstance(s, str):
                s = s.encode()
            if isinstance(q, str):
                q = q.encode()
            parts.append(b"@" + i + b"\n" + s + b"\n+\n" + q + b"\n")
            if len(parts) >= 20000:
                fh.write(b"".join(parts))
                parts.clear()
        if parts:
            fh.write(b"".join(parts))
    finally:
        if fh is not raw:
            fh.close()
        raw.close()


def quals_to_matrix(quals: List[bytes],
                    offset: int = PHRED_OFFSET) -> np.ndarray:
    """[n, maxlen] float64 phred scores; NaN beyond each read's length."""
    n = len(quals)
    lens = np.array([len(q) for q in quals], dtype=np.int64)
    L = int(lens.max()) if n else 0
    out = np.full((n, L), np.nan)
    for i, q in enumerate(quals):
        out[i, : lens[i]] = (
            np.frombuffer(q, dtype=np.uint8).astype(np.float64) - offset
        )
    return out


def phred_offset_for(qualityType: str) -> int:
    """Map the reference's qualityType names to a phred offset.

    reference: derepFastq(qualityType=) forwards to ShortRead's
    FastqStreamer (R/sequenceIO.R:45-64): "FastqQuality" = phred+33,
    "SFastqQuality" = Illumina 1.3+ phred+64; "Auto" lets ShortRead sniff
    — modern data is universally phred+33, which is what Auto resolves to
    here."""
    table = {"Auto": 33, "FastqQuality": 33, "SFastqQuality": 64}
    if qualityType not in table:
        raise ValueError(
            f"Unknown qualityType {qualityType!r}; expected one of "
            f"{sorted(table)}")
    return table[qualityType]


def parse_fastq_directory(path: str) -> List[str]:
    """All fastq-ish files in a directory (reference: R/sequenceIO.R:332-356)."""
    exts = (".fastq", ".fq", ".fastq.gz", ".fq.gz", ".fastq.bz2", ".fq.bz2")
    fls = sorted(
        os.path.join(path, f) for f in os.listdir(path) if f.endswith(exts)
    )
    if not fls:
        raise ValueError(f"No fastq files found in directory {path!r}")
    return fls
