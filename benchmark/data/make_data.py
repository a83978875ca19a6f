"""Regenerate the benchmark's data files from the repo's test data (run
once, from the repo root: `python benchmark/data/make_data.py`; the
benchmark itself only reads the files this writes):

- v4_asvs.txt.gz: the 240 nt after the 515F primer (GTGCCAGCMGCCGCGGTAA,
  E. coli 515-533) of each full-length 16S record of
  tests/extdata/ten_16s.100.fa.gz, the MiSeq SOP's V4 read truncated at
  truncLen 240; records whose cut is not all A/C/G/T are left out;
  distinct cuts in record order, one a line.
- fl16s_asvs.txt.gz: the records of 1,400-1,600 nt that are all A/C/G/T,
  distinct, in record order (full-length 16S amplicons after DADA2's
  PacBio filter, minLen 1000, maxLen 1600).
- quality.json: by position, over the reads that cover it: the mean
  Phred quality of tests/extdata/sam1F.fastq.gz (first 240 positions),
  and the Phred value of the mean error probability of
  tests/extdata/samPB.fastq.gz (first 1,600; CCS qualities are bimodal,
  so their mean would hide nearly every error: this keeps samPB's
  expected errors per read, 0.30 over 1,450 nt), capped at 93 and carried
  past the last covered position.
- tperr1.npy: DADA2's tperr1 error matrix (16 x 41, q 0-40), read from the
  program's copy of tperr1.rda.
"""
import gzip
import json
import os
import re
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
EXT = os.path.join(ROOT, "tests", "extdata")
PRIMER_515F = re.compile("GTGCCAGC[AC]GCCGCGGTAA")


def fasta(path):
    recs = []
    with gzip.open(path, "rt") as fh:
        for line in fh:
            line = line.strip()
            if line.startswith(">"):
                recs.append([])
            elif line:
                recs[-1].append(line.upper())
    return ["".join(r) for r in recs]


def mean_quality(path, n, of_error_rate=False):
    tot = np.zeros(n)
    cnt = np.zeros(n)
    with gzip.open(path, "rt") as fh:
        lines = fh.read().split("\n")
    for q in lines[3::4]:
        v = np.frombuffer(q.encode()[:n], np.uint8).astype(float) - 33
        tot[:len(v)] += 10 ** (-v / 10) if of_error_rate else v
        cnt[:len(v)] += 1
    covered = int(np.nonzero(cnt)[0].max()) + 1
    m = tot[:covered] / cnt[:covered]
    if of_error_rate:
        m = np.minimum(-10 * np.log10(m), 93.0)
    m = np.concatenate([m, np.full(n - covered, m[-1])])
    return [round(float(x), 4) for x in m]


def distinct(seqs):
    seen, out = set(), []
    for s in seqs:
        if s not in seen and set(s) <= set("ACGT"):
            seen.add(s)
            out.append(s)
    return out


def main():
    recs = fasta(os.path.join(EXT, "ten_16s.100.fa.gz"))
    v4 = []
    for r in recs:
        m = PRIMER_515F.search(r)
        if m and len(r) >= m.end() + 240:
            v4.append(r[m.end():m.end() + 240])
    fl = [r for r in recs if 1400 <= len(r) <= 1600]
    for name, seqs in (("v4_asvs", distinct(v4)), ("fl16s_asvs", distinct(fl))):
        with gzip.GzipFile(os.path.join(HERE, name + ".txt.gz"), "wb",
                           mtime=0) as fh:
            fh.write(("\n".join(seqs) + "\n").encode())
    with open(os.path.join(HERE, "quality.json"), "w") as fh:
        json.dump({"sam1F": mean_quality(os.path.join(EXT, "sam1F.fastq.gz"), 240),
                   "samPB": mean_quality(os.path.join(EXT, "samPB.fastq.gz"), 1600,
                                        of_error_rate=True)},
                  fh)
        fh.write("\n")
    sys.path.insert(0, ROOT)
    from dada2_tpu_torch.data import tperr1
    np.save(os.path.join(HERE, "tperr1.npy"), np.asarray(tperr1(), np.float64))


if __name__ == "__main__":
    main()
