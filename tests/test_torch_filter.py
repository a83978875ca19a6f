"""Parity: the port's filtering, primer removal and derep_fasta
(dada2_tpu_torch.filter, .derep; host code) against dada2_tpu's, on the
bundled MiSeq and PacBio reads: every written fastq is byte-identical
after gunzip, every returned count and table equal."""
import gzip

import numpy as np
import pandas as pd
import pytest

import dada2_tpu as dj
import dada2_tpu_torch as dt
from dada2_tpu import filter as fj
from dada2_tpu_torch import filter as ft

PKGS = {"j": dj, "t": dt}


def _text(path):
    with gzip.open(path, "rb") as f:
        return f.read()


def _both(tmp_path, run, outs):
    """run(pkg, prefix) for each package; the written files, gunzipped,
    must be identical; returns both results."""
    res = {}
    for tag, pkg in PKGS.items():
        res[tag] = run(pkg, str(tmp_path / tag))
    for name in outs:
        assert _text(f"{tmp_path / 't'}{name}") == \
            _text(f"{tmp_path / 'j'}{name}"), name
    return res["j"], res["t"]


@pytest.mark.parametrize("kw", [
    dict(maxN=0, maxEE=2, truncLen=240),
    dict(trimLeft=10, truncLen=200, maxEE=2),
    dict(truncQ=11, minLen=100, maxLen=251, minQ=3, rm_phix=False),
    dict(trimRight=15, maxEE=1.5, rm_lowcomplex=8, n=400),
], ids=["trunc240", "trimleft", "truncq_minq", "trimright_lowcomplex"])
def test_fastq_filter_matches_jax(extdata, tmp_path, kw):
    src = str(extdata / "sam1F.fastq.gz")
    j, t = _both(tmp_path, lambda pkg, pre: pkg.fastq_filter(
        src, pre + "_f.fastq.gz", **kw), ["_f.fastq.gz"])
    assert t == j and 0 < t[1] < t[0] == 1500


@pytest.mark.parametrize("multithread", [False, 2], ids=["serial", "spawn2"])
def test_filter_and_trim_paired_matches_jax(extdata, tmp_path, multithread):
    """The tutorial's settings, with rm_phix, on two processes as well."""
    fwd = [str(extdata / f"sam{k}F.fastq.gz") for k in (1, 2)]
    rev = [str(extdata / f"sam{k}R.fastq.gz") for k in (1, 2)]
    names = [f"_{d}{k}.fastq.gz" for d in "FR" for k in (1, 2)]

    def run(pkg, pre):
        return pkg.filter_and_trim(
            fwd, [pre + n for n in names[:2]], rev=rev,
            filt_rev=[pre + n for n in names[2:]], truncLen=(240, 160),
            maxN=0, maxEE=(2, 2), truncQ=2, rm_phix=True,
            multithread=multithread)
    j, t = _both(tmp_path, run, names)
    pd.testing.assert_frame_equal(t, j)
    assert (t["reads.out"] > 500).all()


def test_paired_filter_match_ids_matches_jax(extdata, tmp_path):
    src = [str(extdata / "sam1F.fastq.gz"), str(extdata / "sam1R.fastq.gz")]
    j, t = _both(tmp_path, lambda pkg, pre: pkg.fastq_paired_filter(
        src, [pre + "_mf.fastq.gz", pre + "_mr.fastq.gz"],
        truncLen=(240, 200), maxEE=(2, 2), matchIDs=True),
        ["_mf.fastq.gz", "_mr.fastq.gz"])
    assert t == j


def test_filter_and_trim_per_file_errors_match_jax(extdata, tmp_path):
    bad = tmp_path / "corrupt.fastq.gz"
    bad.write_bytes(b"this is not a gzip fastq")
    msgs = {}
    for tag, pkg in PKGS.items():
        with pytest.raises(RuntimeError) as exc:
            pkg.filter_and_trim(
                [str(extdata / "sam1F.fastq.gz"), str(bad)],
                [str(tmp_path / f"{tag}_good.fastq.gz"),
                 str(tmp_path / f"{tag}_bad.fastq.gz")],
                truncLen=240, maxEE=2)
        msgs[tag] = str(exc.value)
    assert msgs["t"] == msgs["j"] and "1 of 2" in msgs["t"]
    assert _text(tmp_path / "t_good.fastq.gz") == \
        _text(tmp_path / "j_good.fastq.gz")


def test_remove_primers_matches_jax(extdata, tmp_path):
    src = str(extdata / "samPBprimers.fastq.gz")
    F27, R1492 = "AGRGTTYGATYMTGGCTCAG", "RGYTACCTTGTTACGACTT"
    j, t = _both(tmp_path, lambda pkg, pre: pkg.remove_primers(
        src, pre + "_np.fastq.gz", primer_fwd=F27,
        primer_rev=dj.rc(R1492), orient=True), ["_np.fastq.gz"])
    pd.testing.assert_frame_equal(t, j)
    assert t.iloc[0, 1] > 0


def test_host_criteria_match_jax(extdata):
    rng = np.random.default_rng(17)
    quals = [rng.integers(-5, 45, int(n)).astype(np.float64)
             for n in rng.integers(0, 300, 200)] + [np.array([2.5, 40.0])]
    np.testing.assert_array_equal(ft.matrix_ee(quals), fj.matrix_ee(quals))

    phix = dt.data.phix_genome()
    assert phix == dj.data.phix_genome()
    reads = [s.decode() for s in
             dj.io.fastq.read_fastq(str(extdata / "sam1F.fastq.gz")).seqs]
    nts = np.array(list("ACGTN"))
    rand = ["".join(nts[rng.integers(0, 5, int(n))])
            for n in rng.integers(20, 260, 60)]
    frags = []
    for _ in range(60):
        lo = int(rng.integers(0, len(phix) - 300))
        s = list(phix[lo: lo + int(rng.integers(30, 300))])
        for p in rng.integers(0, len(s), int(rng.integers(0, 12))):
            s[p] = "ACGT"[int(rng.integers(0, 4))]
        frags.append("".join(s) if rng.random() < 0.5 else dj.rc("".join(s)))
    seqs = reads[:300] + rand + frags
    for kw in (dict(), dict(wordSize=12, minMatches=3),
               dict(nonOverlapping=False)):
        got, want = ft.is_phix(seqs, **kw), fj.is_phix(seqs, **kw)
        np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(seqs)
    for kw in (dict(), dict(kmerSize=3), dict(window=50, by=10)):
        np.testing.assert_array_equal(ft.seq_complexity(seqs, **kw),
                                      fj.seq_complexity(seqs, **kw))
    ref = phix[:2000]
    for kw in (dict(), dict(word_size=8, non_overlapping=False)):
        np.testing.assert_array_equal(ft.match_ref(seqs, ref, **kw),
                                      fj.match_ref(seqs, ref, **kw))


def test_derep_fasta_matches_jax(extdata):
    path = str(extdata / "example_seqs.fa")
    j, t = dj.derep_fasta(path), dt.derep_fasta(path)
    assert t.uniques == j.uniques
    np.testing.assert_array_equal(t.quals, j.quals)
    np.testing.assert_array_equal(t.map, j.map)
