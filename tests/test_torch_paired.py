"""Parity: the port's paired-read merging (dada2_tpu_torch.paired, kernel
B4's plain version on the CPU) against dada2_tpu.paired on the sam1/sam2
forward and reverse dada results, and the slice after dada as a whole:
merge_pairs -> make_sequence_table -> collapse_no_mismatch ->
remove_bimera_denovo(method="consensus") -> is_shift_denovo. Both packages
start from the same dada results (dada2_tpu's, handed to the port as its
own DadaResult; dada itself is held to dada2_tpu in test_torch_backend.py
and test_torch_pipeline.py). Every result must be identical."""
import dataclasses

import numpy as np
import pandas as pd
import pytest

import dada2_tpu as dj
import dada2_tpu_torch as dt

NT = np.array(list("ACGT"))


def _to_port(res):
    """A dada2_tpu DadaResult as the port's (same fields, same arrays)."""
    kw = {f.name: getattr(res, f.name) for f in dataclasses.fields(res)}
    kw["opts"] = dt.DadaOptions(**dataclasses.asdict(res.opts))
    return dt.DadaResult(**kw)


@pytest.fixture(scope="module")
def paired(extdata):
    """dada2_tpu's dada results and both packages' dereps of sam1/sam2,
    forward and reverse."""
    out = {}
    for d in ("F", "R"):
        paths = {f"sam{k}": str(extdata / f"sam{k}{d}.fastq.gz")
                 for k in (1, 2)}
        drp_j = {s: dj.derep_fastq(p) for s, p in paths.items()}
        dd_j = dj.dada(drp_j, err=dj.data.tperr1(), verbose=False)
        out[d] = dict(dada_j=dd_j, derep_j=drp_j,
                      dada_t={s: _to_port(r) for s, r in dd_j.items()},
                      derep_t={s: dt.derep_fastq(p)
                               for s, p in paths.items()})
    return out


def _merge(paired, pkg, **kw):
    t = "t" if pkg is dt else "j"
    if pkg is dt:
        kw["device"] = "cpu"
    return pkg.merge_pairs(paired["F"][f"dada_{t}"], paired["F"][f"derep_{t}"],
                           paired["R"][f"dada_{t}"], paired["R"][f"derep_{t}"],
                           **kw)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(returnRejects=True),
    dict(maxMismatch=1, returnRejects=True, trimOverhang=True),
    dict(minOverlap=20, propagateCol=["n0", "birth_type"]),
    dict(justConcatenate=True),
], ids=["default", "rejects", "mismatch1_trim", "propagate", "concat"])
def test_merge_pairs_equal(paired, kw):
    got = _merge(paired, dt, **kw)
    want = _merge(paired, dj, **kw)
    assert list(got) == list(want) and len(want) == 2
    for s in want:
        pd.testing.assert_frame_equal(got[s], want[s], obj=s)
        assert len(got[s]) > 0
    if kw.get("returnRejects") and not kw.get("maxMismatch"):
        assert any((~got[s]["accept"].astype(bool)).any() for s in got)


def test_merge_pairs_single_sample(paired):
    """One DadaResult per direction gives one DataFrame."""
    args_t = [paired[d][k]["sam1"] for d, k in
              (("F", "dada_t"), ("F", "derep_t"), ("R", "dada_t"),
               ("R", "derep_t"))]
    args_j = [paired[d][k]["sam1"] for d, k in
              (("F", "dada_j"), ("F", "derep_j"), ("R", "dada_j"),
               ("R", "derep_j"))]
    pd.testing.assert_frame_equal(
        dt.merge_pairs(*args_t, returnRejects=True, device="cpu"),
        dj.merge_pairs(*args_j, returnRejects=True))


def test_slice_merge_to_shift_equal(paired):
    """merge_pairs -> make_sequence_table -> collapse_no_mismatch ->
    remove_bimera_denovo(consensus) -> is_shift_denovo: the port on the CPU
    against dada2_tpu, identical at every step."""
    def chain(pkg, **dev):
        st = pkg.make_sequence_table(_merge(paired, pkg))
        col = pkg.collapse_no_mismatch(st, **dev)
        nochim = pkg.remove_bimera_denovo(col, method="consensus", **dev)
        shift = pkg.is_shift_denovo(
            dict(zip(nochim.columns, nochim.values.sum(axis=0))), **dev)
        return st, col, nochim, shift

    got = chain(dt, device="cpu")
    want = chain(dj)
    for g, w, name in zip(got[:3], want[:3], ("table", "collapsed",
                                               "nochim")):
        pd.testing.assert_frame_equal(g, w, obj=name)
    pd.testing.assert_series_equal(got[3], want[3])
    assert got[0].shape[0] == 2 and got[2].shape[1] > 0


def test_pairwise_helpers_equal():
    """nwalign / nwhamming / nweval / nwextract / eval_pair /
    pair_consensus (host code on the oracle aligner) against dada2_tpu."""
    rng = np.random.default_rng(8)
    for trial in range(12):
        a = "".join(NT[rng.integers(0, 4, int(rng.integers(30, 80)))])
        b = list(a[int(rng.integers(0, 10)):])
        for _ in range(int(rng.integers(0, 5))):
            b.insert(int(rng.integers(0, len(b))), str(NT[rng.integers(4)]))
        b = "".join(b)
        kw = [dict(), dict(band=8), dict(vec=True, band=16),
              dict(homo_gap=-2), dict(endsfree=False)][trial % 5]
        al = dt.nwalign(a, b, **kw)
        assert al == dj.nwalign(a, b, **kw)
        assert dt.nwhamming(a, b, **kw) == dj.nwhamming(a, b, **kw)
        assert dt.nweval(a, b, **kw) == dj.nweval(a, b, **kw)
        assert dt.nwextract(a, b, **kw) == dj.nwextract(a, b, **kw)
        assert dt.eval_pair(*al) == dj.eval_pair(*al)
        for prefer, trim in ((1, False), (2, True)):
            assert (dt.pair_consensus(*al, prefer, trim)
                    == dj.pair_consensus(*al, prefer, trim))
