"""Parity of the port's sequence tables against dada2_tpu, and of the
second slice as a whole on the CPU: derep_fastq on two samples -> dada ->
make_sequence_table -> remove_bimera_denovo(method="consensus"). Every
result must be identical."""
import numpy as np
import pandas as pd
import pytest

import dada2_tpu as dj
import dada2_tpu_torch as dt

CASES = {
    "two_samples": {"s1": {"AAAATTTT": 5, "CCCCGGGG": 10},
                    "s2": {"AAAATTTT": 7}},
    "one_sample": {"s1": {"AAAATTTT": 5}},
    "three_samples": {"s2": {"CCCCGGGG": 3, "AAAATTTT": 1},
                      "s1": {"GGGGAAAA": 3}, "s3": {"CCCCGGGG": 2}},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("order_by", ["abundance", "nsamples", None])
def test_make_sequence_table_equal(case, order_by):
    pd.testing.assert_frame_equal(
        dt.make_sequence_table(CASES[case], orderBy=order_by),
        dj.make_sequence_table(CASES[case], orderBy=order_by))


def test_merge_and_export_equal(tmp_path):
    st1 = {"s1": {"AAAATTTT": 5}}
    st2 = {"s2": {"CCCCGGGG": 3, "AAAATTTT": 1}}
    got = dt.merge_sequence_tables(dt.make_sequence_table(st1),
                                   dt.make_sequence_table(st2))
    want = dj.merge_sequence_tables(dj.make_sequence_table(st1),
                                    dj.make_sequence_table(st2))
    pd.testing.assert_frame_equal(got, want)
    pd.testing.assert_frame_equal(
        dt.merge_sequence_tables(got, got, repeats="sum"),
        dj.merge_sequence_tables(want, want, repeats="sum"))
    with pytest.raises(ValueError):
        dt.merge_sequence_tables(got, got)
    from dada2_tpu_torch.seqtab import seqtab_to_qiime, uniques_to_fasta

    uniques_to_fasta({"ACGT": 7, "TTTT": 2}, str(tmp_path / "u.fa"))
    assert ">sq1;size=7;\nACGT\n" in (tmp_path / "u.fa").read_text()
    seqtab_to_qiime(got, str(tmp_path / "q.txt"))
    assert (tmp_path / "q.txt").read_text().startswith("# Constructed")
    # collapse_no_mismatch (kernel B4's plain version on the CPU)
    pd.testing.assert_frame_equal(
        dt.collapse_no_mismatch(got, device="cpu"),
        dj.collapse_no_mismatch(want))


def _shift_table(seed=4):
    """Samples x sequences where some columns are shifted, trimmed or
    extended copies of others (collapsible), some carry one substitution
    (not collapsible), and some are unrelated."""
    rng = np.random.default_rng(seed)
    nt = np.array(list("ACGT"))
    base = ["".join(nt[rng.integers(0, 4, 90)]) for _ in range(3)]
    cols = []
    for b in base:
        cols += [b, b[3:], b[:-5], "ACG" + b, b[2:-2]]
        mut = list(b)
        mut[40] = "A" if mut[40] != "A" else "C"
        cols.append("".join(mut))
    cols.append("".join(nt[rng.integers(0, 4, 70)]))
    mat = rng.integers(0, 30, (3, len(cols)))
    mat[:, ::4] += 50
    return pd.DataFrame(mat, index=["a", "b", "c"], columns=cols)


@pytest.mark.parametrize("kw", [
    dict(), dict(minOverlap=40), dict(vec=False), dict(band=16),
    dict(vec=False, band=16), dict(orderBy="nsamples"),
    dict(identicalOnly=True)],
    ids=["default", "overlap40", "scalar", "band16", "scalar_band16",
         "nsamples", "identical"])
def test_collapse_no_mismatch_equal(kw):
    """collapse_no_mismatch against dada2_tpu: kernel B4's vectorized and
    scalar aligners, unbanded and banded (the banded scalar case takes the
    host oracle in both packages), and the options around them."""
    st = _shift_table()
    got = dt.collapse_no_mismatch(st, device="cpu", **kw)
    want = dj.collapse_no_mismatch(st, **kw)
    pd.testing.assert_frame_equal(got, want)
    if not kw.get("identicalOnly"):
        assert got.shape[1] < st.shape[1]


def test_slice_two_samples_equal(extdata):
    """derep_fastq(sam1F, sam2F) -> dada(err=tperr1()) ->
    make_sequence_table -> remove_bimera_denovo(consensus), the port on
    the CPU against dada2_tpu: the same table, columns, order and counts."""
    paths = [str(extdata / f"sam{k}F.fastq.gz") for k in (1, 2)]

    def run(pkg, **dev):
        dereps = {f"sam{k}": pkg.derep_fastq(p)
                  for k, p in zip((1, 2), paths)}
        dadas = pkg.dada(dereps, err=pkg.data.tperr1(), verbose=False,
                         **dev)
        st = pkg.make_sequence_table(dadas)
        return st, pkg.remove_bimera_denovo(st, method="consensus", **dev)

    st_j, nochim_j = run(dj)
    st_t, nochim_t = run(dt, device="cpu")
    pd.testing.assert_frame_equal(st_t, st_j)
    pd.testing.assert_frame_equal(nochim_t, nochim_j)
    assert st_t.shape[0] == 2 and 0 < nochim_t.shape[1] <= st_t.shape[1]
    assert np.all(nochim_t.values.sum(axis=0) > 0)
