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
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        dt.seqtab.collapse_no_mismatch(got)


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
