"""Parity of the port's main path against dada2_tpu on the CPU:
derep_fastq, dada() at default options, a selfConsist run, and the
R-exact Poisson tails. Everything here must be bit-identical."""
import numpy as np
import pandas as pd
import pytest

import dada2_tpu as dj
from dada2_tpu.utils import rmath as rmath_j
import dada2_tpu_torch as dt
from dada2_tpu_torch.utils import rmath as rmath_t


def _same_result(a, b):
    pd.testing.assert_frame_equal(a.clustering, b.clustering)
    pd.testing.assert_frame_equal(a.birth_subs, b.birth_subs)
    np.testing.assert_array_equal(a.map, b.map)
    np.testing.assert_array_equal(a.pval, b.pval)
    np.testing.assert_array_equal(a.trans, b.trans)


@pytest.mark.parametrize("name", ["sam1F.fastq.gz", "sam2R.fastq.gz"])
def test_derep_fastq_equal(extdata, name):
    a = dj.derep_fastq(str(extdata / name))
    b = dt.derep_fastq(str(extdata / name))
    assert list(a.uniques.items()) == list(b.uniques.items())
    np.testing.assert_array_equal(a.quals, b.quals)
    np.testing.assert_array_equal(a.map, b.map)


def test_dada_sam1f_equal(extdata):
    """dada(derep_fastq(sam1F), err=tperr1()) through kernel B1's plain
    version: clustering, map, pval, birth_subs and trans bit-identical."""
    path = str(extdata / "sam1F.fastq.gz")
    res_j = dj.dada(dj.derep_fastq(path), err=dj.data.tperr1(),
                    verbose=False)
    res_t = dt.dada(dt.derep_fastq(path), err=dt.data.tperr1(),
                    device="cpu", verbose=False)
    assert len(res_t.denoised) > 1
    _same_result(res_j, res_t)


def test_self_consist_subset_equal(extdata):
    """selfConsist=True from the all-ones initial error matrix on a subset
    of sam1F's uniques: every round's err_in and the final err_out match."""
    full = dj.derep_fastq(str(extdata / "sam1F.fastq.gz"))
    keep = 250
    seqs = full.sequences[:keep]
    uniques = {s: int(full.uniques[s]) for s in seqs}
    quals = full.quals[:keep]
    drp_j = dj.Derep(uniques=uniques, quals=quals,
                     map=np.zeros(0, np.int64), name="sub")
    drp_t = dt.Derep(uniques=dict(uniques), quals=quals.copy(),
                     map=np.zeros(0, np.int64), name="sub")
    res_j = dj.dada(drp_j, err=None, selfConsist=True, verbose=False)
    res_t = dt.dada(drp_t, err=None, selfConsist=True, device="cpu",
                    verbose=False)
    assert len(res_j.err_in) == len(res_t.err_in) >= 2
    for a, b in zip(res_j.err_in, res_t.err_in):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res_j.err_out, res_t.err_out)
    _same_result(res_j, res_t)


@pytest.mark.parametrize("native", ["1", "0"])
def test_ppois_fuzz_equal(monkeypatch, native):
    """R-exact upper Poisson tails, native and pure-Python routes, bit for
    bit against dada2_tpu.utils.rmath."""
    monkeypatch.setenv("DADA2_TPU_NATIVE", native)
    rng = np.random.default_rng(11)
    x = np.concatenate([rng.integers(0, 50, 400),
                        rng.integers(0, 100000, 100)]).astype(np.int64)
    lam = np.concatenate([rng.uniform(0, 60, 300),
                          10.0 ** rng.uniform(-12, 5, 200)])
    np.testing.assert_array_equal(rmath_j.ppois_upper_vec(x, lam),
                                  rmath_t.ppois_upper_vec(x, lam))
    for xi, li in zip(x[:40], lam[:40]):
        assert rmath_j.ppois_upper(int(xi), float(li)) == \
            rmath_t.ppois_upper(int(xi), float(li))


@pytest.mark.parametrize("pool", [True, "pseudo"])
def test_pool_and_pseudo_equal(extdata, pool):
    """Multi-sample pooling and pseudo-pooling (host logic around the
    engine) on subsets of two samples, bit-identical per sample."""
    def subsets(pkg):
        out = {}
        for name in ("sam1F.fastq.gz", "sam2F.fastq.gz"):
            full = dj.derep_fastq(str(extdata / name))
            seqs = full.sequences[:120]
            out[name] = pkg.Derep(
                uniques={s: int(full.uniques[s]) for s in seqs},
                quals=full.quals[:120].copy(), map=np.zeros(0, np.int64),
                name=name)
        return out

    res_j = dj.dada(subsets(dj), err=dj.data.tperr1(), pool=pool,
                    verbose=False)
    res_t = dt.dada(subsets(dt), err=dt.data.tperr1(), pool=pool,
                    device="cpu", verbose=False)
    assert list(res_j) == list(res_t)
    for name in res_j:
        a, b = res_j[name], res_t[name]
        pd.testing.assert_frame_equal(a.clustering, b.clustering)
        np.testing.assert_array_equal(a.map, b.map)
        pd.testing.assert_frame_equal(a.birth_subs, b.birth_subs)


def test_pseudo_checkpoint_equal_and_resumable(extdata, tmp_path):
    """pool="pseudo" with selfConsist and checkpoint= in one process: both
    packages write the same .npz, array by array (pseudo_priors in the
    sequence table's column order, decreasing total abundance), and each
    package resumes from the other's file to the same result."""
    def subsets(pkg):
        out = {}
        for name in ("sam1F.fastq.gz", "sam2F.fastq.gz"):
            full = dj.derep_fastq(str(extdata / name))
            seqs = full.sequences[:120]
            out[name] = pkg.Derep(
                uniques={s: int(full.uniques[s]) for s in seqs},
                quals=full.quals[:120].copy(), map=np.zeros(0, np.int64),
                name=name)
        return out

    kw = dict(err=None, selfConsist=True, pool="pseudo", MAX_CONSIST=2,
              verbose=False)
    ck_j, ck_t = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    dj.dada(subsets(dj), checkpoint=ck_j, **kw)
    dt.dada(subsets(dt), checkpoint=ck_t, device="cpu", **kw)
    a, b = np.load(ck_j, allow_pickle=True), np.load(ck_t, allow_pickle=True)
    assert sorted(a.files) == sorted(b.files) == [
        "err", "history", "nconsist", "pseudo_priors"]
    for name in a.files:
        assert a[name].dtype == b[name].dtype, name
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    assert len(a["pseudo_priors"]) > 1
    # each resumes from the other's file (a resumed run rewrites it)
    (tmp_path / "for_j.npz").write_bytes((tmp_path / "t.npz").read_bytes())
    (tmp_path / "for_t.npz").write_bytes((tmp_path / "j.npz").read_bytes())
    res_j = dj.dada(subsets(dj), checkpoint=str(tmp_path / "for_j.npz"),
                    **kw)
    res_t = dt.dada(subsets(dt), checkpoint=str(tmp_path / "for_t.npz"),
                    device="cpu", **kw)
    assert list(res_j) == list(res_t)
    for name in res_j:
        np.testing.assert_array_equal(res_j[name].err_out,
                                      res_t[name].err_out)
        pd.testing.assert_frame_equal(res_j[name].clustering,
                                      res_t[name].clustering)
        np.testing.assert_array_equal(res_j[name].map, res_t[name].map)
        pd.testing.assert_frame_equal(res_j[name].birth_subs,
                                      res_t[name].birth_subs)
