"""Parity: the port's CudaBackend (on the CPU, where kernel B1 runs as its
plain PyTorch version) against dada2_tpu's TpuBackend on real MiSeq data.
Both packages get identical state through interop.state_from_numpy."""
import dataclasses

import numpy as np
import pandas as pd
import pytest

from dada2_tpu.core.backend_tpu import TpuBackend
from dada2_tpu.core.engine import Engine as EngineJ
from dada2_tpu.core.output import finalize as finalize_j
from dada2_tpu.core.raws import make_rawset
from dada2_tpu.data import tperr1
from dada2_tpu.derep import derep_fastq
from dada2_tpu.options import DEFAULT_OPTIONS
from dada2_tpu_torch.core.backend_cuda import CudaBackend
from dada2_tpu_torch.core.engine import Engine as EngineT
from dada2_tpu_torch.core.output import finalize as finalize_t
from dada2_tpu_torch.interop import state_from_numpy


@pytest.fixture(scope="module")
def sample(extdata):
    d = derep_fastq(str(extdata / "sam1F.fastq.gz"))
    return d.sequences[:150], d.abundances[:150], d.quals[:150]


def _states(sample, n=None, **overrides):
    seqs, ab, quals = sample
    if n is not None:
        seqs, ab, quals = seqs[:n], ab[:n], quals[:n]
    opts = DEFAULT_OPTIONS.replace(**overrides).normalized()
    rs = make_rawset(seqs, ab, None, quals)
    rs_t, err_t, opts_t = state_from_numpy(
        rs.seqs, rs.lens, rs.reads, rs.priors, rs.quals, tperr1(),
        dataclasses.asdict(opts))
    return (rs, tperr1(), opts), (rs_t, err_t, opts_t)


def _assert_same(res_a, res_b):
    pd.testing.assert_frame_equal(res_a["clustering"], res_b["clustering"])
    pd.testing.assert_frame_equal(res_a["birth_subs"], res_b["birth_subs"])
    np.testing.assert_array_equal(res_a["subqual"], res_b["subqual"])
    np.testing.assert_array_equal(res_a["map"], res_b["map"])
    np.testing.assert_array_equal(res_a["pval"], res_b["pval"])
    np.testing.assert_array_equal(res_a["clusterquals"],
                                  res_b["clusterquals"])


def test_state_from_numpy(sample):
    (rs, err, opts), (rs_t, err_t, opts_t) = _states(sample)
    for f in ("seqs", "lens", "reads", "priors", "quals"):
        np.testing.assert_array_equal(getattr(rs, f), getattr(rs_t, f))
    np.testing.assert_array_equal(rs.kmers, rs_t.kmers)
    np.testing.assert_array_equal(err, err_t)
    assert dataclasses.asdict(opts) == dataclasses.asdict(opts_t)


@pytest.mark.parametrize("kdist", [1.0, 0.42])
def test_compare_parity(sample, kdist):
    """One compare(): lam and ham bit-identical to the TPU backend."""
    (rs, err, opts), (rs_t, err_t, opts_t) = _states(sample)
    skip = np.zeros(rs.n, dtype=bool)
    skip[[3, 17]] = True
    lam_j, ham_j = TpuBackend(rs).compare(0, skip, opts, err, True, kdist)
    lam_t, ham_t = CudaBackend(rs_t, device="cpu").compare(
        0, skip, opts_t, err_t, True, kdist)
    np.testing.assert_array_equal(ham_j, ham_t)
    np.testing.assert_array_equal(lam_j, lam_t)


def test_compare_parity_e_thresh(sample):
    """With an e_thresh the port screens on the f32 log-lambda: ham stays
    bit-identical, lam is bit-identical on every row it keeps, every row
    the engine would store is kept, and a zeroed row is provably below
    the store threshold."""
    (rs, err, opts), (rs_t, err_t, opts_t) = _states(sample)
    skip = np.zeros(rs.n, dtype=bool)
    cutoff = opts.KDIST_CUTOFF
    lam_j, ham_j = TpuBackend(rs).compare(0, skip, opts, err, True, cutoff)
    total = int(rs.reads.sum())
    e_minmax = np.full(rs.n, np.median(lam_j[lam_j > 0]) * total / 2)
    lam_t, ham_t = CudaBackend(rs_t, device="cpu").compare(
        0, skip, opts_t, err_t, True, cutoff, e_minmax / total)
    np.testing.assert_array_equal(ham_j, ham_t)
    kept = lam_t != 0
    assert 0 < kept.sum() < (lam_j != 0).sum()     # the screen screened
    np.testing.assert_array_equal(lam_t[kept], lam_j[kept])
    assert kept[lam_j * total > e_minmax].all()
    assert (lam_j[~kept] * total <= e_minmax[~kept]).all()


def test_full_run_parity(sample):
    """Engine.run + finalize through both backends, bit for bit."""
    (rs, err, opts), (rs_t, err_t, opts_t) = _states(sample)
    eng_j = EngineJ(rs, err, opts, TpuBackend(rs), use_quals=True)
    eng_j.run(max_clust=opts.MAX_CLUST)
    res_j = finalize_j(eng_j, opts, err.shape[1], opts.OMEGA_C)
    eng_t = EngineT(rs_t, err_t, opts_t, CudaBackend(rs_t, device="cpu"),
                    use_quals=True)
    eng_t.run(max_clust=opts_t.MAX_CLUST)
    res_t = finalize_t(eng_t, opts_t, err_t.shape[1], opts_t.OMEGA_C)
    assert len(eng_j.clusters) == len(eng_t.clusters) > 1
    np.testing.assert_array_equal(eng_j.comp_lam, eng_t.comp_lam)
    _assert_same(res_j, res_t)


def test_fused_align_base_parity(sample, monkeypatch):
    """The port's error-independent sweep (kernel B1 via its plain
    version) against JAX's _fused_align_base with the Pallas kernel in
    interpret mode: mapq, tvec and small5 exact. The err-dependent f32
    loglam/abssum are held only to TpuBackend._screen_need's margin: both
    are f32 sums taken in another order (and a log from another
    library), and the screen is sound for any order inside that margin;
    ham and flags in the same pack stay exact."""
    monkeypatch.setenv("DADA2_TPU_PALLAS", "1")
    (rs, err, opts), (rs_t, err_t, opts_t) = _states(sample, n=60)
    be_j = TpuBackend(rs)
    assert be_j.use_pallas
    be_t = CudaBackend(rs_t, device="cpu")
    n = rs.n
    center = 5
    len1 = int(rs.lens[center])
    geom_j = be_j._pallas_ok(len1, opts)
    mapq_j, tvec_j, small_j = (np.asarray(x)[:n] for x in
                               be_j._align_all_pallas(center, opts, geom_j,
                                                      err))
    small5_j = np.asarray(be_j._align_ent(center, opts, geom_j)[2])[:n]
    ent_t = be_t._align_ent(center, opts_t,
                            be_t._kernel_geom(len1, opts_t))
    np.testing.assert_array_equal(mapq_j, ent_t[0].numpy())
    np.testing.assert_array_equal(tvec_j, ent_t[1].numpy())
    np.testing.assert_array_equal(small5_j, ent_t[2].numpy())
    assert (small5_j[:, 4] & 1).all()              # every traceback ok

    small_t = be_t._small13(ent_t, center, err_t).numpy()
    np.testing.assert_array_equal(small_j[:, :4], small_t[:, :4])
    np.testing.assert_array_equal(small_j[:, 12], small_t[:, 12])
    f_j = small_j[:, 4:12].copy().view(np.float32).astype(np.float64)
    f_t = small_t[:, 4:12].copy().view(np.float32).astype(np.float64)
    L = rs.max_len
    margin = 1e-4 + 2.0 ** -23 * (5.0 * L + (L + 5.0) * f_j[:, 1])
    assert (np.abs(f_j[:, 0] - f_t[:, 0]) <= margin).all()
    assert (np.abs(f_j[:, 1] - f_t[:, 1]) <= margin).all()


def test_finalize_subs_paths(sample):
    """subs_info / subs_to_center / subs_pairs from the kernel's map
    records against the TPU backend's (CPU) route."""
    (rs, err, opts), (rs_t, err_t, opts_t) = _states(sample)
    be_j = TpuBackend(rs)
    be_t = CudaBackend(rs_t, device="cpu")
    members = np.array([0, 4, 9, 33, 71, 120], np.int64)
    p_j, n_j = be_j.subs_info(2, members, opts)
    p_t, n_t = be_t.subs_info(2, members, opts_t)
    np.testing.assert_array_equal(p_j, p_t)
    np.testing.assert_array_equal(n_j, n_t)
    for a, b in zip(be_j.subs_to_center(2, members, opts),
                    be_t.subs_to_center(2, members, opts_t)):
        assert a.nsubs == b.nsubs
        np.testing.assert_array_equal(a.map, b.map)
        np.testing.assert_array_equal(a.pos, b.pos)
    pairs = [(0, 7), (7, 0), (2, 44)]
    for a, b in zip(be_j.subs_pairs(pairs, opts, True, 1.0),
                    be_t.subs_pairs(pairs, opts_t, True, 1.0)):
        assert a.nsubs == b.nsubs
        np.testing.assert_array_equal(a.map, b.map)
        np.testing.assert_array_equal(a.nt1, b.nt1)


@pytest.mark.parametrize("overrides", [
    dict(BAND_SIZE=-1), dict(VECTORIZED_ALIGNMENT=False),
    dict(HOMOPOLYMER_GAP_PENALTY=-1, BAND_SIZE=32)])
def test_unserved_configs_raise(extdata, monkeypatch, overrides):
    """The configurations kernel B1 does not serve (once refused) run
    through kernel B4 (here its plain version): dada(sam1F) equals
    dada2_tpu's bit for bit, and kernel B1 is never called. BAND_SIZE=-1
    runs on sam1F's 250 most abundant uniques (the unbanded plain version
    is slow on the CPU). The name is the refusal check's it replaced."""
    import dada2_tpu as dj
    import dada2_tpu_torch as dt
    from dada2_tpu_torch.ops import nw_wavefront as nww

    path = str(extdata / "sam1F.fastq.gz")
    dereps = [pkg.derep_fastq(path) for pkg in (dj, dt)]
    if overrides.get("BAND_SIZE") == -1:
        k = 250
        dereps = [type(d)(uniques=dict(list(d.uniques.items())[:k]),
                          quals=d.quals[:k], map=np.arange(k), name="top")
                  for d in dereps]
    res_j = dj.dada(dereps[0], err=dj.data.tperr1(), verbose=False,
                    **overrides)

    def no_sweep(*args, **kwargs):
        raise AssertionError("kernel B1 called on B4's route")

    monkeypatch.setattr(nww, "nw_wavefront", no_sweep)
    res_t = dt.dada(dereps[1], err=dt.data.tperr1(), device="cpu",
                    verbose=False, **overrides)
    assert len(res_t.denoised) > 1
    pd.testing.assert_frame_equal(res_j.clustering, res_t.clustering)
    pd.testing.assert_frame_equal(res_j.birth_subs, res_t.birth_subs)
    np.testing.assert_array_equal(res_j.map, res_t.map)
    np.testing.assert_array_equal(res_j.pval, res_t.pval)
    np.testing.assert_array_equal(res_j.trans, res_t.trans)


def _same_subs(subs_j, subs_t):
    assert len(subs_j) == len(subs_t)
    for a, b in zip(subs_j, subs_t):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert (a.nsubs, a.len0) == (b.nsubs, b.len0)
        for f in ("map", "pos", "nt0", "nt1"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("entry", ["compare", "compare_kdist", "subs",
                                   "subs_info", "cluster_stats_all"])
def test_band0_entry_points(sample, entry):
    """BAND_SIZE=0: every candidate is aligned gapless on the host, as in
    dada2_tpu; each CudaBackend entry point matches TpuBackend bit for
    bit, on every row."""
    (rs, err, opts), (rs_t, err_t, opts_t) = _states(sample, BAND_SIZE=0)
    assert not opts_t.VECTORIZED_ALIGNMENT       # normalized() at band 0
    be_j = TpuBackend(rs)
    be_t = CudaBackend(rs_t, device="cpu")
    members = np.array([0, 4, 9, 33, 71, 120, 149], np.int64)
    if entry.startswith("compare"):
        kdist = 0.42 if entry == "compare_kdist" else 1.0
        skip = np.zeros(rs.n, dtype=bool)
        skip[[3, 17]] = True
        for center in (0, 5):
            lam_j, ham_j = be_j.compare(center, skip, opts, err, True, kdist)
            lam_t, ham_t = be_t.compare(center, skip, opts_t, err_t, True,
                                        kdist)
            np.testing.assert_array_equal(ham_j, ham_t)
            np.testing.assert_array_equal(lam_j, lam_t)
            assert (ham_t[~skip] >= 0).any()
    elif entry == "subs":
        _same_subs(be_j.subs_to_center(2, members, opts),
                   be_t.subs_to_center(2, members, opts_t))
        pairs = [(0, 7), (7, 0), (2, 44), (5, 149)]
        _same_subs(be_j.subs_pairs(pairs, opts, True, 1.0),
                   be_t.subs_pairs(pairs, opts_t, True, 1.0))
        _same_subs([be_j.subs_pair(0, 9, opts, True, 0.42)],
                   [be_t.subs_pair(0, 9, opts_t, True, 0.42)])
    elif entry == "subs_info":
        for a, b in zip(be_j.subs_info(2, members, opts),
                        be_t.subs_info(2, members, opts_t)):
            np.testing.assert_array_equal(a, b)
    else:
        correct = np.ones(len(members), bool)
        correct[2] = False
        clusters = [(0, members, correct), (5, members[:3], correct[:3])]
        for use_quals in (True, False):
            got_j = be_j.cluster_stats_all(clusters, opts, err.shape[1],
                                           use_quals)
            got_t = be_t.cluster_stats_all(clusters, opts_t, err.shape[1],
                                           use_quals)
            for a, b in zip(got_j, got_t):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)


def test_band0_dada_sam1f(extdata, monkeypatch):
    """dada(sam1F, BAND_SIZE=0) through CudaBackend on the CPU equals
    dada2_tpu's: clustering, map, p-values, birth subs and trans, and
    kernel B1 (here its plain version) is never called."""
    import dada2_tpu as dj
    import dada2_tpu_torch as dt
    from dada2_tpu_torch.ops import nw_wavefront as nww

    def no_sweep(*args, **kwargs):
        raise AssertionError("kernel B1 called at BAND_SIZE=0")

    monkeypatch.setattr(nww, "nw_wavefront", no_sweep)
    path = str(extdata / "sam1F.fastq.gz")
    res_j = dj.dada(dj.derep_fastq(path), err=dj.data.tperr1(),
                    BAND_SIZE=0, verbose=False)
    res_t = dt.dada(dt.derep_fastq(path), err=dt.data.tperr1(),
                    BAND_SIZE=0, device="cpu", verbose=False)
    assert len(res_t.denoised) > 1
    pd.testing.assert_frame_equal(res_j.clustering, res_t.clustering)
    pd.testing.assert_frame_equal(res_j.birth_subs, res_t.birth_subs)
    np.testing.assert_array_equal(res_j.map, res_t.map)
    np.testing.assert_array_equal(res_j.pval, res_t.pval)
    np.testing.assert_array_equal(res_j.trans, res_t.trans)
