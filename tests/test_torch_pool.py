"""dada(pool=True) of the port on the CPU: held bit for bit to the
benchmark's plain reference of pooled sample inference
(benchmark/reference/pool_ref.py, loaded by path; it imports nothing of
the program) on seeded small studies; the same study with the alignment
cache pinned too small to hold a center's sweep for long gives the same
results, and finalize sweeps no center again; the numpy split-back
equals the per-unique loop it replaced; the same call in the same order
gives the same result."""
import importlib
import os
import sys
import types

import numpy as np
import pandas as pd
import pytest
import torch

import dada2_tpu_torch as dt
from dada2_tpu_torch import trace
from dada2_tpu_torch.core.backend_cuda import CudaBackend

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
V4 = {"amplicons": "data/v4_asvs.txt.gz", "quality_profile": "sam1F",
      "error_model": {"kind": "matrix", "file": "data/tperr1.npy",
                      "max_q": 50}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain kernels' many small ops gain little
    from more, and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bench_module(name):
    """A module of the benchmark by path: generate.py, or one of
    reference/ as a submodule of a package of its own name."""
    if name == "generate":
        spec = importlib.util.spec_from_file_location(
            "pool_test_generate", os.path.join(BENCH, "generate.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    if "pool_test_reference" not in sys.modules:
        pkg = types.ModuleType("pool_test_reference")
        pkg.__path__ = [os.path.join(BENCH, "reference")]
        sys.modules["pool_test_reference"] = pkg
    return importlib.import_module("pool_test_reference." + name)


def _study(name):
    """[(sample name, sequences, abundances, quals)] and the error
    matrix of a seeded study: "v4" 4 samples x 2,000 240-nt reads of 4 of
    8 ASVs each (the benchmark's generator); "mixed_lengths" 4 samples x
    700 reads of ASVs cut to 200-240 nt."""
    gen = _bench_module("generate")
    if name == "v4":
        x = gen.generate(V4, dict(
            generator="amplicon_samples", pool_asvs=8, asvs_per_sample=4,
            reads_per_sample=2000, samples=4, abundance_sigma=1.6,
            warmup=dict(asvs=1, reads=10)), 2 ** 31 + 11)
        return x["samples"], x["err"]
    rng = gen.rng_of(2 ** 31 + 12)
    cand = gen.candidates(V4)
    asvs = [cand[k][:int(rng.integers(200, 241))]
            for k in rng.choice(len(cand), 16, replace=False)]
    codes, lens = gen._codes(asvs)
    err = gen.error_matrix(V4)
    q8 = np.floor(gen.quality_profile(V4) + 0.5).astype(np.int64)
    samples = []
    for s in range(4):
        pick = rng.choice(len(asvs), 5, replace=False)
        samples.append((f"m{s}", *gen.simulate_sample(
            rng, codes[pick], lens[pick], gen.lognormal_set(5, 0.0, 1.6),
            q8, err, 700)))
    return samples, err


def _dereps(samples):
    return {name: dt.Derep(uniques=dict(zip(seqs, ab.tolist())), quals=q,
                           map=np.zeros(0, np.int64), name=name)
            for name, seqs, ab, q in samples}


_RUNS = {}


def _run(study, cache_bytes=None, again=0):
    """(results, counters over the call, B1 sweeps made inside finalize)
    of dada(pool=True) on the study, cached by its arguments."""
    key = (study, cache_bytes, again)
    if key in _RUNS:
        return _RUNS[key]
    samples, err = _study(study)
    in_final = [0]
    orig = {m: getattr(CudaBackend, m)
            for m in ("cluster_stats_all", "subs_pairs")}

    def counted(m):
        def wrapped(*a, **kw):
            before = trace.COUNTERS.align_sweeps
            out = orig[m](*a, **kw)
            in_final[0] += trace.COUNTERS.align_sweeps - before
            return out
        return wrapped

    saved = CudaBackend.ALIGN_CACHE_BYTES
    try:
        for m in orig:
            setattr(CudaBackend, m, counted(m))
        if cache_bytes is not None:
            CudaBackend.ALIGN_CACHE_BYTES = cache_bytes
        c0 = trace.COUNTERS.as_dict()
        res = dt.dada(_dereps(samples), err=err, pool=True, multithread=1,
                      verbose=False, device="cpu")
        c1 = trace.COUNTERS.as_dict()
    finally:
        CudaBackend.ALIGN_CACHE_BYTES = saved
        for m, f in orig.items():
            setattr(CudaBackend, m, f)
    out = (res, {k: c1[k] - c0[k] for k in c1}, in_final[0])
    _RUNS[key] = out
    return out


def _same(a, b):
    pd.testing.assert_frame_equal(a.clustering, b.clustering)
    pd.testing.assert_frame_equal(a.birth_subs, b.birth_subs)
    np.testing.assert_array_equal(a.map, b.map)
    np.testing.assert_array_equal(a.trans, b.trans)
    np.testing.assert_array_equal(a.quality, b.quality)
    assert a.pval is None and b.pval is None
    assert a.denoised == b.denoised


@pytest.mark.parametrize("study", ["v4", "mixed_lengths"])
def test_pool_matches_the_plain_reference(study):
    pool_ref = _bench_module("pool_ref")
    dada_ref = _bench_module("dada_ref")
    samples, err = _study(study)
    if study == "mixed_lengths":
        lens = {len(s) for _, seqs, _, _ in samples for s in seqs}
        assert min(lens) < 220 and max(lens) >= 230
    got, counters, _ = _run(study)
    want = pool_ref.dada_pooled([s[1:] for s in samples], err,
                                dada_ref.options(), device="cpu")
    assert counters["pooled_uniques"] == len(set().union(
        *[s[1] for s in samples]))
    seen = []
    for (name, seqs, ab, _), w in zip(samples, want):
        g = got[name]
        pd.testing.assert_frame_equal(g.clustering, w["clustering"])
        pd.testing.assert_frame_equal(g.birth_subs, w["birth_subs"])
        np.testing.assert_array_equal(g.map, w["map"])
        np.testing.assert_array_equal(g.trans, w["subqual"])
        assert g.pval is None and w["pval"] is None
        assert int(g.clustering["abundance"].sum()) == int(
            ab[g.map >= 0].sum())
        seen += list(g.clustering["sequence"])
    # some ASV is in several samples, so the split-back matters
    assert len(set(seen)) < len(seen)


def test_a_tiny_alignment_cache_changes_nothing():
    """ALIGN_CACHE_BYTES pinned to 1 byte (one sweep held at a time):
    the same results, sweeps evicted, and finalize sweeps no center: it
    reads an evicted center's members from a sweep of those rows alone."""
    base, c_base, f_base = _run("mixed_lengths")
    tiny, c_tiny, f_tiny = _run("mixed_lengths", cache_bytes=1)
    assert c_base["align_evictions"] == 0 and f_base == 0
    assert c_tiny["align_evictions"] > 0
    assert f_tiny == 0
    nclust = max(len(r.clustering) for r in tiny.values())
    assert c_tiny["align_sweeps"] - c_tiny["align_resweeps"] >= nclust
    for name in base:
        _same(base[name], tiny[name])


def test_the_same_order_gives_the_same_result():
    first, _, _ = _run("mixed_lengths")
    again, _, _ = _run("mixed_lengths", again=1)
    assert list(first) == list(again)
    for name in first:
        _same(first[name], again[name])


def _split_by_loop(pooled, pooled_map, pooled_names, drpi, opts):
    """The split-back as the port wrote it before (one sample): a dict
    lookup and a Python loop per unique."""
    name_to_pooled = {s: k for k, s in enumerate(pooled_names)}
    member = np.array([name_to_pooled[s] for s in drpi.sequences])
    own_clusters = pooled_map[member]
    keep_set = set(int(c) for c in own_clusters if c >= 0)
    nclust = len(pooled.denoised)
    keep = np.array([k in keep_set for k in range(nclust)])
    newBi = np.cumsum(keep) - 1
    cl = pooled.clustering[keep].reset_index(drop=True)
    own_map = np.array([
        newBi[pooled_map[name_to_pooled[s]]]
        if pooled_map[name_to_pooled[s]] >= 0 else -1
        for s in drpi.sequences], dtype=np.int64)
    ab = np.zeros(int(keep.sum()), dtype=np.int64)
    abund_in = drpi.abundances
    for u, c in enumerate(own_map):
        if c >= 0:
            ab[c] += int(abund_in[u])
    cl = cl.copy()
    cl["abundance"] = ab
    bs = pooled.birth_subs
    bs_keep = keep[bs["clust"].to_numpy() - 1]
    bs = bs[bs_keep].copy()
    bs["clust"] = newBi[bs["clust"].to_numpy() - 1] + 1
    denoised = {s: int(a) for s, a in zip(cl["sequence"], ab)}
    return dict(denoised=denoised, clustering=cl, quality=pooled.quality[keep],
                birth_subs=bs, map=own_map)


def _synthetic_pool(case, rng):
    """A pooled DadaResult over 60 pooled uniques and 7 clusters, and
    three samples' dereps: in "lacking" each sample holds the uniques of
    only some clusters; in "unmapped" a quarter of the pooled uniques are
    not corrected (map -1)."""
    from dada2_tpu_torch.dada import DadaResult

    nu, k = 60, 7
    seqs = ["".join(rng.choice(list("ACGT"), 12)) + f"{u:03d}"
            for u in range(nu)]
    pmap = rng.integers(0, k, nu)
    pmap[:k] = np.arange(k)
    if case == "unmapped":
        pmap[rng.choice(np.arange(k, nu), nu // 4, replace=False)] = -1
    cl = pd.DataFrame({"sequence": seqs[:k],
                       "abundance": rng.integers(10, 99, k),
                       "n0": rng.integers(0, 9, k),
                       "nunq": rng.integers(1, 9, k),
                       "pval": rng.random(k)})
    bs = pd.DataFrame({"pos": rng.integers(1, 12, 9),
                       "clust": np.array([2, 2, 3, 4, 5, 5, 6, 7, 7]),
                       "qave": rng.random(9)})
    pooled = DadaResult(
        denoised=dict(zip(cl["sequence"], cl["abundance"].tolist())),
        clustering=cl, sequence=seqs[:k], quality=rng.random((k, 12)),
        birth_subs=bs, trans=np.zeros((16, 41), np.int64), map=pmap,
        pval=None, err_in=None, err_out=None, opts=None, name="pooled")
    dereps, members = [], []
    for s in range(3):
        if case == "lacking":
            own = np.nonzero(np.isin(pmap, rng.choice(k, 3, replace=False)))[0]
        else:
            own = rng.choice(nu, 25, replace=False)
        own = rng.permutation(own)
        dereps.append(dt.Derep(
            uniques={seqs[u]: int(rng.integers(1, 50)) for u in own},
            quals=np.zeros((len(own), 12)), map=np.zeros(0, np.int64),
            name=f"s{s}"))
        members.append(own.astype(np.int64))
    return pooled, seqs, dereps, members


@pytest.mark.parametrize("case", ["lacking", "unmapped"])
def test_the_split_back_equals_the_loop(case):
    from dada2_tpu_torch.dada import _split_pooled

    pooled, seqs, dereps, members = _synthetic_pool(
        case, np.random.default_rng(7 if case == "lacking" else 8))
    for drp, member in zip(dereps, members):
        want = _split_by_loop(pooled, pooled.map, seqs, drp, None)
        got = _split_pooled(pooled, member, drp)
        assert len(got.clustering) < len(pooled.clustering) or (
            case == "unmapped")
        pd.testing.assert_frame_equal(got.clustering, want["clustering"])
        pd.testing.assert_frame_equal(got.birth_subs, want["birth_subs"])
        np.testing.assert_array_equal(got.map, want["map"])
        np.testing.assert_array_equal(got.quality, want["quality"])
        assert got.denoised == want["denoised"]
        assert got.sequence == list(want["clustering"]["sequence"])
        if case == "unmapped":
            assert (got.map == -1).any()


def test_combine_dereps_keeps_each_inputs_index():
    samples, _ = _study("mixed_lengths")
    dereps = list(_dereps(samples).values())
    pooled = dt.combine_dereps(dereps)
    seqs = pooled.sequences
    for d, idx in zip(dereps, pooled.pool_index):
        assert [seqs[j] for j in idx] == d.sequences
    # ties stay in order of first encounter: a stable sort by decreasing
    # total abundance
    order = {}
    for d in dereps:
        for s in d.uniques:
            order.setdefault(s, len(order))
    assert (np.diff(pooled.abundances) <= 0).all()
    ties = [(a, b) for a, b in zip(seqs, seqs[1:])
            if pooled.uniques[a] == pooled.uniques[b]]
    assert ties and all(order[a] < order[b] for a, b in ties)


def test_a_backend_is_freed_without_cycle_collector():
    """A backend that has swept a center, read an evicted center's
    members from a sweep of those rows alone, and tallied clusters holds
    no reference cycle: dropped, it (on the card, its device memory and
    its alignment cache) is freed at once with the cycle collector off."""
    import gc
    import weakref

    from dada2_tpu_torch.core.raws import make_rawset
    from dada2_tpu_torch.options import current_options

    samples, err = _study("mixed_lengths")
    _, seqs, ab, q = samples[0]
    opts = current_options().normalized()
    gc.collect()
    gc.disable()
    try:
        be = CudaBackend(make_rawset(seqs[:300], ab[:300], None, q[:300]),
                         device="cpu")
        be.ALIGN_CACHE_BYTES = 1
        for c in (0, 1):
            be._align_ent(c, opts, be._kernel_geom(len(seqs[c]), opts))
        members = np.arange(2, 40)
        be.cluster_stats_all([(0, members, np.ones(38, bool))], opts,
                             err.shape[1], True)
        assert be._align_evicted
        ref = weakref.ref(be)
        del be
        assert ref() is None
    finally:
        gc.enable()
