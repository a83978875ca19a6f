"""The port's engine keeps cluster membership as flat arrays updated in
place (core/engine.py Membership); dada2_tpu's keeps a Python list of
slots per cluster. Both engines run in lockstep on one deterministic
gapless backend, and after every bud and every shuffle pass the port's
state must equal dada2_tpu's exactly: each cluster's slot order, reads,
center and birth record, cluster_of, p, the comparisons each raw holds,
locks and the speculation hints. Then the native surgery against its
numpy fallback on random cluster states."""
import dataclasses
import gc
import itertools
import weakref

import numpy as np
import pytest

from dada2_tpu.core.engine import MAX_SHUFFLE
from dada2_tpu.core.engine import Engine as EngineJ
from dada2_tpu.core.raws import make_rawset as make_rawset_j
from dada2_tpu.options import DEFAULT_OPTIONS as OPTS_J
from dada2_tpu_torch.core.backend_ref import GaplessBackend
from dada2_tpu_torch.core.engine import Engine as EngineT
from dada2_tpu_torch.core.engine import Membership
from dada2_tpu_torch.core.raws import make_rawset as make_rawset_t
from dada2_tpu_torch.data import tperr1
from dada2_tpu_torch.options import DEFAULT_OPTIONS as OPTS_T
from dada2_tpu_torch.trace import COUNTERS


def _sample(seed, nasv, nreads, L=100):
    """(sequences by decreasing abundance, abundances, quals [n, L]): reads
    of nasv ASVs, half of them a few substitutions from an earlier one,
    with substitution errors at a falling quality profile's rate."""
    rng = np.random.default_rng(seed)
    asvs = rng.integers(0, 4, (nasv, L))
    for k in range(1, nasv):
        if rng.random() < 0.5:
            child = asvs[rng.integers(0, k)].copy()
            at = rng.choice(L, rng.integers(1, 4), replace=False)
            child[at] = (child[at] + rng.integers(1, 4, len(at))) % 4
            asvs[k] = child
    w = np.exp(rng.normal(0.0, 1.6, nasv))
    reads = np.repeat(asvs, rng.multinomial(nreads, w / w.sum()), axis=0)
    q = np.clip(38 - np.arange(L) // 6, 12, 40)
    hit = rng.random(reads.shape) < 10.0 ** (-q / 10.0)
    reads[hit] = (reads[hit] + rng.integers(1, 4, hit.sum())) % 4
    uniq, cnt = np.unique(reads, axis=0, return_counts=True)
    order = np.argsort(-cnt, kind="stable")
    seqs = ["".join("ACGT"[c] for c in uniq[k]) for k in order]
    quals = np.tile(q.astype(np.float64), (len(seqs), 1))
    return seqs, cnt[order].astype(np.int64), quals


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a


def _assert_same(ej, et):
    assert len(ej.clusters) == len(et.clusters)
    for cj, ct in zip(ej.clusters, et.clusters):
        np.testing.assert_array_equal(np.asarray(cj.slots, np.int64),
                                      ct.slots)
        assert (cj.reads, cj.center) == (ct.reads, ct.center)
        for f in ("birth_type", "birth_from", "birth_pval", "birth_fold",
                  "birth_e", "birth_comp_i", "birth_comp_lam",
                  "birth_comp_ham"):
            assert getattr(cj, f) == getattr(ct, f), f
    for name in ("cluster_of", "p", "comp_i", "comp_lam", "comp_ham",
                 "lock", "E_minmax", "bud_candidates"):
        np.testing.assert_array_equal(_bits(getattr(ej, name)),
                                      _bits(getattr(et, name)), name)


def _assert_same_comps(ej, et):
    for cj, ct in zip(ej.clusters, et.clusters):
        for a, b in zip(cj.comps(), ct.comps()):
            np.testing.assert_array_equal(_bits(a), _bits(b))


def _lockstep(ej, et, opts):
    """Engine.run's loop on both engines at once, their states compared
    after every bud and every shuffle pass; the passes that moved raws."""
    moved = 0
    for e in (ej, et):
        e.compare(0, opts.USE_KMERS, 1.0)
        e.p_update()
    _assert_same(ej, et)
    while len(et.clusters) < et.n:
        newi = ej.bud()
        assert et.bud() == newi
        _assert_same(ej, et)
        if not newi:
            break
        for e in (ej, et):
            e.compare(newi, opts.USE_KMERS, opts.KDIST_CUTOFF)
        nshuffle = 0
        while True:
            sj = ej.shuffle()
            assert et.shuffle() == sj
            _assert_same(ej, et)
            moved += sj
            if not (sj and nshuffle + 1 < MAX_SHUFFLE):
                break
            nshuffle += 1
        for e in (ej, et):
            e.p_update()
    _assert_same(ej, et)
    _assert_same_comps(ej, et)
    return moved


CASES = list(itertools.product((True, False), (1.0, 2.0), (False, True),
                               (True, False)))


@pytest.mark.parametrize("greedy,min_fold,priors,native", CASES)
def test_engine_matches_dada2_tpu(greedy, min_fold, priors, native,
                                  monkeypatch):
    """Lockstep against dada2_tpu's engine at GREEDY on and off, MIN_FOLD
    1 and 2, with and without priors, native code on and off; samples of
    a few hundred to about 2,000 uniques. Shuffles moved raws and the
    engine budded more than a few clusters."""
    if not native:
        monkeypatch.setenv("DADA2_TPU_NATIVE", "0")
    k = CASES.index((greedy, min_fold, priors, native))
    seqs, ab, quals = _sample(11 + k, 12 + 3 * k, 2000 + 600 * k)
    pri = None
    if priors:
        pri = np.random.default_rng(k).random(len(seqs)) < 0.05
    kw = dict(GREEDY=greedy, MIN_FOLD=min_fold, OMEGA_A=1e-20)
    oj, ot = (dataclasses.replace(o, **kw) for o in (OPTS_J, OPTS_T))
    rs_j = make_rawset_j(seqs, ab, pri, quals)
    rs_t = make_rawset_t(seqs, ab, pri, quals)
    err = tperr1()
    be = GaplessBackend(rs_t)
    ej = EngineJ(rs_j, err, oj, be)
    et = EngineT(rs_t, err, ot, be)
    moved0 = COUNTERS.shuffle_moved
    assert _lockstep(ej, et, ot) > 0
    assert len(et.clusters) > 3
    assert COUNTERS.shuffle_moved > moved0


def test_engine_freed_without_cycle_collector():
    """The engine holds no reference cycle (a cluster refers to neither
    its engine nor other clusters): dropped after a run, it and its
    backend, which on the card holds the sample's device memory, are
    freed at once with the cycle collector off."""
    seqs, ab, quals = _sample(3, 10, 1500)
    rs = make_rawset_t(seqs, ab, None, quals)
    gc.collect()
    gc.disable()
    try:
        be = GaplessBackend(rs)
        eng = EngineT(rs, tperr1(), OPTS_T, be)
        eng.run()
        assert len(eng.clusters) > 1
        refs = weakref.ref(eng), weakref.ref(be)
        del eng, be
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def _random_state(rng, n, nclust):
    """A Membership of n raws dealt to nclust clusters, each cluster's
    slots shuffled by random pops and appends; its centers the first
    slot. Cluster nclust - 1 is the newest, one raw."""
    mem = Membership(rng.integers(1, 50, n))
    for _ in range(nclust - 1):
        mem.new_cluster()
    for _ in range(3 * n):
        r = int(rng.integers(0, n))
        i = int(mem.cluster_of[r])
        if mem.lens[i] > 1:
            mem.pop(i, int(mem.slot_of[r]))
            mem.append(int(rng.integers(0, nclust - 1)), r)
    newest = int(np.flatnonzero(mem.lens[:nclust] > 1)[0])
    r = int(mem.slots(newest)[-1])
    mem.pop(newest, int(mem.slot_of[r]))
    mem.append(nclust - 1, r)
    for i in range(nclust):
        if mem.lens[i]:
            mem.center[i] = mem.slots(i)[0]
    return mem


def _movers(rng, mem, nclust, case):
    """Movers in the engine's order (ascending cluster, descending slot)
    and their targets, for one of the cases below."""
    cl = mem.cluster_of
    n = len(cl)
    free = np.flatnonzero(np.arange(n) != mem.center[cl])
    if case == "tail":          # every cluster's last slot
        ends = [mem.slots(i)[-1] for i in range(nclust) if mem.lens[i] > 1]
        raws = np.array(ends, np.int64)
    elif case == "center_only":  # all of one cluster but its center
        big = int(np.argmax(mem.lens[:nclust]))
        raws = np.setdiff1d(mem.slots(big), [mem.center[big]])
    else:
        raws = rng.choice(free, len(free) // 4, replace=False)
    if case == "newest":        # every mover into the newest cluster
        tgts = np.full(len(raws), nclust - 1, np.int64)
    elif case == "grow":        # far more than one slot array holds
        tgts = np.full(len(raws), 1, np.int64)
    else:
        tgts = (cl[raws] + rng.integers(1, nclust, len(raws))) % nclust
    order = np.lexsort((-mem.slot_of[raws], cl[raws]))
    return raws[order], tgts[order]


@pytest.mark.parametrize("case", ["tail", "center_only", "newest", "grow",
                                  "random"])
def test_native_surgery_matches_fallback(case, monkeypatch):
    """Membership.move through dada2_shuffle_move against its numpy
    fallback (DADA2_TPU_NATIVE=0) on random cluster states: movers at
    clusters' tails, a cluster left with only its center, moves into the
    newest cluster, a slot array that has to grow, random moves. Every
    slot order, length, read total, cluster and slot of a raw agree, and
    the membership stays consistent."""
    from dada2_tpu_torch.native import get_lib

    if get_lib() is None:
        pytest.skip("the native library did not build (no g++)")
    for seed in range(4):
        rng = np.random.default_rng([seed, len(case)])
        n, nclust = int(rng.integers(40, 400)), int(rng.integers(3, 12))
        states = []
        for native in (True, False):
            mem = _random_state(np.random.default_rng(seed), n, nclust)
            raws, tgts = _movers(np.random.default_rng(seed + 7), mem,
                                 nclust, case)
            cap1 = int(mem.caps[1])
            cl_of_first = mem.cluster_of[raws[0]]
            if native:
                mem.move(raws, tgts)
            else:
                with monkeypatch.context() as m:
                    m.setenv("DADA2_TPU_NATIVE", "0")
                    mem.move(raws, tgts)
            states.append(mem)
        a, b = states
        assert len(raws)
        for i in range(nclust):
            np.testing.assert_array_equal(a.slots(i), b.slots(i))
            np.testing.assert_array_equal(
                np.sort(a.slots(i)), np.flatnonzero(a.cluster_of == i))
            np.testing.assert_array_equal(a.slot_of[a.slots(i)],
                                          np.arange(a.lens[i]))
        for f in ("lens", "reads", "cluster_of", "slot_of"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
        np.testing.assert_array_equal(
            a.reads[:nclust],
            np.bincount(a.cluster_of, a.raw_reads, nclust).astype(np.int64))
        if case == "grow":
            assert a.caps[1] > cap1
        if case == "center_only":
            assert a.lens[int(cl_of_first)] == 1
