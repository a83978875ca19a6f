"""Parity: the port's chimera removal (dada2_tpu_torch.chimeras, run on the
CPU, where kernels B1 and B2 run as their plain PyTorch version) against
dada2_tpu.chimeras. Tolerance: exact (every output is an integer or a
boolean)."""
import numpy as np
import pandas as pd
import pytest
import torch

import dada2_tpu.chimeras as jch
import dada2_tpu_torch.chimeras as tch
from dada2_tpu.options import current_options

NT = np.array(list("ACGT"))
STATS = ("left", "right", "left_oo", "right_oo", "ham")


@pytest.fixture(scope="module")
def parents():
    rng = np.random.default_rng(42)
    a = "".join(NT[rng.integers(0, 4, 120)])
    b = "".join(NT[rng.integers(0, 4, 120)])
    return a, b


def test_is_bimera_and_denovo(parents):
    a, b = parents
    chimera = a[:60] + b[60:]
    mut = list(chimera)
    mut[60] = "A" if mut[60] != "A" else "C"
    mut = "".join(mut)
    for sq, par, oo in ((chimera, [a, b], False), (a, [b], False),
                        (mut, [a, b], False), (mut, [a, b], True)):
        assert tch.is_bimera(sq, par, allowOneOff=oo, device="cpu") == \
            jch.is_bimera(sq, par, allowOneOff=oo)
    assert tch.is_bimera(chimera, [a, b], device="cpu")
    unqs = {a: 100, b: 80, chimera: 5, mut: 4}
    for oo in (False, True):
        pd.testing.assert_series_equal(
            tch.is_bimera_denovo(unqs, allowOneOff=oo, device="cpu"),
            jch.is_bimera_denovo(unqs, allowOneOff=oo))


@pytest.mark.parametrize("method", ["consensus", "pooled", "per-sample"])
def test_table_and_remove(parents, method):
    a, b = parents
    chimera = a[:60] + b[60:]
    st = pd.DataFrame(
        [[100, 80, 5], [50, 60, 3], [70, 10, 0]],
        index=["s1", "s2", "s3"], columns=[a, b, chimera])
    pd.testing.assert_series_equal(
        tch.is_bimera_denovo_table(st, device="cpu"),
        jch.is_bimera_denovo_table(st))
    got = tch.remove_bimera_denovo(st, method=method, device="cpu")
    pd.testing.assert_frame_equal(got, jch.remove_bimera_denovo(
        st, method=method))
    assert list(got.columns) == [a, b]
    uniq = {a: 100, b: 80, chimera: 5}
    assert tch.remove_bimera_denovo(uniq, device="cpu") == \
        jch.remove_bimera_denovo(uniq)


def _rand_seq(rng, lo, hi):
    return "".join(rng.choice(NT, int(rng.integers(lo, hi))))


def _mutate(rng, s, nsub):
    s = list(s)
    for _ in range(nsub):
        s[int(rng.integers(0, len(s)))] = str(rng.choice(NT))
    return "".join(s)


def _chimera_pool(rng, npar=5, L=120):
    """tests/test_reference_parity_aux.py's pool: parents plus queries that
    are true two-parent chimeras, near-copies of a parent, or random."""
    parents = [_rand_seq(rng, L, L + 1) for _ in range(npar)]
    queries = []
    for _ in range(10):
        r = rng.random()
        if r < 0.5:
            i, j = rng.choice(npar, 2, replace=False)
            cut = int(rng.integers(20, L - 20))
            q = _mutate(rng, parents[i][:cut] + parents[j][cut:],
                        int(rng.integers(0, 2)))
        elif r < 0.8:
            q = _mutate(rng, parents[int(rng.integers(npar))],
                        int(rng.integers(1, 6)))
        else:
            q = _rand_seq(rng, L - 10, L + 10)
        queries.append(q)
    return parents, queries


@pytest.mark.parametrize("trial", range(3))
def test_table_bimera_stats_fuzz(trial):
    """(nflag, nsam) on the chimera-pool fuzz of the reference parity
    tests, with and without one-off bimeras."""
    opts = current_options()
    rng = np.random.default_rng(113 + trial)
    parents, queries = _chimera_pool(rng)
    seqs = parents + queries
    mat = np.zeros((4, len(seqs)), np.int64)
    for i in range(4):
        for j in range(len(seqs)):
            if rng.random() < 0.7:
                mat[i, j] = int(rng.integers(1, 40)) * \
                    (4 if j < len(parents) else 1)
    for oo in (False, True):
        want = jch._table_bimera_stats(mat, seqs, 1.5, 2, oo, 4, 16, opts)
        got = tch._table_bimera_stats(mat, seqs, 1.5, 2, oo, 4, 16, opts,
                                      device="cpu")
        for w, g, name in zip(want, got, ("nflag", "nsam")):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} oo={oo}")


def _route_parity_pairs():
    """tests/test_chimeras.py::test_lr_stats_pallas_route_parity's set."""
    rng = np.random.default_rng(23)
    base = ["".join(NT[rng.integers(0, 4, 60)]) for _ in range(6)]
    seqs = []
    for k in range(40):
        s = list(base[k % 6])
        for _ in range(int(rng.integers(0, 4))):
            s[int(rng.integers(0, len(s)))] = NT[rng.integers(0, 4)]
        if rng.random() < 0.3:
            cut = int(rng.integers(1, 8))
            s = s[cut:] + list(NT[rng.integers(0, 4, cut)])
        seqs.append("".join(s))
    pairs = [(i, int(j)) for i in range(40)
             for j in rng.integers(0, 40, 5) if int(j) != i]
    return pairs, seqs


def _mixed_length_pairs():
    """tests/test_chimeras.py::test_lr_stats_pairs_mode_mixed_lengths's
    set: queries of different lengths land in different blocks."""
    rng = np.random.default_rng(31)
    seqs = []
    for k in range(50):
        L = int(rng.choice([52, 57, 60, 64]))
        seqs.append("".join(NT[rng.integers(0, 4, L)]))
    for k in range(10):
        s = list(seqs[k])
        s[5] = "A" if s[5] != "A" else "C"
        seqs.append("".join(s))
    pairs = [(i, int(j)) for i in range(len(seqs))
             for j in rng.integers(0, len(seqs), 4) if int(j) != i]
    return pairs, seqs


def _cols(stats):
    """The five stat arrays of kernel B2's route ([P, 5] on the device)."""
    assert stats is not None
    return tuple(stats.numpy().T)


@pytest.mark.parametrize("pair_set", ["route_parity", "mixed_lengths"])
@pytest.mark.parametrize("oo", [False, True])
def test_batch_lr_stats_equal(pair_set, oo):
    pairs, seqs = {"route_parity": _route_parity_pairs,
                   "mixed_lengths": _mixed_length_pairs}[pair_set]()
    want = jch._batch_lr_stats(pairs, seqs, 16, 5, -4, -8, oo)
    got = tch._batch_lr_stats(pairs, seqs, 16, 5, -4, -8, oo, device="cpu")
    for w, g, name in zip(want, got, STATS):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_pairs_route_equals_per_query_route():
    """Kernel B2's route and kernel B1's per-query route give the same
    five arrays (so either may serve a pair set)."""
    pairs, seqs = _route_parity_pairs()
    be, opts = tch._chimera_backend(seqs, 5, -4, -8, 16, "cpu")
    qi = np.array([p[0] for p in pairs], np.int64)
    pi = np.array([p[1] for p in pairs], np.int64)
    b2 = _cols(tch._pairs_lr_stats(be, opts, qi, pi, 16, True))
    b1 = tch._per_query_lr_stats(be, opts, qi, pi, 16, True)
    assert b1 is not None
    for x, y, name in zip(b2, b1, STATS):
        np.testing.assert_array_equal(x, y, err_msg=name)
    assert sum(int(x.sum()) for x in b2) > 0


@pytest.mark.parametrize("max_shift", [1, 4, 16])
@pytest.mark.parametrize("oo", [False, True])
def test_pairs_stats_route_matches_jax_pairs_route(monkeypatch, oo,
                                                   max_shift):
    """The pairs route (kernel B2's stats mode, its plain version here)
    against the JAX package's pairs route (the Pallas kernel in interpret
    mode, then _lr_accum_pairs_trace) and against the port's per-query
    route (kernel B1), at band = max_shift."""
    monkeypatch.setenv("DADA2_TPU_PALLAS", "1")
    pairs, seqs = _route_parity_pairs()
    want = jch._batch_lr_stats(pairs, seqs, max_shift, 5, -4, -8, oo)
    be, opts = tch._chimera_backend(seqs, 5, -4, -8, max_shift, "cpu")
    qi = np.array([p[0] for p in pairs], np.int64)
    pi = np.array([p[1] for p in pairs], np.int64)
    got = _cols(tch._pairs_lr_stats(be, opts, qi, pi, max_shift, oo))
    b1 = tch._per_query_lr_stats(be, opts, qi, pi, max_shift, oo)
    assert b1 is not None
    for w, g, q, name in zip(want, got, b1, STATS):
        np.testing.assert_array_equal(g, w, err_msg=name)
        np.testing.assert_array_equal(q, w, err_msg=name)


def _random_alignment_pair(rng, n, gap):
    """A plausible gapped alignment (tests/test_chimeras.py's generator):
    never a gap in both rows at once, end-gap runs, interior indels."""
    al0 = rng.integers(1, 5, n).astype(np.uint8)
    al1 = np.where(rng.random(n) < 0.7, al0,
                   rng.integers(1, 5, n)).astype(np.uint8)
    lead = int(rng.integers(0, min(25, n // 3 + 1)))
    trail = int(rng.integers(0, min(25, n // 3 + 1)))
    if lead:
        (al0 if rng.random() < 0.5 else al1)[:lead] = gap
    if trail:
        (al0 if rng.random() < 0.5 else al1)[n - trail:] = gap
    for _ in range(int(rng.integers(0, 4))):
        p = int(rng.integers(lead + 1, max(lead + 2, n - trail - 1)))
        (al0 if rng.random() < 0.5 else al1)[p] = gap
    both = (al0 == gap) & (al1 == gap)
    al1[both] = 1
    return al0, al1


@pytest.mark.parametrize("max_shift", [1, 4, 16])
@pytest.mark.parametrize("oo", [False, True])
def test_class_scans_match_host_scans(max_shift, oo):
    """The torch diagonal-space scans over column classes
    (_lr_accum_pairs) against the host column scans (_lr_ham_batch), and
    the port's host copy against dada2_tpu's, on random alignments with
    inactive diagonals interleaved."""
    gap, pad = tch.GAP, tch._PAD
    rng = np.random.default_rng(500 + max_shift)
    P, D = 200, 460
    lens = rng.integers(8, 200, P)
    A = np.full((P, int(lens.max())), pad, np.uint8)
    B = np.full_like(A, pad)
    cls = np.zeros((P, D), np.int64)
    for p in range(P):
        a0, a1 = _random_alignment_pair(rng, int(lens[p]), gap)
        A[p, : lens[p]] = a0
        B[p, : lens[p]] = a1
        c = np.where(a0 == gap, 1, np.where(a1 == gap, 2,
                                             np.where(a0 != a1, 3, 4)))
        # the kernel's rows: one active step per column, in order, with
        # inactive diagonals (skipped by diagonal steps) in between
        slots = np.sort(rng.choice(D, int(lens[p]), replace=False))
        cls[p, slots] = c
    host = tch._lr_ham_batch(A, B, lens.astype(np.int64), oo, max_shift)
    want = jch._lr_ham_batch(A, B, lens.astype(np.int64), oo, max_shift)
    got = tch._lr_accum_pairs(torch.from_numpy(cls), allow_one_off=oo,
                              max_shift=max_shift).numpy()
    for k, name in enumerate(STATS):
        np.testing.assert_array_equal(host[k], want[k], err_msg=name)
        np.testing.assert_array_equal(got[:, k], want[k], err_msg=name)


def test_not_ported_raise():
    """is_shift_denovo and its unbanded eval_pair statistics (once refused)
    run through kernel B4's scalar aligner and equal dada2_tpu's. The
    name is the refusal check's it replaced."""
    pd.testing.assert_series_equal(
        tch.is_shift_denovo({"ACGT" * 10: 5}, device="cpu"),
        jch.is_shift_denovo({"ACGT" * 10: 5}))
    pairs, seqs = _route_parity_pairs()
    want = jch._batch_eval_stats(pairs, seqs, 5, -4, -8)
    got = tch._batch_eval_stats(pairs, seqs, 5, -4, -8, device="cpu")
    for w, g, name in zip(want, got, ("match", "mismatch", "indel")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert sum(int(x.sum()) for x in got) > 0
    for out in (tch._batch_eval_stats([], seqs, 5, -4, -8, device="cpu"),
                jch._batch_eval_stats([], seqs, 5, -4, -8)):
        assert [len(x) for x in out] == [0, 0, 0]


def _shift_uniques(seed):
    """Uniques where shifted and trimmed copies of abundant sequences
    appear at lower abundance, plus mutants and unrelated sequences."""
    rng = np.random.default_rng(seed)
    base = ["".join(NT[rng.integers(0, 4, 80)]) for _ in range(4)]
    unqs = {}
    for k, b in enumerate(base):
        unqs[b] = 200 - k
        unqs[b[5:] + "".join(NT[rng.integers(0, 4, 5)])] = 50 - k
        unqs[b[:60]] = 40 - k
        unqs["GT" + b[:70]] = 30 - k
        unqs[_mutate(rng, b, 2)] = 20 - k
    unqs["".join(NT[rng.integers(0, 4, 75)])] = 3
    return unqs


@pytest.mark.parametrize("kw", [dict(), dict(flagSubseqs=True),
                                dict(minOverlap=70)],
                         ids=["default", "subseqs", "overlap70"])
def test_is_shift_denovo_equal(kw):
    unqs = _shift_uniques(61)
    got = tch.is_shift_denovo(unqs, device="cpu", **kw)
    pd.testing.assert_series_equal(got, jch.is_shift_denovo(unqs, **kw))
    assert got.any() and not got.all()


def _long_pairs():
    """Queries of ~200 nt against mutated, shifted parents: at
    maxShift=150 their window is wider than kernel B1's and B2's."""
    rng = np.random.default_rng(77)
    base = ["".join(NT[rng.integers(0, 4, 200)]) for _ in range(4)]
    seqs = []
    for k in range(16):
        s = list(base[k % 4])
        for _ in range(int(rng.integers(0, 5))):
            s[int(rng.integers(0, len(s)))] = NT[rng.integers(0, 4)]
        cut = int(rng.integers(0, 30))
        seqs.append("".join(s[cut:] + list(NT[rng.integers(0, 4, cut)])))
    pairs = [(i, int(j)) for i in range(16)
             for j in rng.integers(0, 16, 6) if int(j) != i]
    return pairs, seqs


@pytest.mark.parametrize("oo", [False, True])
def test_fallback_route_matches_jax_nw_batch_route(oo):
    """Pairs that fit neither kernel route (here maxShift=150) go through
    kernel B4 and its torch scans; the five arrays equal the JAX package's
    nw_batch route (a pair set under 256 pairs takes it there)."""
    pairs, seqs = _long_pairs()
    assert len(pairs) < 256
    be, opts = tch._chimera_backend(seqs, 5, -4, -8, 150, "cpu")
    qi = np.array([p[0] for p in pairs], np.int64)
    pi = np.array([p[1] for p in pairs], np.int64)
    assert tch._pairs_plan(be, opts, qi, pi) is None
    assert tch._per_query_lr_stats(be, opts, qi, pi, 150, oo) is None
    want = jch._batch_lr_stats(pairs, seqs, 150, 5, -4, -8, oo)
    got = tch._batch_lr_stats(pairs, seqs, 150, 5, -4, -8, oo,
                              device="cpu")
    for w, g, name in zip(want, got, STATS):
        np.testing.assert_array_equal(g, w, err_msg=name)
    # the same pairs at maxShift=16 through B4's scans equal the B2 route
    b4 = tch._nw_batch_lr_stats(np.asarray(pairs), seqs, 16, 5, -4, -8, oo,
                                device="cpu")
    b2 = tch._batch_lr_stats(pairs, seqs, 16, 5, -4, -8, oo, device="cpu")
    for x, y, name in zip(b4, b2, STATS):
        np.testing.assert_array_equal(x, y, err_msg=name)


def test_alignment_code_mats_equal():
    """The host code matrices of kernel B4's alignments, and the torch
    scans over them, against dada2_tpu's."""
    pairs, seqs = _route_parity_pairs()
    from dada2_tpu_torch.encode import pack_sequences

    mat, lens = pack_sequences(seqs)
    got = tch._alignment_code_mats(pairs, mat, lens, 16, 5, -4, -8,
                                   device="cpu")
    want = jch._alignment_code_mats(pairs, mat, lens, 16, 5, -4, -8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    host = tch._lr_ham_batch(*got, True, 16)
    b4 = tch._nw_batch_lr_stats(np.asarray(pairs), seqs, 16, 5, -4, -8,
                                True, device="cpu")
    for x, y, name in zip(host, b4, STATS):
        np.testing.assert_array_equal(x, y, err_msg=name)


# ---- the consensus table on the device ------------------------------------

def _host_plan(be, opts, qi, pi):
    """Kernel B2's layout of host pairs built on the host, as the port
    built it before the plan moved to the device: (qblk, pblk, scal, pos,
    order, WP), or None where the window does not fit."""
    P = len(qi)
    lens = be.lens
    band = int(opts.BAND_SIZE)
    l1s = lens[qi]
    order = np.argsort(l1s, kind="stable")
    qs, ps = qi[order], pi[order]
    l1o = l1s[order]
    bounds = np.nonzero(np.diff(l1o))[0] + 1
    starts = np.concatenate([[0], bounds]).astype(np.int64)
    ends = np.concatenate([bounds, [P]]).astype(np.int64)
    WPmax = 8
    for s, e in zip(starts, ends):
        gl2 = lens[ps[s:e]]
        WPmax = max(WPmax, tch.nww.block_window(
            int(l1o[s]), np.array([int(gl2.min()), int(gl2.max())]), band))
    WP = tch.nww._round_up(WPmax, 32)
    if WP > tch.nww.WP_MAX:
        return None
    LANES = tch.LANES
    gsizes = ends - starts
    gblocks = -(-gsizes // LANES)
    gbase = np.concatenate([[0], np.cumsum(gblocks)[:-1]])
    nb = int(gblocks.sum())
    gid = np.repeat(np.arange(len(starts)), gsizes)
    t_in = np.arange(P) - starts[gid]
    blk = gbase[gid] + t_in // LANES
    lane = t_in % LANES
    qblk = np.zeros((nb, LANES), np.int64)
    pblk = np.zeros((nb, LANES), np.int64)
    filled = np.zeros((nb, LANES), bool)
    qblk[blk, lane] = qs
    pblk[blk, lane] = ps
    filled[blk, lane] = True
    padm = ~filled
    qblk[padm] = np.broadcast_to(qblk[:, :1], qblk.shape)[padm]
    pblk[padm] = np.broadcast_to(pblk[:, :1], pblk.shape)[padm]
    l2b = lens[pblk]
    len1b = l1o[np.repeat(starts, gblocks)].astype(np.int64)
    scal = np.stack([
        len1b, l2b.max(axis=1),
        band + np.maximum(0, l2b.max(axis=1) - len1b),
        l2b.min(axis=1)], axis=1).astype(np.int32)
    return qblk, pblk, scal, blk * LANES + lane, order, WP


def _consensus_table(case):
    """(mat, seqs, maxShift) of a small sequence table: parents, their
    two-parent chimeras (some trimmed, some mutated) and near-copies.
    "ties" deals abundances on a grid where many parent candidates sit
    exactly at fold (1.5) x abundance or at minParentAbundance (2);
    "absent" adds columns present in no sample and samples with no
    parentable column; "lengths" mixes query lengths (several groups,
    padding lanes); "wide" is aligned at maxShift 150, a window kernel
    B2 does not fit."""
    rng = np.random.default_rng({"random": 7, "ties": 8, "absent": 9,
                                 "lengths": 10, "wide": 11}[case])
    L = 130 if case == "wide" else 64
    npar = 6
    parents = ["".join(NT[rng.integers(0, 4, L)]) for _ in range(npar)]
    seqs = list(parents)
    while len(seqs) < (20 if case == "wide" else 36):
        r = rng.random()
        if r < 0.6:
            i, j = rng.choice(npar, 2, replace=False)
            cut = int(rng.integers(10, L - 10))
            s = _mutate(rng, parents[i][:cut] + parents[j][cut:],
                        int(rng.integers(0, 2)))
        else:
            s = _mutate(rng, parents[int(rng.integers(npar))],
                        int(rng.integers(1, 4)))
        if case == "lengths" and rng.random() < 0.6:
            s = s[:len(s) - int(rng.integers(1, 9))]
        if s not in seqs:
            seqs.append(s)
    nsam = 6
    mat = np.zeros((nsam, len(seqs)), np.int64)
    for a in range(nsam):
        for b in range(len(seqs)):
            if rng.random() < 0.7:
                mat[a, b] = int(rng.integers(1, 40)) * \
                    (4 if b < npar else 1)
    if case == "ties":
        grid = np.array([0, 1, 2, 3, 4, 6, 9])
        mat = grid[rng.integers(0, len(grid), mat.shape)]
    if case == "absent":
        mat[:, [3, 17, 30]] = 0
        mat[2] = np.minimum(mat[2], 1)
        mat[4] = 0
    return mat, seqs, 150 if case == "wide" else 16


def _spy(monkeypatch, module, name, seen):
    """Replace module.name by a wrapper that records its arguments and
    result in seen[name]."""
    inner = getattr(module, name)

    def spy(*a, **kw):
        out = inner(*a, **kw)
        seen[name] = (a, out)
        return out

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("oo", [False, True])
@pytest.mark.parametrize("case", ["random", "ties", "absent", "lengths",
                                  "wide"])
def test_consensus_table_on_device(monkeypatch, case, oo):
    """The consensus table's device path on the CPU against dada2_tpu's
    host loop, each package running is_bimera_denovo_table once: the
    flags, (nflag, nsam), the union parent pairs (dada2_tpu's list handed
    to its _batch_lr_stats) and the stats equal; kernel B2's device layout
    equals the host layout element for element (or both refuse the
    window), and the device vote alone gives (nflag, nsam). The row and
    pair chunks are cut small, and B2's launches to 2 blocks, so that
    every chunk, padding lane and tail launch path runs."""
    mat, seqs, max_shift = _consensus_table(case)
    nsam, ncol = mat.shape
    monkeypatch.setattr(tch, "TABLE_CHUNK", 7 * nsam * ncol)
    monkeypatch.setattr(tch, "VOTE_CHUNK", 37 * nsam)
    monkeypatch.setattr(tch, "CH_BLOCKS", 2)
    st = pd.DataFrame(mat, index=[f"s{i}" for i in range(nsam)],
                      columns=seqs)
    kw = dict(allowOneOff=oo, maxShift=max_shift)
    jseen, tseen = {}, {}
    for name in ("_batch_lr_stats", "_table_bimera_stats"):
        _spy(monkeypatch, jch, name, jseen)
    for name in ("_pairs_lr_stats", "_unplanned_lr_stats",
                 "_table_bimera_stats"):
        _spy(monkeypatch, tch, name, tseen)
    pd.testing.assert_series_equal(
        tch.is_bimera_denovo_table(st, device="cpu", **kw),
        jch.is_bimera_denovo_table(st, **kw))
    want = jseen["_table_bimera_stats"][1]
    for g, w, name in zip(tseen["_table_bimera_stats"][1], want,
                          ("nflag", "nsam")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert want[0].any()
    jpairs = np.asarray(jseen["_batch_lr_stats"][0][0],
                        np.int64).reshape(-1, 2)
    pairs = tch._table_pairs(torch.from_numpy(mat), 1.5, 2)
    np.testing.assert_array_equal(pairs.numpy(), jpairs)
    be, opts = tch._chimera_backend(seqs, 5, -4, -8, max_shift, "cpu")
    plan = tch._pairs_plan(be, opts, pairs[:, 0], pairs[:, 1])
    host = _host_plan(be, opts, jpairs[:, 0].copy(), jpairs[:, 1].copy())
    stats = tseen["_pairs_lr_stats"][1]
    if case == "wide":
        assert host is None and plan is None and stats is None
        stats = torch.from_numpy(np.stack(tseen["_unplanned_lr_stats"][1],
                                          1))
    else:
        assert "_unplanned_lr_stats" not in tseen
        got = (plan.qblk, plan.pblk, plan.scal, plan.pos, plan.order)
        for g, h, name in zip(got, host, ("qblk", "pblk", "scal", "pos",
                                           "order")):
            np.testing.assert_array_equal(g.numpy(), h, err_msg=name)
        assert plan.WP == host[5]
        if case == "lengths":
            lens1 = plan.scal[:, 0].numpy()
            assert len(np.unique(lens1)) >= 3
            assert len(lens1) > 2 and len(lens1) % 2 == 1  # a tail launch
            assert (plan.qblk.numpy() == plan.qblk[:, :1].numpy()).all(
                1).any()                                   # padding lanes
    for g, w, name in zip(stats.numpy().T, jseen["_batch_lr_stats"][1],
                          STATS):
        np.testing.assert_array_equal(g, w, err_msg=name)
    votes = tch._table_votes(mat, be.lens, pairs, stats, 1.5, 2, oo, 4)
    for g, w, name in zip(votes, want, ("nflag", "nsam")):
        np.testing.assert_array_equal(g, w, err_msg=name)


def test_consensus_table_without_pairs():
    """A table where no column has a parent (every abundance within the
    fold of every other) has no pairs: nothing is aligned, and no column
    is flagged, as in dada2_tpu."""
    mat, seqs, _ = _consensus_table("random")
    mat = np.where(mat > 0, 5, 0)
    assert len(tch._table_pairs(mat, 1.5, 2)) == 0
    want = jch._table_bimera_stats(mat, seqs, 1.5, 2, True, 4, 16,
                                   current_options())
    got = tch._table_bimera_stats(mat, seqs, 1.5, 2, True, 4, 16,
                                  current_options(), device="cpu")
    for g, w, name in zip(got, want, ("nflag", "nsam")):
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert not got[0].any() and got[1].any()


def test_consensus_table_fetches_little():
    """A consensus table on kernel B2's route crosses back only its small
    reads (the plan's per-length pair counts and extremes, the end-flag
    check, each column's nflag and nsam): under 1 MB, and nothing that
    grows with the pairs, whose stats (24 bytes a pair) used to cross
    whole. The chimera_pairs counter holds the table's pair count,
    process-wide and on its chimera.table span."""
    from dada2_tpu_torch import trace

    mat, seqs, _ = _consensus_table("random")
    mat = np.concatenate([mat, mat[::-1] + 1])
    st = pd.DataFrame(mat, index=[f"s{i}" for i in range(len(mat))],
                      columns=seqs)
    npairs = len(tch._table_pairs(mat, 1.5, 2))
    c = trace.COUNTERS
    f0, n0, p0 = c.fetch_bytes, c.device_fetches, c.chimera_pairs
    trace.reset()
    with trace.tracing():
        out = tch.remove_bimera_denovo(st, method="consensus", device="cpu")
    fetched = c.fetch_bytes - f0
    maxlen = max(len(s) for s in seqs)
    assert fetched < 1 << 20
    assert fetched <= 8 * (3 * (maxlen + 1) + 2 * len(seqs)) < 24 * npairs
    assert c.device_fetches - n0 == 2
    assert c.chimera_pairs - p0 == npairs > 500
    (table,) = [s for s in trace.spans() if s.name == "chimera.table"]
    assert table.counters["chimera_pairs"] == npairs
    assert table.counters["fetch_bytes"] == fetched
    assert 0 < out.shape[1] < len(seqs)
