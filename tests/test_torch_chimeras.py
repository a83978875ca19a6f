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
    b2 = tch._pairs_lr_stats(be, opts, qi, pi, 16, True)
    b1 = tch._per_query_lr_stats(be, opts, qi, pi, 16, True)
    assert b2 is not None and b1 is not None
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
    got = tch._pairs_lr_stats(be, opts, qi, pi, max_shift, oo)
    b1 = tch._per_query_lr_stats(be, opts, qi, pi, max_shift, oo)
    assert got is not None and b1 is not None
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
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        tch.is_shift_denovo({"ACGT" * 10: 5}, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A5"):
        tch._batch_eval_stats([(0, 1)], ["ACGT", "ACGA"], 5, -4, -8)
