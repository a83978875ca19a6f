"""Parity: the plain PyTorch version of the wavefront kernel's pairs mode
(B2), its stats mode (B2 stats, nw_pairs_stats) and kinds mode (B3), what
the wrappers run on CPU tensors, against the TPU Pallas kernel in the same
modes, run in interpret mode (B2 stats: followed by the JAX package's
_lr_accum_pairs_trace); and nw_wavefront_grouped against
nw_pallas_grouped. Tolerance: exact (every output is an integer or a
boolean). The CUDA kernel itself is held against the plain version on the
card by chip_smoke.py and the gpu-marked tests. The JAX package is
imported inside the tests that compare with it, so that the gpu tests run
where jax is not installed (`pytest --noconftest -m gpu`)."""
import functools
import itertools
import pathlib

import numpy as np
import pytest
import torch

from dada2_tpu_torch.ops import nw_wavefront as nww
from test_torch_nw_wavefront import _mutate, make_inputs

LANES = nww.LANES
GEOM = dict(match=5, mismatch=-4, gap_p=-8)
SAM1F = pathlib.Path(__file__).parent / "extdata" / "sam1F.fastq.gz"
GROUPED_OUTS = ("kinds", "p0", "p1", "ham", "tvec", "ok")


def _nwp():
    from dada2_tpu.ops import nw_pallas

    return nw_pallas


def pairs_inputs(rng, blocks, band=16, wp=None, quals=False):
    """Pairs-mode kernel inputs: blocks is a list of (len1, pairs) with
    pairs a list of (query [len1], parent) code arrays, at most 128 per
    block; pad lanes repeat lane 0 of their block, as the chimera route
    lays them out. wp gives the window's rows (narrower than the band
    needs cuts it, the buffers keep the wider window's size); quals puts
    random qualities into s2q."""
    nb = len(blocks)
    cand, block_idx, len1s = [], [], []
    queries = np.zeros((nb, LANES), object)
    for b, (len1, pairs) in enumerate(blocks):
        rows = [len(cand) + k for k in range(len(pairs))]
        cand.extend(p for _, p in pairs)
        rows += [rows[0]] * (LANES - len(rows))
        block_idx.append(rows)
        len1s.append(len1)
        for k in range(LANES):
            queries[b, k] = pairs[k if k < len(pairs) else 0][0]
    block_idx = np.array(block_idx, np.int64)
    l2all = np.array([len(c) for c in cand], np.int64)
    s2b = np.full((len(cand), int(l2all.max())), 255, np.uint8)
    for k, c in enumerate(cand):
        s2b[k, : len(c)] = c
    W = max(nww.block_window(len1s[b], l2all[block_idx[b]], band)
            for b in range(nb))
    W = nww._round_up(max(W, 8), 32)
    WP = wp or W
    NDP = nww._round_up(max(len1s) + int(l2all.max()) + 1, 8)
    L1R = nww._round_up(max(len1s) + 1 + max(W, WP), 8)
    L2R = nww._round_up(int(l2all.max()) + max(W, WP), 8)
    merged = s2b.astype(np.int64) & 3
    if quals:
        merged |= rng.integers(2, 41, s2b.shape) << 2
    s2q = nww.pack_s2_blocks(merged, l2all, block_idx, L2R)
    scal = np.zeros((nb, 4), np.int32)
    params = np.zeros((nb, 8, LANES), np.int32)
    s1 = np.zeros((nb, L1R, LANES), np.int32)
    for b in range(nb):
        len1 = len1s[b]
        l2 = l2all[block_idx[b]]
        scal[b] = (len1, int(l2.max()), band + max(0, int(l2.max()) - len1),
                   int(l2.min()))
        params[b, 0] = l2
        params[b, 1] = band + np.maximum(0, len1 - l2)
        params[b, 2] = band + np.maximum(0, l2 - len1)
        for k in range(LANES):
            s1[b, 1: 1 + len1, k] = queries[b, k]
    geom = dict(L1R=L1R, L2R=L2R, NDP=NDP, WP=WP, **GEOM)
    return (scal, params, s1, s2q), geom


def _check(arrays, geom, emit_kinds, s1_per_block, names, case=None):
    """The port's outputs (CPU tensors: the plain version) against the
    Pallas kernel's in interpret mode, exactly; the tracebacks' ends as
    the case expects (_assert_ends). Returns the port's outputs."""
    want = _nwp()._pallas_call(*arrays, end_gap_p=0, interpret=True,
                            emit_kinds=emit_kinds, halves=1,
                            s1_per_block=s1_per_block, **geom)
    got = nww.nw_wavefront(*(torch.from_numpy(a) for a in arrays),
                           emit_kinds=emit_kinds, s1_per_block=s1_per_block,
                           **geom)
    assert len(got) == len(want) == len(names)
    for name, w, g in zip(names, want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                      err_msg=name)
    _assert_ends(case, arrays, got[-1].numpy())
    return got


def _family(rng, len1, n, nops):
    """n (query, parent) pairs: distinct queries of length len1, each
    against a mutated copy of itself (indels change the parent's length)."""
    out = []
    for _ in range(n):
        q = rng.integers(0, 4, len1).astype(np.uint8)
        out.append((q, _mutate(rng, q, nops=nops)))
    return out


def _short_parents(rng, len1=40):
    """Parents of length 0, 1 and 2 (cut from their queries, and one
    random base) beside mutated copies."""
    qs = [rng.integers(0, 4, len1).astype(np.uint8) for _ in range(4)]
    return ([(qs[0], qs[0][:0]), (qs[1], qs[1][:1]), (qs[2], qs[2][3:5]),
             (qs[3], rng.integers(0, 4, 1).astype(np.uint8))]
            + _family(rng, len1, 20, 6))


def _cut_parents(rng, len1=150, cut=100, step=4):
    """Queries against their own prefixes, up to cut - step nt shorter,
    and mutated copies: at the defaults the band needs a window of about
    80 rows."""
    out = []
    for k in range(0, cut, step):
        q = rng.integers(0, 4, len1).astype(np.uint8)
        out.append((q, q[: len1 - k]))
    return out + _family(rng, len1, 30, 8)


# lanes (block, lane) given len2 = len2max + 1, a geometry the kernel's
# buffers cannot hold: those tracebacks fail and report (len1, len2)
FAILED_LANES = {"failed_lane": [(0, 5), (1, 0)]}
# windows (rows) cut below what the band needs: tracebacks that leave the
# window get stuck, and the class rows class their last step as 4
CUT_WP = {"window_cut": 32}

PAIRS_CASES = {
    # per-lane distinct queries, one len1, substitutions and indels
    "distinct_queries": lambda rng: [(60, _family(rng, 60, 128, 8))],
    # mixed parent lengths: shifts and truncations past the band
    "mixed_l2": lambda rng: [(70, [
        (q, p) for q in [rng.integers(0, 4, 70).astype(np.uint8)]
        for p in (q[5:], q[:61], np.concatenate([q, q[:9]]),
                  rng.integers(0, 4, 50).astype(np.uint8))]
        + _family(rng, 70, 60, 12))],
    # two blocks of different len1 in one launch
    "two_len1": lambda rng: [(48, _family(rng, 48, 128, 6)),
                             (90, _family(rng, 90, 128, 10))],
    # a ragged tail: pad lanes repeat lane 0
    "pad_tail": lambda rng: [(150, _family(rng, 150, 128, 20)),
                             (150, _family(rng, 150, 37, 20))],
    # parents of length 0, 1 and 2
    "short_parents": lambda rng: [(40, _short_parents(rng))],
    # a window cut below the band (CUT_WP): stuck tracebacks
    "window_cut": lambda rng: [(150, _cut_parents(rng))],
    # lanes whose geometry fails (FAILED_LANES), one of them a pad lane's
    # source, over two blocks
    "failed_lane": lambda rng: [(60, _family(rng, 60, 128, 8)),
                                (58, _family(rng, 58, 50, 8))],
}


def pairs_case(case):
    """A PAIRS_CASES mix's kernel inputs (arrays, geometry), with its
    window cut and its failed lanes applied."""
    rng = np.random.default_rng(len(case))
    arrays, geom = pairs_inputs(rng, PAIRS_CASES[case](rng),
                                wp=CUT_WP.get(case),
                                quals=case in ("short_parents", "window_cut",
                                               "failed_lane"))
    for b, lane in FAILED_LANES.get(case, ()):
        arrays[1][b, 0, lane] = arrays[0][b, 1] + 1
    return arrays, geom


def _assert_ends(case, arrays, end):
    """The case is what it says: every traceback completes (end (0, 0)),
    but for FAILED_LANES, which report (len1, len2), and CUT_WP's cases,
    where some get stuck and some complete."""
    done = (end[:, 0] == 0) & (end[:, 1] == 0)          # [nb, 128]
    if case in CUT_WP:
        assert not done.all() and done.any()
        return
    failed = FAILED_LANES.get(case, [])
    for b, lane in failed:
        assert end[b, :2, lane].tolist() == [arrays[0][b, 0],
                                             arrays[1][b, 0, lane]]
    assert int((~done).sum()) == len(failed)


@pytest.mark.parametrize("case", sorted(PAIRS_CASES))
def test_pairs_mode_b2(case):
    arrays, geom = pairs_case(case)
    got = _check(arrays, geom, "cls", True, ("cls", "sub", "mapq", "end"),
                 case)
    cls = got[0].numpy()
    assert set(np.unique(cls)) <= {0, 1, 2, 3, 4}
    # every completed pair's columns: one active step per column
    nact = (cls != 0).sum(axis=1)
    l2 = arrays[1][:, 0]
    end = got[-1].numpy()
    done = (end[:, 0] == 0) & (end[:, 1] == 0)
    assert (nact >= np.maximum(arrays[0][:, :1], l2))[done].all()
    # a failed lane's rows stay 0; a stuck one classes its last step 4
    assert (nact[~done & (l2 > arrays[0][:, 1:2])] == 0).all()
    if case in CUT_WP:
        stuck = np.argwhere(~done)
        assert all(cls[b, end[b, 0, k] + end[b, 1, k], k] == 4
                   for b, k in stuck)


@functools.lru_cache(maxsize=None)
def _pairs_case_pallas(case):
    """A PAIRS_CASES mix and the Pallas kernel's class rows and ends on it
    (interpret mode), made once per mix."""
    arrays, geom = pairs_case(case)
    cls, _sub, _mapq, end = _nwp()._pallas_call(
        *arrays, end_gap_p=0, interpret=True, emit_kinds="cls", halves=1,
        s1_per_block=True, **geom)
    return arrays, geom, np.asarray(cls), np.asarray(end)


SHIFTS = [1, 4, 16]


@pytest.mark.parametrize("max_shift", SHIFTS)
@pytest.mark.parametrize("oo", [False, True])
@pytest.mark.parametrize("case", sorted(PAIRS_CASES))
def test_pairs_stats_ref_matches_pallas(case, oo, max_shift):
    """nw_pairs_stats_ref against the Pallas kernel's pairs mode followed
    by the JAX package's _lr_accum_pairs_trace, and the ends' OR."""
    import jax.numpy as jnp

    from dada2_tpu.chimeras import _lr_accum_pairs_trace

    arrays, geom, cls, end = _pairs_case_pallas(case)
    rows = cls.transpose(0, 2, 1).reshape(-1, geom["NDP"])
    want = np.asarray(_lr_accum_pairs_trace(
        jnp.asarray(rows), allow_one_off=oo, max_shift=max_shift))
    end_rows = end.transpose(0, 2, 1).reshape(-1, 8)
    got = nww.nw_pairs_stats_ref(*(torch.from_numpy(a) for a in arrays),
                                 allow_one_off=oo, max_shift=max_shift,
                                 **geom)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == (arrays[0].shape[0] * LANES, 6)
    np.testing.assert_array_equal(got[:, :5].numpy(), want)
    np.testing.assert_array_equal(got[:, 5].numpy(),
                                  end_rows[:, 0] | end_rows[:, 1])
    _assert_ends(case, arrays, end)
    assert (got[:, :5] >= 0).all() and got[:, :5].sum() > 0


@pytest.mark.parametrize("max_shift", SHIFTS)
@pytest.mark.parametrize("oo", [False, True])
def test_pairs_stats_wrapper_cpu_is_ref(oo, max_shift):
    """nw_pairs_stats on CPU tensors is its plain version, on the mix with
    shifted and truncated parents."""
    arrays, geom, _, _ = _pairs_case_pallas("mixed_l2")
    t = [torch.from_numpy(a) for a in arrays]
    got = nww.nw_pairs_stats(*t, allow_one_off=oo, max_shift=max_shift,
                             **geom)
    want = nww.nw_pairs_stats_ref(*t, allow_one_off=oo, max_shift=max_shift,
                                  **geom)
    assert torch.equal(got, want)


_BAD_STATS_CALLS = {
    # B1/B3's shared s1 [L1R, 128] is not the pairs layout
    "shared_s1": (lambda t, g: ((t[0], t[1], t[2][0], t[3]), g),
                  "s1 has shape"),
    "int64_s2q": (lambda t, g: ((*t[:3], t[3].long()), g), "int32"),
    "wp_48": (lambda t, g: (t, {**g, "WP": 48}), "multiples of 32"),
    "not_ends_free": (lambda t, g: (t, {**g, "gap_p": 0}), "ends-free"),
    "oo_not_bool": (lambda t, g: (t, {**g, "allow_one_off": "yes"}),
                    "allow_one_off"),
}


@pytest.mark.parametrize("bad", sorted(_BAD_STATS_CALLS))
def test_pairs_stats_wrapper_rejects(bad):
    """The stats mode takes only B2's operands and an ends-free score."""
    rng = np.random.default_rng(3)
    arrays, geom = pairs_inputs(rng, [(30, _family(rng, 30, 4, 2))])
    t = [torch.from_numpy(a) for a in arrays]
    make, msg = _BAD_STATS_CALLS[bad]
    args, kw = make(t, {**geom, "allow_one_off": False, "max_shift": 16})
    with pytest.raises(ValueError, match=msg):
        nww.nw_pairs_stats(*args, **kw)


KINDS_CASES = {
    "uniform_band4": (4, 40, 6, None, 1, True),
    "uniform_band16": (16, 40, 6, None, 1, True),
    "mixed_lengths": (16, 50, 6, None, 1, False),
    "wide_window_multi_block": (8, 24, 3, 64, 140, False),
    "amplicon_length": (16, 150, 20, None, 10, False),
}


@pytest.mark.parametrize("case", sorted(KINDS_CASES))
def test_kinds_mode_b3(case):
    """B3 on the B1 tests' fuzz mixes (tests/test_torch_nw_wavefront.py)."""
    band, len1, nops, wp, ncand, uniform = KINDS_CASES[case]
    rng = np.random.default_rng(len1 + band)
    s1 = rng.integers(0, 4, len1).astype(np.uint8)
    if uniform:
        cands = []
        for _ in range(5):
            c = s1.copy()
            c[rng.integers(0, len1, int(rng.integers(0, nops)))] = \
                rng.integers(0, 4)
            cands.append(c)
    else:
        cands = [_mutate(rng, s1, nops=nops) for _ in range(ncand)]
    cands.append(rng.integers(0, 4, len1 - 3).astype(np.uint8))
    arrays, geom = make_inputs(rng, s1, cands, band, wp=wp)
    got = _check(arrays, geom, True, False, ("kinds", "sub", "mapq", "end"))
    assert set(np.unique(got[0].numpy())) <= {0, 1, 2, 3}


def test_wrapper_modes():
    """Only the kernel's three modes are accepted, and B2 wants s1 per
    block."""
    rng = np.random.default_rng(3)
    arrays, geom = pairs_inputs(rng, [(30, _family(rng, 30, 4, 2))])
    t = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError, match="modes"):
        nww.nw_wavefront(*t, emit_kinds="cls", s1_per_block=False, **geom)
    with pytest.raises(ValueError, match="modes"):
        nww.nw_wavefront(*t, emit_kinds=True, s1_per_block=True, **geom)
    with pytest.raises(ValueError, match="s1 has shape"):
        nww.nw_wavefront(t[0], t[1], t[2][0], t[3], emit_kinds="cls",
                         s1_per_block=True, **geom)


def _padded(cands):
    """Candidates as nw_pallas_grouped takes them: codes padded with 255,
    and their lengths."""
    s2b = np.full((len(cands), max(1, max(len(c) for c in cands))), 255,
                  np.uint8)
    l2b = np.array([len(c) for c in cands], np.int64)
    for k, c in enumerate(cands):
        s2b[k, : len(c)] = c
    return s2b, l2b


def _grouped_both(s1, cands, band):
    """nw_wavefront_grouped (the plain version) against nw_pallas_grouped
    (interpret mode) for one center: kinds, p0, p1, ham, tvec and ok
    exactly. Returns the port's outputs."""
    s2b, l2b = _padded(cands)
    want = _nwp().nw_pallas_grouped(s1, len(s1), s2b, l2b, band=band,
                                    interpret=True, **GEOM)
    got = nww.nw_wavefront_grouped(s1, len(s1), s2b, l2b, band=band,
                                   device="cpu", **GEOM)
    assert len(got) == len(want) == len(GROUPED_OUTS)
    for name, w, g in zip(GROUPED_OUTS, want, got):
        np.testing.assert_array_equal(w, g, err_msg=name)
    return got


@pytest.mark.parametrize("band", [4, 16])
def test_grouped_matches_pallas_grouped(band):
    """nw_wavefront_grouped against nw_pallas_grouped on
    tests/test_nw_pallas.py's mixed-length case: kinds, p0, p1, ham, tvec
    and ok."""
    rng = np.random.default_rng(99)
    s1 = rng.integers(0, 4, 50).astype(np.uint8)
    cands = [_mutate(rng, s1) for _ in range(9)]
    cands += [s1[5:], s1[:44], rng.integers(0, 4, 31).astype(np.uint8)]
    got = _grouped_both(s1, cands, band)
    assert got[5].all()


@functools.lru_cache(maxsize=None)
def _sam1f_uniques():
    """sam1F's uniques as code rows, most abundant first."""
    import dada2_tpu_torch as dt
    from dada2_tpu_torch.encode import pack_sequences

    codes, lens = pack_sequences(dt.derep_fastq(str(SAM1F)).sequences)
    return [codes[k, : lens[k]] for k in range(len(lens))]


def test_grouped_matches_pallas_grouped_sam1f():
    """Kernel B3's path on real reads: sam1F's most abundant unique against
    24 of its uniques (every 37th, itself first) at the default band."""
    uniq = _sam1f_uniques()
    got = _grouped_both(uniq[0], uniq[::37][:24], 16)
    assert got[5].all()
    assert got[3][0] == 0 and (got[3][1:] > 0).all()


def _narrowed(call, band, cut_wp, to_kernel):
    """A wrapper of a kernel call (the Pallas kernel's or the port's) that
    gives it the grouped path's inputs with each lane's band left at
    `band` on both sides, not widened by the length difference, or with
    the window cut to cut_wp rows."""
    def run(scal, params, *rest, **geom):
        scal = np.array(scal)
        params = np.array(params)
        if band is not None:
            params[:, 1:3] = band
            scal[:, 2] = band
        if cut_wp is not None:
            assert geom["WP"] > cut_wp
            geom = dict(geom, WP=cut_wp)
        return call(to_kernel(scal), to_kernel(params), *rest, **geom)
    return run


# (band of the grouped call, narrowed band, window rows kept): tracebacks
# that fail because the band leaves out the end cell (len1, len2) of the
# longer and shorter candidates, or because the cut window leaves out
# cells their paths cross
FAILING_CASES = {"narrow_band": (4, 4, None), "window_cut": (16, None, 32)}


@pytest.mark.parametrize("case", sorted(FAILING_CASES))
def test_grouped_failed_tracebacks_match_pallas(case, monkeypatch):
    """nw_wavefront_grouped against nw_pallas_grouped where some
    tracebacks fail (ok False): both kernels get the same narrowed inputs
    (nw_pallas_grouped's band rule, widened on the long side, never makes
    a traceback fail, so the band or the window is cut at the kernel
    call); kinds, p0, p1, ham, tvec and ok exactly."""
    import jax.numpy as jnp

    band, narrow, cut = FAILING_CASES[case]
    nwp = _nwp()
    monkeypatch.setattr(nwp, "_pallas_call", _narrowed(
        nwp._pallas_call, narrow, cut, jnp.asarray))
    monkeypatch.setattr(nww, "nw_wavefront", _narrowed(
        nww.nw_wavefront, narrow, cut, torch.from_numpy))
    uniq = _sam1f_uniques()
    s1 = uniq[0]
    cands = uniq[1:9] + [s1[:240], s1[7:], np.concatenate([s1, s1[:9]]),
                         s1[3:247], s1[:200], s1[40:]]
    got = _grouped_both(s1, cands, band)
    assert got[5][:8].all() and not got[5].all()


@pytest.mark.parametrize("band", [4, 16])
def test_grouped_short_candidates(band):
    """nw_wavefront_grouped against nw_pallas_grouped with candidates of
    length 0, 1 and 2 beside mutated copies of a 40-nt center."""
    rng = np.random.default_rng(40 + band)
    s1 = rng.integers(0, 4, 40).astype(np.uint8)
    cands = [s1[:0], s1[:1], s1[5:7], rng.integers(0, 4, 1).astype(np.uint8)]
    cands += [_mutate(rng, s1, nops=6) for _ in range(8)]
    got = _grouped_both(s1, cands, band)
    assert got[5].all()
    # length 0: 40 up steps; length 1: one step takes the candidate's base
    assert (got[0][0] == 3).sum() == 40 and set(got[0][0]) <= {0, 3}
    assert ((got[0][1] == 1) | (got[0][1] == 2)).sum() == 1


@pytest.mark.gpu
def test_modes_match_plain_on_card():
    """B2, B2 stats and B3 against their plain versions on the card,
    bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run through chip_smoke.py)")
    rng = np.random.default_rng(11)
    arrays, geom = pairs_inputs(rng, [(250, _family(rng, 250, 128, 12)),
                                      (247, _family(rng, 247, 100, 12))])
    s1 = rng.integers(0, 4, 250).astype(np.uint8)
    kin, kgeom = make_inputs(rng, s1, [_mutate(rng, s1, nops=12)
                                       for _ in range(300)], 16)
    for arr, g, emit, per in ((arrays, geom, "cls", True),
                              (kin, kgeom, True, False)):
        t = [torch.from_numpy(a).cuda() for a in arr]
        got = nww.nw_wavefront(*t, emit_kinds=emit, s1_per_block=per, **g)
        want = nww.nw_wavefront_ref(*t, emit_kinds=emit, s1_per_block=per,
                                    **g)
        for x, y in zip(got, want):
            assert torch.equal(x, y)
    t = [torch.from_numpy(a).cuda() for a in arrays]
    for oo, ms in itertools.product((False, True), SHIFTS):
        got = nww.nw_pairs_stats(*t, allow_one_off=oo, max_shift=ms, **geom)
        want = nww.nw_pairs_stats_ref(*t, allow_one_off=oo, max_shift=ms,
                                      **geom)
        assert torch.equal(got, want)


def _b3_card_cases(rng):
    """Kernel B3's launches for the card test, (label, arrays, geom): at
    windows of 32, 64, 96 and 128 rows, mutated candidates over three
    blocks with one lane whose geometry fails (len2 > len2max), a 40-nt
    center against candidates of length 0, 1 and 2, and candidates cut
    short by up to 294 nt under a window cut to those rows (the band needs
    about 170), whose tracebacks get stuck; and samPB-length pairs (about
    1,450 nt) at 64 rows."""
    s_cut = rng.integers(0, 4, 400).astype(np.uint8)
    cut, cut_geom = make_inputs(rng, s_cut, [s_cut[: 400 - k]
                                             for k in range(0, 300, 6)]
                                + [_mutate(rng, s_cut, nops=8)
                                   for _ in range(40)], 16)
    assert cut_geom["WP"] > 128
    out = []
    for wp in (32, 64, 96, 128):
        s1 = rng.integers(0, 4, 250).astype(np.uint8)
        arrays, geom = make_inputs(rng, s1, [_mutate(rng, s1, nops=8)
                                             for _ in range(300)], 16, wp=wp)
        arrays[1][0, 0, 5] = arrays[0][0, 1] + 1
        out.append((f"family WP={wp}", arrays, geom))
        s1 = rng.integers(0, 4, 40).astype(np.uint8)
        cands = [s1[:0], s1[:1], s1[3:5]] + [_mutate(rng, s1, nops=6)
                                             for _ in range(20)]
        out.append((f"short WP={wp}", *make_inputs(rng, s1, cands, 4,
                                                   wp=wp)))
        out.append((f"window cut to WP={wp}", cut, dict(cut_geom, WP=wp)))
    s1 = rng.integers(0, 4, 1450).astype(np.uint8)
    out.append(("samPB length WP=64", *make_inputs(
        rng, s1, [_mutate(rng, s1, nops=30) for _ in range(200)], 16,
        wp=64)))
    return out


@pytest.mark.gpu
def test_b3_every_pairs_per_block_on_card(monkeypatch):
    """Kernel B3 (nw_compare_kernel's kinds variant) bitwise against its
    plain version on the card at every pairs per block P that fits and at
    the fit's own choice: kinds, sub, mapq and end, where tracebacks
    complete, get stuck and fail on their geometry."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run through chip_smoke.py)")
    tried = set()
    for label, arrays, geom in _b3_card_cases(np.random.default_rng(17)):
        t = [torch.from_numpy(a).cuda() for a in arrays]
        want = nww.nw_wavefront_ref(*t, emit_kinds=True, **geom)
        fits = [P for P in (1, 2, 4, 8, 16, 32) if nww.compare_blocks_per_sm(
            geom["L1R"], geom["L2R"], geom["NDP"], geom["WP"], P, 3) > 0]
        assert 1 in fits, label
        tried.update(fits)
        for P in [None] + fits:
            monkeypatch.setattr(nww, "PAIRS_PER_BLOCK", P)
            got = nww.nw_wavefront(*t, emit_kinds=True, **geom)
            for name, x, y in zip(("kinds", "sub", "mapq", "end"), got,
                                  want):
                assert torch.equal(x, y), f"{label}, P={P}: {name}"
        end = want[3][:, :2].cpu().numpy()
        if label.startswith("window cut"):
            assert (end != 0).any() and (end == 0).any(), label
        elif label.startswith("family"):
            assert end[0, :, 5].tolist() == [250, arrays[1][0, 0, 5]]
            end[0, :, 5] = 0
            assert (end == 0).all(), label
        else:
            assert (end == 0).all(), label
    assert tried == {1, 2, 4, 8, 16, 32}
    # B3's fit: one pair a block for a one-block launch; a larger P that
    # keeps four blocks an SM for phase 5's 169 blocks
    assert nww.pairs_per_block(384, 384, 512, 32, 3, 1) == 1
    P = nww.pairs_per_block(384, 384, 512, 32, 3, 169)
    assert P > 1 and nww.compare_blocks_per_sm(384, 384, 512, 32, P, 3) >= 4


def _b2_card_cases(rng):
    """Kernel B2's class-row launches for the card test, (label, arrays,
    geom, failed lanes or None where tracebacks get stuck): at windows of
    32, 64, 96 and 128 rows, two blocks of mutated 250-nt pairs with one
    lane whose geometry fails, 40-nt queries against parents of length 0,
    1 and 2, and 400-nt queries against their prefixes, up to 294 nt
    shorter, under a window cut to those rows (the band needs about 170:
    tracebacks get stuck); and 1,450-nt pairs (PacBio full-length 16S) at
    64 rows. Random qualities in s2q."""
    cut = [(400, _cut_parents(rng, 400, 300, 6))]
    out = []
    for wp in (32, 64, 96, 128):
        arrays, geom = pairs_inputs(
            rng, [(250, _family(rng, 250, 128, 8)),
                  (247, _family(rng, 247, 100, 8))], wp=wp, quals=True)
        arrays[1][0, 0, 5] = arrays[0][0, 1] + 1
        out.append((f"family WP={wp}", arrays, geom, [(0, 5)]))
        out.append((f"short parents WP={wp}", *pairs_inputs(
            rng, [(40, _short_parents(rng))], wp=wp, quals=True), []))
        out.append((f"window cut to WP={wp}", *pairs_inputs(
            rng, cut, wp=wp, quals=True), None))
    out.append(("1450 nt WP=64", *pairs_inputs(
        rng, [(1450, _family(rng, 1450, 128, 30)),
              (1447, _family(rng, 1447, 100, 30))], wp=64, quals=True), []))
    return out


@pytest.mark.gpu
def test_b2_every_pairs_per_block_on_card(monkeypatch):
    """Kernel B2's class rows (nw_compare_kernel's class-row variant)
    bitwise against their plain version on the card at every pairs per
    block P that fits and at the fit's own choice: class rows, sub, mapq
    and end, where tracebacks complete, get stuck and fail on their
    geometry, and parents are 0, 1 and 2 nt long."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run through chip_smoke.py)")
    tried = set()
    kw = dict(emit_kinds="cls", s1_per_block=True)
    for label, arrays, geom, failed in _b2_card_cases(
            np.random.default_rng(18)):
        t = [torch.from_numpy(a).cuda() for a in arrays]
        want = nww.nw_wavefront_ref(*t, **kw, **geom)
        fits = [P for P in (1, 2, 4, 8, 16, 32) if nww.compare_blocks_per_sm(
            geom["L1R"], geom["L2R"], geom["NDP"], geom["WP"], P, 2) > 0]
        assert 1 in fits, label
        tried.update(fits)
        for P in [None] + fits:
            monkeypatch.setattr(nww, "PAIRS_PER_BLOCK", P)
            got = nww.nw_wavefront(*t, **kw, **geom)
            for name, x, y in zip(("cls", "sub", "mapq", "end"), got, want):
                assert torch.equal(x, y), f"{label}, P={P}: {name}"
        end = want[3][:, :2].cpu().numpy()
        done = (end[:, 0] == 0) & (end[:, 1] == 0)
        if failed is None:
            assert not done.all() and done.any(), label
        else:
            assert int((~done).sum()) == len(failed), label
            assert all(not done[b, lane] for b, lane in failed), label
        if label.startswith("1450"):
            # the 49 KB slab a pair leaves room for two pairs at most
            assert nww.compare_blocks_per_sm(geom["L1R"], geom["L2R"],
                                             geom["NDP"], 64, 4, 2) == 0
    assert tried == {1, 2, 4, 8, 16, 32}
    # B2's fit: one pair a block for a one-block launch; at the chimera
    # table's 1024-block launch a larger P that keeps four blocks an SM
    assert nww.pairs_per_block(384, 384, 512, 32, 2, 1) == 1
    P = nww.pairs_per_block(384, 384, 512, 32, 2, 1024)
    assert P > 1 and nww.compare_blocks_per_sm(384, 384, 512, 32, P, 2) >= 4
