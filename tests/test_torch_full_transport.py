"""The full compare's one-fetch transport, the host tvec cache,
compare_many and the packed construction upload of the port
(ops/store_screen.py: kernel B5's full and gather modes and their plain
versions; core/backend_cuda.py) against dada2_tpu on the CPU.

Tolerance: bitwise, everywhere. The plain versions' outputs equal the
JAX package's XLA programs (`_full_fused`, `_take_subs`, `_gather_subs`,
`_gather_tvec_packed`) byte for byte; CudaBackend on the CPU equals
TpuBackend (its Pallas kernel in interpret mode, no speculation) in every
fetched full buffer, lam, ham and compare_many result; the construction's
tensors equal the JAX package's. A screened compare reads the small
pack's f32 loglam, which the two packages sum in different orders
(tests/test_torch_budded_fused.py holds them to the screen's margin), so
the backend tests hand the port dada2_tpu's small pack through the
small13 cache (`_share_small`), as tests/test_torch_shortlist.py does.

dada2_tpu is imported inside the tests that use it, so that the `gpu`
tests (the two new modes against their plain versions on the card) run
where jax is not installed (`pytest --noconftest -m gpu`)."""
import dataclasses

import numpy as np
import pytest
import torch

from dada2_tpu_torch.core.backend_cuda import CudaBackend
from dada2_tpu_torch.ops import store_screen as ss


def _inputs(seed, n=150, W=64):
    """Seeded full-compare rows in numpy: seqs, tvec (8% substitutions),
    lens, small13 (ham, ham_gapless, loglam, abssum, flags: gapless on 30%
    of the rows, two rows with a -inf and a NaN loglam), and e_thresh
    mixing the -999 init state, 0, a subnormal value and positive values
    near each row's lambda."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(W - 12, W + 1, n).astype(np.int32)
    lens[0] = W
    valid = np.arange(W)[None, :] < lens[:, None]
    s = rng.integers(0, 4, (n, W))
    seqs = np.where(valid, s, -1).astype(np.int8)
    sub = valid & (rng.random((n, W)) < 0.08)
    sub[5, : W // 2] = valid[5, : W // 2]       # more than any tile holds
    nt0 = (s + rng.integers(1, 4, (n, W))) % 4
    tvec = np.where(valid, np.where(sub, 4 * nt0 + s, 5 * s), 16).astype(
        np.int8)
    flags = (1 + 2 * (rng.random(n) < 0.3)
             + 4 * (rng.random(n) < 0.15)).astype(np.uint8)
    loglam = rng.uniform(-60.0, -0.5, n).astype(np.float32)
    loglam[7], loglam[11] = -np.inf, np.nan
    abssum = (np.abs(loglam) + rng.uniform(0, 5, n)).astype(np.float32)
    small13 = np.zeros((n, 13), np.uint8)
    small13[:, :4] = np.stack([sub.sum(1), rng.integers(0, 9, n)], 1).astype(
        np.int16).view(np.uint8)
    small13[:, 4:8] = loglam[:, None].view(np.uint8)
    small13[:, 8:12] = abssum[:, None].view(np.uint8)
    small13[:, 12] = flags
    e = np.exp(np.nan_to_num(loglam.astype(np.float64), neginf=-30.0)
               + rng.normal(0, 0.3, n))
    kind = rng.integers(0, 4, n)
    e = np.where(kind == 0, -999.0 / 120_000, np.where(kind == 1, 0.0, e))
    e[4::13] = 9.2e-41                  # subnormal: XLA reads it as 0
    return dict(seqs=seqs, tvec=tvec, lens=lens, small13=small13.view(
        np.int8), e=e)


def _eth(e, n, nd, screened):
    """The full mode's eth operand: bf16 thresholds (screened), then the
    pad bitmap of rows n..nd-1."""
    pad = np.packbits(np.arange(nd) >= n, bitorder="little")
    if not screened:
        return pad
    eth = np.zeros(2 * nd + nd // 8, np.uint8)
    eth[: 2 * n] = (e.astype(np.float32).view(np.uint32) >> 16).astype(
        np.uint16).view(np.uint8)
    eth[2 * nd:] = pad
    return eth


def _torch(d, dev="cpu"):
    t = {k: torch.from_numpy(np.ascontiguousarray(d[k])).to(dev)
         for k in ("seqs", "tvec", "small13")}
    t["lens"] = torch.from_numpy(d["lens"].astype(np.int64)).to(dev)
    t["small5"] = torch.cat([t["small13"][:, :4], t["small13"][:, 12:]],
                            dim=1).contiguous()
    return t


def _jax_padded(d, nd):
    """The JAX package's device arrays: nd rows, rows n.. copies of row
    0."""
    import jax.numpy as jnp

    n = d["seqs"].shape[0]
    return {k: jnp.asarray(np.concatenate(
        [d[k], np.repeat(d[k][:1], nd - n, axis=0)]))
        for k in ("seqs", "tvec", "lens", "small13")}


FULL_CASES = {   # (screened, M0 (None: nd, the unscreened adaptive size), K)
    "unscreened_m16_k8": (False, 16, 8),
    "unscreened_adaptive_k48": (False, None, 48),
    "screened_m16_k48": (True, 16, 48),
    "screened_adaptive_k8": (True, None, 8),
}


@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_full_pack_ref_equal(case):
    """full_pack_ref (small13 screened, small5 unscreened) bitwise equal to
    _full_fused: the buffer and the order; then the follow-up over the
    rows past M0 (take_subs_ref over the same small rows) equal to
    _take_subs over the full mode's order."""
    import jax.numpy as jnp

    from dada2_tpu.core import backend_tpu as btj

    screened, M0, K = FULL_CASES[case]
    d = _inputs(3 + len(case))
    n, W = d["seqs"].shape
    nd = ss.pad_rows(n)
    M0 = M0 or nd
    L = int(d["lens"].max())
    center = 2
    eth = _eth(d["e"], n, nd, screened)
    jx = _jax_padded(d, nd)
    buf_j, ord_j = btj._full_fused(
        jx["tvec"], jx["small13"], jx["seqs"], jx["lens"], jnp.int32(center),
        jnp.asarray(eth.view(np.int8)), L=L, M0=M0, K=K, screened=screened)
    t = _torch(d)
    small = t["small13"] if screened else t["small5"]
    buf_t, ord_t = ss.full_pack_ref(small, t["tvec"], t["seqs"], t["lens"],
                                    center, torch.from_numpy(eth), nd=nd,
                                    L=L, M0=M0, K=K, screened=screened)
    buf_j = np.asarray(buf_j).view(np.uint8)
    assert len(buf_j) == len(buf_t) == ss.fullbuf_layout(nd, M0, K)[3]
    diff = np.nonzero(buf_j != buf_t.numpy())[0]
    assert not len(diff), f"bytes {diff[:20]}"
    np.testing.assert_array_equal(np.asarray(ord_j), ord_t.numpy())
    m = int(buf_t[:16].view(torch.int32)[0])
    if screened:        # the screen kept some rows and dropped others
        need = np.unpackbits(buf_j[16 + 5 * nd: 16 + 6 * nd], count=n,
                             bitorder="little")
        assert 0 < need.sum() < n
    if M0 < m:
        M = min(ss.bucket15(m - M0), nd - M0)
        want = np.asarray(btj._take_subs(
            jx["small13"], jx["tvec"], jx["seqs"], jx["lens"],
            jnp.int32(center), ord_j, M0=M0, M=M, K=K)).view(np.uint8)
        got = ss.take_subs_ref(small, t["tvec"], t["seqs"], t["lens"],
                               center, ord_t, M0=M0, M=M, K=K)
        np.testing.assert_array_equal(want, got.numpy())
    else:
        assert M0 == nd


@pytest.mark.parametrize("K", [8, 48])
def test_gather_equal(K):
    """gather_subs_ref bitwise equal to _gather_subs and
    gather_tvec_packed to _gather_tvec_packed, on a bucketed row list
    padded with its first row, gapless rows included."""
    import jax.numpy as jnp

    from dada2_tpu.core import backend_tpu as btj

    d = _inputs(21 + K)
    n = d["seqs"].shape[0]
    jx = _jax_padded(d, ss.pad_rows(n))
    rows = np.array([5, 9, 0, 31, 77, 120, 149, 64, 3], np.int64)
    idx = np.concatenate([rows, np.full(ss.bucket15(len(rows)) - len(rows),
                                        rows[0])]).astype(np.int32)
    t = _torch(d)
    want = np.asarray(btj._gather_subs(
        jx["tvec"], jx["seqs"], jx["lens"], jnp.int32(4), jx["small13"],
        jnp.asarray(idx), K=K))
    got = ss.gather_subs_ref(t["tvec"], t["seqs"], t["lens"], 4,
                             t["small13"][:, 12], torch.from_numpy(idx), K=K)
    np.testing.assert_array_equal(want, got.numpy().view(np.uint16))
    for W in (64, 63):      # an odd row width pads the last byte
        want = np.asarray(btj._gather_tvec_packed(jx["tvec"][:, :W],
                                                  jnp.asarray(idx)))
        got = ss.gather_tvec_packed(t["tvec"][:, :W].contiguous(),
                                    torch.from_numpy(idx))
        np.testing.assert_array_equal(want, got.numpy())


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors full_pack, gather_subs and take_subs (over small5
    rows) are their plain versions and count no launch; they refuse
    inputs the kernel would not take."""
    d = _inputs(5)
    t = _torch(d)
    n = d["seqs"].shape[0]
    nd = ss.pad_rows(n)
    before = dict(ss.launches)
    base = (t["tvec"], t["seqs"], t["lens"], 2)
    for screened in (False, True):
        small = t["small13"] if screened else t["small5"]
        eth = torch.from_numpy(_eth(d["e"], n, nd, screened))
        kw = dict(nd=nd, L=64, M0=32, K=16, screened=screened)
        got = ss.full_pack(small, *base, eth, **kw)
        want = ss.full_pack_ref(small, *base, eth, **kw)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        tk = dict(M0=32, M=24, K=16)
        assert torch.equal(ss.take_subs(small, *base, got[1], **tk),
                           ss.take_subs_ref(small, *base, got[1], **tk))
    idx = torch.tensor([3, 1, 4, 1, 5], dtype=torch.int32)
    assert torch.equal(ss.gather_subs(*base, t["small5"], idx, K=8),
                       ss.gather_subs_ref(*base, t["small5"][:, 4], idx,
                                          K=8))
    assert ss.launches == before
    with pytest.raises(ValueError, match="eth2"):
        ss.full_pack(t["small5"], *base, torch.zeros(nd, dtype=torch.uint8),
                     nd=nd, L=64, M0=32, K=16, screened=False)
    with pytest.raises(ValueError, match="small rows"):
        ss.full_pack(t["small5"], *base,
                     torch.from_numpy(_eth(d["e"], n, nd, True)), nd=nd,
                     L=64, M0=32, K=16, screened=True)


# ---- rows as wide as the slot packer's passes -------------------------------

# a MiSeq row (16 lanes a slot, one 16-byte chunk a lane), an odd width past
# 256 (32 lanes a slot, two passes) and samPB's full-length 16S width
WIDE_W = (250, 1451, 1500)


@pytest.mark.parametrize("W", WIDE_W)
def test_wide_rows_full_and_gather_equal(W):
    """At widths the other B5 tests never reach: full_pack_ref bitwise
    equal to _full_fused screened (M0 16, K 128) and unscreened (M0 nd,
    K 8), buffer and order, and gather_subs_ref to _gather_subs at K 8
    and 128 over 37 rows (not a multiple of the packer's slots a warp)."""
    import jax.numpy as jnp

    from dada2_tpu.core import backend_tpu as btj

    d = _inputs(40 + W, n=70, W=W)
    n = d["seqs"].shape[0]
    nd = ss.pad_rows(n)
    L = int(d["lens"].max())
    jx = _jax_padded(d, nd)
    t = _torch(d)
    for screened, M0, K in ((True, 16, 128), (False, nd, 8)):
        eth = _eth(d["e"], n, nd, screened)
        buf_j, ord_j = btj._full_fused(
            jx["tvec"], jx["small13"], jx["seqs"], jx["lens"],
            jnp.int32(2), jnp.asarray(eth.view(np.int8)), L=L, M0=M0, K=K,
            screened=screened)
        small = t["small13"] if screened else t["small5"]
        buf_t, ord_t = ss.full_pack_ref(
            small, t["tvec"], t["seqs"], t["lens"], 2, torch.from_numpy(eth),
            nd=nd, L=L, M0=M0, K=K, screened=screened)
        np.testing.assert_array_equal(np.asarray(buf_j).view(np.uint8),
                                      buf_t.numpy())
        np.testing.assert_array_equal(np.asarray(ord_j), ord_t.numpy())
    idx = np.random.default_rng(W).integers(0, nd, 37).astype(np.int32)
    for K in (8, 128):
        want = np.asarray(btj._gather_subs(
            jx["tvec"], jx["seqs"], jx["lens"], jnp.int32(4), jx["small13"],
            jnp.asarray(idx), K=K))
        got = ss.gather_subs_ref(t["tvec"], t["seqs"], t["lens"], 4,
                                 t["small13"][:, 12], torch.from_numpy(idx),
                                 K=K)
        np.testing.assert_array_equal(want, got.numpy().view(np.uint16))


# ---- the backends ----------------------------------------------------------

@pytest.fixture(scope="module")
def sample(extdata):
    from dada2_tpu.derep import derep_fastq

    d = derep_fastq(str(extdata / "sam1F.fastq.gz"))
    return d.sequences[:150], d.abundances[:150], d.quals[:150]


def _states(seqs, ab, quals, **overrides):
    from dada2_tpu.core.raws import make_rawset
    from dada2_tpu.data import tperr1
    from dada2_tpu.options import DEFAULT_OPTIONS

    from dada2_tpu_torch.interop import state_from_numpy

    opts = DEFAULT_OPTIONS.replace(**overrides).normalized()
    rs = make_rawset(seqs, ab, None, quals)
    rs_t, _, opts_t = state_from_numpy(
        rs.seqs, rs.lens, rs.reads, rs.priors, rs.quals, tperr1(),
        dataclasses.asdict(opts))
    return (rs, opts), (rs_t, opts_t)


def _share_small(be_j, be_t, opts):
    """Every small13 lookup of the port hits with dada2_tpu's small pack
    for the same center and error matrix (its f32 sums in XLA's order)."""
    from dada2_tpu.core import backend_tpu as btj

    def small13(ent, center, err):
        ent_j = be_j._align_ent(center, opts, be_j._pallas_ok(
            int(be_j.lens[center]), opts))
        small = btj._fused_small(ent_j[1], be_j.d_seqs, be_j.d_lens,
                                 be_j._center_dev(center),
                                 be_j._get_qlerr(err), ent_j[2])
        return torch.from_numpy(np.asarray(small)[: be_t.rs.n].copy())
    be_t._small13 = be_t._small13_cached = small13


def _backends(monkeypatch, rs, rs_t, opts, **attrs):
    """TpuBackend (Pallas in interpret mode, no speculation) and the
    port's CudaBackend on the CPU sharing dada2_tpu's small pack, each
    recording the buffer of every one-fetch full compare."""
    from dada2_tpu.core.backend_tpu import TpuBackend

    monkeypatch.setenv("DADA2_TPU_PALLAS", "1")
    be_j = TpuBackend(rs, use_quals=True)
    assert be_j.use_pallas
    be_t = CudaBackend(rs_t, device="cpu")
    be_j.SPEC_K = be_t.SPEC_K = 0
    _share_small(be_j, be_t, opts)
    for be in (be_j, be_t):
        for k, v in attrs.items():
            setattr(be, k, v)
        be.bufs = []
        orig = be._full_finish

        def wrap(buf, ctx, _orig=orig, _be=be):
            _be.bufs.append(np.asarray(buf).view(np.uint8).copy())
            return _orig(buf, ctx)
        be._full_finish = wrap
    return be_j, be_t


def _same_buffers(be_j, be_t):
    assert len(be_j.bufs) == len(be_t.bufs) > 0
    for k, (a, b) in enumerate(zip(be_j.bufs, be_t.bufs)):
        assert len(a) == len(b), f"full compare {k}: {len(a)} != {len(b)}"
        diff = np.nonzero(a != b)[0]
        assert not len(diff), f"full compare {k}: bytes {diff[:20]}"


def _second_err():
    from dada2_tpu.data import tperr1

    err2 = tperr1() ** 1.1
    for b in range(4):
        rows = [4 * b + j for j in range(4) if j != b]
        err2[4 * b + b] = 1.0 - err2[rows].sum(axis=0)
    return err2


def _eth_state(rs_t, opts_t, err, skip):
    """e_thresh of a run that compared centers 0..3 (a live threshold),
    from a backend of its own."""
    be = CudaBackend(rs_t, device="cpu")
    e_minmax = np.full(rs_t.n, -999.0)
    for c in range(4):
        lam_c, _ = be.compare(c, skip, opts_t, err, True, 1.0)
        e_minmax = np.maximum(e_minmax, lam_c * int(rs_t.reads[c]))
    return e_minmax / int(rs_t.reads.sum())


FULL_COMPARE_CASES = {
    "adaptive": {},
    "followup": dict(FULL_SCREENED_M0=16, SHORTLIST_M0=16),
}


@pytest.mark.parametrize("case", sorted(FULL_COMPARE_CASES))
def test_full_compares_equal(sample, monkeypatch, case):
    """Init compares over three error matrices (all ones, tperr1, another)
    and screened compares at a cutoff other than the engine's: lam, ham
    and every fetched full buffer equal dada2_tpu's. The all-ones round
    takes no full compare, the first real one seeds the host tvec cache,
    and the third round's init compare fetches only its 5-byte rows. The
    followup case pins M0 at 16, so every full compare takes the
    follow-up fetch."""
    from dada2_tpu.data import tperr1

    from dada2_tpu_torch.trace import COUNTERS

    (rs, opts), (rs_t, opts_t) = _states(*sample)
    be_j, be_t = _backends(monkeypatch, rs, rs_t, opts,
                           **FULL_COMPARE_CASES[case])
    n = rs.n
    skip = np.zeros(n, bool)
    skip[[5, 17, 40]] = True
    ones = np.ones_like(tperr1())
    f0 = COUNTERS.followup_fetches
    for r, err in enumerate((ones, tperr1(), _second_err())):
        b0 = COUNTERS.fetch_bytes
        lam_j, ham_j = be_j.compare(0, skip, opts, err, True, 1.0)
        lam_t, ham_t = be_t.compare(0, skip, opts_t, err, True, 1.0)
        np.testing.assert_array_equal(ham_j, ham_t)
        np.testing.assert_array_equal(lam_j, lam_t)
        assert len(be_t.bufs) == min(r, 1)
        if r == 2:                      # a host cache hit: no tvec rows
            assert COUNTERS.fetch_bytes - b0 == 5 * n
    eth = _eth_state(rs_t, opts_t, tperr1(), skip)
    for center in (0, 7):
        lam_j, ham_j = be_j.compare(center, skip, opts, tperr1(), True, 1.0,
                                    eth)
        lam_t, ham_t = be_t.compare(center, skip, opts_t, tperr1(), True,
                                    1.0, eth)
        np.testing.assert_array_equal(ham_j, ham_t)
        np.testing.assert_array_equal(lam_j, lam_t)
        assert (lam_t == 0).sum() > (ham_t < 0).sum()   # the screen screened
    _same_buffers(be_j, be_t)
    assert len(be_t.bufs) == 3
    if case == "followup":
        assert COUNTERS.followup_fetches >= f0 + 3


def test_classic_path_tiles_and_dense_rows(sample, monkeypatch):
    """With FULL_FUSED_INIT_MAX_N = 0 every init compare takes the classic
    path: its tvec rows travel as substitution tiles (B5's gather mode)
    and 4-bit dense rows, then come from the host cache; lam and ham equal
    dada2_tpu's in each of three rounds."""
    from dada2_tpu.data import tperr1

    from dada2_tpu_torch.trace import COUNTERS

    (rs, opts), (rs_t, opts_t) = _states(*sample)
    be_j, be_t = _backends(monkeypatch, rs, rs_t, opts,
                           FULL_FUSED_INIT_MAX_N=0)
    calls = {"gather": 0, "dense": 0}
    gather, dense = ss.gather_subs, be_t._fetch_tvec_rows

    def gather_spy(*a, **kw):
        calls["gather"] += 1
        return gather(*a, **kw)

    def dense_spy(*a):
        calls["dense"] += 1
        return dense(*a)
    monkeypatch.setattr(ss, "gather_subs", gather_spy)
    be_t._fetch_tvec_rows = dense_spy
    skip = np.zeros(rs.n, bool)
    fetched = []
    for err in (tperr1(), _second_err(), tperr1()):
        b0 = COUNTERS.fetch_bytes
        lam_j, ham_j = be_j.compare(3, skip, opts, err, True, 1.0)
        lam_t, ham_t = be_t.compare(3, skip, opts_t, err, True, 1.0)
        np.testing.assert_array_equal(ham_j, ham_t)
        np.testing.assert_array_equal(lam_j, lam_t)
        fetched.append(COUNTERS.fetch_bytes - b0)
    assert calls == {"gather": 1, "dense": 1}
    assert fetched[1] == fetched[2] == 5 * rs.n < fetched[0]
    assert not be_t.bufs and not be_j.bufs


def test_compare_many_equal(sample, monkeypatch):
    """compare_many of four centers equals dada2_tpu's compare_many and
    the port's own compare() calls, in both halves: unscreened and
    screened full compares (one fetch), and budded ones (one fetch and
    one batched follow-up, the buffer pinned at 16 rows with bits K = 8);
    the budded batch leaves the bud-ordinal history as it found it."""
    from dada2_tpu.data import tperr1

    from dada2_tpu_torch.trace import COUNTERS

    (rs, opts), (rs_t, opts_t) = _states(*sample)
    err = tperr1()
    skip = np.zeros(rs.n, bool)
    centers = [0, 3, 7]
    cutoff = opts.KDIST_CUTOFF
    for e_none, kd, attrs in ((True, 1.0, {}), (False, 1.0, {}),
                              (False, cutoff, dict(
                                  SHORTLIST_M0=16,
                                  SHORTLIST_FORCE=("bits", 8)))):
        be_j, be_t = _backends(monkeypatch, rs, rs_t, opts, **attrs)
        single = CudaBackend(rs_t, device="cpu")
        _share_small(be_j, single, opts)
        for k, v in attrs.items():
            setattr(single, k, v)
        eth = None if e_none else _eth_state(rs_t, opts_t, err, skip)
        hist = dict(be_t._m_by_ordinal)
        dense = {"calls": 0}
        fetch_rows = be_t._fetch_tvec_rows

        def dense_spy(*a, _f=fetch_rows):
            dense["calls"] += 1
            return _f(*a)
        be_t._fetch_tvec_rows = dense_spy
        f0 = COUNTERS.device_fetches
        fu0 = COUNTERS.followup_fetches
        many_j = be_j.compare_many(centers, skip, opts, err, True, kd, eth)
        many_t = be_t.compare_many(centers, skip, opts_t, err, True, kd, eth)
        nfetch = COUNTERS.device_fetches - f0
        nfu = COUNTERS.followup_fetches - fu0
        for c, (lam_j, ham_j), (lam_t, ham_t) in zip(centers, many_j,
                                                     many_t):
            np.testing.assert_array_equal(ham_j, ham_t)
            np.testing.assert_array_equal(lam_j, lam_t)
            lam_s, ham_s = single.compare(c, skip, opts_t, err, True, kd,
                                          eth)
            np.testing.assert_array_equal(ham_s, ham_t)
            np.testing.assert_array_equal(lam_s, lam_t)
        if kd == cutoff:
            assert be_t._m_by_ordinal == hist and be_t._bud_ordinal == 0
        else:
            _same_buffers(be_j, be_t)
            assert len(be_t.bufs) == len(centers)
        # one fetch for all buffers, one for every follow-up (budded: one
        # for all), and the dense re-fetches
        assert nfetch == dense["calls"] + 1 + (min(nfu, 1) if kd == cutoff
                                               else nfu)


@pytest.mark.parametrize("quals", ["q93", "q41", "none"])
def test_packed_construction_equal(quals):
    """The one-blob construction upload unpacks on the device to
    dada2_tpu's d_seqs[:n] and d_quals[:n] (PacBio's q93 as uint8, quals
    under 64 6-bit packed, none), and to the RawSet's own codes."""
    from dada2_tpu.core.backend_tpu import TpuBackend
    from dada2_tpu.core.raws import make_rawset

    from dada2_tpu_torch.core.raws import make_rawset as make_rawset_t
    from dada2_tpu_torch.trace import COUNTERS

    rng = np.random.default_rng(11)
    n = 300
    seqs = ["".join(rng.choice(list("ACGT"), size=rng.integers(60, 122)))
            for _ in range(n)]
    q = np.full((n, 121), np.nan)
    for i, s in enumerate(seqs):
        q[i, : len(s)] = rng.integers(2, 94, len(s))
    q = {"q93": q, "q41": np.minimum(q, 41), "none": None}[quals]
    rs = make_rawset(seqs, np.arange(1, n + 1), None, q)
    bk = TpuBackend(rs, use_quals=True)
    p0, b0 = COUNTERS.device_puts, COUNTERS.put_bytes
    rs_t = make_rawset_t(seqs, np.arange(1, n + 1), None, q)
    be = CudaBackend(rs_t, device="cpu")
    np.testing.assert_array_equal(np.asarray(bk.d_seqs)[:n],
                                  be.d_seqs.numpy())
    np.testing.assert_array_equal(be.d_seqs.numpy(),
                                  np.asarray(rs_t.seqs).view(np.int8))
    W = rs_t.seqs.shape[1]
    Wp4 = (W + 3) // 4
    blob = n * Wp4 + {"q93": n * W, "q41": 3 * n * Wp4, "none": 0}[quals]
    if q is None:
        assert be.d_quals is None
    else:
        np.testing.assert_array_equal(np.asarray(bk.d_quals)[:n],
                                      be.d_quals.numpy())
        np.testing.assert_array_equal(be.d_quals.numpy(), rs_t.quals)
    # the construction's puts: lengths, the one blob, and what the other
    # device state needs (reads, the kernel's block tables)
    assert COUNTERS.put_bytes - b0 - 8 * n - blob == sum(
        x.numel() * x.element_size()
        for x in (be.d_reads, be._pb.d_l2max, be._pb.d_inv)) + 8 * (
            be._pb.block_idx.size)
    assert COUNTERS.device_puts - p0 == 6


# ---- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel B5 has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FULL_CASES))
def test_full_and_gather_kernels_equal_plain_on_card(case):
    """B5's full mode bitwise equal to full_pack_ref (buffer and order),
    the follow-up over its order (take_subs, small5 or small13 rows) and
    the gather mode over a bucketed row list to their plain versions;
    one launch counted per call."""
    dev = _card()
    screened, M0, K = FULL_CASES[case]
    d = _inputs(3 + len(case))
    t = _torch(d, dev)
    n = d["seqs"].shape[0]
    nd = ss.pad_rows(n)
    M0 = M0 or nd
    small = t["small13"] if screened else t["small5"]
    eth = torch.from_numpy(_eth(d["e"], n, nd, screened)).to(dev)
    base = (t["tvec"], t["seqs"], t["lens"], 2)
    kw = dict(nd=nd, L=int(d["lens"].max()), M0=M0, K=K, screened=screened)
    before = dict(ss.launches)
    got = ss.full_pack(small, *base, eth, **kw)
    want = ss.full_pack_ref(small, *base, eth, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    tk = dict(M0=min(M0, nd - 16), M=16, K=K)
    assert torch.equal(ss.take_subs(small, *base, got[1], **tk),
                       ss.take_subs_ref(small, *base, got[1], **tk))
    idx = torch.tensor([5, 9, 0, 31, 77, 120, 149, 64, 3] + [5] * 3,
                       dtype=torch.int32, device=dev)
    assert torch.equal(ss.gather_subs(*base, small, idx, K=K),
                       ss.gather_subs_ref(*base, small[:, -1], idx, K=K))
    torch.cuda.synchronize()
    assert {k: ss.launches[k] - before[k] for k in ss.launches} == dict(
        pack=0, take=1, small=0, full=1, gather=1)


def _odd_base(x, shift=3):
    """A copy of x whose data starts `shift` bytes past an aligned address
    (a contiguous view with a storage offset)."""
    flat = torch.empty(x.numel() + shift, dtype=x.dtype, device=x.device)
    y = flat[shift:].view(x.shape)
    y.copy_(x)
    return y


def _full_equal(small, base, eth, kw):
    got = ss.full_pack(small, *base, eth, **kw)
    want = ss.full_pack_ref(small, *base, eth, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("W", WIDE_W)
def test_wide_rows_kernels_equal_plain_on_card(W):
    """The slot packer at W 250, 1,451 and 1,500, with tvec at an odd base
    address (its rows and the sequences' realigned apart): the full mode
    (screened M0 16 K 128, unscreened M0 nd K 8) and the gather mode (K 8
    and 128 over 37 rows) bitwise equal to their plain versions; one
    launch a call."""
    dev = _card()
    d = _inputs(40 + W, n=70, W=W)
    t = _torch(d, dev)
    n = d["seqs"].shape[0]
    nd = ss.pad_rows(n)
    L = int(d["lens"].max())
    base = (_odd_base(t["tvec"]), t["seqs"], t["lens"], 2)
    before = dict(ss.launches)
    for screened, M0, K in ((True, 16, 128), (False, nd, 8)):
        eth = torch.from_numpy(_eth(d["e"], n, nd, screened)).to(dev)
        small = t["small13"] if screened else t["small5"]
        _full_equal(small, base, eth, dict(nd=nd, L=L, M0=M0, K=K,
                                           screened=screened))
    idx = torch.from_numpy(np.random.default_rng(W).integers(
        0, nd, 37).astype(np.int32)).to(dev)
    for K in (8, 128):
        for small in (t["small5"], t["small13"]):
            assert torch.equal(ss.gather_subs(*base, small, idx, K=K),
                               ss.gather_subs_ref(*base, small[:, -1], idx,
                                                  K=K))
    torch.cuda.synchronize()
    assert {k: ss.launches[k] - before[k] for k in ss.launches} == dict(
        pack=0, take=0, small=0, full=2, gather=4)


@pytest.mark.gpu
@pytest.mark.parametrize("limit", ["sms", "large"])
@pytest.mark.parametrize("step", [-8, 0, 8], ids=["below", "at", "above"])
def test_full_mode_at_grid_limits_on_card(limit, step):
    """The full mode at nd one step (8 rows) below, at and above the
    points where its cooperative grid changes shape, W 250: 32 rows a
    block on every SM (past it a block's rows grow to 64) and 32,768 rows
    (256 rows a block on an H100), at phase 5's screened shape (M0 1,024,
    K 48) and unscreened (M0 nd, K 8): bitwise equal to full_pack_ref,
    one launch a call."""
    dev = _card()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    nd = (32 * sms if limit == "sms" else 32_768) + step
    d = _inputs(50 + step, n=nd - 3, W=250)
    t = _torch(d, dev)
    n = nd - 3
    L = int(d["lens"].max())
    base = (t["tvec"], t["seqs"], t["lens"], 2)
    for screened, M0, K in ((True, min(1024, nd), 48), (False, nd, 8)):
        eth = torch.from_numpy(_eth(d["e"], n, nd, screened)).to(dev)
        small = t["small13"] if screened else t["small5"]
        before = ss.launches["full"]
        _full_equal(small, base, eth, dict(nd=nd, L=L, M0=M0, K=K,
                                           screened=screened))
        assert ss.launches["full"] == before + 1
