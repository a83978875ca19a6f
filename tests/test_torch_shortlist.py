"""Parity of the port's budded compare (kernel B5's plain version on the
CPU, ops/store_screen.py, and CudaBackend._compare_shortlisted) against
dada2_tpu's budded transport (TpuBackend with SPEC_K = 0, its Pallas
kernel in interpret mode, as tests/test_backend_tpu.py runs it).

Everything is bitwise: the plain functions' outputs, the fetched buffer
byte for byte, lam, ham (with -2 for rows the screen dropped),
last_stats, and the engine's results.

The screen reads the small pack's f32 loglam, which the two packages sum
in different orders (tests/test_torch_backend.py holds it to the
screen's margin), so a row whose loglam sits within an ulp of its
threshold could be kept by one and dropped by the other, both soundly.
The backend tests that compare buffers byte for byte therefore hand the
port dada2_tpu's own small pack (`_share_small`); the underflow test and
tests/test_torch_backend.py / test_torch_pipeline.py run the port's own
small pack and hold results."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from dada2_tpu.core import backend_tpu as btj
from dada2_tpu.core.backend_tpu import TpuBackend
from dada2_tpu.core.engine import Engine as EngineJ
from dada2_tpu.core.output import finalize as finalize_j
from dada2_tpu.core.raws import make_rawset
from dada2_tpu.data import tperr1
from dada2_tpu.derep import derep_fastq
from dada2_tpu.options import DEFAULT_OPTIONS
from dada2_tpu.trace import COUNTERS as COUNTERS_J
from dada2_tpu_torch.core.backend_cuda import CudaBackend
from dada2_tpu_torch.core.engine import Engine as EngineT
from dada2_tpu_torch.core.output import finalize as finalize_t
from dada2_tpu_torch.interop import state_from_numpy
from dada2_tpu_torch.ops import store_screen as ss
from dada2_tpu_torch.trace import COUNTERS as COUNTERS_T


# ---- the plain functions against dada2_tpu's traces -------------------------

def _plain_inputs(seed, n=150, W=64, nbad=3, qlo=-6.0):
    """Seeded compare-sweep state in both packages' layouts: the JAX
    package's padded to nd rows (copies of row 0), the port's at n rows.
    e_thresh mixes the -999 init state, 0 (underflow-pinned), subnormal
    and positive thresholds near each row's lambda; nbad rows get a -inf
    log factor (a non-finite loglam). Log factors are uniform in [qlo,
    -0.001): at qlo = -6 most lambdas underflow a float32 threshold."""
    rng = np.random.default_rng(seed)
    nd = ss.pad_rows(n)
    lens = rng.integers(W - 12, W + 1, n).astype(np.int32)
    lens[0] = W
    pos = np.arange(W)[None, :]
    valid = pos < lens[:, None]
    s = rng.integers(0, 4, (n, W))
    seqs = np.where(valid, s, -1).astype(np.int8)
    sub = valid & (rng.random((n, W)) < 0.08)
    nt0 = (s + rng.integers(1, 4, (n, W))) % 4
    tvec = np.where(valid, np.where(sub, 4 * nt0 + s, 5 * s), 16).astype(
        np.int8)
    flags = (1 + 2 * (rng.random(n) < 0.3)
             + 4 * (rng.random(n) < 0.15)).astype(np.int8)
    small5 = np.zeros((n, 5), np.int8)
    small5[:, :4] = np.stack([sub.sum(1), rng.integers(0, 9, n)], 1).astype(
        np.int16).view(np.int8)
    small5[:, 4] = flags
    reads = rng.integers(1, 1000, n).astype(np.int32)
    qlerr = rng.uniform(qlo, -0.001, (17, nd, W)).astype(np.float32)
    qlerr[16] = 0.0
    bad = rng.choice(np.arange(1, n), nbad, replace=False)
    qlerr[:, bad, 0] = -np.inf

    def padj(x):
        return np.concatenate([x, np.repeat(x[:1], nd - n, axis=0)])

    qlerr[:, n:] = qlerr[:, :1]
    jx = dict(tvec=padj(tvec), small5=padj(small5), seqs=padj(seqs),
              lens=padj(lens), reads=padj(reads), qlerr=qlerr)
    small = np.asarray(btj._fused_small(
        jnp.asarray(jx["tvec"]), jnp.asarray(jx["seqs"]),
        jnp.asarray(jx["lens"]), jnp.int32(3), jnp.asarray(qlerr),
        jnp.asarray(jx["small5"])))
    loglam = small[:n, 4:8].copy().view(np.float32)[:, 0]
    kind = rng.integers(0, 3, n)
    e = np.where(np.isfinite(loglam),
                 np.exp(loglam.astype(np.float64) + rng.normal(0, 0.3, n)),
                 1e-3)
    e = np.where(kind == 0, -999.0 / reads.sum(), np.where(kind == 1, 0.0, e))
    e[4::13] = 9.2e-41          # subnormal: XLA reads it as 0
    lock = np.ones(nd, bool)
    lock[:n] = rng.random(n) < 0.2
    lock[3] = True                      # the center, unskipped under greedy
    eth = np.zeros(2 * nd + nd // 8, np.uint8)
    eth[: 2 * n] = (e.astype(np.float32).view(np.uint32) >> 16).astype(
        np.uint16).view(np.uint8)
    eth[2 * nd:] = np.packbits(lock, bitorder="little")
    cached = rng.random(nd) < 0.5
    cbits = np.packbits(cached, bitorder="little")
    pt = dict(small13=torch.from_numpy(small[:n].copy()),
              tvec=torch.from_numpy(tvec), seqs=torch.from_numpy(seqs),
              lens=torch.from_numpy(lens.astype(np.int64)),
              reads=torch.from_numpy(reads), eth2=torch.from_numpy(eth),
              cbits=torch.from_numpy(cbits))
    jx.update(small=small, eth2=eth.view(np.int8), cbits=cbits.view(np.int8))
    return nd, int(lens.max()), jx, pt, e


PLAIN_CASES = {   # (greedy, kind, K, cache_on)
    "tiles16": (False, "tiles", 16, False),
    "tiles48_greedy": (True, "tiles", 48, False),
    "tiles1": (True, "tiles", 1, False),
    "bits8_cache": (False, "bits", 8, True),
    "bits128_greedy_cache": (True, "bits", 128, True),
}


@pytest.mark.parametrize("case", sorted(PLAIN_CASES))
def test_plain_functions_equal(case):
    """shortlist_screen, subs_tiles / subs_bits, budded_pack and take_subs
    bitwise equal to _shortlist_screen, _subs_tile_trace /
    _subs_bits_trace, _budded_fused and _take_subs on the same inputs."""
    greedy, kind, K, cache_on = PLAIN_CASES[case]
    nd, L, jx, pt, e = _plain_inputs(7 + len(case))
    n = pt["seqs"].shape[0]
    center = 3
    d = {k: jnp.asarray(v) for k, v in jx.items()}
    cj = jnp.int32(center)

    hdr_j, order_j, shr_j, need_j = btj._shortlist_screen(
        d["small"], d["eth2"], d["reads"], cj, None, L=L, greedy=greedy)
    hdr_t, order_t, shr_t, need_t = ss.shortlist_screen(
        pt["small13"], pt["eth2"], pt["reads"], center, nd=nd, L=L,
        greedy=greedy)
    need_j, need_t = np.asarray(need_j), need_t.numpy()
    diff = np.nonzero(need_j != need_t)[0]
    assert not len(diff), f"need differs at rows {diff.tolist()}"
    np.testing.assert_array_equal(np.asarray(hdr_j), hdr_t.numpy())
    np.testing.assert_array_equal(np.asarray(order_j), order_t.numpy())
    np.testing.assert_array_equal(np.asarray(shr_j), shr_t.numpy())
    # the threshold keeps some positive-threshold rows and drops others
    pos = need_t[:n][e > 0]
    assert pos.any() and not pos.all()

    idx = np.arange(nd)
    src = ss._src(torch.from_numpy(idx), n)
    flags_t = pt["small13"][:, 12]
    fj = (btj._subs_bits_trace if kind == "bits" else btj._subs_tile_trace)
    want = np.asarray(fj(d["tvec"], d["seqs"], d["lens"], cj,
                         d["small"][:, 12], jnp.asarray(idx), K=K))
    ft = ss.subs_bits if kind == "bits" else ss.subs_tiles
    got = ft(pt["tvec"], pt["seqs"], pt["lens"], center, flags_t, src,
             K).numpy()
    np.testing.assert_array_equal(want.astype(np.int64),
                                  got.astype(np.int64))

    M0, M0U = 32, (16 if cache_on else None)
    buf_j, ord_j, oru_j, small_j = btj._budded_fused(
        d["tvec"], d["small5"], d["seqs"], d["lens"], d["reads"], cj,
        d["qlerr"], d["eth2"], None, d["cbits"], L=L, M0=M0, K=K,
        greedy=greedy, kind=kind, M0U=M0U, cache_on=cache_on)
    np.testing.assert_array_equal(np.asarray(small_j), jx["small"])
    buf_t, ord_t, oru_t, small_t = ss.budded_pack_ref(
        pt["small13"], pt["tvec"], pt["seqs"], pt["lens"], pt["reads"],
        center, pt["eth2"], pt["cbits"], nd=nd, L=L, M0=M0, K=K,
        greedy=greedy, kind=kind, M0U=M0U, cache_on=cache_on)
    assert small_t is pt["small13"]     # given, not recomputed
    buf_j = np.asarray(buf_j).view(np.uint8)
    assert len(buf_t) == len(buf_j) == ss.budbuf_layout(
        nd, pt["seqs"].shape[1], M0, K, kind, M0U)[3]
    np.testing.assert_array_equal(buf_j, buf_t.numpy())
    np.testing.assert_array_equal(np.asarray(ord_j), ord_t.numpy())
    np.testing.assert_array_equal(np.asarray(oru_j), oru_t.numpy())
    m_u = int(buf_t[:16].view(torch.int32)[3 if cache_on else 0])
    assert m_u > (M0U or M0)            # the follow-up has rows to take

    MU = M0U or M0
    M = min(ss.bucket15(m_u - MU), nd - MU)
    want = np.asarray(btj._take_subs(
        d["small"], d["tvec"], d["seqs"], d["lens"], cj, oru_j, M0=MU, M=M,
        K=K, kind=kind)).view(np.uint8)
    got = ss.take_subs_ref(pt["small13"], pt["tvec"], pt["seqs"],
                           pt["lens"], center, oru_t, M0=MU, M=M, K=K,
                           kind=kind)
    np.testing.assert_array_equal(want, got.numpy())


def test_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors budded_pack and take_subs are their plain versions
    and count no launch; they refuse inputs the kernel would not take."""
    nd, L, _, pt, _ = _plain_inputs(3)
    kw = dict(nd=nd, L=L, M0=32, K=16, greedy=False, kind="tiles")
    before = dict(ss.launches)
    args = [pt[k] for k in ("small13", "tvec", "seqs", "lens", "reads")]
    got = ss.budded_pack(*args, 3, pt["eth2"], **kw)
    want = ss.budded_pack_ref(*args, 3, pt["eth2"], **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    got = ss.take_subs(*args[:4], 3, want[1], M0=32, M=24, K=16)
    assert torch.equal(got, ss.take_subs_ref(*args[:4], 3, want[1], M0=32,
                                             M=24, K=16))
    assert ss.launches == before
    with pytest.raises(ValueError, match="bits stream"):
        ss.budded_pack(*args, 3, pt["eth2"], **dict(kw, kind="bits", K=6))
    with pytest.raises(ValueError, match="lens"):
        ss.budded_pack(*args[:3], args[3].to(torch.int32), args[4], 3,
                       pt["eth2"], **kw)


# ---- the backends ----------------------------------------------------------

@pytest.fixture(scope="module")
def sample(extdata):
    d = derep_fastq(str(extdata / "sam1F.fastq.gz"))
    return d.sequences[:150], d.abundances[:150], d.quals[:150]


def _states(seqs, ab, quals, **overrides):
    opts = DEFAULT_OPTIONS.replace(**overrides).normalized()
    rs = make_rawset(seqs, ab, None, quals)
    rs_t, err_t, opts_t = state_from_numpy(
        rs.seqs, rs.lens, rs.reads, rs.priors, rs.quals, tperr1(),
        dataclasses.asdict(opts))
    return (rs, opts), (rs_t, opts_t)


def _backends(monkeypatch, rs, rs_t, opts=None, **attrs):
    """TpuBackend (Pallas in interpret mode, no speculation) and the
    port's CudaBackend on the CPU, each recording every buffer its
    budded compares fetch; given opts, the port screens dada2_tpu's small
    pack (_share_small)."""
    monkeypatch.setenv("DADA2_TPU_PALLAS", "1")
    be_j = TpuBackend(rs, use_quals=True)
    assert be_j.use_pallas
    be_t = CudaBackend(rs_t, device="cpu")
    be_j.SPEC_K = be_t.SPEC_K = 0
    if opts is not None:
        _share_small(be_j, be_t, opts)
    for be, pos in ((be_j, 4), (be_t, 3)):
        for k, v in attrs.items():
            setattr(be, k, v)
        be.bufs = []
        orig = be._finish_budded

        def wrap(*a, _orig=orig, _be=be, _pos=pos, **kw):
            _be.bufs.append(np.asarray(a[_pos]).view(np.uint8).copy())
            return _orig(*a, **kw)
        be._finish_budded = wrap
    return be_j, be_t


def _share_small(be_j, be_t, opts):
    """The port's budded compares get dada2_tpu's small pack for the same
    center and error matrix (its f32 loglam summed in XLA's order), so
    that their screens see the same bits: every lookup of the port's
    small13 cache hits with it, so B5 runs in its small13-given mode."""
    def small13(ent, center, err):
        ent_j = be_j._align_ent(center, opts, be_j._pallas_ok(
            int(be_j.lens[center]), opts))
        small = btj._fused_small(ent_j[1], be_j.d_seqs, be_j.d_lens,
                                 be_j._center_dev(center),
                                 be_j._get_qlerr(err), ent_j[2])
        return torch.from_numpy(np.asarray(small)[: be_t.rs.n].copy())
    be_t._small13 = be_t._small13_cached = small13


def _same_buffers(be_j, be_t):
    assert len(be_j.bufs) == len(be_t.bufs) > 0
    for k, (a, b) in enumerate(zip(be_j.bufs, be_t.bufs)):
        assert len(a) == len(b), f"budded compare {k}: {len(a)} != {len(b)}"
        diff = np.nonzero(a != b)[0]
        assert not len(diff), f"budded compare {k}: bytes {diff[:20]}"


def _assert_same(res_a, res_b):
    pd.testing.assert_frame_equal(res_a["clustering"], res_b["clustering"])
    pd.testing.assert_frame_equal(res_a["birth_subs"], res_b["birth_subs"])
    for k in ("subqual", "map", "pval", "clusterquals"):
        np.testing.assert_array_equal(res_a[k], res_b[k])


COMPARE_CASES = {
    "m0_16": dict(SHORTLIST_M0=16),     # the follow-up fetch (m > M0)
    "adaptive": {},
    "k1": dict(SHORTLIST_K=1),          # most rows dense re-fetched
    "bits8": dict(SHORTLIST_FORCE=("bits", 8)),
}


@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_shortlist_equal(sample, monkeypatch, case):
    """Budded compares (after an init compare on the same backend) give
    dada2_tpu's lam, ham (-2 rows included), last_stats and buffer,
    under a threshold that mixes the -999 init state, 0 and positive
    values, with and without greedy; the rows the screen drops are never
    stored."""
    (rs, opts), (rs_t, opts_t) = _states(*sample)
    be_j, be_t = _backends(monkeypatch, rs, rs_t, opts,
                           **COMPARE_CASES[case])
    err = tperr1()
    n = rs.n
    skip = np.zeros(n, bool)
    skip[[5, 17, 40]] = True
    cutoff = opts.KDIST_CUTOFF
    lam0, ham0 = be_j.compare(0, skip, opts, err, True, 1.0)
    lam0_t, _ = be_t.compare(0, skip, opts_t, err, True, 1.0)
    np.testing.assert_array_equal(lam0, lam0_t)
    total = int(rs.reads.sum())
    e_minmax = np.full(n, np.median(lam0[lam0 > 0]) * total / 2)
    e_minmax[1::7] = -999.0
    e_minmax[2::7] = 0.0
    fetched = None
    for center, greedy in ((0, True), (7, False), (7, True), (0, False)):
        o_j = opts.replace(GREEDY=greedy)
        o_t = dataclasses.replace(opts_t, GREEDY=greedy)
        sk = skip | ((rs.reads > rs.reads[center]) if greedy else False)
        lam_j, ham_j = be_j.compare(center, sk, o_j, err, True, cutoff,
                                    e_minmax / total)
        lam_t, ham_t = be_t.compare(center, sk, o_t, err, True, cutoff,
                                    e_minmax / total)
        np.testing.assert_array_equal(ham_j, ham_t)
        np.testing.assert_array_equal(lam_j, lam_t)
        assert be_j.last_stats == be_t.last_stats is not None
        if center == 0 and not greedy:
            fetched = ham_t != -2
    _same_buffers(be_j, be_t)
    assert 0 < fetched.sum() < n - 3    # the screen screened
    lam_f, ham_f = be_j.compare(0, skip, opts, err, True, cutoff)
    store = lam_f * total > e_minmax
    assert fetched[store & (ham_f >= 0)].all()


def test_full_run_parity_bits_transport(sample, monkeypatch):
    """An engine run with the bits transport forced tiny (K = 8) and a
    16-row buffer: the bits decode, the follow-up fetch and the dense
    re-fetches all run; comp_lam, the finalized results and every buffer
    equal dada2_tpu's."""
    (rs, opts), (rs_t, opts_t) = _states(*sample)
    be_j, be_t = _backends(monkeypatch, rs, rs_t, opts, SHORTLIST_M0=16,
                           SHORTLIST_FORCE=("bits", 8))
    err = tperr1()
    outs = []
    f0, d0 = COUNTERS_T.followup_fetches, COUNTERS_T.dense_refetches
    for be, Eng, fin, o in ((be_j, EngineJ, finalize_j, opts),
                            (be_t, EngineT, finalize_t, opts_t)):
        eng = Eng(rs if be is be_j else rs_t, err, o, be, use_quals=True)
        eng.run(max_clust=o.MAX_CLUST)
        outs.append((eng, fin(eng, o, err.shape[1], o.OMEGA_C)))
    (eng_j, res_j), (eng_t, res_t) = outs
    assert len(eng_j.clusters) == len(eng_t.clusters) > 1
    np.testing.assert_array_equal(eng_j.comp_lam, eng_t.comp_lam)
    _assert_same(res_j, res_t)
    _same_buffers(be_j, be_t)
    assert COUNTERS_T.followup_fetches > f0
    assert COUNTERS_T.dense_refetches > d0


def test_underflow_screen_soundness(monkeypatch):
    """E_minmax == 0 (distant singletons after a lambda underflow): the
    card's screen drops exactly the rows dada2_tpu drops, each with an
    exact lambda of 0.0; at the -999 init state every row ships."""
    rng = np.random.default_rng(7)
    n = 60
    seqs = ["".join(rng.choice(list("ACGT"), size=400)) for _ in range(n)]
    ab = np.concatenate([[500], np.ones(n - 1)]).astype(np.int64)
    quals = np.full((n, 400), 35.0)
    (rs, opts), (rs_t, opts_t) = _states(seqs, ab, quals, KDIST_CUTOFF=1.0)
    be_j, be_t = _backends(monkeypatch, rs, rs_t)
    err = tperr1()
    skip = np.zeros(n, bool)
    lam_full, _ = CudaBackend(rs_t, device="cpu").compare(
        0, skip, opts_t, err, True, 1.0)
    eth = np.zeros(n)
    eth[:3] = 1e-12
    for e in (eth, np.full(n, -999.0 / int(rs.reads.sum()))):
        lam_j, ham_j = be_j.compare(0, skip, opts, err, True, 1.0, e)
        lam_t, ham_t = be_t.compare(0, skip, opts_t, err, True, 1.0, e)
        np.testing.assert_array_equal(ham_j, ham_t)
        np.testing.assert_array_equal(lam_j, lam_t)
        assert be_j.last_stats == be_t.last_stats
    _same_buffers(be_j, be_t)
    dropped = be_t.compare(0, skip, opts_t, err, True, 1.0, eth)[1] == -2
    dropped_z = dropped & (eth == 0)
    assert dropped_z.any()                      # the underflow rule fired
    assert (lam_full[dropped_z] == 0.0).all()   # soundly
    assert (ham_t != -2).all()                  # -999: every row ships


def _second_err():
    err2 = tperr1() ** 1.1
    for b in range(4):
        rows = [4 * b + j for j in range(4) if j != b]
        err2[4 * b + b] = 1.0 - err2[rows].sum(axis=0)
    return err2


def _rounds(be, rs, opts, Eng, fin, C):
    """Three engine runs on one backend (selfConsist's rounds: err,
    another matrix, err again): the finalized results and each round's
    fetched bytes."""
    out, fb = [], []
    for e in (tperr1(), _second_err(), tperr1()):
        b0 = C.fetch_bytes
        eng = Eng(rs, e, opts, be, use_quals=True)
        eng.run(max_clust=opts.MAX_CLUST)
        out.append(fin(eng, opts, e.shape[1], opts.OMEGA_C))
        fb.append(C.fetch_bytes - b0)
    return out, fb


@pytest.mark.parametrize("m0u", [None, 0], ids=["adaptive", "m0u_0"])
def test_cross_round_subs_cache_parity(sample, monkeypatch, m0u):
    """Rounds 2 and 3 on one backend ship payload only for uncached
    rows. With the full-coverage bits transport (no dense re-fetch) the
    results and every buffer equal dada2_tpu's; the third round fetches
    fewer bytes than the first; with the uncached buffer forced empty
    every uncached row takes the cache-mode follow-up."""
    (rs, opts), (rs_t, opts_t) = _states(*sample)
    be_j, be_t = _backends(monkeypatch, rs, rs_t, opts)
    full = be_t._k_menu()[-1]
    assert full[0] == "bits"
    be_j.SHORTLIST_FORCE = be_t.SHORTLIST_FORCE = full
    if m0u is not None:
        be_j._predict_m0u = lambda ordinal, M0: m0u
        be_t._predict_m0u = lambda ordinal, M0: m0u
    f0, d0 = COUNTERS_T.followup_fetches, COUNTERS_T.dense_refetches
    res_j, _ = _rounds(be_j, rs, opts, EngineJ, finalize_j, COUNTERS_J)
    res_t, fb = _rounds(be_t, rs_t, opts_t, EngineT, finalize_t, COUNTERS_T)
    for a, b in zip(res_j, res_t):
        _assert_same(a, b)
    _same_buffers(be_j, be_t)
    assert fb[2] < fb[0]                 # the cached round ships less
    assert COUNTERS_T.dense_refetches == d0
    if m0u is not None:
        assert COUNTERS_T.followup_fetches > f0


def test_cross_round_dense_records_match_oracle(sample):
    """Rows re-fetched densely (more substitutions than the narrow tile
    holds) enter the cross-round cache with complete records; later
    rounds rebuild their lambdas from the cache, and the port's three
    rounds equal the oracle's bit for bit. (dada2_tpu's transport caches
    these rows' nt0 as 0 — `(t >> 2) << 14` on uint8 overflows under
    numpy 2 — so with SPEC_K = 0 its later rounds can differ from the
    oracle; ROADMAP.md records it.) Speculation is off: its segments'
    widest K leaves no row to re-fetch densely."""
    from dada2_tpu.core.backend_ref import OracleBackend

    (rs, opts), (rs_t, opts_t) = _states(*sample)
    be_t = CudaBackend(rs_t, device="cpu")
    be_t.SPEC_K = 0
    d0 = COUNTERS_T.dense_refetches
    res_t, fb = _rounds(be_t, rs_t, opts_t, EngineT, finalize_t, COUNTERS_T)
    assert COUNTERS_T.dense_refetches > d0
    assert any(ent[4]["flat"].size for ent in be_t._subs_cache.values())
    res_o, _ = _rounds(OracleBackend(rs, use_quals=True), rs, opts, EngineJ,
                       finalize_j, COUNTERS_J)
    for b, c in zip(res_t, res_o):
        _assert_same(c, b)
    assert fb[2] < fb[0]
