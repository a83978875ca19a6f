"""Kernel B5 as the whole budded compare: its small pack (the f32
log-lambda screen of every row) inside the same launch as the screen,
the compactions and the shortlist pack (ops/store_screen.py), against
dada2_tpu on the CPU.

The small pack sums in the kernel's order (`small_pack_ref`: lane l of
32 adds positions l, l + 32, ..., then an xor butterfly), not XLA's. Its
loglam and abssum are held to dada2_tpu's `_small_trace` within the
screen's margin: both sum the same W float32 terms, in two orders, so
they differ by at most about W * 2^-23 * sum |term|, which the margin
1e-4 + 2^-23 (5 L + (L + 5) abssum) bounds (TpuBackend._screen_need
keeps 1e-3 + the same terms, so a row that either sum keeps is kept).
Non-finite sums and every other byte are equal. The order itself is held
bit for bit against a scalar loop and on a row where it decides the
result. On the card (`gpu` tests) the kernel is bitwise equal to its
plain version in both modes: small13 computed and given. dada2_tpu is
imported inside the tests that compare with it, so that the `gpu` tests
run where jax is not installed (`pytest --noconftest -m gpu`)."""
import pathlib

import numpy as np
import pandas as pd
import pytest
import torch

import dada2_tpu_torch as dt
from dada2_tpu_torch.core.backend_cuda import CudaBackend
from dada2_tpu_torch.ops import store_screen as ss

EPS = 2.0 ** -23


def _rows(seed, n=90, W=70, Q=41, gl_share=0.3, with_quals=True,
          neg_inf=False):
    """Seeded compare-sweep rows in numpy: seqs, tvec (8% substitutions),
    lens, small5 (gapless flags on gl_share of the rows), quals (some at
    or past Q, which add nothing), lerr [17, Q] f32 (row 16 = 0), and, with
    neg_inf, one zero error rate (a -inf factor)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(W - 15, W + 1, n)
    lens[0] = W
    pos = np.arange(W)[None, :]
    valid = pos < lens[:, None]
    s = rng.integers(0, 4, (n, W))
    seqs = np.where(valid, s, -1).astype(np.int8)
    sub = valid & (rng.random((n, W)) < 0.08)
    nt0 = (s + rng.integers(1, 4, (n, W))) % 4
    tvec = np.where(valid, np.where(sub, 4 * nt0 + s, 5 * s), 16).astype(
        np.int8)
    flags = (1 + 2 * (rng.random(n) < gl_share)
             + 4 * (rng.random(n) < 0.1)).astype(np.int8)
    small5 = np.zeros((n, 5), np.int8)
    small5[:, :4] = np.stack([sub.sum(1), rng.integers(0, 9, n)], 1).astype(
        np.int16).view(np.int8)
    small5[:, 4] = flags
    err = rng.uniform(1e-5, 0.9, (16, Q))
    if neg_inf:
        err[5 * 2, 3] = 0.0
    with np.errstate(divide="ignore"):
        lerr = np.concatenate([np.log(err), np.zeros((1, Q))]).astype(
            np.float32)
    quals = (rng.integers(0, Q + 6, (n, W)).astype(np.uint8) if with_quals
             else None)
    return dict(seqs=seqs, tvec=tvec, lens=lens.astype(np.int64),
                small5=small5, quals=quals, lerr=lerr)


def _torch(d, dev="cpu"):
    return {k: (None if v is None else torch.from_numpy(v).to(dev))
            for k, v in d.items()}


def _small_ref(t, center):
    return ss.small_pack_ref(t["tvec"], t["seqs"], t["lens"], t["quals"],
                             center, t["lerr"], t["small5"])


def _jax_small(d, center):
    """dada2_tpu's _small_trace on the same rows: its per-position
    [17, n, W] table is lerr[t, q] (0 where q >= Q), as _qlerr_table
    builds it."""
    import jax.numpy as jnp

    from dada2_tpu.core import backend_tpu as btj

    n, W = d["seqs"].shape
    Q = d["lerr"].shape[1]
    q = (d["quals"].astype(np.int64) if d["quals"] is not None
         else np.zeros((n, W), np.int64))
    qlerr = np.where((q < Q)[None], d["lerr"][:, np.minimum(q, Q - 1)],
                     np.float32(0.0)).astype(np.float32)
    return np.asarray(btj._fused_small(
        jnp.asarray(d["tvec"]), jnp.asarray(d["seqs"]),
        jnp.asarray(d["lens"].astype(np.int32)), jnp.int32(center),
        jnp.asarray(qlerr), jnp.asarray(d["small5"])))


SMALL_CASES = {
    "quals": {},
    "no_quals": dict(with_quals=False),
    "gapless": dict(gl_share=1.0),
    "neg_inf": dict(neg_inf=True),
}


@pytest.mark.parametrize("case", sorted(SMALL_CASES))
def test_small_pack_within_margin_of_jax(case):
    """small_pack_ref against dada2_tpu's _small_trace: ham, ham_gapless
    and flags equal; loglam and abssum within the screen's margin (see
    the module docstring), non-finite ones equal."""
    d = _rows(31 + len(case), **SMALL_CASES[case])
    center = 4
    want = _jax_small(d, center)
    got = _small_ref(_torch(d), center).numpy()
    np.testing.assert_array_equal(want[:, :4], got[:, :4])
    np.testing.assert_array_equal(want[:, 12], got[:, 12])
    fj = want[:, 4:12].copy().view(np.float32).astype(np.float64)
    ft = got[:, 4:12].copy().view(np.float32).astype(np.float64)
    fin = np.isfinite(fj)
    np.testing.assert_array_equal(fin, np.isfinite(ft))
    np.testing.assert_array_equal(fj[~fin], ft[~fin])
    L = int(d["lens"].max())
    margin = 1e-4 + EPS * (5.0 * L + (L + 5.0) * np.abs(fj[:, 1]))
    for k in (0, 1):
        ok = fin[:, k]
        assert (np.abs(fj[ok, k] - ft[ok, k]) <= margin[ok]).all()
    if case == "neg_inf":
        assert (~fin[:, 0]).any()
    if case == "gapless":
        assert ((got[:, 12] & 2) != 0).all()


def _kernel_order(lf):
    """The defined order as a scalar loop over one row's f32 terms."""
    lanes = [np.float32(0.0)] * 32
    for p, v in enumerate(lf):
        lanes[p % 32] = np.float32(lanes[p % 32] + v)
    for off in (16, 8, 4, 2, 1):
        lanes = [np.float32(lanes[i] + lanes[i ^ off]) for i in range(32)]
    return lanes[0]


def test_small_pack_order_is_the_scalar_loop():
    """On seeded rows the plain version's loglam and abssum are bit for
    bit the defined order run as a scalar loop."""
    d = _rows(5, n=24, W=100)
    center = 2
    got = _small_ref(_torch(d), center).numpy()
    f = got[:, 4:12].copy().view(np.float32)
    n, W = d["seqs"].shape
    Q = d["lerr"].shape[1]
    s0 = d["seqs"][center].astype(np.int64)
    for i in range(n):
        lf = np.zeros(W, np.float32)
        for p in range(int(d["lens"][i])):
            a = int(d["seqs"][i, p])
            if d["small5"][i, 4] & 2:
                t = (4 * s0[p] + a if p < d["lens"][center] and s0[p] != a
                     else 5 * a)
            else:
                t = int(d["tvec"][i, p])
            q = int(d["quals"][i, p])
            lf[p] = d["lerr"][t, q] if q < Q else np.float32(0.0)
        assert f[i, 0] == _kernel_order(lf), i
        assert f[i, 1] == _kernel_order(np.abs(lf)), i


@pytest.mark.parametrize("placing", [(0, 16, 8), (3, 35, 19)],
                         ids=["butterfly", "strided"])
def test_small_pack_order_decides_last_bit(placing):
    """1e8, 1 and -1e8 on positions whose lanes the defined order pairs:
    it rounds 1e8 + 1 to 1e8 before -1e8 cancels it, so loglam is 0.0,
    where the ascending sequential sum keeps the 1 (1.0)."""
    W, Q = 64, 4
    p_big, p_one, p_neg = placing
    quals = np.zeros((1, W), np.uint8)
    quals[0, [p_big, p_one, p_neg]] = [1, 2, 3]
    lerr = np.zeros((17, Q), np.float32)
    lerr[0] = [0.0, 1e8, 1.0, -1e8]
    d = dict(seqs=np.zeros((1, W), np.int8), tvec=np.zeros((1, W), np.int8),
             lens=np.array([W], np.int64), small5=np.ones((1, 5), np.int8),
             quals=quals, lerr=lerr)
    got = _small_ref(_torch(d), 0).numpy()
    loglam, abssum = got[0, 4:12].copy().view(np.float32)
    seq = np.float32(0.0)
    for v in lerr[0, quals[0]]:
        seq = np.float32(seq + v)
    assert seq == np.float32(1.0)
    assert loglam == np.float32(0.0)
    assert abssum == np.float32(2e8)


def _budded_inputs(seed, n=150, W=64):
    """Rows plus a budded compare's screen inputs: e_thresh near each
    row's loglam, 0 and -999 states mixed in, lock bits (pad rows
    locked), reads, a cached-row bitmap."""
    d = _rows(seed, n=n, W=W)
    rng = np.random.default_rng(seed + 1)
    nd = ss.pad_rows(n)
    t = _torch(d)
    small = _small_ref(t, 3).numpy()
    loglam = small[:, 4:8].copy().view(np.float32)[:, 0].astype(np.float64)
    e = np.exp(loglam + rng.normal(0, 0.3, n))
    kind = rng.integers(0, 3, n)
    e = np.where(kind == 0, -1e-3, np.where(kind == 1, 0.0, e))
    lock = np.ones(nd, bool)
    lock[:n] = rng.random(n) < 0.2
    lock[3] = True
    eth = np.zeros(2 * nd + nd // 8, np.uint8)
    eth[: 2 * n] = (e.astype(np.float32).view(np.uint32) >> 16).astype(
        np.uint16).view(np.uint8)
    eth[2 * nd:] = np.packbits(lock, bitorder="little")
    t.update(reads=torch.from_numpy(rng.integers(1, 1000, n).astype(
        np.int32)), eth2=torch.from_numpy(eth),
        cbits=torch.from_numpy(np.packbits(rng.random(nd) < 0.5,
                                           bitorder="little")))
    return nd, int(d["lens"].max()), t


FUSED_CASES = {   # (greedy, kind, K, cache_on)
    "tiles16": (False, "tiles", 16, False),
    "tiles48_greedy": (True, "tiles", 48, False),
    "bits8_cache": (False, "bits", 8, True),
    "bits64_greedy_cache": (True, "bits", 64, True),
}


def _pack_args(t, nd, L, case, small13=None, **over):
    greedy, kind, K, cache_on = FUSED_CASES[case]
    args = [small13, t["tvec"], t["seqs"], t["lens"], t["reads"], 3,
            t["eth2"], t["cbits"] if cache_on else None]
    kw = dict(nd=nd, L=L, M0=32, K=K, greedy=greedy, kind=kind,
              M0U=16 if cache_on else None, cache_on=cache_on,
              small5=t["small5"], quals=t["quals"], lerr=t["lerr"])
    kw.update(over)
    return args, kw


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_budded_pack_computes_its_small_pack(case):
    """budded_pack_ref(small13=None) (the small pack inside) equals
    budded_pack_ref given small_pack_ref's small13, byte for byte, and
    returns that small13; on CPU tensors the wrapper is the plain version
    in both modes and counts no launch."""
    nd, L, t = _budded_inputs(11 + len(case))
    small = _small_ref(t, 3)
    args, kw = _pack_args(t, nd, L, case)
    got = ss.budded_pack_ref(*args, **kw)
    want = ss.budded_pack_ref(small, *args[1:], **kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    m = int(got[0][:16].view(torch.int32)[0])
    assert 0 < m < nd
    before = dict(ss.launches)
    for a in (args, [small] + args[1:]):
        for g, w in zip(ss.budded_pack(*a, **kw), want):
            assert torch.equal(g, w)
    assert torch.equal(ss.small_pack(t["tvec"], t["seqs"], t["lens"],
                                     t["quals"], 3, t["lerr"], t["small5"]),
                       small)
    assert ss.launches == before


def test_budded_route_caches_the_fused_small_pack(extdata, monkeypatch):
    """A budded compare whose small13 is not cached runs B5 with the small
    pack inside and caches the small13 it returns; the same center and
    error matrix again hits the cache (B5 given small13), and that
    small13 is the full route's (one definition of its bits)."""
    drp = dt.derep_fastq(str(extdata / "sam1F.fastq.gz"))
    rs = dt.core.raws.make_rawset(drp.sequences[:120], drp.abundances[:120],
                                  None, drp.quals[:120])
    be = CudaBackend(rs, device="cpu")
    opts = dt.DEFAULT_OPTIONS.normalized()
    err = dt.data.tperr1()
    modes = []
    ref = ss.budded_pack_ref

    def spy(small13, *a, **kw):
        modes.append(small13 is None)
        return ref(small13, *a, **kw)
    monkeypatch.setattr(ss, "budded_pack_ref", spy)
    skip = np.zeros(rs.n, bool)
    lam0, _ = be.compare(0, skip, opts, err, True, 1.0)
    e = np.full(rs.n, np.median(lam0[lam0 > 0]) / 2)
    out1 = be.compare(5, skip, opts, err, True, opts.KDIST_CUTOFF, e)
    out2 = be.compare(5, skip, opts, err, True, opts.KDIST_CUTOFF, e)
    assert modes == [True, False]
    for a, b in zip(out1, out2):
        np.testing.assert_array_equal(a, b)
    ent = be._align_ent(5, opts, be._kernel_geom(int(be.lens[5]), opts))
    cached = be._small13_cached(ent, 5, err)
    full = ss.small_pack_ref(ent[1], be.d_seqs, be.d_lens, be.d_quals, 5,
                             be._lerr(err), ent[2])
    assert torch.equal(cached, full)


def _simulated(seed=12, nreads=1500):
    """A small phase-5-like sample: reads drawn from sam1F's eight most
    abundant uniques (multinomial by abundance), each base substituted
    with probability 0.004 (the targets uniform), with the unique's
    qualities; dereplicated in memory into both packages' Derep."""
    import dada2_tpu as dj

    base = dj.derep_fastq(str(pathlib.Path(__file__).parent / "extdata"
                              / "sam1F.fastq.gz"))
    rng = np.random.default_rng(seed)
    seqs = base.sequences[:8]
    ab = np.asarray(base.abundances[:8], float)
    counts = rng.multinomial(nreads, ab / ab.sum())
    nt = "ACGT"
    reads, quals = [], []
    for k, m in enumerate(counts):
        s = np.frombuffer(seqs[k].encode(), np.uint8)
        codes = np.searchsorted(np.frombuffer(b"ACGT", np.uint8), s)
        for _ in range(m):
            c = codes.copy()
            hit = rng.random(len(c)) < 0.004
            c[hit] = (c[hit] + rng.integers(1, 4, hit.sum())) % 4
            reads.append("".join(nt[x] for x in c))
            quals.append(np.asarray(base.quals[k][:len(c)], float))
    order, first = {}, {}
    for i, r in enumerate(reads):
        order[r] = order.get(r, 0) + 1
        first.setdefault(r, i)
    uniq = sorted(order, key=lambda r: (-order[r], first[r]))
    W = max(len(r) for r in uniq)
    q = np.full((len(uniq), W), np.nan)
    for j, r in enumerate(uniq):
        q[j, :len(r)] = quals[first[r]]
    rank = {r: j for j, r in enumerate(uniq)}
    mp = np.array([rank[r] for r in reads], np.int64)
    mk = dict(uniques={r: order[r] for r in uniq}, map=mp, name="sim")
    return (dj.Derep(quals=q, **mk),
            dt.Derep(quals=q.copy(), **dict(mk, uniques=dict(mk["uniques"]),
                                            map=mp.copy())))


def test_self_consist_simulated_equal(monkeypatch):
    """selfConsist on a simulated sample through the port's budded route
    (B5's plain version computing its small pack) gives dada2_tpu's
    results bit for bit: every round's err_in, err_out, clustering, map,
    pval, birth_subs and trans."""
    import dada2_tpu as dj

    drp_j, drp_t = _simulated()
    modes = []
    ref = ss.budded_pack_ref

    def spy(small13, *a, **kw):
        modes.append(small13 is None)
        return ref(small13, *a, **kw)
    monkeypatch.setattr(ss, "budded_pack_ref", spy)
    res_j = dj.dada(drp_j, err=None, selfConsist=True, MAX_CONSIST=3,
                    verbose=False)
    res_t = dt.dada(drp_t, err=None, selfConsist=True, MAX_CONSIST=3,
                    device="cpu", verbose=False)
    assert sum(modes) > 0                   # budded compares, fused pack
    assert len(res_j.err_in) == len(res_t.err_in) >= 2
    for a, b in zip(res_j.err_in, res_t.err_in):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(res_j.err_out, res_t.err_out)
    assert len(res_t.denoised) > 1
    pd.testing.assert_frame_equal(res_j.clustering, res_t.clustering)
    pd.testing.assert_frame_equal(res_j.birth_subs, res_t.birth_subs)
    for k in ("map", "pval", "trans"):
        np.testing.assert_array_equal(getattr(res_j, k), getattr(res_t, k))


# ---- the follow-up at wide rows ---------------------------------------------

# W 250 (16 lanes a slot, one chunk a lane), an odd 1,451 (32 lanes a slot,
# two passes) and samPB's ~1,500
WIDE_W = (250, 1451, 1500)
TAKE_KINDS = (("tiles", 8), ("tiles", 128), ("bits", 256), ("bits", 1024))


def _wide_take(W, dev="cpu"):
    """Seeded rows of width W, their small13 and small5 rows, and an order
    over the JAX package's nd rows (pad rows included)."""
    d = _rows(60 + W, n=70, W=W)
    t = _torch(d, dev)
    small13 = _small_ref({k: v.cpu() for k, v in t.items()}, 3).to(dev)
    nd = ss.pad_rows(70)
    order = np.random.default_rng(W).permutation(nd).astype(np.int32)
    return d, t, small13, nd, order


@pytest.mark.parametrize("W", WIDE_W)
def test_wide_rows_take_equal(W):
    """take_subs_ref bitwise equal to _take_subs over 37 compacted rows
    (not a multiple of the packer's slots a warp) past M0 5, tiles at K 8
    and 128 and bits at K 256 and 1024, at widths the other B5 tests never
    reach."""
    import jax.numpy as jnp

    from dada2_tpu.core import backend_tpu as btj

    d, t, small13, nd, order = _wide_take(W)
    n = d["seqs"].shape[0]

    def padded(x):
        return jnp.asarray(np.concatenate([x, np.repeat(x[:1], nd - n, 0)]))

    jx = {k: padded(np.asarray(v)) for k, v in (
        ("small13", small13.numpy()), ("tvec", d["tvec"]),
        ("seqs", d["seqs"]), ("lens", d["lens"]))}
    for kind, K in TAKE_KINDS:
        want = np.asarray(btj._take_subs(
            jx["small13"], jx["tvec"], jx["seqs"], jx["lens"], jnp.int32(3),
            jnp.asarray(order), M0=5, M=37, K=K, kind=kind)).view(np.uint8)
        got = ss.take_subs_ref(small13, t["tvec"], t["seqs"], t["lens"], 3,
                               torch.from_numpy(order), M0=5, M=37, K=K,
                               kind=kind)
        np.testing.assert_array_equal(want, got.numpy())


# ---- on the card ------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel B5 has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_kernel_equals_plain_on_card(case):
    """One launch of B5 per call, bitwise equal to its plain version on
    the same card tensors: buf, order, order_u and small13, with small13
    computed and given; the small-only launch equals small_pack_ref."""
    dev = _card()
    nd, L, t = _budded_inputs(11 + len(case))
    t = {k: v.to(dev) for k, v in t.items()}
    args, kw = _pack_args(t, nd, L, case)
    before = dict(ss.launches)
    got = ss.budded_pack(*args, **kw)
    want = ss.budded_pack_ref(*args, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    given = [got[3]] + args[1:]
    for g, w in zip(ss.budded_pack(*given, **kw),
                    ss.budded_pack_ref(*given, **kw)):
        assert torch.equal(g, w)
    small = ss.small_pack(t["tvec"], t["seqs"], t["lens"], t["quals"], 3,
                          t["lerr"], t["small5"])
    assert torch.equal(small, got[3])
    torch.cuda.synchronize()
    assert ss.launches["pack"] - before["pack"] == 2
    assert ss.launches["small"] - before["small"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("placing", [(0, 16, 8), (3, 35, 19)],
                         ids=["butterfly", "strided"])
def test_small_kernel_order_on_card(placing):
    """The kernel's small pack sums in the defined order: on the row where
    the order decides the last bit it gives small_pack_ref's 0.0, in the
    small-only launch and inside budded_pack."""
    dev = _card()
    W, Q = 64, 4
    quals = np.zeros((1, W), np.uint8)
    quals[0, list(placing)] = [1, 2, 3]
    lerr = np.zeros((17, Q), np.float32)
    lerr[0] = [0.0, 1e8, 1.0, -1e8]
    t = _torch(dict(seqs=np.zeros((1, W), np.int8),
                    tvec=np.zeros((1, W), np.int8),
                    lens=np.array([W], np.int64),
                    small5=np.ones((1, 5), np.int8), quals=quals, lerr=lerr),
               dev)
    small = ss.small_pack(t["tvec"], t["seqs"], t["lens"], t["quals"], 0,
                          t["lerr"], t["small5"])
    assert torch.equal(small.cpu(), _small_ref(
        {k: v.cpu() for k, v in t.items()}, 0))
    assert small.cpu()[0, 4:8].view(torch.float32).item() == 0.0
    nd = 16
    eth = torch.zeros(2 * nd + nd // 8, dtype=torch.uint8, device=dev)
    got = ss.budded_pack(None, t["tvec"], t["seqs"], t["lens"],
                         torch.ones(1, dtype=torch.int32, device=dev), 0,
                         eth, nd=nd, L=W, M0=1, K=4, greedy=False,
                         small5=t["small5"], quals=t["quals"],
                         lerr=t["lerr"])
    assert torch.equal(got[3], small)


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_projection_kernel_equals_plain_on_card(case):
    """B5 with a projection operand (each row's loglam plus noise on half
    the rows, -inf elsewhere, finite on the center's row) and the fold of
    its compare into proj_out, writing into a slice of a larger buffer:
    bitwise equal to its plain version (buf, order, order_u, small13,
    proj_out), small13 computed and given, the bytes around the slice
    untouched; the center's reads is 7, where the correctly rounded log
    and the projection's log_f32 differ."""
    dev = _card()
    nd, L, t = _budded_inputs(31 + len(case))
    t["reads"][3] = 7
    t = {k: v.to(dev) for k, v in t.items()}
    rng = np.random.default_rng(len(case))
    loglam = _small_ref({k: v.cpu() for k, v in t.items()}, 3)[
        :, 4:8].contiguous().view(torch.float32)[:, 0].numpy()
    src = np.where(np.arange(nd) < len(loglam), np.arange(nd), 0)
    proj = np.where(rng.random(nd) < 0.5, -np.inf,
                    loglam[src] + rng.normal(0.0, 0.5, nd))
    proj[3] = 0.0
    args, kw = _pack_args(t, nd, L, case,
                          proj=torch.from_numpy(proj.astype(np.float32)).to(
                              dev), logtotal=float(np.log(1e5)))
    before = dict(ss.launches_with)
    for small13 in (None, "given"):
        a = args if small13 is None else [got[3]] + args[1:]
        outs = []
        for fn in (ss.budded_pack, ss.budded_pack_ref):
            po = torch.empty(nd, dtype=torch.float32, device=dev)
            outs.append(list(fn(*a, **kw, proj_out=po)) + [po])
        got = outs[0]
        for g, w in zip(*outs):
            assert torch.equal(g, w)
        blen = len(got[0])
        big = torch.full((blen + 64,), 0xA5, dtype=torch.uint8, device=dev)
        po = torch.empty(nd, dtype=torch.float32, device=dev)
        res = ss.budded_pack(*a, **kw, proj_out=po, out=big[32: 32 + blen])
        assert res[0].data_ptr() == big[32:].data_ptr()
        assert torch.equal(big[32: 32 + blen], got[0])
        assert torch.equal(po, got[4])
        assert bool((big[:32] == 0xA5).all() & (big[32 + blen:] == 0xA5).all())
    torch.cuda.synchronize()
    assert ss.launches_with["proj"] - before["proj"] == 4
    assert ss.launches_with["fold"] - before["fold"] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("W", WIDE_W)
def test_wide_rows_take_kernel_equals_plain_on_card(W):
    """The follow-up's slot packer at W 250, 1,451 and 1,500 over 37
    compacted rows past M0 5 and over all nd from 0, small13 and small5
    rows, tiles at K 8 and 128 and bits at K 256 and 1024, with tvec at
    an odd base address: bitwise equal to take_subs_ref, one launch a
    call."""
    dev = _card()
    d, t, small13, nd, order = _wide_take(W, dev)
    order = torch.from_numpy(order).to(dev)
    flat = torch.empty(t["tvec"].numel() + 3, dtype=torch.int8, device=dev)
    tvec = flat[3:].view(t["tvec"].shape)
    tvec.copy_(t["tvec"])
    before = ss.launches["take"]
    calls = 0
    for small in (small13, t["small5"]):
        for kind, K in TAKE_KINDS:
            for M0, M in ((5, 37), (0, nd)):
                a = (small, tvec, t["seqs"], t["lens"], 3, order)
                kw = dict(M0=M0, M=M, K=K, kind=kind)
                assert torch.equal(ss.take_subs(*a, **kw),
                                   ss.take_subs_ref(*a, **kw))
                calls += 1
    torch.cuda.synchronize()
    assert ss.launches["take"] - before == calls
