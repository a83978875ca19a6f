"""Speculation, the multi-bud prefetch, in the port against dada2_tpu on
the CPU.

Kernel B5's projection fold (`proj_update_ref`, the JAX package's
`_proj_update`) and its projected screen (`budded_pack_ref(proj=)`,
`_budded_fused(..., proj)`) bit for bit, with the f32 log they take
(`log_f32`) held to XLA's; then the backend at SPEC_K = 8: the same
results as at SPEC_K = 0 with hits, follow-ups inside consumed segments
and the bud sequence rolled over between runs; and, sharing dada2_tpu's
small pack (`_share_small`), every budded buffer (main compares and
consumed segments), every dispatch's candidate list, the spec counters
and the engine's bud candidates equal to dada2_tpu's. Every comparison
is exact: no tolerance."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_shortlist import (_assert_same, _plain_inputs, _rounds,
                                  _same_buffers, _share_small, _states,
                                  sample)  # noqa: F401 (fixture)

from dada2_tpu.core import backend_tpu as btj
from dada2_tpu.core.backend_tpu import TpuBackend
from dada2_tpu.core.engine import Engine as EngineJ
from dada2_tpu.core.output import finalize as finalize_j
from dada2_tpu.data import tperr1
from dada2_tpu.trace import COUNTERS as COUNTERS_J
from dada2_tpu_torch.core.backend_cuda import CudaBackend
from dada2_tpu_torch.core.engine import Engine as EngineT
from dada2_tpu_torch.core.output import finalize as finalize_t
from dada2_tpu_torch.ops import store_screen as ss
from dada2_tpu_torch.trace import COUNTERS as COUNTERS_T

SPEC = ("spec_hits", "spec_misses", "spec_wasted")


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


def test_log_f32_matches_xla():
    """log_f32 gives XLA's f32 log bit for bit: every integer to 2^20 (a
    center's reads), random magnitudes, bit patterns and the special
    values. The correctly rounded log differs on some integers (7 among
    them), so torch.log would not do."""
    rng = np.random.default_rng(5)
    x = np.concatenate([
        np.arange(0, 1 << 20, dtype=np.float32),
        rng.uniform(1e-30, 1e30, 1 << 18).astype(np.float32),
        rng.integers(0, 2 ** 31 - 1, 1 << 18).astype(np.uint32).view(
            np.float32),
        np.array([-0.0, 9e-41, -1.0, np.inf, -np.inf, np.nan,
                  np.finfo(np.float32).tiny, 3.4e38], np.float32)])
    want = np.asarray(jax.jit(jnp.log)(x))
    got = ss.log_f32(torch.from_numpy(x)).numpy()
    same = (_bits(want) == _bits(got)) | (np.isnan(want) & np.isnan(got))
    assert same.all(), x[~same][:10]
    seven = torch.tensor([7.0])
    assert _bits(ss.log_f32(seven)) != _bits(torch.log(seven))


def _proj_inputs(seed, n=140, L=120):
    """A small13 pack with shrouded rows, -inf, subnormal (read as 0) and
    NaN-free loglams, locks (pad rows locked), reads, a center whose
    log(reads) the correctly rounded log gets wrong, and a chained seed
    (finite on some rows, -inf on others)."""
    rng = np.random.default_rng(seed)
    nd = ss.pad_rows(n)
    small = rng.integers(-128, 128, (n, 13)).astype(np.int8)
    ll = -rng.exponential(20.0, n).astype(np.float32)
    ab = (-ll * rng.uniform(1.0, 1.3, n)).astype(np.float32)
    ll[rng.random(n) < 0.06] = -np.inf
    ll[rng.random(n) < 0.06] = np.float32(1e-40)
    ab[rng.random(n) < 0.06] = np.float32(3e-39)
    small[:, 4:8] = ll.view(np.int8).reshape(n, 4)
    small[:, 8:12] = ab.view(np.int8).reshape(n, 4)
    small[:, 12] = (rng.random(n) < 0.15) * 4 + 1
    reads = rng.integers(1, 5000, n).astype(np.int32)
    center = 11
    reads[center] = 7
    lock = rng.random(nd) < 0.3
    lock[n:] = True
    eth = np.zeros(2 * nd + nd // 8, np.uint8)
    eth[2 * nd:] = np.packbits(lock, bitorder="little")
    logtotal = np.float32(math.log(int(reads.sum())))
    seed_p = np.where(rng.random(nd) < 0.5, -np.inf,
                      -rng.exponential(30.0, nd)).astype(np.float32)
    return nd, L, small, reads, center, eth, logtotal, seed_p


@pytest.mark.parametrize("greedy", [False, True], ids=["plain", "greedy"])
@pytest.mark.parametrize("chained", [False, True], ids=["neginf", "chained"])
def test_proj_update_equal(greedy, chained):
    """proj_update_ref == _proj_update bit for bit (its nd rows padded
    with row 0 as the JAX package's arrays are); pad rows, skipped and
    shrouded rows and non-finite loglams contribute -inf."""
    nd, L, small, reads, center, eth, logtotal, seed_p = _proj_inputs(
        3 + 2 * greedy + chained)
    n = small.shape[0]
    proj = seed_p if chained else np.full(nd, -np.inf, np.float32)

    def padj(x):
        return np.concatenate([x, np.repeat(x[:1], nd - n, axis=0)])

    want = np.asarray(btj._proj_update(
        jnp.asarray(proj), jnp.asarray(padj(small)), jnp.asarray(padj(reads)),
        jnp.int32(center), jnp.asarray(logtotal),
        jnp.asarray(eth.view(np.int8)), L=L, greedy=greedy))
    got = ss.proj_update_ref(
        torch.from_numpy(proj) if chained else None, torch.from_numpy(small),
        torch.from_numpy(reads), center, float(logtotal),
        torch.from_numpy(eth), nd=nd, L=L, greedy=greedy).numpy()
    np.testing.assert_array_equal(_bits(want), _bits(got))
    term = got if not chained else ss.proj_update_ref(
        None, torch.from_numpy(small), torch.from_numpy(reads), center,
        float(logtotal), torch.from_numpy(eth), nd=nd, L=L,
        greedy=greedy).numpy()
    assert np.isneginf(term[n:]).all()                      # pad rows
    assert np.isfinite(term).any()
    assert np.isneginf(term[:n][(small[:, 12] & 4) != 0]).all()


PROJ_CASES = {   # (greedy, kind, K, cache_on, proj)
    "tiles16_mixed": (False, "tiles", 16, False, "mixed"),
    "tiles48_greedy_neginf": (True, "tiles", 48, False, "neginf"),
    "bits8_cache_mixed": (False, "bits", 8, True, "mixed"),
    "bits128_greedy_cache_fold": (True, "bits", 128, True, "fold"),
}


@pytest.mark.parametrize("case", sorted(PROJ_CASES))
def test_budded_pack_proj_equal(case):
    """budded_pack_ref(..., proj=) == _budded_fused(..., proj) byte for
    byte (buffer, order, order_u), with the fold of this compare into
    proj_out == _proj_update. proj: all -inf, a mixed one (finite on the
    center's row too, which the screen exempts), or the fold of another
    center's compare, as a chained segment sees it."""
    greedy, kind, K, cache_on, pk = PROJ_CASES[case]
    nd, L, jx, pt, e = _plain_inputs(21 + len(case), qlo=-1.0)
    n = pt["seqs"].shape[0]
    center = 3
    d = {k: jnp.asarray(v) for k, v in jx.items()}
    lt = np.float32(math.log(int(jx["reads"][:n].sum())))
    if pk == "neginf":
        proj = np.full(nd, -np.inf, np.float32)
    elif pk == "fold":
        proj = np.asarray(btj._proj_update(
            jnp.full(nd, -np.inf, jnp.float32), d["small"], d["reads"],
            jnp.int32(7), jnp.asarray(lt), d["eth2"], L=L, greedy=greedy))
    else:
        loglam = jx["small"][:, 4:8].copy().view(np.float32)[:, 0]
        rng = np.random.default_rng(len(case))
        proj = np.where(rng.random(nd) < 0.5, -np.inf,
                        loglam + rng.normal(0.0, 0.5, nd)).astype(np.float32)
        proj[center] = 0.0
    M0, M0U = 32, (16 if cache_on else None)
    buf_j, ord_j, oru_j, small_j = btj._budded_fused(
        d["tvec"], d["small5"], d["seqs"], d["lens"], d["reads"],
        jnp.int32(center), d["qlerr"], d["eth2"], jnp.asarray(proj),
        d["cbits"], L=L, M0=M0, K=K, greedy=greedy, kind=kind, M0U=M0U,
        cache_on=cache_on)
    fold_j = np.asarray(btj._proj_update(
        jnp.asarray(proj), small_j, d["reads"], jnp.int32(center),
        jnp.asarray(lt), d["eth2"], L=L, greedy=greedy))
    proj_out = torch.empty(nd, dtype=torch.float32)
    out = torch.zeros(ss.budbuf_layout(nd, pt["seqs"].shape[1], M0, K, kind,
                                       M0U)[3], dtype=torch.uint8)
    args = (pt["small13"], pt["tvec"], pt["seqs"], pt["lens"], pt["reads"],
            center, pt["eth2"], pt["cbits"])
    kw = dict(nd=nd, L=L, M0=M0, K=K, greedy=greedy, kind=kind, M0U=M0U,
              cache_on=cache_on)
    buf_t, ord_t, oru_t, _ = ss.budded_pack(
        *args, **kw, proj=torch.from_numpy(proj.copy()), proj_out=proj_out,
        logtotal=float(lt), out=out)
    assert buf_t is out
    np.testing.assert_array_equal(np.asarray(buf_j).view(np.uint8),
                                  buf_t.numpy())
    np.testing.assert_array_equal(np.asarray(ord_j), ord_t.numpy())
    np.testing.assert_array_equal(np.asarray(oru_j), oru_t.numpy())
    np.testing.assert_array_equal(_bits(fold_j), _bits(proj_out.numpy()))
    if pk == "mixed":   # the projection tightened the screen
        plain = ss.budded_pack_ref(*args, **kw)[0]
        m = int(buf_t[:4].view(torch.int32)[0])
        assert m < int(plain[:4].view(torch.int32)[0])


def test_wrapper_takes_the_plain_version_on_cpu():
    """On CPU tensors budded_pack with a projection, a fold and a shared
    buffer is budded_pack_ref (no launch counted) and refuses operands of
    the wrong shape or a fold without logtotal."""
    nd, L, jx, pt, e = _plain_inputs(40, qlo=-1.0)
    args = (pt["small13"], pt["tvec"], pt["seqs"], pt["lens"], pt["reads"],
            3, pt["eth2"])
    kw = dict(nd=nd, L=L, M0=32, K=16, greedy=True)
    proj = torch.full((nd,), -5.0)
    po = [torch.empty(nd), torch.empty(nd)]
    before, with0 = dict(ss.launches), dict(ss.launches_with)
    got = ss.budded_pack(*args, **kw, proj=proj, proj_out=po[0],
                         logtotal=9.5)
    want = ss.budded_pack_ref(*args, **kw, proj=proj, proj_out=po[1],
                              logtotal=9.5)
    for g, w in zip(list(got) + [po[0]], list(want) + [po[1]]):
        assert torch.equal(g, w)
    assert ss.launches == before and ss.launches_with == with0
    with pytest.raises(ValueError, match="proj must be"):
        ss.budded_pack(*args, **kw, proj=proj[:-1])
    with pytest.raises(ValueError, match="needs proj_out and logtotal"):
        ss.budded_pack(*args, **kw, proj_out=po[0])
    with pytest.raises(ValueError, match="out must be"):
        ss.budded_pack(*args, **kw, out=torch.empty(3, dtype=torch.uint8))


def _run_t(rs_t, opts_t, err, be=None, **attrs):
    be = be or CudaBackend(rs_t, device="cpu")
    for k, v in attrs.items():
        setattr(be, k, v)
    eng = EngineT(rs_t, err, opts_t, be, use_quals=True)
    eng.run(max_clust=opts_t.MAX_CLUST)
    return be, eng, finalize_t(eng, opts_t, err.shape[1], opts_t.OMEGA_C)


def test_speculation_same_results(sample):
    """The port at SPEC_K = 8 == SPEC_K = 0 (results, nalign, nshroud)
    with hits; SHORTLIST_M0 = 16 with two-entry tiles sends consumed
    segments through the follow-up and the dense re-fetch; a second run
    on the same backend rolls the bud sequence over and still hits."""
    _, (rs_t, opts_t) = _states(*sample)
    err = tperr1()
    _, eng0, res0 = _run_t(rs_t, opts_t, err, SPEC_K=0)
    h0, c0 = COUNTERS_T.spec_hits, COUNTERS_T.device_fetches
    be8, eng8, res8 = _run_t(rs_t, opts_t, err)
    assert be8.SPEC_K == 8                       # the default
    assert COUNTERS_T.spec_hits > h0, "speculation never hit"
    assert (eng0.nalign, eng0.nshroud) == (eng8.nalign, eng8.nshroud)
    np.testing.assert_array_equal(eng0.cluster_of, eng8.cluster_of)
    np.testing.assert_array_equal(eng0.comp_lam, eng8.comp_lam)
    _assert_same(res0, res8)
    f0, h1 = COUNTERS_T.followup_fetches, COUNTERS_T.spec_hits
    d0 = COUNTERS_T.dense_refetches
    _, _, resf = _run_t(rs_t, opts_t, err, SHORTLIST_M0=16,
                        SHORTLIST_FORCE=("tiles", 2))
    assert COUNTERS_T.spec_hits > h1
    assert COUNTERS_T.followup_fetches > f0
    assert COUNTERS_T.dense_refetches > d0
    _assert_same(res0, resf)
    assert be8._centers_cur
    h2 = COUNTERS_T.spec_hits
    _, engb, resb = _run_t(rs_t, opts_t, err, be=be8)
    assert be8._centers_prev                   # rolled over at the init
    assert COUNTERS_T.spec_hits > h2
    _assert_same(res0, resb)
    assert c0 > 0


def _record(be, pos, log):
    """Record every buffer _finish_budded gets (argument pos) and every
    dispatch's candidate list."""
    fin, cands = be._finish_budded, be._spec_candidates

    def finish(*a, **kw):
        log["bufs"].append(np.asarray(a[pos]).view(np.uint8).copy())
        return fin(*a, **kw)

    def candidates(center):
        out = cands(center)
        log["cands"].append(list(out))
        return out
    be._finish_budded, be._spec_candidates = finish, candidates


def _bud_log(Eng, log):
    """An Engine class that records bud_candidates after every bud."""
    class Rec(Eng):
        def bud(self):
            out = super().bud()
            log["buds"].append(self.bud_candidates.tolist())
            return out
    return Rec


def test_speculation_matches_dada2_tpu(sample, monkeypatch):
    """Both packages at SPEC_K = 8 over three engine runs on one backend
    (selfConsist's shape, a second error matrix in between), the port
    sharing dada2_tpu's small pack: the same buffer in every
    _finish_budded call (main compares and consumed segments), the same
    candidates per dispatch, the same spec counters, bud candidates and
    results; the chained projection and the roll-over both ran."""
    (rs, opts), (rs_t, opts_t) = _states(*sample)
    monkeypatch.setenv("DADA2_TPU_PALLAS", "1")
    be_j = TpuBackend(rs, use_quals=True)
    assert be_j.use_pallas and be_j.SPEC_K == 8
    be_t = CudaBackend(rs_t, device="cpu")
    _share_small(be_j, be_t, opts)
    lj, lt = ({k: [] for k in ("bufs", "cands", "buds")} for _ in range(2))
    _record(be_j, 4, lj)
    _record(be_t, 3, lt)
    cj0 = [getattr(COUNTERS_J, k) for k in SPEC]
    ct0 = [getattr(COUNTERS_T, k) for k in SPEC]
    res_j, _ = _rounds(be_j, rs, opts, _bud_log(EngineJ, lj), finalize_j,
                       COUNTERS_J)
    res_t, _ = _rounds(be_t, rs_t, opts_t, _bud_log(EngineT, lt), finalize_t,
                       COUNTERS_T)
    for a, b in zip(res_j, res_t):
        _assert_same(a, b)
    assert lj["buds"] == lt["buds"] and any(lt["buds"])
    assert lj["cands"] == lt["cands"]
    assert any(fp for cs in lt["cands"] for _, fp in cs)   # chained
    be_j.bufs, be_t.bufs = lj["bufs"], lt["bufs"]
    _same_buffers(be_j, be_t)
    dj = [getattr(COUNTERS_J, k) - v for k, v in zip(SPEC, cj0)]
    dt_ = [getattr(COUNTERS_T, k) - v for k, v in zip(SPEC, ct0)]
    assert dj == dt_ and dt_[0] > 0
