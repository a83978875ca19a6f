"""Parity: the port's batch aligner (dada2_tpu_torch.ops.nw_batch, kernel
B4's plain PyTorch version on the CPU) against dada2_tpu.ops.nw_batch on
tests/test_nw_batch.py's mixes, and on the window widths where the
kernel changes body or register tier, pairs of length 0 and 1, and small
merge- and shift-like batches: all six outputs (kinds, p0, p1, ham, tvec,
ok), their dtypes and shapes. Tolerance: exact (integer outputs). The
CUDA kernel itself is held against nw_batch_ref on the card by
chip_smoke.py and by the gpu-marked test below."""
import numpy as np
import pytest
import torch

from dada2_tpu.ops import nw_batch as jnb
from dada2_tpu.ops import nw_ref as jref
from dada2_tpu_torch.ops import nw_batch as tnb

OUTS = ("kinds", "p0", "p1", "ham", "tvec", "ok")


def _random_pair(rng, lmin=8, lmax=60, mutate=True):
    """tests/test_nw_batch.py's generator."""
    l1 = int(rng.integers(lmin, lmax))
    s1 = rng.integers(0, 4, l1).astype(np.uint8)
    if mutate:
        s2 = list(s1)
        for _ in range(int(rng.integers(0, 8))):
            op = rng.integers(0, 3)
            p = int(rng.integers(0, len(s2))) if s2 else 0
            if op == 0 and s2:
                s2[p] = int(rng.integers(0, 4))
            elif op == 1 and len(s2) > lmin:
                del s2[p]
            else:
                s2.insert(p, int(rng.integers(0, 4)))
        s2 = np.array(s2, dtype=np.uint8)
    else:
        s2 = rng.integers(0, 4, int(rng.integers(lmin, lmax))).astype(
            np.uint8)
    return s1, s2


def _homo_pair(rng):
    """tests/test_nw_batch.py::test_scalar_banded_homo_parity's pairs:
    homopolymer runs, then substitutions and indels."""
    l1 = int(rng.integers(40, 120))
    s1 = rng.integers(0, 4, l1).astype(np.uint8)
    for _ in range(3):
        p = int(rng.integers(0, l1 - 8))
        s1[p: p + int(rng.integers(3, 7))] = int(rng.integers(0, 4))
    s2 = s1.copy().tolist()
    for _ in range(int(rng.integers(0, 6))):
        p = int(rng.integers(0, len(s2)))
        op = rng.random()
        if op < 0.4:
            s2[p] = int(rng.integers(0, 4))
        elif op < 0.7 and len(s2) > 30:
            del s2[p]
        else:
            s2.insert(p, int(rng.integers(0, 4)))
    return s1, np.array(s2, np.uint8)


def _pack(pairs):
    n = len(pairs)
    L1 = max(len(a) for a, _ in pairs)
    L2 = max(len(b) for _, b in pairs)
    s1b = np.full((n, L1), 255, np.uint8)
    s2b = np.full((n, L2), 255, np.uint8)
    for k, (a, b) in enumerate(pairs):
        s1b[k, : len(a)] = a
        s2b[k, : len(b)] = b
    l1 = np.array([len(a) for a, _ in pairs], np.int64)
    l2 = np.array([len(b) for _, b in pairs], np.int64)
    return s1b, l1, s2b, l2


def _assert_equal_to_jax(pairs, **kw):
    args = _pack(pairs)
    want = [np.asarray(x) for x in jnb.nw_batch(*args, **kw)]
    got = [x.numpy() for x in tnb.nw_batch(*args, device="cpu", **kw)]
    for w, g, name in zip(want, got, OUTS):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=f"{name} {kw}")
    assert got[5].all()
    return got


@pytest.mark.parametrize("band,egp", [(-1, 0), (16, 0), (4, 0), (16, -8),
                                      (2, 0), (999, 0)])
def test_vec_parity_random(band, egp):
    rng = np.random.default_rng(100 + band + egp)
    pairs = [_random_pair(rng) for _ in range(40)]
    pairs += [_random_pair(rng, mutate=False) for _ in range(10)]
    _assert_equal_to_jax(pairs, match=5, mismatch=-4, gap_p=-8,
                         end_gap_p=egp, band=band)


@pytest.mark.parametrize("egp,params", [(0, (1, -64, -64)),
                                        (0, (1, -8, -8)),
                                        (-8, (5, -4, -8))])
def test_scalar_mode_parity(egp, params):
    """The mergePairs configuration (unbanded, ends-free, merge scoring)
    and a global one."""
    match, mismatch, gap = params
    rng = np.random.default_rng(200 + egp + match)
    pairs = [_random_pair(rng, lmin=10, lmax=50) for _ in range(30)]
    _assert_equal_to_jax(pairs, match=match, mismatch=mismatch, gap_p=gap,
                         end_gap_p=egp, band=-1, mode="scalar")


@pytest.mark.parametrize("hgp", [None, -1, -3])
def test_scalar_banded_homo_parity(hgp):
    """Scalar mode, banded (the -9999 boundary) and not, with and without
    homopolymer gaps, ends-free and global; each (band, end gap) a batch."""
    rng = np.random.default_rng(31 + (hgp or 0))
    for band in (-1, 8, 16, 32):
        for egp in (0, -8):
            pairs = [_homo_pair(rng) for _ in range(8)]
            _assert_equal_to_jax(pairs, match=5, mismatch=-4, gap_p=-8,
                                 end_gap_p=egp, band=band, mode="scalar",
                                 homo_gap_p=hgp)


def test_mixed_length_and_identical():
    """Pure shifts of one sequence in both orders (per-pair band geometry
    and window padding in one batch) and an identical pair."""
    rng = np.random.default_rng(11)
    base = rng.integers(0, 4, 80).astype(np.uint8)
    pairs = [(base, base)]
    for off in (0, 3, 10, 25):
        pairs += [(base, base[off:]), (base[off:], base)]
    got = _assert_equal_to_jax(pairs, match=5, mismatch=-4, gap_p=-8,
                               end_gap_p=0, band=16)
    assert (got[3] == 0).all()


def _short_pairs():
    """Pairs of length 0 and 1 against each other."""
    e, a, c = (np.zeros(0, np.uint8), np.array([1], np.uint8),
               np.array([2], np.uint8))
    return [(e, e), (a, e), (e, c), (a, a), (a, c), (np.array([0, 1, 2],
                                                             np.uint8), c)]


def _window_pairs(rng, W):
    """Unbanded pairs whose window is exactly W rows (two of length W - 1)
    beside narrower ones, as one batch."""
    L = W - 1
    pairs = [(rng.integers(0, 4, L).astype(np.uint8),
              rng.integers(0, 4, L).astype(np.uint8))]
    a = rng.integers(0, 4, L).astype(np.uint8)
    b = a.copy()
    b[rng.integers(0, L, 4)] = rng.integers(0, 4, 4)
    return pairs + [(a, b), (a[: L // 2], b[5:])] + _short_pairs()


def _merge_like(rng, n=12):
    """merge_pairs' shape, cut down: a forward read against the reverse
    read's complement, overlapping by 40 to 60 positions."""
    out = []
    for _ in range(n):
        s = rng.integers(0, 4, 120).astype(np.uint8)
        f, r = s[:80].copy(), s[int(rng.integers(20, 40)):].copy()
        f[rng.integers(0, 80, 2)] = rng.integers(0, 4, 2)
        out.append((f, r))
    return out


def _shift_like(rng, n=6):
    """is_shift_denovo's shape, cut down: all pairs of a few sequences of
    equal length, some of them shifts of one another."""
    base = rng.integers(0, 4, 70).astype(np.uint8)
    seqs = [base[:60], base[3:63], base[10:]]
    seqs += [rng.integers(0, 4, 60).astype(np.uint8) for _ in range(n - 3)]
    return [(seqs[i], seqs[j]) for i in range(n) for j in range(i + 1, n)]


def _wide_pairs(rng, L, n=3, nops=12, homo=False):
    """n pairs of length L against an edited copy (indels and
    substitutions; homopolymer runs planted if homo): windows of about
    L + 1 rows, the wide body's above 256."""
    out = []
    for _ in range(n):
        a = rng.integers(0, 4, L).astype(np.uint8)
        if homo:
            for _ in range(L // 40):
                p = int(rng.integers(0, L - 8))
                a[p: p + int(rng.integers(3, 8))] = int(rng.integers(0, 4))
        b = a.tolist()
        for _ in range(nops):
            p = int(rng.integers(0, len(b)))
            op = rng.random()
            if op < 0.5:
                b[p] = int(rng.integers(0, 4))
            elif op < 0.75:
                del b[p]
            else:
                b.insert(p, int(rng.integers(0, 4)))
        out.append((a, np.array(b, np.uint8)))
    return out


def _banded_wide(rng):
    """Pairs whose lengths differ by 300 or more: at band 140 the window
    (lband + rband) / 2 + 2 reaches 301 rows, where lo(d) takes the
    ceiling of (d - rband) / 2 on the wide body's rows."""
    a = rng.integers(0, 4, 620).astype(np.uint8)
    return [(rng.integers(0, 4, 600).astype(np.uint8),
             rng.integers(0, 4, 300).astype(np.uint8)),
            (a, a[150:450].copy()), (a[100:400].copy(), a)]


def _mixed_windows(rng):
    """One batch whose pairs' windows differ: two over 256 rows (the
    batch's window), narrow ones and pairs of length 0 and 1."""
    return (_wide_pairs(rng, 380, n=2) + _wide_pairs(rng, 40, n=2)
            + _short_pairs())


def _long_short(rng):
    """len1 much longer than len2 (and the reverse): the window is
    min + 1 rows, while i spans len1 + 1."""
    a = rng.integers(0, 4, 700).astype(np.uint8)
    return [(a, a[200:490].copy()), (a[300:600].copy(), a),
            (rng.integers(0, 4, 650).astype(np.uint8),
             rng.integers(0, 4, 280).astype(np.uint8))]


MERGE_KW = dict(match=1, mismatch=-64, gap_p=-64, band=-1, mode="scalar")
SHIFT_KW = dict(match=5, mismatch=-4, gap_p=-8, band=-1, mode="scalar")
SC5 = dict(match=5, mismatch=-4, gap_p=-8)
BODY_CASES = {
    # windows on both sides of the register body's tiers and of its
    # 256-row limit (the kernel's route changes there; the plain version
    # and the JAX aligner must agree on every side)
    "W32": (lambda rng: _window_pairs(rng, 32), MERGE_KW),
    "W33": (lambda rng: _window_pairs(rng, 33), MERGE_KW),
    "W256": (lambda rng: _window_pairs(rng, 256), MERGE_KW),
    "W257": (lambda rng: _window_pairs(rng, 257), MERGE_KW),
    "W33 homopolymer": (lambda rng: _window_pairs(rng, 33),
                        dict(SC5, band=-1, mode="scalar", homo_gap_p=-1)),
    "short vec unbanded": (lambda rng: _short_pairs(),
                           dict(SC5, band=-1)),
    "short vec band 4 end gaps -8": (lambda rng: _short_pairs(),
                                     dict(SC5, band=4, end_gap_p=-8)),
    "short scalar band 4 homopolymer": (
        lambda rng: _short_pairs(),
        dict(SC5, band=4, mode="scalar", homo_gap_p=-1)),
    "merge-like": (_merge_like, MERGE_KW),
    "shift-like": (_shift_like, SHIFT_KW),
    # the wide body's geometries (windows of 257 to 2,048 rows)
    "W300": (lambda rng: _window_pairs(rng, 300), MERGE_KW),
    "W513": (lambda rng: _window_pairs(rng, 513), SHIFT_KW),
    "wide band 140": (_banded_wide, dict(SC5, band=140)),
    "wide band 140 scalar": (_banded_wide, dict(SC5, band=140,
                                                mode="scalar")),
    "wide vec ends-free": (lambda rng: _wide_pairs(rng, 300),
                           dict(SC5, band=-1)),
    "wide vec end gaps -8": (lambda rng: _wide_pairs(rng, 300),
                             dict(SC5, band=-1, end_gap_p=-8)),
    "wide scalar homopolymer -1": (
        lambda rng: _wide_pairs(rng, 300, homo=True),
        dict(SC5, band=-1, mode="scalar", homo_gap_p=-1)),
    "wide mixed windows": (_mixed_windows, MERGE_KW),
    "wide len1 >> len2": (_long_short, SHIFT_KW),
}


@pytest.mark.parametrize("case", sorted(BODY_CASES))
def test_window_tiers_short_pairs_and_slice_shapes(case):
    """The geometries that choose kernel B4's body and its register tier,
    pairs of length 0 and 1, small merge- and shift-like unbanded scalar
    batches, and the wide body's windows (over 256 rows in every aligner,
    banded, mixed, one sequence much longer): the plain version against
    the JAX aligner, exact."""
    gen, kw = BODY_CASES[case]
    _assert_equal_to_jax(gen(np.random.default_rng(len(case))), **kw)


def test_homo_mask_and_alignment_helpers():
    rng = np.random.default_rng(5)
    for _ in range(50):
        L = int(rng.integers(3, 80))
        s = rng.integers(0, 3, (2, L)).astype(np.uint8)
        lens = np.array([L, max(1, L - 3)])
        np.testing.assert_array_equal(tnb.homo_mask_batch(s, lens),
                                      jnb.homo_mask_batch(s, lens))
    assert tnb.batch_geometry([30, 41], [35, 20], 16) == \
        jnb.batch_geometry([30, 41], [35, 20], 16)
    pairs = [_random_pair(rng) for _ in range(6)]
    kinds, p0, p1, *_ = (x.numpy() for x in tnb.nw_batch(
        *_pack(pairs), match=5, mismatch=-4, gap_p=-8, band=16,
        device="cpu"))
    for k, (a, b) in enumerate(pairs):
        got = tnb.steps_to_alignment(kinds[k], p0[k], p1[k], a, b)
        want = jref.nw_align_ref(a, b, 5, -4, -8, 0, 16, mode="vec")
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_chunks_and_tensor_inputs(monkeypatch):
    """A byte budget that forces one pair per chunk, and tensor inputs,
    give the same outputs as one call on numpy arrays."""
    rng = np.random.default_rng(3)
    pairs = [_homo_pair(rng) for _ in range(7)]
    args = _pack(pairs)
    kw = dict(match=5, mismatch=-4, gap_p=-8, band=-1, mode="scalar",
              homo_gap_p=-1)
    whole = tnb.nw_batch(*args, device="cpu", **kw)
    tens = tnb.nw_batch(*(torch.from_numpy(a) for a in args), **kw)
    monkeypatch.setattr(tnb, "MAX_BYTES", 1)
    chunked = tnb.nw_batch(*args, device="cpu", **kw)
    for a, b, c in zip(whole, chunked, tens):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_wrapper_checks_and_no_launch_on_cpu():
    rng = np.random.default_rng(9)
    args = _pack([_random_pair(rng) for _ in range(3)])
    kw = dict(match=5, mismatch=-4, gap_p=-8, device="cpu")
    before = tnb.nw_batch.launches
    tnb.nw_batch(*args, **kw)
    assert tnb.nw_batch.launches == before
    with pytest.raises(ValueError):
        tnb.nw_batch(*args, mode="global", **kw)
    with pytest.raises(ValueError):
        tnb.nw_batch(args[0], args[1] + 100, args[2], args[3], **kw)
    with pytest.raises(ValueError):
        tnb.nw_batch(args[0], args[1][:2], args[2], args[3], **kw)
    empty = tnb.nw_batch(args[0][:0], args[1][:0], args[2][:0],
                         args[3][:0], **kw)
    assert [tuple(x.shape) for x in empty] == [
        (0, args[0].shape[1] + args[2].shape[1])] * 3 + [
        (0,), (0, args[2].shape[1]), (0,)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tnb.nw_batch(*args, match=5, mismatch=-4, gap_p=-8)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(monkeypatch):
    """Kernel B4 against its plain version on the card, bitwise, in every
    aligner, banded and unbanded, through the register body and, forced,
    the one-block-per-pair body (pointer slab in shared memory), chunked
    and not; windows of 256 and 257 rows take the register body and the
    wide body; long unbanded pairs take the wide body's device-memory
    slab. tests/test_torch_nw_batch_wide.py holds the wide body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run through chip_smoke.py)")
    rng = np.random.default_rng(17)
    cases = [(dict(mode="vec", band=16, end_gap_p=0), _random_pair),
             (dict(mode="vec", band=-1, end_gap_p=-8), _random_pair),
             (dict(mode="scalar", band=32, homo_gap_p=-1), _homo_pair),
             (dict(mode="scalar", band=-1, homo_gap_p=-3), _homo_pair)]
    for kw, gen in cases:
        args = [torch.from_numpy(a).cuda()
                for a in _pack([gen(rng) for _ in range(200)])]
        want = tnb.nw_batch_ref(*args, match=5, mismatch=-4, gap_p=-8,
                                **kw)
        for body, budget in ((None, tnb.MAX_BYTES), ("block", tnb.MAX_BYTES),
                             ("block", 1)):
            monkeypatch.setattr(tnb, "MAX_BYTES", budget)
            monkeypatch.setattr(tnb, "BODY", body)
            before = dict(tnb.nw_batch.launches_by_body)
            got = tnb.nw_batch(*args, match=5, mismatch=-4, gap_p=-8,
                               **kw)
            ran = [k for k, v in tnb.nw_batch.launches_by_body.items()
                   if v != before[k]]
            assert ran == [body or "register"], (kw, body, ran)
            for g, w in zip(got, want):
                assert torch.equal(g, w), (kw, body)
        monkeypatch.undo()
    for W, route in ((256, 3), (257, 4)):
        args = [torch.from_numpy(a).cuda()
                for a in _pack(_window_pairs(rng, W))]
        nd, Wb = tnb.batch_geometry(args[1].cpu().numpy(),
                                    args[3].cpu().numpy(), -1)
        assert Wb == W
        assert tnb.route(args[0].shape[1], args[2].shape[1], nd, W,
                         False) == route
        before = dict(tnb.nw_batch.launches_by_body)
        got = tnb.nw_batch(*args, **MERGE_KW)
        assert tnb.nw_batch.launches_by_body[tnb.body(route)] == \
            before[tnb.body(route)] + 1
        want = tnb.nw_batch_ref(*args, **MERGE_KW)
        for g, w in zip(got, want):
            assert torch.equal(g, w), W
    long = rng.integers(0, 4, (4, 1500)).astype(np.uint8)
    args = [torch.from_numpy(a).cuda() for a in
            (long, np.full(4, 1500), long[::-1].copy(), np.full(4, 1500))]
    nd, W = tnb.batch_geometry(np.full(4, 1500), np.full(4, 1500), -1)
    assert tnb.route(1500, 1500, nd, W, False) == 4
    got = tnb.nw_batch(*args, match=1, mismatch=-64, gap_p=-64,
                       mode="scalar")
    want = tnb.nw_batch_ref(*args, match=1, mismatch=-64, gap_p=-64,
                            mode="scalar")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
