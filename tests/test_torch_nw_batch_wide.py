"""Kernel B4's wide body (windows of 257 to 2,048 rows: ceil(W / 256) warps
per pair) against its plain version on the card, bitwise: all six outputs
(kinds, p0, p1, ham, tvec, ok). Tolerance: exact (integer outputs). The
plain version itself is held against the JAX aligner on the CPU by
tests/test_torch_nw_batch.py, at these geometries cut down. Imports no jax,
so `python -m pytest --noconftest -m gpu tests/test_torch_nw_batch_wide.py`
runs it where jax is absent; without a card every test skips."""
import numpy as np
import pytest
import torch

from dada2_tpu_torch.ops import nw_batch as tnb

OUTS = ("kinds", "p0", "p1", "ham", "tvec", "ok")
SC5 = dict(match=5, mismatch=-4, gap_p=-8)
MERGE_KW = dict(match=1, mismatch=-64, gap_p=-64, band=-1, mode="scalar")
CONFIGS = {
    "merge scoring": MERGE_KW,
    "scalar shift scoring": dict(SC5, band=-1, mode="scalar"),
    "vec ends-free": dict(SC5, band=-1),
    "vec end gaps -8": dict(SC5, band=-1, end_gap_p=-8),
    "scalar homopolymer -1": dict(SC5, band=-1, mode="scalar",
                                  homo_gap_p=-1),
}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run through chip_smoke.py)")


def _edit(rng, a, nops):
    b = a.tolist()
    for _ in range(nops):
        p = int(rng.integers(0, len(b)))
        op = rng.random()
        if op < 0.5:
            b[p] = int(rng.integers(0, 4))
        elif op < 0.75 and len(b) > 1:
            del b[p]
        else:
            b.insert(p, int(rng.integers(0, 4)))
    return np.array(b, np.uint8)


def _window(rng, W, n=6):
    """Unbanded pairs whose batch window is exactly W rows (two of length
    W - 1), edited copies of mixed lengths beside them and pairs of length
    0 and 1."""
    L = W - 1
    out = [(rng.integers(0, 4, L).astype(np.uint8),
            rng.integers(0, 4, L).astype(np.uint8))]
    a = rng.integers(0, 4, L).astype(np.uint8)
    b = a.copy()
    b[rng.integers(0, L, 6)] = rng.integers(0, 4, 6)
    out.append((a, b))
    for _ in range(n):
        x = rng.integers(0, 4, int(rng.integers(L // 2, L))).astype(np.uint8)
        out.append((x, _edit(rng, x, 12)))
    e, c = np.zeros(0, np.uint8), np.array([2], np.uint8)
    return out + [(e, e), (c, e), (e, c), (c, c)]


def _tensors(pairs):
    n = len(pairs)
    L1 = max(len(a) for a, _ in pairs)
    L2 = max(len(b) for _, b in pairs)
    s1 = np.full((n, L1), 255, np.uint8)
    s2 = np.full((n, L2), 255, np.uint8)
    for k, (a, b) in enumerate(pairs):
        s1[k, : len(a)] = a
        s2[k, : len(b)] = b
    lens = [np.array([len(p[i]) for p in pairs], np.int64) for i in (0, 1)]
    return [torch.from_numpy(x).cuda() for x in (s1, lens[0], s2, lens[1])]


def _check(args, kw, body="wide", launches=1):
    """nw_batch on the card == nw_batch_ref on the card, through `body`
    in `launches` launches."""
    want = tnb.nw_batch_ref(*args, **kw)
    before = dict(tnb.nw_batch.launches_by_body)
    got = tnb.nw_batch(*args, **kw)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in tnb.nw_batch.launches_by_body.items()
           if v != before[k]}
    assert ran == {body: launches}, ran
    for name, g, w in zip(OUTS, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), (name, kw)
    return got


def _route(args, kw):
    nd, W = tnb.batch_geometry(args[1].cpu().numpy(), args[3].cpu().numpy(),
                               kw["band"])
    homo = kw.get("homo_gap_p") is not None
    return tnb.route(args[0].shape[1], args[2].shape[1], nd, W, homo), W


@pytest.mark.gpu
@pytest.mark.parametrize("W", [257, 288, 512, 513, 1451])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_wide_body_matches_plain(W, config):
    """Windows of 257 (one row past the register body), 288, 512 and 513
    (two and three warps) and 1,451 (samPB's, six warps, the pointers in
    device memory) rows, in every aligner."""
    _card()
    kw = CONFIGS[config]
    args = _tensors(_window(np.random.default_rng(W), W,
                            n=2 if W > 1000 else 6))
    r, Wb = _route(args, kw)
    assert Wb == W and r == 4, (W, r)
    assert tnb.warps_per_pair(W) == (W + 255) // 256
    _check(args, kw)


@pytest.mark.gpu
def test_wide_body_mixed_windows_and_banded():
    """One batch whose pairs' windows differ (two over 256 rows, narrow
    ones, lengths 0 and 1), one sequence much longer than the other, and a
    banded window over 256 rows (band 140, lengths 300 apart)."""
    _card()
    rng = np.random.default_rng(5)
    mixed = (_window(rng, 400, n=1) + _window(rng, 40, n=2))
    for kw in CONFIGS.values():
        _check(_tensors(mixed), kw)
    a = rng.integers(0, 4, 700).astype(np.uint8)
    long_short = [(a, a[200:490].copy()), (a[300:600].copy(), a),
                  (rng.integers(0, 4, 650).astype(np.uint8),
                   rng.integers(0, 4, 280).astype(np.uint8))]
    _check(_tensors(long_short), CONFIGS["scalar shift scoring"])
    banded = [(rng.integers(0, 4, 600).astype(np.uint8),
               rng.integers(0, 4, 300).astype(np.uint8)),
              (a[:620], a[150:450].copy()), (a[100:400].copy(), a[:620])]
    for kw in (dict(SC5, band=140), dict(SC5, band=140, end_gap_p=-8),
               dict(SC5, band=140, mode="scalar", homo_gap_p=-1)):
        args = _tensors(banded)
        r, W = _route(args, kw)
        assert W > 256 and r == 4, (W, r)
        _check(args, kw)


@pytest.mark.gpu
def test_wide_body_device_slab_one_pair_a_launch(monkeypatch):
    """The device-memory slab chunked down to one pair a launch gives the
    same outputs as one launch."""
    _card()
    rng = np.random.default_rng(11)
    pairs = [(x, _edit(rng, x, 20)) for x in
             (rng.integers(0, 4, 1450).astype(np.uint8) for _ in range(3))]
    args = _tensors(pairs)
    kw = CONFIGS["scalar homopolymer -1"]
    assert _route(args, kw)[0] == 4
    whole = _check(args, kw)
    monkeypatch.setattr(tnb, "MAX_BYTES", 1)
    chunked = _check(args, kw, launches=len(pairs))
    for g, w in zip(chunked, whole):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_route_at_256_and_257():
    """256 rows are the register body's last window, 257 the wide body's
    first; the one-block-per-pair body takes windows over 2,048 rows."""
    _card()
    rng = np.random.default_rng(2)
    for W, route, body in ((256, 3, "register"), (257, 4, "wide")):
        args = _tensors(_window(rng, W))
        assert _route(args, MERGE_KW) == (route, W)
        assert tnb.body(route) == body
        assert tnb.register_fit(args[0].shape[1], args[2].shape[1],
                                2 * W - 1, W, True, False,
                                args[0].shape[0])[0] == 8
        _check(args, MERGE_KW, body=body)
    nd, W = 2 * 2100 + 1, 2101
    assert tnb.route(2100, 2100, nd, W, False) in (1, 2)
    assert tnb.body(tnb.route(2100, 2100, nd, W, False)) == "block"
