"""Parity: the port's batch aligner (dada2_tpu_torch.ops.nw_batch, kernel
B4's plain PyTorch version on the CPU) against dada2_tpu.ops.nw_batch on
tests/test_nw_batch.py's mixes: all six outputs (kinds, p0, p1, ham, tvec,
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
    aligner, banded and unbanded, with the pointer slab in shared memory
    and (long unbanded pairs) in device memory, chunked and not."""
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
        for budget in (tnb.MAX_BYTES, 1):
            monkeypatch.setattr(tnb, "MAX_BYTES", budget)
            got = tnb.nw_batch(*args, match=5, mismatch=-4, gap_p=-8,
                               **kw)
            for g, w in zip(got, want):
                assert torch.equal(g, w), kw
        monkeypatch.undo()
    long = rng.integers(0, 4, (4, 1500)).astype(np.uint8)
    args = [torch.from_numpy(a).cuda() for a in
            (long, np.full(4, 1500), long[::-1].copy(), np.full(4, 1500))]
    nd, W = tnb.batch_geometry(np.full(4, 1500), np.full(4, 1500), -1)
    assert tnb.slab_route(1500, 1500, nd, W, False) == 2
    got = tnb.nw_batch(*args, match=1, mismatch=-64, gap_p=-64,
                       mode="scalar")
    want = tnb.nw_batch_ref(*args, match=1, mismatch=-64, gap_p=-64,
                            mode="scalar")
    for g, w in zip(got, want):
        assert torch.equal(g, w)
