"""Parity: the port's plain PyTorch version of kernel B1 (nw_wavefront_ref,
what nw_compare runs on CPU tensors) against the TPU Pallas kernel in
compare mode, run in interpret mode. Tolerance: exact (integer outputs).
The CUDA kernel itself is held against nw_wavefront_ref on the card by
chip_smoke.py and by the gpu-marked test below. The JAX package is
imported inside the tests that compare with it, so that the gpu test runs
where jax is not installed (`pytest --noconftest -m gpu`)."""
import numpy as np
import pytest
import torch

from dada2_tpu_torch.ops import nw_wavefront as nww

LANES = nww.LANES


def _mutate(rng, s, lmin=8, nops=6):
    s2 = list(s)
    for _ in range(int(rng.integers(0, nops))):
        op = rng.integers(0, 3)
        p = int(rng.integers(0, len(s2))) if s2 else 0
        if op == 0 and s2:
            s2[p] = int(rng.integers(0, 4))
        elif op == 1 and len(s2) > lmin:
            del s2[p]
        else:
            s2.insert(p, int(rng.integers(0, 4)))
    return np.array(s2, dtype=np.uint8)


def make_inputs(rng, s1, cands, band, wp=None, nblocks_min=1):
    """Compare-mode kernel inputs for one center vs candidates, built the
    way nw_pallas_grouped lays them out (qualities ride in s2q)."""
    n = len(cands)
    L2 = max(len(c) for c in cands)
    s2b = np.full((n, L2), 255, np.uint8)
    l2b = np.zeros(n, np.int64)
    for k, c in enumerate(cands):
        s2b[k, : len(c)] = c
        l2b[k] = len(c)
    quals = rng.integers(2, 41, (n, L2))
    merged = (s2b.astype(np.int64) & 3) | (quals << 2)
    block_idx = nww.assemble_blocks(s2b, l2b)
    while block_idx.shape[0] < nblocks_min:
        block_idx = np.concatenate([block_idx, block_idx[-1:]])
    nb = block_idx.shape[0]
    len1 = len(s1)
    W = max(nww.block_window(len1, l2b[block_idx[bi]], band)
            for bi in range(nb))
    WP = wp or nww._round_up(max(W, 8), 32)
    assert WP >= W
    NDP = nww._round_up(len1 + int(l2b.max()) + 1, 8)
    L1R = nww._round_up(len1 + 1 + WP, 8)
    L2R = nww._round_up(int(l2b.max()) + WP, 8)
    s2q = nww.pack_s2_blocks(merged, l2b, block_idx, L2R)
    scal = np.zeros((nb, 4), np.int32)
    params = np.zeros((nb, 8, LANES), np.int32)
    for bi in range(nb):
        l2 = l2b[block_idx[bi]]
        lb = band + np.maximum(0, len1 - l2)
        rb = band + np.maximum(0, l2 - len1)
        scal[bi] = (len1, int(l2.max()), int(rb.max()), int(l2.min()))
        params[bi, 0] = l2
        params[bi, 1] = lb
        params[bi, 2] = rb
    s1t = np.zeros((L1R, LANES), np.int32)
    s1t[1: 1 + len1, :] = np.asarray(s1, np.int32)[:, None]
    geom = dict(L1R=L1R, L2R=L2R, NDP=NDP, WP=WP, match=5, mismatch=-4,
                gap_p=-8)
    return (scal, params, s1t, s2q), geom


def _check(arrays, geom):
    from dada2_tpu.ops import nw_pallas as nwp

    want = nwp._pallas_call(*arrays, end_gap_p=0, interpret=True, **geom)
    got = nww.nw_compare(*(torch.from_numpy(a) for a in arrays), **geom)
    for name, w, g in zip(("sub", "mapq", "end"), want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy(),
                                      err_msg=name)
    end = got[2].numpy()
    assert (end[:, :2] == 0).all()      # every traceback completed


@pytest.mark.parametrize("band", [4, 16])
def test_uniform_len(band):
    rng = np.random.default_rng(band)
    s1 = rng.integers(0, 4, 40).astype(np.uint8)
    cands = []
    for _ in range(5):
        c = s1.copy()
        for _ in range(int(rng.integers(0, 6))):
            c[int(rng.integers(0, len(c)))] = int(rng.integers(0, 4))
        cands.append(c)
    cands.append(rng.integers(0, 4, 40).astype(np.uint8))
    _check(*make_inputs(rng, s1, cands, band))


def test_mixed_lengths():
    rng = np.random.default_rng(99)
    s1 = rng.integers(0, 4, 50).astype(np.uint8)
    cands = [_mutate(rng, s1) for _ in range(9)]
    cands += [s1[5:], s1[:44], rng.integers(0, 4, 31).astype(np.uint8)]
    _check(*make_inputs(rng, s1, cands, 16))


def test_wide_window_multi_block():
    """A window wider than the geometry needs (WP = 64) and more than 128
    candidates (several blocks, ragged pad lanes)."""
    rng = np.random.default_rng(13)
    s1 = rng.integers(0, 4, 24).astype(np.uint8)
    cands = [_mutate(rng, s1, nops=3) for _ in range(140)]
    _check(*make_inputs(rng, s1, cands, 8, wp=64))


def test_amplicon_length():
    """len1 >= 2*WP: the TPU kernel's interior chunked phase runs, which
    the port's single fill body must reproduce exactly."""
    rng = np.random.default_rng(150)
    s1 = rng.integers(0, 4, 150).astype(np.uint8)
    cands = [_mutate(rng, s1, nops=20) for _ in range(7)]
    cands += [s1[8:], s1[:137], rng.integers(0, 4, 145).astype(np.uint8)]
    _check(*make_inputs(rng, s1, cands, 16))


def test_wrapper_checks():
    rng = np.random.default_rng(1)
    s1 = rng.integers(0, 4, 30).astype(np.uint8)
    arrays, geom = make_inputs(rng, s1, [s1], 16)
    t = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError):
        nww.nw_compare(t[0].to(torch.int64), *t[1:], **geom)
    with pytest.raises(ValueError):
        nww.nw_compare(*t, **{**geom, "L1R": geom["L1R"] + 8})
    with pytest.raises(ValueError):
        nww.nw_compare(*t, **{**geom, "gap_p": 0})
    with pytest.raises(ValueError):
        nww.nw_compare(*t, **{**geom, "WP": nww.WP_MAX + 32})


@pytest.mark.gpu
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version on the card, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run through chip_smoke.py)")
    rng = np.random.default_rng(7)
    s1 = rng.integers(0, 4, 250).astype(np.uint8)
    cands = [_mutate(rng, s1, nops=12) for _ in range(300)]
    arrays, geom = make_inputs(rng, s1, cands, 16)
    t = [torch.from_numpy(a).cuda() for a in arrays]
    got = nww.nw_compare(*t, **geom)
    want = nww.nw_wavefront_ref(*t, **geom)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # B1's pairs per block: one for a one-block launch; for the main
    # path's 169 blocks a larger P that keeps four blocks per SM
    assert nww.pairs_per_block(384, 384, 512, 32, 1, 1) == 1
    P = nww.pairs_per_block(384, 384, 512, 32, 1, 169)
    assert P > 1 and nww.compare_blocks_per_sm(384, 384, 512, 32, P) >= 4
    assert nww.pairs_per_block(384, 384, 512, 32, 2, 169) == 4
    assert nww.pairs_per_block(384, 384, 512, 160) == 0
