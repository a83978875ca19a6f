"""Plain PyTorch banded ends-free Needleman-Wunsch (DADA2's vectorized
aligner), batched over pairs: the benchmark's own aligner for the plain
reference. It imports nothing of the program under test.

Semantics (DADA2 src/nwalign_vectorized.cpp:71-318, in input
coordinates): lband = band + max(0, len1 - len2), rband = band +
max(0, len2 - len1); cell (i, j) is in the band iff -lband <= j - i <=
rband. d[0, 0] = 0; d[i, 0] = 0 (pointer up) for i <= min(lband, len1);
d[0, j] = 0 (pointer left) for j <= min(rband, len2); every other cell
outside the recurrence is minus infinity. Interior: U = d[i-1, j] + gap,
L = d[i, j-1] + gap, D = d[i-1, j-1] + match or mismatch; U wins ties
with L, and D must be strictly greater than both. On the last row
(i == len1, j > j_first) the free move d[len1, j-1] competes after the
three-way max and wins ties only against D; then on the last column
(j == len2, i > i_first) the free move d[i-1, len2] competes and wins
every tie. j_first = len1 - lband when the band clips the first column,
else 0; i_first likewise.

Layout: one row of the DP per band offset o = j - i, kept for every pair
in one int32 tensor A[P, W + 2] (W band offsets, a minus-infinity pad
column at each end). Anti-diagonal d = i + j touches only the offsets of
d's parity, and reads the other parity's offsets (U at o + 1, L at o - 1,
written at d - 1) and its own previous value (D, written at d - 2), so one
tensor updated in place on alternating halves holds the whole front.
Scores are kept as 4 * score; the low two bits carry the pointer during
the max (U 3, L 2, D 1), which reproduces the tie rules with plain max.
"""
from __future__ import annotations

import torch

GAP = 254      # gap code in gapped alignment rows
PAD = 255      # code past a row's alignment length
NEG = -(1 << 28)   # 4 * minus infinity; far below any reachable score
CHUNK = 262144     # pairs per batch


def _bands(len1, len2, band):
    lb = band + torch.clamp_min(len1 - len2, 0)
    rb = band + torch.clamp_min(len2 - len1, 0)
    return lb, rb


def align(s1, len1, s2, len2, *, band: int, match: int, mismatch: int,
          gap: int, rows: bool = False):
    """Align pairs (s1[p, :len1[p]], s2[p, :len2[p]]), codes 0..3 in
    int tensors on one device. Returns map1 [P, L1] int64 (the s2 position
    aligned to each s1 position, -1 at a gap or past len1); with rows=True
    also (A, B, m): the gapped rows in forward order ([P, T] int64, GAP in
    gaps, PAD past m[p]) and the alignment lengths m."""
    P = s1.shape[0]
    if P > CHUNK:
        parts = [align(s1[k:k + CHUNK], len1[k:k + CHUNK], s2[k:k + CHUNK],
                       len2[k:k + CHUNK], band=band, match=match,
                       mismatch=mismatch, gap=gap, rows=rows)
                 for k in range(0, P, CHUNK)]
        if not rows:
            return torch.cat(parts)
        T = max(p[1].shape[1] for p in parts)
        pad = [torch.nn.functional.pad(p[k], (0, T - p[k].shape[1]),
                                       value=PAD)
               for p in parts for k in (1, 2)]
        return (torch.cat([p[0] for p in parts]), torch.cat(pad[0::2]),
                torch.cat(pad[1::2]), torch.cat([p[3] for p in parts]))
    dev = s1.device
    i32, i64 = torch.int32, torch.int64
    len1 = len1.to(dev, i64)
    len2 = len2.to(dev, i64)
    L1 = s1.shape[1]
    L2 = s2.shape[1]
    lb, rb = _bands(len1, len2, band)
    LB = int(lb.max())
    RB = int(rb.max())
    W = LB + RB + 1
    # characters at 1-based positions, distinct sentinels outside
    s1p = torch.full((P, L1 + 2), 6, dtype=i32, device=dev)
    s2p = torch.full((P, L2 + 2), 7, dtype=i32, device=dev)
    s1p[:, 1:L1 + 1] = s1.to(i32)
    s2p[:, 1:L2 + 1] = s2.to(i32)
    pos1 = torch.arange(L1 + 2, device=dev)[None, :]
    pos2 = torch.arange(L2 + 2, device=dev)[None, :]
    s1p = torch.where((pos1 >= 1) & (pos1 <= len1[:, None]), s1p, 6)
    s2p = torch.where((pos2 >= 1) & (pos2 <= len2[:, None]), s2p, 7)

    kk = torch.arange(W, device=dev)
    off = kk - LB                                   # o = j - i per column
    inband = (off[None, :] >= -lb[:, None]) & (off[None, :] <= rb[:, None])
    half = [(kk % 2 == q) for q in (0, 1)]
    nq = [int(h.sum()) for h in half]
    offq = [off[h] for h in half]
    bandq = [inband[:, h] for h in half]
    D_MAX = int((len1 + len2).max())
    # each step's rows i and columns j by parity, and the clamped
    # character indexes
    dd = torch.arange(D_MAX + 1, device=dev)[:, None]
    Iq = [(dd - o[None, :]) >> 1 for o in offq]
    Jq = [i + o[None, :] for i, o in zip(Iq, offq)]
    I1 = [i.clamp(0, L1 + 1) for i in Iq]
    J2 = [j.clamp(0, L2 + 1) for j in Jq]
    A = torch.full((P, W + 2), NEG, dtype=i32, device=dev)
    A[:, LB + 1] = 0                                # d[0, 0]
    slab = torch.zeros((D_MAX + 1, P, max(nq)), dtype=torch.int8,
                       device=dev)
    kD = (4 * match + 1, 4 * mismatch + 1)
    kU = 4 * gap + 3
    kL = 4 * gap + 2
    j_first = torch.where(lb < len1, len1 - lb, 0)[:, None]
    i_first = torch.where(rb < len2, len2 - rb, 0)[:, None]
    # below d_safe no in-band cell lies past a pair's last row or column
    d_safe = int(min((2 * len1 - lb).min(), (2 * len2 - rb).min()))
    row0 = torch.minimum(rb, len2)                  # d[0, j] = 0 up to here
    col0 = torch.minimum(lb, len1)                  # d[i, 0] = 0 up to here
    l1c, l2c = len1[:, None], len2[:, None]
    for d in range(1, D_MAX + 1):
        q = (d + LB) % 2
        n = nq[q]
        cur = A[:, q + 1:q + 1 + 2 * n:2]
        up = A[:, q + 2:q + 2 + 2 * n:2]
        left = A[:, q:q + 2 * n:2]
        c1 = s1p.index_select(1, I1[q][d])
        c2 = s2p.index_select(1, J2[q][d])
        e = torch.maximum(torch.maximum(up + kU, left + kL),
                          cur + torch.where(c1 == c2, kD[0], kD[1]))
        valid = bandq[q]
        if d <= max(LB, RB) + 1:
            valid = valid & ((Iq[q][d] >= 1) & (Jq[q][d] >= 1))[None, :]
        if d > d_safe:
            i, j = Iq[q][d][None, :], Jq[q][d][None, :]
            last_r = (i == l1c) & (j > j_first)
            e = torch.where(last_r, torch.maximum(e, left + 2), e)
            last_c = (j == l2c) & (i > i_first)
            e = torch.where(last_c, torch.maximum(e, up + 3), e)
            valid = valid & (i <= l1c) & (j <= l2c)
        # the pointer of a cell off the band is never read: the traceback
        # walks in-band cells only
        slab[d, :, :n] = e & 3
        cur.copy_(torch.where(valid, e & -4, NEG))
        # the first row and column (free end gaps)
        if d <= RB:
            ok = d <= row0
            A[:, d + LB + 1] = torch.where(ok, 0, NEG).to(i32)
            slab[d, :, (d + LB) // 2] = torch.where(ok, 2, 0).to(torch.int8)
        if d <= LB:
            ok = d <= col0
            A[:, LB - d + 1] = torch.where(ok, 0, NEG).to(i32)
            slab[d, :, (LB - d) // 2] = torch.where(ok, 3, 0).to(torch.int8)
    return _traceback(slab, s1p, s2p, len1, len2, LB, L1, rows)


# moves by pointer: (anti-diagonals back, band column change, s1 and s2
# positions consumed); pointer 0 is the finished walk's "stay"
_STEP_D = (0, 2, 1, 1)
_STEP_K = (0, 0, -1, 1)


def _traceback(slab, s1p, s2p, len1, len2, LB, L1, rows):
    """Every pair walks back from (len1, len2) one step an iteration; the
    moves are kept and the map and rows built from them at the end."""
    dev = slab.device
    i64 = torch.int64
    P, nqm = slab.shape[1], slab.shape[2]
    flat = slab.view(-1)
    base = torch.arange(P, device=dev) * nqm
    stepd = torch.tensor(_STEP_D, device=dev)
    stepk = torch.tensor(_STEP_K, device=dev)
    d = len1 + len2
    kk = len2 - len1 + LB
    T = int(d.max())
    moves = torch.zeros((T, P), dtype=i64, device=dev)
    for t in range(T):
        if t % 64 == 63 and not bool((d > 0).any()):
            moves = moves[:t]
            break
        ptr = flat[d * (P * nqm) + base + (kk >> 1)].to(i64)
        moves[t] = ptr
        d = d - stepd[ptr]
        kk = kk + stepk[ptr]
    if bool((d > 0).any()):
        raise RuntimeError("N-W Align out of range.")
    # positions before each move: s1 and s2 consumed so far
    eat1 = (moves == 1) | (moves == 3)
    eat2 = (moves == 1) | (moves == 2)
    i = len1[None, :] - torch.cumsum(eat1, 0) + eat1.to(i64)
    j = len2[None, :] - torch.cumsum(eat2, 0) + eat2.to(i64)
    diag = moves == 1
    map1 = torch.full((P, L1 + 1), -1, dtype=i64, device=dev)
    map1.scatter_(1, torch.where(diag, i - 1, L1).t(),
                  torch.where(diag, j - 1, -1).t())
    map1 = map1[:, :L1]
    if not rows:
        return map1
    Ar = torch.where(eat1, s1p.gather(1, i.t()).t(), GAP)
    Br = torch.where(eat2, s2p.gather(1, j.t()).t(), GAP)
    Ar = torch.where(moves == 0, PAD, Ar).t()
    Br = torch.where(moves == 0, PAD, Br).t()
    m = (Ar != PAD).sum(1)
    T = Ar.shape[1]
    J = m[:, None] - 1 - torch.arange(T, device=dev)[None, :]
    Jc = J.clamp(0, T - 1)
    A = torch.where(J >= 0, Ar.gather(1, Jc), PAD)
    B = torch.where(J >= 0, Br.gather(1, Jc), PAD)
    return map1, A, B, m
