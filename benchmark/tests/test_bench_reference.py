"""The plain reference against the program's own plain versions on the
CPU: the aligner against its NumPy oracle, and one sample's dada() and
one table's consensus chimera flags against the program run on the CPU.
(The reference itself imports nothing of the program; these tests do.)"""
import numpy as np
import pandas as pd
import pytest
import torch

import bench_tiny  # noqa: F401  (puts the benchmark on sys.path)
import generate
from reference import bimera_ref, dada_ref, nw


def random_pairs(rng, n):
    out = []
    for _ in range(n):
        a = list(rng.integers(0, 4, int(rng.integers(1, 50))))
        b = list(a)
        for _ in range(int(rng.integers(0, 10))):
            p = int(rng.integers(0, max(len(b), 1)))
            r = rng.random()
            if r < 0.5 and b:
                b[p] = int(rng.integers(0, 4))
            elif r < 0.75:
                b.insert(p, int(rng.integers(0, 4)))
            elif len(b) > 1:
                b.pop(p)
        out.append((a, b) if rng.random() < 0.5 else (b, a))
    return out


def packed(seqs):
    L = max(len(s) for s in seqs)
    m = torch.full((len(seqs), L), 255, dtype=torch.int64)
    for k, s in enumerate(seqs):
        m[k, :len(s)] = torch.tensor(s, dtype=torch.int64)
    return m, torch.tensor([len(s) for s in seqs])


@pytest.mark.parametrize("band", [0, 2, 16])
def test_aligner_matches_the_oracle(band):
    from dada2_tpu_torch.ops.nw_ref import nw_align_ref

    pairs = random_pairs(np.random.default_rng(band), 300)
    s1, l1 = packed([a for a, _ in pairs])
    s2, l2 = packed([b for _, b in pairs])
    _, A, B, m = nw.align(s1, l1, s2, l2, band=band, match=5, mismatch=-4,
                          gap=-8, rows=True)
    for k, (a, b) in enumerate(pairs):
        wa, wb = nw_align_ref(np.array(a, np.uint8), np.array(b, np.uint8),
                              5, -4, -8, 0, band, mode="vec")
        assert np.array_equal(A[k, :int(m[k])].numpy(), wa)
        assert np.array_equal(B[k, :int(m[k])].numpy(), wb)


def test_lr_scans_match_the_programs():
    from dada2_tpu_torch.chimeras import _lr_ham_batch

    pairs = random_pairs(np.random.default_rng(7), 400)
    s1, l1 = packed([a for a, _ in pairs])
    s2, l2 = packed([b for _, b in pairs])
    _, A, B, m = nw.align(s1, l1, s2, l2, band=16, match=5, mismatch=-4,
                          gap=-8, rows=True)
    for oo in (False, True):
        got = bimera_ref.lr_ham(A, B, m, oo, 16)
        want = _lr_ham_batch(A.numpy(), B.numpy(), m.numpy(), oo, 16)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), w)


V4 = {"amplicons": "data/v4_asvs.txt.gz", "quality_profile": "sam1F",
      "error_model": {"kind": "matrix", "file": "data/tperr1.npy",
                      "max_q": 50}}


def test_one_sample_matches_the_program():
    import dada2_tpu_torch as dt

    mix = dict(generator="amplicon_samples", pool_asvs=60, asvs_per_sample=8,
               reads_per_sample=900, samples=1, abundance_sigma=1.6,
               warmup=dict(asvs=1, reads=10))
    x = generate.generate(V4, mix, 2 ** 31 + 99)
    name, seqs, ab, q = x["samples"][0]
    want = dada_ref.dada_sample(seqs, ab, q, x["err"], dada_ref.options(),
                                device="cpu")
    got = dt.dada(dt.Derep(uniques=dict(zip(seqs, ab.tolist())), quals=q,
                           map=np.zeros(0, np.int64), name=name),
                  err=x["err"], selfConsist=False, multithread=1,
                  verbose=False, device="cpu")
    pd.testing.assert_frame_equal(got.clustering, want["clustering"])
    pd.testing.assert_frame_equal(got.birth_subs, want["birth_subs"])
    np.testing.assert_array_equal(got.map, want["map"])
    np.testing.assert_array_equal(got.pval, want["pval"])
    np.testing.assert_array_equal(got.trans, want["subqual"])


def test_one_table_matches_the_program():
    import dada2_tpu_torch as dt

    mix = dict(generator="chimera_table", parents=10, asvs=80, samples=6,
               mutant_share=0.3, recombinant_share=0.6, occupancy=[3, 6],
               log_count_mean=3.0, abundance_sigma=1.6)
    x = generate.generate(V4, mix, 11)
    want = bimera_ref.bimera_flags(x["counts"], x["seqs"], device="cpu")
    got = dt.is_bimera_denovo_table(pd.DataFrame(x["counts"],
                                                 columns=x["seqs"]),
                                    device="cpu").values
    assert want.any()
    np.testing.assert_array_equal(got, want)
