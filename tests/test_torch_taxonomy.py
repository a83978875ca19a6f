"""Parity: the port's taxonomy (dada2_tpu_torch.taxonomy, its scorer in
torch ops on the CPU) against dada2_tpu.taxonomy.

The host parts (fasta parsing, k-mer arrays, the lgk table, species
matching) must be identical. The scorer is fed dada2_tpu's own lgk and
jax's own uniforms: the best genus and every bootstrap winner must then
agree wherever the decision's top-two margin (in float64, from
chip_smoke.decision_margins) exceeds 1e-4 of the score; the two float32
products sum in different orders, so a decision within that margin (a
genus tie) may go either way, but each run's pick must still score within
1e-4 of the top.
Exempted decisions are counted and printed."""
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import chip_smoke
import dada2_tpu as dj
import dada2_tpu_torch as dt
from dada2_tpu import taxonomy as tj
from dada2_tpu_torch import taxonomy as tt

TRAIN = "example_train_set.fa.gz"
SPECIES = "example_species_assignment.fa.gz"
REL = 1e-4


@pytest.fixture(scope="module")
def train(extdata):
    refs, r2g, levels = tt.load_reference(str(extdata / TRAIN))
    return dict(refs=refs, r2g=r2g, levels=levels,
                lgk=tj._build_lgk(refs, r2g, len(levels)))


@pytest.fixture(scope="module")
def asvs(extdata):
    """The sam1F and sam2F ASVs (dada2_tpu's dada with tperr1)."""
    dd = dj.dada({s: dj.derep_fastq(str(extdata / f"{s}F.fastq.gz"))
                  for s in ("sam1", "sam2")}, err=dj.data.tperr1(),
                 verbose=False)
    return sorted({s for r in dd.values() for s in r.denoised})


def test_reference_and_lgk_bitwise(extdata, train):
    path = str(extdata / TRAIN)
    ids_j, refs_j = tj.read_fasta(path)
    assert tt.read_fasta(path) == (ids_j, refs_j)
    assert tt._parse_ref_taxonomy(ids_j) == tj._parse_ref_taxonomy(ids_j)
    for a, b in zip(tt.tax_karrays_bulk(refs_j),
                    tj.tax_karrays_bulk(refs_j)):
        np.testing.assert_array_equal(a, b)
    lgk = tt._build_lgk(train["refs"], train["r2g"], len(train["levels"]))
    assert lgk.dtype == train["lgk"].dtype == np.float32
    np.testing.assert_array_equal(lgk.view(np.uint32),
                                  train["lgk"].view(np.uint32))


def _queries(name, extdata, train, asvs):
    if name == "example_seqs":
        _, qs = tj.read_fasta(str(extdata / "example_seqs.fa"))
        return tj.tax_karrays_bulk(qs), train["lgk"]
    if name == "example_seqs_rc":
        _, qs = tj.read_fasta(str(extdata / "example_seqs.fa"))
        return tj.tax_karrays_bulk([tj.rc(s) for s in qs]), train["lgk"]
    if name == "sam_asvs":
        return tj.tax_karrays_bulk(asvs), train["lgk"]
    # a seeded 50-genus table (test_score_batch_chunked_equivalence's)
    rng = np.random.default_rng(9)
    lgk = rng.uniform(-12, -2, (50, 65536)).astype(np.float32)
    return ([rng.integers(0, 65536, size=int(rng.integers(40, 120)))
             for _ in range(12)], lgk)


@pytest.mark.parametrize("name", ["example_seqs", "example_seqs_rc",
                                  "sam_asvs", "seeded_50_genera"])
def test_score_batch_matches_jax(name, extdata, train, asvs):
    karrs, lgk = _queries(name, extdata, train, asvs)
    G = lgk.shape[0]
    A = max(max(len(a) for a in karrs), 8)
    key = jax.random.PRNGKey(7)
    u = np.asarray(jax.random.uniform(key, (len(karrs), tt.NBOOT,
                                            A // 8 + 1)))
    jb, jl, jbb = tj._score_batch(karrs, jnp.asarray(lgk), key, G)
    tb, tl, tbb = tt._score_batch(karrs, tt.device_lgk(lgk, "cpu"), u, G)
    np.testing.assert_allclose(tl, np.asarray(jl), rtol=1e-5)
    qm, bm, gaps = chip_smoke.decision_margins(
        karrs, lgk, u, runs=[(tb, tl, tbb), (jb, jl, jbb)])
    ok_q, ok_b = qm > REL, bm > REL
    np.testing.assert_array_equal(tb[ok_q], np.asarray(jb)[ok_q])
    np.testing.assert_array_equal(tbb[ok_b], np.asarray(jbb)[ok_b])
    # inside the margin too, both picks are top genera
    for gq, gb in gaps:
        assert gq.max() <= REL and gb.max() <= REL
    print(f"[{name}] {len(karrs)} queries x {G} genera: exempt "
          f"{int((~ok_q).sum())} queries, {int((~ok_b).sum())} of "
          f"{ok_b.size} bootstrap replicates; the port differs from "
          f"dada2_tpu on {int((tb != jb).sum())} bests and "
          f"{int((tbb != jbb).sum())} replicates")


def test_score_batch_chunked_equivalence(extdata, train, asvs):
    """Genus-axis chunking must not change any decision (same uniforms,
    the running max keeps the earlier chunk on ties)."""
    karrs = tt.tax_karrays_bulk(asvs)
    G = train["lgk"].shape[0]
    u = tt.boot_uniforms(karrs, torch.Generator().manual_seed(3))
    lgk_t = tt.device_lgk(train["lgk"], "cpu")
    A = max(len(a) for a in karrs)
    full = tt._score_batch(karrs, lgk_t, u, G, mem_cap=1 << 40)
    chunked = tt._score_batch(karrs, lgk_t, u, G,
                              mem_cap=len(karrs) * A * 16)
    for a, b in zip(full, chunked):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tryRC", [False, True], ids=["fwd", "tryRC"])
def test_assign_taxonomy_matches_jax(extdata, asvs, tryRC):
    """minBoot=0: every level of the best genus, so the table equals
    dada2_tpu's exactly; the bootstrap counts come from different random
    streams and agree within 10 per rank on average."""
    _, ex = tj.read_fasta(str(extdata / "example_seqs.fa"))
    seqs = ex + asvs
    path = str(extdata / TRAIN)
    kw = dict(minBoot=0, tryRC=tryRC, outputBootstraps=True)
    rj = dj.assign_taxonomy(seqs, path, **kw)
    rt = dt.assign_taxonomy(seqs, path, device="cpu", **kw)
    pd.testing.assert_frame_equal(rt["tax"], rj["tax"])
    diff = np.abs(rt["boot"].values - rj["boot"].values).mean(axis=0)
    print(f"mean |boot difference| per rank: {diff.round(2).tolist()}")
    assert (diff <= 10).all()
    # the port's seeded draws repeat: a second run is identical
    again = dt.assign_taxonomy(seqs, path, device="cpu", **kw)
    pd.testing.assert_frame_equal(again["boot"], rt["boot"])


@pytest.mark.parametrize("kw", [dict(), dict(tryRC=True),
                                dict(allowMultiple=True),
                                dict(allowMultiple=3, tryRC=True)],
                         ids=["default", "tryRC", "multiple", "multiple3"])
def test_assign_species_and_add_species(extdata, asvs, kw):
    path = str(extdata / SPECIES)
    ids, refs = tj.read_fasta(path)
    frags = [f for f in [r[100:250] for r in refs[:40]]
             + [tj.rc(refs[3][50:300])] if set(f) <= set("ACGT")]
    seqs = asvs + frags
    sj = dj.assign_species(seqs, path, **kw)
    st = dt.assign_species(seqs, path, **kw)
    pd.testing.assert_frame_equal(st, sj)
    assert st["Species"].notna().any()
    taxtab = dj.assign_taxonomy(seqs, str(extdata / TRAIN))
    pd.testing.assert_frame_equal(dt.add_species(taxtab, path, **kw),
                                  dj.add_species(taxtab, path, **kw))
    assert tt.match_genera("Escherichia/Shigella", "Escherichia")
    assert not tt.match_genera(None, "Bacillus")


def test_tax_rows_agree_holds_each_row(extdata, train):
    """chip_smoke's card-vs-CPU check of assign_taxonomy's tables, here
    on two CPU runs: equal runs pass with no row exempt; a boot count or
    a tax cell changed on a row outside the margin fails."""
    _, qs = tj.read_fasta(str(extdata / "example_seqs.fa"))
    kw = dict(tryRC=True, outputBootstraps=True, device="cpu")
    a = dt.assign_taxonomy(qs, str(extdata / TRAIN), **kw)
    b = dt.assign_taxonomy(qs, str(extdata / TRAIN), **kw)
    on_cpu = tt.device_lgk(train["lgk"], "cpu")
    held = chip_smoke.scored_both(tt, qs, train["lgk"], on_cpu, on_cpu,
                                  "example_seqs")
    err, exempt, _ = chip_smoke.tax_rows_agree(held, a, b)
    assert err is None and exempt == 0
    for key, col, value in (("boot", 5, 2), ("tax", 0, "Archaea")):
        bad = {k: v.copy() for k, v in b.items()}
        cell = bad[key].iloc[0, col]
        bad[key].iloc[0, col] = cell + value if key == "boot" else value
        err, _, _ = chip_smoke.tax_rows_agree(held, a, bad)
        assert err is not None and err.startswith("row 0")


def test_scorer_products_run_without_tf32(extdata, train, monkeypatch):
    """TF32 is off during both products (their f32 values feed argmaxes)
    and the caller's setting comes back afterwards."""
    seen = []
    for name in ("matmul", "bmm"):
        real = getattr(torch, name)

        def spy(*a, _real=real, _name=name, **k):
            seen.append((_name, torch.backends.cuda.matmul.allow_tf32))
            return _real(*a, **k)
        monkeypatch.setattr(torch, name, spy)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        _, qs = tj.read_fasta(str(extdata / "example_seqs.fa"))
        karrs = tt.tax_karrays_bulk(qs)
        tt._score_batch(karrs, tt.device_lgk(train["lgk"], "cpu"),
                        tt.boot_uniforms(karrs, torch.Generator()),
                        train["lgk"].shape[0], mem_cap=len(qs) * 300 * 16)
        assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert {n for n, _ in seen} == {"matmul", "bmm"}
    assert len(seen) > 2 and not any(flag for _, flag in seen)


def test_assign_taxonomy_default_device_raises_without_card(extdata):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.assign_taxonomy(str(extdata / "example_seqs.fa"),
                           str(extdata / TRAIN))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.device_lgk(np.zeros((2, 65536), np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.tax_check(str(extdata / TRAIN), nseq=2)


@pytest.mark.gpu
def test_score_batch_card_matches_cpu(extdata, train, asvs):
    """On the card: the scorer against its own CPU run, same uniforms."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    karrs = tt.tax_karrays_bulk(asvs)
    G = train["lgk"].shape[0]
    u = tt.boot_uniforms(karrs, torch.Generator().manual_seed(1))
    cpu = tt._score_batch(karrs, tt.device_lgk(train["lgk"], "cpu"), u, G)
    gpu = tt._score_batch(karrs, tt.device_lgk(train["lgk"], "cuda"), u, G)
    qm, bm, gaps = chip_smoke.decision_margins(karrs, train["lgk"], u,
                                               runs=[gpu, cpu])
    np.testing.assert_allclose(gpu[1], cpu[1], rtol=1e-5)
    np.testing.assert_array_equal(gpu[0][qm > REL], cpu[0][qm > REL])
    np.testing.assert_array_equal(gpu[2][bm > REL], cpu[2][bm > REL])
    for gq, gb in gaps:
        assert gq.max() <= REL and gb.max() <= REL
