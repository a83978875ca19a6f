"""Parity: the port's diagnostics, exporters, reference-database builders
and plots (dada2_tpu_torch.diagnostics, .refdb, .plot; host code) against
dada2_tpu's, and the port's public names against dada2_tpu's."""
import gzip
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import pandas as pd
import pytest

import dada2_tpu as dj
import dada2_tpu_torch as dt
from dada2_tpu import refdb as rj
from dada2_tpu_torch import refdb as rt

NT = np.array(list("ACGT"))
ROOT = pathlib.Path(dt.__file__).parent.parent


def test_port_exports_every_public_name():
    """Everything dada2_tpu exports, apart from what waits for the
    multi-GPU slice (parallel/, dada(mesh=)), which dada2_tpu's __init__
    does not export either."""
    want = {n for n in vars(dj) if not n.startswith("_")}
    want -= {n for n, v in vars(dj).items()
             if isinstance(v, types.ModuleType)
             and n not in ("data", "refdb", "trace")}
    missing = sorted(n for n in want if not hasattr(dt, n))
    assert not missing, missing
    for name in ("filter_and_trim", "derep_fasta", "assign_taxonomy",
                 "plot_errors", "kmer_dist", "tax_check"):
        assert getattr(dt, name).__module__.startswith("dada2_tpu_torch.")


def test_new_modules_import_no_jax_and_no_cuda():
    """The slice's modules load neither jax nor dada2_tpu, and importing
    the package initialises no CUDA context (filter_and_trim's spawned
    workers import it)."""
    code = ("import sys, torch, dada2_tpu_torch.filter, "
            "dada2_tpu_torch.taxonomy, dada2_tpu_torch.refdb, "
            "dada2_tpu_torch.plot, dada2_tpu_torch.diagnostics; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'dada2_tpu')]; "
            "print(bad, torch.cuda.is_initialized())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] False"
    pat = re.compile(r"^\s*(import|from)\s+(jax|dada2_tpu)(\s|\.|,|$)",
                     re.M)
    assert not pat.findall((ROOT / "ab_tax.py").read_text())


def _seq_pairs(rng, n, lo, hi):
    s1, s2 = [], []
    for _ in range(n):
        a = "".join(NT[rng.integers(0, 4, int(rng.integers(lo, hi)))])
        b = list(a)
        for p in rng.integers(0, len(b), int(rng.integers(0, 8))):
            b[p] = NT[rng.integers(0, 4)]
        s1.append(a)
        s2.append("".join(b)[: len(b) - int(rng.integers(0, 3))])
    return s1, s2


def test_diagnostics_match_jax(tmp_path):
    rng = np.random.default_rng(23)
    s1, s2 = _seq_pairs(rng, 40, 12, 260)
    for k in (3, 5, 8):
        for name in ("kmer_dist", "kmer_matches", "kdist_matches"):
            np.testing.assert_array_equal(
                getattr(dt, name)(s1, s2, kmer_size=k),
                getattr(dj, name)(s1, s2, kmer_size=k))
        for sse in (0, 2):
            np.testing.assert_array_equal(
                dt.kord_dist(s1, s2, kmer_size=k, SSE=sse),
                dj.kord_dist(s1, s2, kmer_size=k, SSE=sse))
    err = dj.data.tperr1()
    res = types.SimpleNamespace(err_out=err, err_in=[err * 0.5, err * 0.9])
    np.testing.assert_array_equal(dt.check_convergence(res),
                                  dj.check_convergence(res))
    assert dt.pfasta(s1[:5]) == dj.pfasta(s1[:5])
    assert dt.pfasta(s1[:3], ids=["a", "b", "c"]) == \
        dj.pfasta(s1[:3], ids=["a", "b", "c"])
    st = pd.DataFrame(rng.integers(0, 50, (3, 4)), index=["s1", "s2", "s3"],
                      columns=s1[:4])
    sam = pd.DataFrame({"x": [1, 2], "y": ["a", "b"]}, index=["s1", "s2"])
    for tag, pkg in (("t", dt), ("j", dj)):
        pkg.seqtab_to_mothur(st, str(tmp_path / f"{tag}.shared"))
        pkg.samdf_to_qiime2(sam, str(tmp_path / f"{tag}.tsv"))
    for ext in ("shared", "tsv"):
        assert (tmp_path / f"t.{ext}").read_bytes() == \
            (tmp_path / f"j.{ext}").read_bytes()


def _refdb_inputs(tmp_path):
    """Synthetic release files for every builder (tests/test_refdb.py's
    RDP and GreenGenes2 inputs, and SILVA-shaped ones)."""
    rng = np.random.default_rng(4)

    def sq():
        return "".join(NT[rng.integers(0, 4, 120)])
    p = {}
    p["rdp"] = tmp_path / "rdp.fa"
    p["rdp"].write_text(
        ">S001\tBacillus subtilis strain X\tBacteria;Firmicutes;Bacilli;"
        "Bacillales;Bacillaceae;Bacillus\n" + "ACGT" * 30 + "\n"
        ">S002\tEscherichia coli K12\tBacteria;Proteobacteria;"
        "Gammaproteobacteria;Enterobacterales;Enterobacteriaceae;"
        "Escherichia\n" + "TTGA" * 30 + "\n")
    p["rdp_db"] = tmp_path / "db.txt"
    p["rdp_db"].write_text("\n".join(
        f"{k}*{name}*0*0*{lev}" for k, (name, lev) in enumerate([
            ("Bacteria", "domain"), ("Firmicutes", "phylum"),
            ("Bacilli", "class"), ("Bacillales", "order"),
            ("Bacillaceae", "family"), ("Bacillus", "genus"),
            ("Proteobacteria", "phylum"),
            ("Gammaproteobacteria", "class"),
            ("Enterobacterales", "order"),
            ("Enterobacteriaceae", "family"), ("Escherichia", "genus"),
        ])) + "\n")
    p["rdp_unaligned"] = tmp_path / "rdp_unaligned.fa"
    p["rdp_unaligned"].write_text("".join(f">{i}\n{sq()}\n" for i in [
        "S000000001 Bacillus subtilis (T);Root;Bacteria;Firmicutes;Bacillus;"
        "Bacillus",
        "S000000002 Escherichia coli;Root;Bacteria;Escherichia;Escherichia",
        "S000000003 uncultured bacterium;Root;Bacteria;X;Y",
        "S000000004 Candidatus Foo bar;Root;Bacteria;Candidatus Foo;"
        "Candidatus Foo",
        "S000000005 Lactobacillus sp.;Root;Bacteria;Lactobacillus;"
        "Lactobacillus",
        "S000000006 Prevotella;Root;Bacteria;Prevotella;Prevotella"]))
    silva_ids = [
        "AB001.1.1500 Bacteria;Firmicutes;Bacilli;Bacillales;Bacillaceae;"
        "Bacillus;Bacillus subtilis",
        "AB002.1.1500 Bacteria;Proteobacteria;Gammaproteobacteria;"
        "Enterobacterales;Enterobacteriaceae;Escherichia-Shigella;"
        "Escherichia coli",
        "AB003.1.1500 Bacteria;Firmicutes;Clostridia;Incertae Sedis;"
        "Incertae Sedis;Incertae Sedis;uncultured bacterium",
        "AB004.1.1500 Archaea;Euryarchaeota;Methanobacteria;"
        "Methanobacteriales;Methanobacteriaceae;Methanobrevibacter;"
        "Methanobrevibacter smithii",
        "AB005.1.1500 Eukaryota;Opisthokonta;Holozoa;Metazoa",
        "AB006.1.1500 Eukaryota;Archaeplastida;Chloroplastida",
        "AB007.1.1500 Bacteria;Bacteroidota;Bacteroidia;Bacteroidales;"
        "Prevotellaceae;Prevotella;Prevotella sp."]
    p["silva"] = tmp_path / "silva.fa"
    p["silva"].write_text("".join(f">{i}\n{sq().replace('T', 'U')}\n"
                                  for i in silva_ids))
    levels = set()
    for i in silva_ids:
        t = i.split(" ", 1)[1].split(";")
        for j in range(1, min(len(t), 6) + 1):
            levels.add(";".join(t[:j]) + ";")
    levels.discard("Bacteria;Proteobacteria;Gammaproteobacteria;"
                   "Enterobacterales;")
    p["silva_tax"] = tmp_path / "silva_tax.txt"
    p["silva_tax"].write_text("".join(f"{lv}\t1\tlevel\t\t\n"
                                      for lv in sorted(levels)))
    p["gg2"] = tmp_path / "sq.fa"
    p["gg2"].write_text(">id1\n" + "ACGT" * 30 + "\n>id2\n" + "GGCA" * 30
                        + "\n")
    p["gg2_tax"] = tmp_path / "tax.tsv"
    p["gg2_tax"].write_text(
        "Feature ID\tTaxon\n"
        "id1\td__Bacteria; p__Firmicutes; c__Bacilli; o__Lactobacillales; "
        "f__Lactobacillaceae; g__Lactobacillus; s__Lactobacillus iners\n"
        "id2\td__Bacteria; p__Proteobacteria; c__; o__; f__; g__; s__\n")
    return {k: str(v) for k, v in p.items()}


@pytest.mark.parametrize("builder,args,kw", [
    ("make_taxonomy_fasta_rdp", ("rdp", "rdp_db"), dict()),
    ("make_taxonomy_fasta_rdp", ("rdp", "rdp_db"),
     dict(include_species=True)),
    ("make_species_fasta_rdp", ("rdp_unaligned",), dict()),
    ("make_taxonomy_fasta_silva_nr", ("silva", "silva_tax"), dict()),
    ("make_taxonomy_fasta_silva_nr", ("silva", "silva_tax"),
     dict(include_species=True, n_euk=1)),
    ("make_species_fasta_silva", ("silva",), dict()),
    ("make_taxonomy_fasta_gg2", ("gg2", "gg2_tax"), dict()),
    ("make_taxonomy_fasta_gg2", ("gg2", "gg2_tax"),
     dict(include_species=True, output_binomials=True)),
], ids=["rdp", "rdp_species", "species_rdp", "silva_nr",
        "silva_nr_species", "species_silva", "gg2", "gg2_binomials"])
def test_refdb_builders_match_jax(tmp_path, builder, args, kw):
    p = _refdb_inputs(tmp_path)
    outs = {}
    for tag, mod in (("t", rt), ("j", rj)):
        fout = str(tmp_path / f"{tag}_out.fa.gz")
        getattr(mod, builder)(*[p[a] for a in args], fout, **kw)
        with gzip.open(fout, "rb") as f:
            outs[tag] = f.read()
    assert outs["t"] == outs["j"]
    assert outs["t"].count(b">") >= 1


def test_tax_check_matches_jax(extdata):
    """Taxonomy mode's picks and reference labels are equal (its assigned
    genera rest on bootstraps); species mode refuses the test set's
    non-ACGT reads in both packages."""
    sp = str(extdata / "example_species_assignment.fa.gz")
    test = str(extdata / "ten_16s.100.fa.gz")
    for mod in (rt, rj):
        with pytest.raises(ValueError, match="Non-ACGT"):
            mod.tax_check(sp, test, nseq=20, mode="species")
    train = str(extdata / "example_train_set.fa.gz")
    got = rt.tax_check(train, test, nseq=20, device="cpu")
    want = rj.tax_check(train, test, nseq=20)
    pd.testing.assert_series_equal(got["reference"], want["reference"])
    assert got.shape == want.shape == (20, 2)


def _figure_arrays(fig):
    """Every plotted array of a Figure, axes by axes."""
    out = []
    for ax in fig.axes:
        out.append(ax.get_title())
        out += [ln.get_xydata() for ln in ax.get_lines()]
        out += [np.asarray(c.get_offsets()) for c in ax.collections]
        out += [np.asarray(im.get_array()) for im in ax.get_images()]
        out += [np.array([r.get_x(), r.get_height()]) for r in ax.patches]
    return out


def _same_figures(a, b):
    import matplotlib.pyplot as plt

    fa, fb = _figure_arrays(a), _figure_arrays(b)
    plt.close(a)
    plt.close(b)
    assert len(fa) == len(fb) > 0
    for x, y in zip(fa, fb):
        if isinstance(x, str):
            assert x == y
        else:
            np.testing.assert_array_equal(x, y)


def test_plots_match_jax(extdata):
    pytest.importorskip("matplotlib")
    rng = np.random.default_rng(2)
    err = dj.data.tperr1()
    dq = {"err_out": err, "err_in": err * 0.8,
          "trans": rng.integers(0, 500, (16, err.shape[1]))}
    kw = dict(err_in=True, nominalQ=True)
    _same_figures(dt.plot_errors(dq, **kw), dj.plot_errors(dq, **kw))
    fq = [str(extdata / "sam1F.fastq.gz"), str(extdata / "sam2R.fastq.gz")]
    _same_figures(dt.plot_quality_profile(fq, n=400),
                  dj.plot_quality_profile(fq, n=400))
    _same_figures(dt.plot_complexity(fq, n=400, aggregate=True),
                  dj.plot_complexity(fq, n=400, aggregate=True))
