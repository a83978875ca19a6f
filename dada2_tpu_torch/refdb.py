"""Reference-database builders and the taxonomy sanity checker.

reference: R/taxonomy.R internal helpers — makeTaxonomyFasta_RDP (:385-440),
makeSpeciesFasta_RDP (:453-517), makeTaxonomyFasta_SilvaNR (:532-668),
makeSpeciesFasta_Silva (:670-726), makeTaxonomyFasta_GG2 (:756-828) and
tax.check (:829-841). These convert the raw RDP/Silva/GreenGenes2 release
files into the training-fasta formats consumed by assign_taxonomy /
assign_species. A copy of dada2_tpu/refdb.py; tax_check classifies on the
card unless given device="cpu".
"""
from __future__ import annotations

import gzip
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .taxonomy import match_genera, read_fasta


def _write_fasta(ids: Sequence[str], seqs: Sequence[str], fout: str,
                 compress: bool = True) -> None:
    op = gzip.open if (compress or str(fout).endswith(".gz")) else open
    with op(fout, "wt") as f:
        for i, s in zip(ids, seqs):
            f.write(f">{i}\n{s}\n")


def make_taxonomy_fasta_rdp(fin: str, fdb: str, fout: str,
                            include_species: bool = False,
                            compress: bool = True) -> None:
    """DADA2 training fasta from the RDP speciesrank trainset.

    fin: RDP trainset fasta whose id lines are tab-separated
    (accession, species binomial+, ;-separated taxonomy); fdb: the RDP
    trainset db file naming the six standard levels
    (reference: makeTaxonomyFasta_RDP, R/taxonomy.R:385-440)."""
    ids, seqs = read_fasta(fin)
    tax = [i.split("\t")[2] if len(i.split("\t")) > 2 else "" for i in ids]
    tax = [re.sub(r"[a-z]{5,8}__", "", t) for t in tax]
    tax = [t.replace("; ", ";") for t in tax]
    taxes = [t.split(";") for t in tax]
    keep_names = set()
    with open(fdb) as f:
        for line in f:
            parts = line.rstrip("\n").split("*")
            if len(parts) >= 5 and parts[4] in (
                    "domain", "phylum", "class", "order", "family",
                    "genus"):
                keep_names.add(parts[1])
    taxes = [[x for x in t if x in keep_names] for t in taxes]
    if max((len(t) for t in taxes), default=0) > 6:
        raise ValueError("Taxonomy with >6 levels detected.")
    nspc = 0
    if include_species:
        binom = [i.split("\t")[1] if len(i.split("\t")) > 1 else ""
                 for i in ids]
        gen_binom = [b.split()[0] if b.split() else "" for b in binom]
        spc_binom = [b.split()[1] if len(b.split()) > 1 else None
                     for b in binom]
        for k, t in enumerate(taxes):
            gen = t[5] if len(t) >= 6 else None
            if spc_binom[k] is not None and \
                    match_genera(gen, gen_binom[k]) and len(t) == 6:
                t.append(spc_binom[k])
                nspc += 1
    out = [";".join(t) + ";" for t in taxes]
    out = [re.sub(r"[^;]*_incertae_sedis;$", "", t) for t in out]
    out = [t.replace(" ", "_") for t in out]
    print(f"{len(out)} reference sequences were output.")
    if include_species:
        print(f"{nspc} had valid species names.")
    _write_fasta(out, seqs, fout, compress)


def make_species_fasta_rdp(fin: str, fout: str,
                           compress: bool = True) -> None:
    """DADA2 assignSpecies fasta from RDP's Bacteria_unaligned.fa
    (reference: makeSpeciesFasta_RDP, R/taxonomy.R:453-517)."""
    ids, seqs = read_fasta(fin)
    keep = [not re.search(r"[Uu]ncultured|[Uu]nclassified|Outgroup|"
                          r"[Uu]nidentified", i) for i in ids]
    ids = [i for i, k in zip(ids, keep) if k]
    seqs = [s for s, k in zip(seqs, keep) if k]
    binom = [i.split(";")[0].split("\t")[0] for i in ids]
    binom = [re.sub(r" \(T\)", "", b).replace("[", "").replace("]", "")
             for b in binom]
    bar = [i.split(";") for i in ids]
    geni = [b[-2] if len(b) >= 2 else "" for b in bar]
    binom = [re.sub(r"^S[0-9]{9} ", "", b).replace("'", "") for b in binom]
    binom = [b.replace("Candidatus ", "") for b in binom]
    geni = [g.replace("Candidatus ", "") for g in geni]
    bg = [b.split()[0] if b.split() else "" for b in binom]
    keep = [match_genera(g, x) for g, x in zip(geni, bg)]
    ids = [i for i, k in zip(ids, keep) if k]
    seqs = [s for s, k in zip(seqs, keep) if k]
    binom = [b for b, k in zip(binom, keep) if k]
    binom = [b + " sp." if len(b.split()) == 1 else b for b in binom]
    b2 = [(b.split()[0], b.split()[1]) for b in binom]
    keep = [not re.search(r"sp\.", s) for _, s in b2]
    out_ids = [f"{i[:10]} {g} {s}"
               for i, (g, s), k in zip(ids, b2, keep) if k]
    out_seqs = [s for s, k in zip(seqs, keep) if k]
    print(f"{len(out_ids)} sequences with genus/species binomial "
          "annotation output.")
    _write_fasta(out_ids, out_seqs, fout, compress)


def make_taxonomy_fasta_silva_nr(fin: str, ftax: str, fout: str,
                                 include_species: bool = False,
                                 compress: bool = True,
                                 n_euk: int = 500,
                                 seed: int = 500) -> None:
    """DADA2 training fasta from the SILVA NR99 release
    (reference: makeTaxonomyFasta_SilvaNR, R/taxonomy.R:532-668)."""
    ids, seqs = read_fasta(fin)
    seqs = [s.replace("U", "T").replace("u", "t") for s in seqs]  # RNA->DNA
    acc = [i.split()[0] for i in ids]
    if len(set(acc)) != len(acc):
        raise ValueError("Duplicated sequence IDs detected.")
    taxl = [re.sub(r"^[A-Za-z0-9.]+\s", "", i) for i in ids]
    taxa = [t.split(";") for t in taxl]
    valid = set()
    with open(ftax) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if parts:
                valid.add(parts[0])
    kingdom = [t[0] if t else "" for t in taxa]
    ba = [k in ("Bacteria", "Archaea") for k in kingdom]
    mat = []
    keep_acc = []
    keep_seq = []
    for a, s, t, isba in zip(acc, seqs, taxa, ba):
        if not isba:
            continue
        row = [(t[j] if j < len(t) else None) for j in range(6)]
        # validity vs the declared Silva taxonomic levels
        pref = ""
        for j in range(6):
            if row[j] is None:
                continue
            pref = (pref + row[j] + ";")
            if pref not in valid:
                row[j] = None
        row = [None if (r in ("Uncultured", "uncultured")) else r
               for r in row]
        # terminal Incertae Sedis -> None
        make_na = [r == "Incertae Sedis" for r in row]
        for j in range(4, -1, -1):
            make_na[j] = make_na[j] and make_na[j + 1]
        row = [None if m else r for r, m in zip(row, make_na)]
        if include_species:
            sp = t[6] if len(t) >= 7 else None
            genus = row[5]
            ok = False
            if sp is not None and genus is not None:
                g = re.sub(r"Candidatus |\[|\]", "", genus)
                b = re.sub(r"Candidatus |\[|\]", "", sp).split()
                if len(b) >= 2 and match_genera(g, b[0], split_glyph="-"):
                    s2 = b[1]
                    if not re.search(r"sp\.", s2) and \
                            b[0] != "endosymbiont" and \
                            s2 != "endosymbiont" and \
                            not re.search(r"[Uu]ncultured|[Uu]nidentified",
                                          " ".join(b[:2])):
                        row.append(s2)
                        ok = True
            if not ok:
                row.append(None)
        mat.append(row)
        keep_acc.append(a)
        keep_seq.append(s)
    # Eukaryota outgroup subsample, kingdom-level only
    euk = [(a, s) for a, s, k in zip(acc, seqs, kingdom)
           if k == "Eukaryota"]
    rng = np.random.default_rng(seed)
    ncols = 7 if include_species else 6
    if euk:
        pick = rng.choice(len(euk), size=min(n_euk, len(euk)),
                          replace=False)
        for p in pick:
            a, s = euk[p]
            mat.append(["Eukaryota"] + [None] * (ncols - 1))
            keep_acc.append(a)
            keep_seq.append(s)
    out = []
    for row in mat:
        t = ";".join("" if r is None else r for r in row) + ";"
        t = re.sub(r"(?<=;);", "", t)
        t = ";".join(r for r in (x for x in t.split(";")) if r != "")
        t = (t + ";") if t else t
        out.append(t)
    print(f"{len(out)} reference sequences were output.")
    _write_fasta(out, keep_seq, fout, compress)


def make_species_fasta_silva(fin: str, fout: str,
                             compress: bool = True) -> None:
    """DADA2 assignSpecies fasta from the SILVA SSURef (non-NR99) release
    (reference: makeSpeciesFasta_Silva, R/taxonomy.R:670-726)."""
    ids, seqs = read_fasta(fin)
    seqs = [s.replace("U", "T").replace("u", "t") for s in seqs]
    keep = [("Bacteria;" in i and not re.search(r"[Uu]ncultured", i)
             and not re.search(r"[Uu]nidentified", i)
             and len(i.split(";")) == 7) for i in ids]
    ids = [i for i, k in zip(ids, keep) if k]
    seqs = [s for s, k in zip(seqs, keep) if k]
    tax = [i.split(";") for i in ids]
    clean = lambda x: re.sub(r"[\[\]()]", "",
                             x.replace("Candidatus ", "Candidatus_"))
    genus = [clean(t[5]) for t in tax]
    binom = [clean(t[6]) for t in tax]
    gb = [b.split()[0] if b.split() else "" for b in binom]
    keep = [match_genera(g, x, split_glyph="-")
            for g, x in zip(genus, gb)]
    ids = [i for i, k in zip(ids, keep) if k]
    seqs = [s for s, k in zip(seqs, keep) if k]
    binom = [b for b, k in zip(binom, keep) if k]
    binom = [b + " sp." if len(b.split()) == 1 else b for b in binom]
    b2 = [(b.split()[0], b.split()[1]) for b in binom]
    keep = [not (re.search(r"sp\.$", s) or s == "endosymbiont")
            for _, s in b2]
    out_ids = [f"{i.split()[0]} {g} {s}"
               for i, (g, s), k in zip(ids, b2, keep) if k]
    out_seqs = [s for s, k in zip(seqs, keep) if k]
    print(f"{len(out_ids)} sequences with genus/species binomial "
          "annotation output.")
    _write_fasta(out_ids, out_seqs, fout, compress)


def make_taxonomy_fasta_gg2(fn: str, txfn: str, fout: str,
                            include_species: bool = False,
                            output_binomials: bool = False,
                            compress: bool = True) -> None:
    """DADA2 training fasta from GreenGenes2 release files
    (reference: makeTaxonomyFasta_GG2, R/taxonomy.R:756-828)."""
    ids, seqs = read_fasta(fn)
    seq_by_id = dict(zip([i.split()[0] for i in ids], seqs))
    tax_pre = ["d__", "p__", "c__", "o__", "f__", "g__", "s__"]
    rows = []
    with open(txfn) as f:
        header = f.readline()
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 2:
                rows.append((parts[0], parts[1]))
    out_ids = []
    out_seqs = []
    n_binom = 0
    n_discord = 0
    for rid, tx in rows:
        if rid not in seq_by_id:
            continue
        taxes = tx.split("; ")
        if len(taxes) != 7:
            raise ValueError("GG2 taxonomy must be 7-level.")
        genus = re.sub(r"^g__", "", taxes[5])
        genus = genus.replace("Escherichia", "Escherichia_Shigella")
        binom = re.sub(r"^s__", "", taxes[6])
        bparts = binom.split(" ")
        has_binom = len(bparts) == 2
        if has_binom:
            n_binom += 1
            gmatch = match_genera(genus, bparts[0], split_glyph="_")
            if gmatch:
                if output_binomials:
                    taxes[6] = taxes[6].replace(" ", "_")
                else:
                    taxes[6] = "s__" + bparts[1]
            else:
                n_discord += 1
                taxes[6] = "s__"
        depth = 7
        for j, (t, p) in enumerate(zip(taxes, tax_pre)):
            if t == p:
                depth = j
                break
        if not include_species:
            depth = min(depth, 6)
        tid = ";".join(taxes[:depth]) + ";" if depth else ";"
        out_ids.append(tid)
        out_seqs.append(seq_by_id[rid])
    if include_species:
        print(f"{n_binom} out of {len(rows)} sequences had a binomial "
              f"species name assigned.\n{n_discord} species assignments "
              "were removed as discordant with the genus assignment.")
    print(f"{len(out_ids)} reference sequences were output.")
    _write_fasta(out_ids, out_seqs, fout, compress)


def tax_check(fn_tax: str, fn_test: Optional[str] = None, nseq: int = 100,
              level: int = 6, mode: str = "taxonomy", seed: int = 100,
              device=None):
    """Sanity harness: assign the labeled ten_16s test sequences against a
    training fasta and tabulate assigned vs reference labels
    (reference: tax.check, R/taxonomy.R:829-841). device: where
    assign_taxonomy scores (None = the CUDA card, "cpu")."""
    import os

    import pandas as pd

    from .taxonomy import assign_species, assign_taxonomy

    if fn_test is None:
        fn_test = os.path.join(os.path.dirname(__file__), "..", "tests",
                               "extdata", "ten_16s.100.fa.gz")
    ids, seqs = read_fasta(fn_test)
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(seqs), size=min(nseq, len(seqs)), replace=False)
    sq = [seqs[i] for i in pick]
    labels = [ids[i] for i in pick]
    # labels like "...;tax=d:...,p:...,c:...,o:...,f:...,g:...;"
    def ref_level(lab: str) -> Optional[str]:
        m = re.search(r"tax=([^;]*)", lab)
        if not m:
            return None
        flds = m.group(1).split(",")
        return flds[level - 1].split(":", 1)[1] if len(flds) >= level \
            else None

    if mode == "taxonomy":
        tax = assign_taxonomy(sq, fn_tax, multithread=True,
                              device=device)
        assigned = list(tax.iloc[:, min(level, tax.shape[1]) - 1])
    elif mode == "species":
        spc = assign_species(sq, fn_tax)
        assigned = list(spc.iloc[:, level - 6 + 1 - 1]
                        if level >= 6 else spc.iloc[:, 0])
    else:
        raise ValueError("Valid modes are taxonomy or species.")
    return pd.DataFrame({"assigned": assigned,
                         "reference": [ref_level(l) for l in labels]})
