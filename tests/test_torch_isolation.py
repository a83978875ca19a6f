"""The port stands alone: importing it loads neither jax nor dada2_tpu, its
sources import neither, and its entry points never fall back to the CPU
when a CUDA card was (implicitly) asked for."""
import pathlib
import re
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import dada2_tpu_torch as dt

PKG = pathlib.Path(dt.__file__).parent
ROOT = PKG.parent


def test_import_loads_no_jax():
    code = ("import sys, dada2_tpu_torch, dada2_tpu_torch.chimeras, "
            "dada2_tpu_torch.seqtab, dada2_tpu_torch.paired, "
            "dada2_tpu_torch.ops.nw_batch; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'dada2_tpu' "
            "or m.startswith('dada2_tpu.')]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_sources_import_no_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|dada2_tpu)(\s|\.|,|$)",
                     re.M)
    files = sorted(PKG.rglob("*.py")) + [
        ROOT / name for name in ("chip_smoke.py", "ab_b1.py", "ab_b2.py",
                                 "sass_fill.py")]
    assert len(files) > 15
    for f in files:
        hits = pat.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"


def test_default_device_raises_without_card(extdata):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    drp = dt.derep_fastq(str(extdata / "sam1F.fastq.gz"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.dada(drp, err=dt.data.tperr1(), verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.learn_errors(drp, verbose=False)
    rs = dt.core.raws.make_rawset(drp.sequences[:5], drp.abundances[:5])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.CudaBackend(rs)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.dada_uniques(drp.sequences[:5], drp.abundances[:5],
                        [False] * 5, dt.data.tperr1(), None,
                        dt.DEFAULT_OPTIONS, 0, False)


def test_chimera_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    rng = np.random.default_rng(42)
    a, b = ("".join("ACGT"[i] for i in rng.integers(0, 4, 120))
            for _ in range(2))
    st = pd.DataFrame([[100, 80, 5], [50, 60, 3]], index=["s1", "s2"],
                      columns=[a, b, a[:60] + b[60:]])
    for method in ("consensus", "pooled", "per-sample"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dt.remove_bimera_denovo(st, method=method)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.is_bimera(a[:60] + b[60:], [a, b])


def test_batch_aligner_default_device_raises_without_card():
    """merge_pairs' and collapse_no_mismatch's aligner, is_shift_denovo
    and nw_batch on numpy inputs run on the card by default."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from dada2_tpu_torch.ops.nw_batch import nw_batch

    a = "ACGTTGCAAC" * 5
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nw_batch(np.zeros((2, 8), np.uint8), [8, 8],
                 np.zeros((2, 8), np.uint8), [8, 8], match=5, mismatch=-4,
                 gap_p=-8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.is_shift_denovo({a: 10, a[3:]: 2})
    st = pd.DataFrame([[5, 3]], index=["s1"], columns=[a, a[3:]])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.collapse_no_mismatch(st)


def test_mesh_raises(extdata):
    drp = dt.derep_fastq(str(extdata / "sam1F.fastq.gz"))
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        dt.dada(drp, err=dt.data.tperr1(), mesh=object(), device="cpu",
                verbose=False)


def test_cpu_device_runs_plain_version():
    """A CPU tensor takes the plain version and counts no kernel launch."""
    from dada2_tpu_torch.ops import nw_wavefront as nww

    rs = dt.core.raws.make_rawset(["ACGTACGTAC" * 3, "ACGTACGTAA" * 3],
                                  [3, 1])
    be = dt.CudaBackend(rs, device="cpu")
    before = dict(nww.nw_wavefront.launches)
    lam, ham = be.compare(0, np.zeros(2, bool), dt.DEFAULT_OPTIONS,
                          dt.data.tperr1(), False, 1.0)
    assert nww.nw_wavefront.launches == before
    assert ham.tolist() == [0, 3]
    assert lam[0] > lam[1] > 0
