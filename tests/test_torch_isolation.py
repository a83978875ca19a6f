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
            "dada2_tpu_torch.ops.nw_batch, dada2_tpu_torch.parallel, "
            "dada2_tpu_torch.parallel.dist, "
            "dada2_tpu_torch.ops.store_screen; "
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
                                 "ab_b3.py", "ab_b4.py", "ab_bud.py",
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
    """dada(mesh=) runs (tests/test_torch_parallel.py); a mesh together
    with an explicit device is refused: neither overrides the other."""
    from dada2_tpu_torch.parallel.dist import cpu_devices, make_mesh

    drp = dt.derep_fastq(str(extdata / "sam1F.fastq.gz"))
    mesh = make_mesh(devices=cpu_devices(2), samples=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        dt.dada(drp, err=dt.data.tperr1(), mesh=mesh, device="cpu",
                verbose=False)
    rs = dt.core.raws.make_rawset(drp.sequences[:5], drp.abundances[:5])
    with pytest.raises(ValueError, match="mutually exclusive"):
        dt.CudaBackend(rs, device="cpu", mesh=make_mesh(
            devices=cpu_devices(2)))


def test_mesh_default_device_raises_without_card(extdata):
    """make_mesh, CudaBackend(mesh=...) and dada(mesh=...) over CUDA
    entries never fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    from dada2_tpu_torch import parallel
    from dada2_tpu_torch.parallel.dist import Mesh, make_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices=["cuda:0"] * 2, samples=1)
    # a mesh built by hand holds CUDA entries unchecked until used
    cuda_mesh = Mesh(np.array([torch.device("cuda", 0)] * 2, dtype=object)
                     .reshape(2, 1))
    pairs_mesh = Mesh(np.array([torch.device("cuda", 0)] * 2, dtype=object)
                      .reshape(1, 2))
    drp = dt.derep_fastq(str(extdata / "sam1F.fastq.gz"))
    rs = dt.core.raws.make_rawset(drp.sequences[:5], drp.abundances[:5])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.CudaBackend(rs, mesh=pairs_mesh)
    parallel.use_mesh(pairs_mesh)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dt.CudaBackend(rs)
    finally:
        parallel.use_mesh(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dt.dada(drp, err=dt.data.tperr1(), mesh=cuda_mesh, verbose=False)


@pytest.mark.gpu
def test_second_card_launches_on_its_own_device(extdata):
    """Kernels B1 and B4 launched on cuda:1 while cuda:0 is current: the
    fit queries, their cache keys and the launches follow the tensors'
    device, and the results equal the CPU's (a pairs mesh over both
    cards too)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards (the launches' device "
                    "guard cannot show on one)")
    from dada2_tpu_torch.ops import nw_batch as nwb
    from dada2_tpu_torch.parallel.dist import make_mesh

    torch.cuda.set_device(0)
    drp = dt.derep_fastq(str(extdata / "sam1F.fastq.gz"))
    rs = dt.core.raws.make_rawset(drp.sequences, drp.abundances, None,
                                  drp.quals)
    skip = np.zeros(rs.n, bool)
    opts = dt.DEFAULT_OPTIONS.normalized()
    err = dt.data.tperr1()
    want = dt.CudaBackend(rs, device="cpu").compare(0, skip, opts, err,
                                                    True, 1.0)
    for be in (dt.CudaBackend(rs, device="cuda:1"),
               dt.CudaBackend(rs, mesh=make_mesh(devices=["cuda:0",
                                                          "cuda:1"]))):
        got = be.compare(0, skip, opts, err, True, 1.0)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert torch.cuda.current_device() == 0
    codes = np.asarray(rs.seqs[:64])
    lens = np.asarray(rs.lens[:64])
    args = (codes[:1].repeat(64, 0), lens[:1].repeat(64), codes, lens)
    kw = dict(match=5, mismatch=-4, gap_p=-8, band=16)
    got = nwb.nw_batch(*args, device="cuda:1", **kw)
    assert all(x.device == torch.device("cuda", 1) for x in got)
    for g, w in zip(got, nwb.nw_batch(*args, device="cpu", **kw)):
        assert torch.equal(g.cpu(), w)


def test_store_screen_refuses_other_devices():
    """Kernel B5's wrappers run the plain version only for CPU tensors:
    any other device is refused, never quietly computed elsewhere."""
    from dada2_tpu_torch.ops import store_screen as ss

    n, W, nd = 4, 8, 16
    meta = torch.device("meta")
    args = (torch.zeros((n, 13), dtype=torch.int8, device=meta),
            torch.zeros((n, W), dtype=torch.int8, device=meta),
            torch.zeros((n, W), dtype=torch.int8, device=meta),
            torch.zeros(n, dtype=torch.int64, device=meta))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ss.budded_pack(*args, torch.zeros(n, dtype=torch.int32, device=meta),
                       0, torch.zeros(2 * nd + nd // 8, dtype=torch.uint8,
                                      device=meta),
                       nd=nd, L=W, M0=4, K=4, greedy=False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ss.take_subs(*args, 0, torch.zeros(nd, dtype=torch.int32,
                                            device=meta), M0=0, M=4, K=4)


@pytest.mark.gpu
def test_budded_route_under_mesh_equal(extdata):
    """On the card: the budded compares (kernel B5) of a selfConsist
    engine run give the same results with B1's blocks split over two mesh
    entries of the card (use_mesh) as meshless, and B5 launches in both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from dada2_tpu_torch.core.engine import Engine
    from dada2_tpu_torch.core.output import finalize
    from dada2_tpu_torch.ops import store_screen as ss
    from dada2_tpu_torch.parallel.dist import make_mesh

    drp = dt.derep_fastq(str(extdata / "sam1F.fastq.gz"))
    rs = dt.core.raws.make_rawset(drp.sequences, drp.abundances, None,
                                  drp.quals)
    opts = dt.DEFAULT_OPTIONS.normalized()
    err = dt.data.tperr1()
    runs = []
    for mesh in (None, make_mesh(devices=["cuda:0"] * 2)):
        be = dt.CudaBackend(rs, mesh=mesh)
        before = ss.launches["pack"]
        eng = Engine(rs, err, opts, be, use_quals=True)
        eng.run(max_clust=opts.MAX_CLUST)
        runs.append((eng.comp_lam.copy(),
                     finalize(eng, opts, err.shape[1], opts.OMEGA_C),
                     ss.launches["pack"] - before))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    for k in ("clustering", "birth_subs"):
        pd.testing.assert_frame_equal(runs[0][1][k], runs[1][1][k])
    for k in ("subqual", "map", "pval", "clusterquals"):
        np.testing.assert_array_equal(runs[0][1][k], runs[1][1][k])
    assert runs[0][2] == runs[1][2] > 0


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
