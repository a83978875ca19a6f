"""Parity of the port's parallel/ (meshes of CPU entries, one process)
against dada2_tpu's on the virtual 8-device CPU mesh conftest sets up:
the transition tally, the sharded compare-and-tally step, the dry run,
the mesh tally reduction, the pairs-sharded compare backend and
dada(mesh=) — all bit-identical, log-lambda sums within float32
summation-order tolerance."""
import jax
import numpy as np
import pandas as pd
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding, PartitionSpec as P

import dada2_tpu as dj
import dada2_tpu.parallel as parj
import dada2_tpu.parallel.dist as distj
from dada2_tpu.ops import nw_batch as nwb_j
import dada2_tpu_torch as dt
import dada2_tpu_torch.parallel as part
import dada2_tpu_torch.parallel.dist as distt

# loglam is an f32 sum over positions in both packages, in different
# orders (XLA's reduction against torch's)
LOGLAM_TOL = dict(rtol=1e-6, atol=1e-6)


def _tally_inputs(rng, n, L, ncol):
    lens = rng.integers(L // 2, L + 1, n).astype(np.int32)
    tvec = rng.integers(0, 16, (n, L)).astype(np.int8)
    quals = rng.integers(0, ncol + 5, (n, L)).astype(np.int32)
    reads = rng.integers(1, 500, n).astype(np.int32)
    return tvec, quals, lens, reads


def test_trans_tally_equal():
    rng = np.random.default_rng(11)
    ncol = 41
    args = _tally_inputs(rng, 300, 60, ncol)
    want = np.asarray(distj.trans_tally(*args, ncol))
    got = distt.trans_tally(*(torch.from_numpy(a) for a in args), ncol)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _step_inputs(seed=3, S=2, npairs=8, L=24, ncol=41, varied=False):
    rng = np.random.default_rng(seed)
    seqs = rng.integers(0, 4, (S, npairs, L)).astype(np.int8)
    lens = np.full((S, npairs), L, np.int32)
    if varied:
        lens[:, 1:] = rng.integers(L - 4, L + 1, (S, npairs - 1))
    quals = rng.integers(10, 40, (S, npairs, L)).astype(np.int32)
    reads = rng.integers(1, 20, (S, npairs)).astype(np.int32)
    logerr = np.log(np.full((16, ncol), 1e-3))
    logerr[[0, 5, 10, 15], :] = 0.0
    nd, W = nwb_j.batch_geometry(np.full(S * npairs, L), lens.reshape(-1),
                                 16)
    return (seqs[:, 0, :], lens[:, 0], seqs, lens, quals, reads,
            logerr), nd, W, ncol


def _jax_step(samples_axis, ndev, args, nd, W, ncol):
    mesh = distj.make_mesh(devices=distj.cpu_devices(ndev),
                           samples=samples_axis)
    step = distj.build_compare_and_tally(mesh, nd, W, ncol, match=5,
                                         mismatch=-4, gap_p=-8, band=16)
    specs = (("samples", None), ("samples",),
             ("samples", "pairs", None), ("samples", "pairs"),
             ("samples", "pairs", None), ("samples", "pairs"), ())
    placed = [jax.device_put(a, NamedSharding(mesh, P(*spec)))
              for a, spec in zip(args, specs)]
    return [np.asarray(x) for x in step(*placed)]


@pytest.mark.parametrize("varied", [False, True],
                         ids=["equal_lengths", "varied_lengths"])
@pytest.mark.parametrize("samples_axis,ndev", [(2, 8), (1, 4), (2, 2)])
def test_compare_and_tally_equal(samples_axis, ndev, varied):
    """The sharded step at each of dada2_tpu's shard counts against its
    own at the same mesh: ham and counts exact, loglam to f32 order."""
    args, nd, W, ncol = _step_inputs(varied=varied)
    want = _jax_step(samples_axis, ndev, args, nd, W, ncol)
    mesh = distt.make_mesh(devices=distt.cpu_devices(ndev),
                           samples=samples_axis)
    step = distt.build_compare_and_tally(mesh, nd, W, ncol, match=5,
                                         mismatch=-4, gap_p=-8, band=16)
    ham, loglam, counts = (x.numpy() for x in step(*args))
    assert ham.shape == want[0].shape and counts.shape == (16, ncol)
    np.testing.assert_array_equal(ham, want[0])
    np.testing.assert_array_equal(counts, want[2])
    np.testing.assert_allclose(loglam, want[1], **LOGLAM_TOL)


@pytest.mark.parametrize("npairs,ndev", [(8, 3), (2, 4)],
                         ids=["uneven", "empty_shards"])
def test_compare_and_tally_uneven_shards(npairs, ndev):
    """Shards of unequal size, and shards with no uniques (the port
    splits with tensor_split where dada2_tpu needs divisible shapes),
    give the one-shard result."""
    args, nd, W, ncol = _step_inputs(npairs=npairs, varied=True)
    kw = dict(match=5, mismatch=-4, gap_p=-8, band=16)
    outs = [distt.build_compare_and_tally(
        distt.make_mesh(devices=distt.cpu_devices(n)), nd, W, ncol,
        **kw)(*args) for n in (1, ndev)]
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_dryrun_multichip():
    """The port's dry run on 8 CPU entries passes its own checks and
    equals dada2_tpu's step on the same data at the same (2, 4) mesh."""
    ham, loglam, counts = distt.dryrun_multichip(8, device="cpu")
    distj.dryrun_multichip(8)
    S, npairs, L, ncol = 2, 8, 32, 41
    rng = np.random.default_rng(0)
    seqs = rng.integers(0, 4, (S, npairs, L)).astype(np.int8)
    lens = np.full((S, npairs), L, np.int32)
    quals = rng.integers(20, 40, (S, npairs, L)).astype(np.int32)
    reads = rng.integers(1, 50, (S, npairs)).astype(np.int32)
    logerr = np.log(np.full((16, ncol), 1e-3))
    logerr[[0, 5, 10, 15], :] = 0.0
    nd, W = nwb_j.batch_geometry(np.full(npairs, L), np.full(npairs, L), 16)
    want = _jax_step(2, 8, (seqs[:, 0, :], lens[:, 0], seqs, lens, quals,
                            reads, logerr), nd, W, ncol)
    np.testing.assert_array_equal(ham, want[0])
    np.testing.assert_array_equal(counts, want[2])
    np.testing.assert_allclose(loglam, want[1], **LOGLAM_TOL)


def test_accumulate_trans_mesh_large_counts():
    """Exact beyond int32, equal to both packages' accumulate_trans."""
    rng = np.random.default_rng(2)
    tallies = [rng.integers(0, 3_000_000_000, (16, 41)).astype(np.int64)
               for _ in range(10)]
    # ragged Q, as in the reference
    tallies.append(rng.integers(0, 3_000_000_000, (16, 30)).astype(
        np.int64))
    mesh = distt.make_mesh(devices=distt.cpu_devices(8), samples=8)
    got = distt.accumulate_trans_mesh(mesh, tallies)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, dt.accumulate_trans(tallies))
    np.testing.assert_array_equal(got, dj.accumulate_trans(tallies))
    np.testing.assert_array_equal(got, distj.accumulate_trans_mesh(
        distj.make_mesh(devices=distj.cpu_devices(8), samples=8), tallies))


@pytest.mark.parametrize("edge", ["value", "samples"])
def test_accumulate_trans_mesh_overflow(edge):
    """OverflowError at dada2_tpu's bounds: a summed count >= 2^50, or
    2^11 padded samples."""
    if edge == "value":
        tallies = [np.full((16, 41), 1 << 49, np.int64)] * 2
    else:
        tallies = [np.ones((16, 41), np.int64)] * (1 << 11)
    mesh_t = distt.make_mesh(devices=distt.cpu_devices(8), samples=8)
    mesh_j = distj.make_mesh(devices=distj.cpu_devices(8), samples=8)
    with pytest.raises(OverflowError):
        distj.accumulate_trans_mesh(mesh_j, tallies)
    with pytest.raises(OverflowError):
        distt.accumulate_trans_mesh(mesh_t, tallies)
    # one sample short of the bound, and just under the value bound, pass
    ok = ([np.full((16, 41), (1 << 49) - 1, np.int64)] * 2
          if edge == "value" else tallies[:-8])
    np.testing.assert_array_equal(distt.accumulate_trans_mesh(mesh_t, ok),
                                  dt.accumulate_trans(ok))


@pytest.fixture(scope="module")
def sam1f_rawsets(extdata):
    d = dj.derep_fastq(str(extdata / "sam1F.fastq.gz"))

    def rawsets(n):
        from dada2_tpu.core.raws import make_rawset as make_j
        from dada2_tpu_torch.core.raws import make_rawset as make_t

        args = (d.sequences[:n], d.abundances[:n], None, d.quals[:n])
        return make_j(*args), make_t(*args)
    return rawsets


@pytest.mark.parametrize("n,ndev", [(40, 8), (300, 2), (300, 3)])
def test_sharded_compare_backend_parity(sam1f_rawsets, n, ndev):
    """A compare sweep with kernel B1's blocks sharded over a pairs mesh
    of CPU entries equals the unsharded backend and dada2_tpu's
    TpuBackend bit for bit (40 uniques: one block repeated onto 8 shards;
    300: three blocks split unevenly)."""
    from dada2_tpu.core.backend_tpu import TpuBackend
    from dada2_tpu_torch.core.backend_cuda import CudaBackend

    rs_j, rs_t = sam1f_rawsets(n)
    opts = dt.DEFAULT_OPTIONS.normalized()
    err = dt.data.tperr1()
    skip = np.zeros(n, dtype=bool)
    lam_j, ham_j = TpuBackend(rs_j).compare(0, skip, dj.DEFAULT_OPTIONS
                                            .normalized(), err, True, 1.0)
    single = CudaBackend(rs_t, device="cpu")
    assert single.mesh is None
    lam_s, ham_s = single.compare(0, skip, opts, err, True, 1.0)

    mesh = distt.make_mesh(devices=distt.cpu_devices(ndev))
    part.use_mesh(mesh)
    try:
        sharded = CudaBackend(rs_t)
        assert sharded.mesh is mesh
        assert sharded.device == torch.device("cpu")
        lam_m, ham_m = sharded.compare(0, skip, opts, err, True, 1.0)
        # an explicit device bypasses the process-wide mesh
        assert CudaBackend(rs_t, device="cpu").mesh is None
    finally:
        part.use_mesh(None)
    lam_e, ham_e = CudaBackend(rs_t, mesh=mesh).compare(0, skip, opts, err,
                                                        True, 1.0)
    for lam, ham in ((lam_s, ham_s), (lam_m, ham_m), (lam_e, ham_e)):
        np.testing.assert_array_equal(ham, ham_j)
        np.testing.assert_array_equal(lam, lam_j)
    with pytest.raises(ValueError, match="mutually exclusive"):
        CudaBackend(rs_t, device="cpu", mesh=mesh)


def _subsets(pkg, extdata, n=120):
    out = {}
    for name in ("sam1F.fastq.gz", "sam2F.fastq.gz"):
        full = dj.derep_fastq(str(extdata / name))
        seqs = full.sequences[:n]
        out[name] = pkg.Derep(
            uniques={s: int(full.uniques[s]) for s in seqs},
            quals=full.quals[:n].copy(), map=np.zeros(0, np.int64),
            name=name)
    return out


MODES = {"selfconsist": dict(err=None, selfConsist=True, MAX_CONSIST=2),
         "pool": dict(pool=True), "pseudo": dict(pool="pseudo")}


@pytest.mark.parametrize("mode", list(MODES))
def test_dada_mesh_invariance(extdata, mode):
    """dada() with its samples on an 8-entry CPU mesh equals the port's
    meshless run and dada2_tpu.dada(mesh=) on 8 virtual CPU devices:
    error matrices, tallies, ASV tables and maps."""
    kw = dict(MODES[mode], multithread=False, verbose=False)
    if "err" not in kw:
        kw["err"] = dt.data.tperr1()
    base = dt.dada(_subsets(dt, extdata), device="cpu", **kw)
    sharded = dt.dada(_subsets(dt, extdata), mesh=distt.make_mesh(
        devices=distt.cpu_devices(8), samples=8), **kw)
    ref = dj.dada(_subsets(dj, extdata), mesh=distj.make_mesh(
        devices=distj.cpu_devices(8), samples=8), **kw)
    assert list(base) == list(sharded) == list(ref)
    for name in base:
        for other in (sharded[name], ref[name]):
            b = base[name]
            np.testing.assert_array_equal(b.err_out, other.err_out)
            np.testing.assert_array_equal(b.trans, other.trans)
            assert b.denoised == other.denoised
            pd.testing.assert_frame_equal(b.clustering, other.clustering)
            np.testing.assert_array_equal(b.map, other.map)


def test_use_mesh_requires_pairs_axis():
    bad = distt.Mesh(np.array(distt.cpu_devices(4), dtype=object),
                     ("samples",))
    with pytest.raises(ValueError, match='"pairs"'):
        part.use_mesh(bad)
    with pytest.raises(ValueError, match='"pairs"'):
        parj.use_mesh(JaxMesh(np.array(jax.devices("cpu")[:4]),
                              ("samples",)))
    part.use_mesh(distt.make_mesh(devices=distt.cpu_devices(2)))
    part.use_mesh(None)
    assert part.get_mesh() is None


def test_dada_mesh_and_device_raise(extdata):
    drp = dt.derep_fastq(str(extdata / "sam1F.fastq.gz"))
    mesh = distt.make_mesh(devices=distt.cpu_devices(2), samples=2)
    with pytest.raises(ValueError, match="mutually exclusive"):
        dt.dada(drp, err=dt.data.tperr1(), mesh=mesh, device="cpu",
                verbose=False)


def test_make_mesh_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default mesh is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distt.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distt.make_mesh(devices=["cuda:0", "cuda:0"], samples=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distt.dryrun_multichip(2)
