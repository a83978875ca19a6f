"""Parity: CudaBackend's kernel-B4 route (the configurations kernel B1 does
not serve; B4 runs as its plain PyTorch version on the CPU) against
dada2_tpu's TpuBackend, entry point by entry point, on 150 sam1F uniques.
Both packages get identical state through interop.state_from_numpy.
Tolerance: exact."""
import numpy as np
import pytest

from dada2_tpu.core.backend_tpu import TpuBackend
from dada2_tpu.derep import derep_fastq
from dada2_tpu_torch.core.backend_cuda import CudaBackend
from dada2_tpu_torch.ops import nw_batch as nwb
from test_torch_backend import _same_subs, _states

CONFIGS = {"unbanded": dict(BAND_SIZE=-1),
           "scalar": dict(VECTORIZED_ALIGNMENT=False),
           "homopolymer": dict(HOMOPOLYMER_GAP_PENALTY=-1, BAND_SIZE=32)}


@pytest.fixture(scope="module")
def sample(extdata):
    d = derep_fastq(str(extdata / "sam1F.fastq.gz"))
    return d.sequences[:150], d.abundances[:150], d.quals[:150]


def test_routes(sample):
    """The route is chosen from geometry: B1 at default options, B4 for
    each refused configuration and for a window wider than B1's."""
    (_, _, opts), (rs_t, _, opts_t) = _states(sample)
    be = CudaBackend(rs_t, device="cpu")
    assert be._route(int(rs_t.lens[0]), opts_t) == "B1"
    for ov in CONFIGS.values():
        _, (_, _, o) = _states(sample, **ov)
        assert be._route(int(rs_t.lens[0]), o) == "B4"
        with pytest.raises(ValueError):
            be._kernel_geom(int(rs_t.lens[0]), o)
    wide = opts_t.replace(BAND_SIZE=300)
    assert be._route(int(rs_t.lens[0]), wide) == "B4"


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_b4_entry_points(sample, config):
    """compare (two k-mer cutoffs), subs_to_center, subs_pairs, subs_pair,
    subs_info and cluster_stats_all on B4's route equal TpuBackend's."""
    (rs, err, opts), (rs_t, err_t, opts_t) = _states(sample,
                                                     **CONFIGS[config])
    be_j = TpuBackend(rs)
    be_t = CudaBackend(rs_t, device="cpu")
    launches = nwb.nw_batch.launches
    skip = np.zeros(rs.n, dtype=bool)
    skip[[3, 17]] = True
    for kdist in (1.0, 0.42):
        lam_j, ham_j = be_j.compare(0, skip, opts, err, True, kdist)
        lam_t, ham_t = be_t.compare(0, skip, opts_t, err_t, True, kdist)
        np.testing.assert_array_equal(ham_j, ham_t)
        np.testing.assert_array_equal(lam_j, lam_t)
        assert (ham_t[~skip] >= 0).sum() > 100
    members = np.array([0, 4, 9, 33, 71, 120, 149], np.int64)
    _same_subs(be_j.subs_to_center(2, members, opts),
               be_t.subs_to_center(2, members, opts_t))
    pairs = [(0, 7), (7, 0), (2, 44)]
    _same_subs(be_j.subs_pairs(pairs, opts, True, 1.0),
               be_t.subs_pairs(pairs, opts_t, True, 1.0))
    _same_subs([be_j.subs_pair(0, 9, opts, True, 0.42)],
               [be_t.subs_pair(0, 9, opts_t, True, 0.42)])
    for a, b in zip(be_j.subs_info(2, members, opts),
                    be_t.subs_info(2, members, opts_t)):
        np.testing.assert_array_equal(a, b)
    correct = np.ones(len(members), bool)
    correct[2] = False
    clusters = [(0, members, correct), (5, members[:3], correct[:3])]
    for use_quals in (True, False):
        got_j = be_j.cluster_stats_all(clusters, opts, err.shape[1],
                                       use_quals)
        got_t = be_t.cluster_stats_all(clusters, opts_t, err.shape[1],
                                       use_quals)
        for a, b in zip(got_j, got_t):
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
    assert nwb.nw_batch.launches == launches    # CPU: the plain version
