"""Multi-process (2-process) runs of the port: bit-identical results.

Launches two real torch processes joined by torch.distributed over gloo
on the CPU, each with a mesh of 4 CPU entries (an 8-entry processes x
devices mesh, from pod_mesh). Contract, as for dada2_tpu's
tests/test_multihost.py: each process passes ITS OWN sample (derep IO is
never duplicated).

Covered modes, all held bit-identical to dada2_tpu.dada run meshless in
one process over both samples:
- dada(selfConsist): the per-round 16 x Q tally all-reduced, so the
  learned error matrices agree across processes and with one process;
- dada(pool=TRUE): distributed unique dedup — only dereplicated summaries
  travel; every process builds the identical pooled derep, runs the
  deterministic pooled engine and splits back its own sample;
- dada(pool='pseudo'): prior selection from allgathered per-sample ASV
  summaries between the two passes.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ("sam1F.fastq.gz", "sam2F.fastq.gz")

_CHILD = r"""
import json, os, sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]
outdir = sys.argv[3]
sys.path.insert(0, %(repo)r)
import dada2_tpu_torch as dt
from dada2_tpu_torch.parallel.dist import (cpu_devices, init_distributed,
                                           pod_mesh)

init_distributed(coordinator_address=f"localhost:{port}", num_processes=2,
                 process_id=pid, backend="gloo")
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_rank() == pid
mesh = pod_mesh(devices=cpu_devices(4))
assert mesh.shape == {"samples": 2, "pairs": 4}, mesh.shape

def load(f):
    d = dt.derep_fastq(os.path.join(%(repo)r, "tests/extdata", f))
    d.uniques = dict(list(d.uniques.items())[:120])
    d.quals = d.quals[:120]
    d.map = d.map[d.map < 120]
    return d

# each process loads ONLY its own sample
own_file = %(files)r[pid]
drp = load(own_file)
out = {}
kw = dict(multithread=False, verbose=False, mesh=mesh)

res = dt.dada([drp], err=None, selfConsist=True, MAX_CONSIST=2, **kw)
assert set(res) == {own_file}
np.save(os.path.join(outdir, f"err_{pid}.npy"), res[own_file].err_out)
out["selfconsist"] = {n: {"denoised": {k: int(v) for k, v in
                                       r.denoised.items()},
                          "map": [int(m) for m in r.map]}
                      for n, r in res.items()}
err = dt.data.tperr1()
for mode, pool in (("pool", True), ("pseudo", "pseudo")):
    resp = dt.dada([drp], err=err, pool=pool, **kw)
    assert set(resp) == {own_file}
    out[mode] = {n: {"denoised": {k: int(v) for k, v in r.denoised.items()},
                     "map": [int(m) for m in r.map]}
                 for n, r in resp.items()}
with open(os.path.join(outdir, f"res_{pid}.json"), "w") as fh:
    json.dump(out, fh)
dist.destroy_process_group()
print("OK", pid)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _load_j(f):
    import dada2_tpu as d2

    d = d2.derep_fastq(os.path.join(REPO, "tests/extdata", f))
    d.uniques = dict(list(d.uniques.items())[:120])
    d.quals = d.quals[:120]
    d.map = d.map[d.map < 120]
    return d


def test_two_process_dada_invariance(tmp_path):
    script = tmp_path / "child.py"
    script.write_text(_CHILD % {"repo": REPO, "files": FILES})
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    res = [json.loads((tmp_path / f"res_{pid}.json").read_text())
           for pid in (0, 1)]
    got = {mode: {**res[0][mode], **res[1][mode]}
           for mode in ("selfconsist", "pool", "pseudo")}

    # --- dada2_tpu, meshless, one process over both samples ---
    import dada2_tpu as d2

    drps = [_load_j(f) for f in FILES]
    kw = dict(multithread=False, verbose=False)
    err0 = np.load(tmp_path / "err_0.npy")
    np.testing.assert_array_equal(err0, np.load(tmp_path / "err_1.npy"))
    truth = {"selfconsist": d2.dada(drps, err=None, selfConsist=True,
                                    MAX_CONSIST=2, **kw),
             "pool": d2.dada(drps, err=d2.data.tperr1(), pool=True, **kw),
             "pseudo": d2.dada(drps, err=d2.data.tperr1(), pool="pseudo",
                               **kw)}
    np.testing.assert_array_equal(
        err0, truth["selfconsist"][FILES[0]].err_out)
    for mode, results in truth.items():
        assert set(got[mode]) == set(FILES)
        for name, r in results.items():
            assert got[mode][name]["denoised"] == {
                k: int(v) for k, v in r.denoised.items()}, (mode, name)
            np.testing.assert_array_equal(
                np.array(got[mode][name]["map"]), r.map)


_CHILD_TALLY = r"""
import os, sys
import numpy as np

pid = int(sys.argv[1])
port = sys.argv[2]
outdir = sys.argv[3]
sys.path.insert(0, %(repo)r)
from dada2_tpu_torch.parallel.dist import (build_compare_and_tally,
                                           cpu_devices, init_distributed,
                                           pod_mesh)

init_distributed(coordinator_address=f"localhost:{port}", num_processes=2,
                 process_id=pid, backend="gloo")
import torch.distributed as dist
mesh = pod_mesh(devices=cpu_devices(4))
assert mesh.shape == {"samples": 2, "pairs": 4}, mesh.shape
z = np.load(os.path.join(outdir, "inputs.npz"))
args = [z[k] for k in ("cs", "cl", "seqs", "lens", "quals", "reads",
                       "logerr")]
step = build_compare_and_tally(mesh, int(z["nd"]), int(z["W"]),
                               int(z["ncol"]), match=5, mismatch=-4,
                               gap_p=-8, band=16)
ham, loglam, counts = (x.numpy() for x in step(*args))
np.savez(os.path.join(outdir, f"tally_{pid}.npz"), ham=ham, loglam=loglam,
         counts=counts)
dist.destroy_process_group()
print("OK", pid)
"""


def test_two_process_compare_and_tally(tmp_path):
    """build_compare_and_tally over a mesh that spans two processes
    (pod_mesh, 2 x 4 CPU entries, gloo): each process runs its own
    entries' shards and one int64 all_reduce sums the counts and fills in
    the other's rows. Both processes return dada2_tpu's one-process
    result on a (2, 4) mesh (ham and counts exact, loglam to f32 order)
    and the port's one-process result bit for bit."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import dada2_tpu.parallel.dist as distj
    from dada2_tpu.ops import nw_batch as nwb_j
    import dada2_tpu_torch.parallel.dist as distt

    rng = np.random.default_rng(5)
    S, npairs, L, ncol = 2, 16, 24, 41
    seqs = rng.integers(0, 4, (S, npairs, L)).astype(np.int8)
    lens = np.full((S, npairs), L, np.int32)
    lens[:, 1:] = rng.integers(L - 4, L + 1, (S, npairs - 1))
    quals = rng.integers(10, 40, (S, npairs, L)).astype(np.int32)
    reads = rng.integers(1, 20, (S, npairs)).astype(np.int32)
    logerr = np.log(np.full((16, ncol), 1e-3))
    logerr[[0, 5, 10, 15], :] = 0.0
    nd, W = nwb_j.batch_geometry(np.full(S * npairs, L), lens.reshape(-1),
                                 16)
    args = (seqs[:, 0, :], lens[:, 0], seqs, lens, quals, reads, logerr)
    np.savez(tmp_path / "inputs.npz", cs=args[0], cl=args[1], seqs=seqs,
             lens=lens, quals=quals, reads=reads, logerr=logerr, nd=nd,
             W=W, ncol=ncol)
    script = tmp_path / "child_tally.py"
    script.write_text(_CHILD_TALLY % {"repo": REPO})
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-3000:]
    got = [np.load(tmp_path / f"tally_{pid}.npz") for pid in (0, 1)]

    kw = dict(match=5, mismatch=-4, gap_p=-8, band=16)
    mesh_j = distj.make_mesh(devices=distj.cpu_devices(8), samples=2)
    specs = (("samples", None), ("samples",),
             ("samples", "pairs", None), ("samples", "pairs"),
             ("samples", "pairs", None), ("samples", "pairs"), ())
    placed = [jax.device_put(a, NamedSharding(mesh_j, P(*spec)))
              for a, spec in zip(args, specs)]
    want = [np.asarray(x) for x in distj.build_compare_and_tally(
        mesh_j, nd, W, ncol, **kw)(*placed)]
    one = [x.numpy() for x in distt.build_compare_and_tally(
        distt.make_mesh(devices=distt.cpu_devices(8), samples=2), nd, W,
        ncol, **kw)(*args)]
    for g in got:
        np.testing.assert_array_equal(g["ham"], want[0])
        np.testing.assert_array_equal(g["counts"], want[2])
        np.testing.assert_allclose(g["loglam"], want[1], rtol=1e-6,
                                   atol=1e-6)
        for k, x in zip(("ham", "loglam", "counts"), one):
            assert g[k].dtype == x.dtype
            np.testing.assert_array_equal(g[k], x)
