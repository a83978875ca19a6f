"""Multi-device distribution: device meshes, sharded compare, collective
transition tallies (counterpart of dada2_tpu/parallel/dist.py).

The reference is single-node (threads + fork only; SURVEY.md §2.3). The
port distributes along the JAX package's two axes:

* ``samples`` — data parallel over samples (replaces parallel::mclapply
  over files, reference: R/filter.R:461-477). Each sample's engine runs
  on its own mesh device, and the per-sample 16 x Q transition tallies
  are summed every selfConsist round (replaces accumulateTrans,
  reference: R/errorModels.R:462-471).
* ``pairs`` — data parallel over unique sequences within a compare sweep
  (replaces RcppParallel parallelFor over raws, reference:
  src/cluster.cpp:90-204). Each device aligns its shard of uniques
  against the cluster center; the shards' outputs are gathered in shard
  order.

A mesh is a grid of (process index, torch.device) entries. PyTorch runs
eagerly, so there is no shard_map: this process launches each of its
shards' work on the shard's device and reduces on the first one. Across
processes the collectives are torch.distributed's, on the default
process group: NCCL between cards (the collectives' tensors on this
process's current card), gloo on the CPU (tensors on the CPU; also for
several processes sharing one card, which NCCL refuses). The backend is
the caller's choice; nothing switches it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops import nw_batch as nwb

AXES = ("samples", "pairs")


class MeshDevice(NamedTuple):
    """One mesh entry: the process that drives it and its device."""
    process_index: int
    device: torch.device


def process_index() -> int:
    """This process's rank in the default process group (0 without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _entry(d) -> MeshDevice:
    if isinstance(d, MeshDevice):
        return MeshDevice(int(d.process_index), torch.device(d.device))
    return MeshDevice(process_index(), torch.device(d))


class Mesh:
    """A grid of MeshDevice entries with named axes (the port's
    jax.sharding.Mesh): ``devices`` is the object array of entries and
    ``shape`` maps each axis name to its size."""

    def __init__(self, devices, axis_names: Sequence[str] = AXES):
        src = np.asarray(devices, dtype=object)
        if src.ndim != len(axis_names):
            raise ValueError(f"{src.ndim}-D devices for axes {axis_names}")
        arr = np.empty(src.shape, dtype=object)
        for k, d in enumerate(src.reshape(-1)):
            arr.reshape(-1)[k] = _entry(d)
        self.devices = arr
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def __repr__(self):
        return (f"Mesh({self.shape}, "
                f"{[tuple(e) for e in self.devices.reshape(-1)]})")


def _local_device(d: torch.device) -> torch.device:
    """A device of this process, checked: CUDA raises without a card
    (never a quiet CPU run) or past the cards there are."""
    from ..core.backend_cuda import resolve_device

    d = resolve_device(d)
    if d.type == "cuda":
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d.index >= torch.cuda.device_count():
            raise ValueError(f"{d}: this process sees "
                             f"{torch.cuda.device_count()} CUDA device(s)")
    return d


def cpu_devices(n: int):
    """n entries of the CPU device (tests: every shard runs the kernels'
    plain versions in this process)."""
    return [torch.device("cpu")] * n


def make_mesh(n_devices: Optional[int] = None, samples: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """(samples, pairs) mesh over the given devices (torch devices, device
    strings or MeshDevice entries; one device may appear several times),
    by default over every CUDA card of this process (the first n_devices).
    Raises where there is no card: a CPU mesh is asked for explicitly
    (cpu_devices)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for a mesh; "
                               "pass devices=cpu_devices(n) to run on the "
                               "CPU")
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    entries = [_entry(d) for d in devices]
    me = process_index()
    entries = [MeshDevice(e.process_index, _local_device(e.device))
               if e.process_index == me else e for e in entries]
    if not entries or len(entries) % samples:
        raise ValueError("samples axis must divide device count")
    arr = np.empty(len(entries), dtype=object)
    for k, e in enumerate(entries):
        arr[k] = e
    return Mesh(arr.reshape(samples, len(entries) // samples), AXES)


def pairs_devices(mesh: Mesh):
    """The devices of the mesh's "pairs" axis that a compare sweep shards
    its blocks over (index 0 along every other axis; the JAX package's
    shard_map replicates the sweep over them), each one of this
    process's and checked."""
    names = list(mesh.axis_names)
    if "pairs" not in names:
        raise ValueError('mesh must have a "pairs" axis')
    grid = np.moveaxis(mesh.devices, names.index("pairs"), -1)
    row = grid.reshape(-1, grid.shape[-1])[0]
    me = process_index()
    if any(e.process_index != me for e in row):
        raise ValueError("a pairs-sharded compare needs the pairs axis's "
                         "devices in this process")
    return [_local_device(e.device) for e in row]


def trans_tally(tvec, quals, lens, reads, ncol: int):
    """16 x ncol int32 transition-count tally of a batch of aligned uniques
    (tensors on one device; the tally lands there).

    Device equivalent of the per-sample tally that feeds the error model
    (reference: src/error.cpp:131-172), computed as one flat index-add.
    """
    n, L = tvec.shape
    dev = tvec.device
    pos = torch.arange(L, device=dev)[None, :]
    valid = pos < lens.to(dev)[:, None]
    t = torch.where(valid, tvec.to(torch.int64), 0)
    q = torch.where(valid, quals.to(dev, torch.int64), 0).clamp(0, ncol - 1)
    w = torch.where(valid, reads.to(dev, torch.int32)[:, None], 0)
    counts = torch.zeros(16 * ncol, dtype=torch.int32, device=dev)
    counts.index_add_(0, (t * ncol + q).reshape(-1), w.reshape(-1))
    return counts.reshape(16, ncol)


def build_compare_and_tally(mesh: Mesh, nd: int, W: int, ncol: int, *,
                            match: int, mismatch: int, gap_p: int,
                            band: int):
    """One multi-device "training step": sharded compare + summed tally.

    Returns step(center_seq [S, L1], center_len [S], seqs [S, npairs, L],
    lens [S, npairs], quals [S, npairs, L], reads [S, npairs], logerr
    [16, ncol]) -> (ham [S, npairs] int32, loglam [S, npairs] f32, counts
    [16, ncol] int32), on the mesh's first device. Inputs are numpy arrays
    or tensors.

    Per (samples, pairs) shard, on the shard's device: align the local
    uniques against their sample's center with kernel B4 (one launch per
    shard; the vectorized aligner, end gaps free, the band and the static
    (nd, W) geometry as given), tally 16 x Q transition counts weighted
    by abundance, and sum them over every shard — the reduction that
    replaces accumulateTrans (reference: R/errorModels.R:462-471) each
    selfConsist round. Also returns per-unique log-lambda under logerr
    (the f32 sum of logerr[t, q] over valid positions), gathered over the
    pairs axis in shard order. Shards may be uneven (tensor_split).

    On a mesh that spans processes (pod_mesh) every process passes the
    same global inputs and runs only its own entries' shards, as the JAX
    package's shard_map does; one int64 all_reduce over the default
    process group then sums the counts and fills in the other processes'
    ham and loglam rows (each entry is one process's, the rest add
    zeros: loglam travels as its float32 bits), so every process returns
    the whole result."""
    me = process_index()
    devs = np.empty(mesh.devices.shape, dtype=object)
    for k, e in enumerate(mesh.devices.reshape(-1)):
        devs.reshape(-1)[k] = (_local_device(e.device)
                               if e.process_index == me else None)
    if devs.ndim != 2:
        raise ValueError('the mesh must have axes ("samples", "pairs")')
    local = [d for d in devs.reshape(-1) if d is not None]
    if not local:
        raise ValueError("build_compare_and_tally needs an entry of this "
                         "process in the mesh")
    spans = len(local) < devs.size
    out_dev = local[0]

    def local_step(dev, center_seq, center_len, seqs, lens, quals, reads,
                   logerr):
        s, p, L = seqs.shape
        L1 = center_seq.shape[1]
        # one copy of each input to the shard's device
        s1 = center_seq.to(dev)[:, None, :].expand(s, p, L1).reshape(-1, L1)
        l1 = center_len.to(dev)[:, None].expand(s, p).reshape(-1)
        seqs = seqs.to(dev).reshape(s * p, L)
        quals = quals.to(dev).reshape(s * p, L)
        lens = lens.to(dev).reshape(-1)
        reads = reads.to(dev).reshape(-1)
        _, _, _, ham, tvec, _ = nwb.nw_batch(
            s1, l1, seqs, lens, match=match, mismatch=mismatch, gap_p=gap_p,
            end_gap_p=0, band=band, mode="vec", geometry=(nd, W))
        counts = trans_tally(tvec, quals, lens, reads, ncol)
        pos = torch.arange(L, device=dev)[None, :]
        valid = pos < lens[:, None]
        t = torch.where(valid, tvec.to(torch.int64), 0)
        q = torch.where(valid, quals.to(torch.int64), 0).clamp(0, ncol - 1)
        loglam = torch.where(valid, logerr.to(dev)[t, q], 0.0).sum(dim=1)
        return ham.reshape(s, p), loglam.reshape(s, p), counts

    def step(center_seq, center_len, seqs, lens, quals, reads, logerr):
        ins = [torch.as_tensor(x) for x in (center_seq, center_len, seqs,
                                            lens, quals, reads)]
        lerr = torch.as_tensor(logerr).to(torch.float32)
        ms, mp = devs.shape
        S, npairs = ins[2].shape[:2]
        rows = torch.tensor_split(torch.arange(S), ms)
        cols = torch.tensor_split(torch.arange(npairs), mp)
        ham = torch.zeros((S, npairs), dtype=torch.int32, device=out_dev)
        lam = torch.zeros((S, npairs), dtype=torch.float32, device=out_dev)
        total = torch.zeros((16, ncol), dtype=torch.int32, device=out_dev)
        for i, si in enumerate(rows):
            for j, pj in enumerate(cols):
                if devs[i, j] is None:
                    continue
                h, lm, c = local_step(
                    devs[i, j], ins[0][si], ins[1][si],
                    ins[2][si][:, pj], ins[3][si][:, pj],
                    ins[4][si][:, pj], ins[5][si][:, pj], lerr)
                ham[si[:, None], pj[None, :]] = h.to(out_dev, torch.int32)
                lam[si[:, None], pj[None, :]] = lm.to(out_dev)
                total = total + c.to(out_dev)
        if spans:
            ham, lam, total = _sum_across_processes(ham, lam, total)
        return ham, lam, total

    return step


def _sum_across_processes(ham, lam, counts):
    """One int64 all_reduce of (counts, ham, loglam's float32 bits): the
    counts are summed, and ham and loglam come back whole, since every
    element of theirs is nonzero in one process at most."""
    import torch.distributed as dist

    parts = (counts.to(torch.int64).reshape(-1),
             ham.to(torch.int64).reshape(-1),
             lam.view(torch.int32).to(torch.int64).reshape(-1))
    buf = torch.cat(parts).to(_collective_device())
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    buf = buf.to(ham.device)
    nc, nh = parts[0].numel(), parts[1].numel()
    return (buf[nc: nc + nh].to(torch.int32).reshape(ham.shape),
            buf[nc + nh:].to(torch.int32).view(torch.float32).reshape(
                lam.shape),
            buf[:nc].to(torch.int32).reshape(counts.shape))


def dryrun_multichip(n_devices: int, device=None):
    """Run one full sharded step on tiny shapes over n_devices mesh
    entries: the CUDA cards round-robin (device None; raises without a
    card), or n_devices entries of `device` ("cpu" for the CPU tests).
    Checks the JAX package's invariants and returns (ham, loglam,
    counts) as numpy arrays."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        ncard = torch.cuda.device_count()
        devs = [torch.device("cuda", k % ncard) for k in range(n_devices)]
    else:
        devs = [device] * n_devices
    samples_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(devices=devs, samples=samples_axis)
    S = samples_axis
    npairs = 2 * (n_devices // samples_axis)  # 2 uniques per pair-shard
    L = 32
    ncol = 41
    rng = np.random.default_rng(0)
    seqs = rng.integers(0, 4, (S, npairs, L)).astype(np.int8)
    lens = np.full((S, npairs), L, np.int32)
    quals = rng.integers(20, 40, (S, npairs, L)).astype(np.int32)
    reads = rng.integers(1, 50, (S, npairs)).astype(np.int32)
    logerr = np.log(np.full((16, ncol), 1e-3))
    logerr[[0, 5, 10, 15], :] = 0.0

    nd, W = nwb.batch_geometry(np.full(npairs, L), np.full(npairs, L), 16)
    stepf = build_compare_and_tally(mesh, nd, W, ncol, match=5, mismatch=-4,
                                    gap_p=-8, band=16)
    ham, loglam, counts = (x.cpu().numpy() for x in stepf(
        seqs[:, 0, :], lens[:, 0], seqs, lens, quals, reads, logerr))
    if ham.shape != (S, npairs) or counts.shape != (16, ncol):
        raise RuntimeError(f"dry run shapes: ham {ham.shape}, counts "
                           f"{counts.shape}")
    # centers align to themselves with zero substitutions, and every
    # consumed base lands in the tally exactly once
    if (ham[:, 0] != 0).any():
        raise RuntimeError(f"a center does not align to itself: {ham[:, 0]}")
    total = int((reads * lens).sum())
    if int(counts.sum()) != total:
        raise RuntimeError(f"tally holds {int(counts.sum())} of {total} "
                           "consumed bases")
    return ham, loglam, counts


def accumulate_trans_mesh(mesh: Mesh, tallies):
    """Sum per-sample 16 x Q transition tallies over the mesh's devices:
    each tally goes to its sample's device (round-robin, as
    sample_devices assigns the engines), each device sums its own in
    int64, and the first device sums those — the replacement for the
    host accumulateTrans reduction (reference: R/errorModels.R:462-471)
    when samples are sharded across devices.

    tallies: list of [16, Qi] integer arrays (ragged Q allowed, as in the
    reference). Returns the summed [16, Qmax] int64 host array,
    bit-identical to errors.accumulate_trans. Raises OverflowError at
    the JAX package's bounds (its two-limb transport's exact range), so
    both packages behave the same at the edge."""
    ncol = max(t.shape[1] for t in tallies)
    S = len(tallies)
    nshard = mesh.shape.get("samples", 1)
    Sp = ((S + nshard - 1) // nshard) * nshard
    if Sp >= (1 << 11):
        raise OverflowError("transition tallies exceed the two-limb "
                            "collective's exact range")
    devs = sample_devices(mesh)
    if devs is None:
        raise ValueError("the mesh holds no device of this process")
    devs = [_local_device(d) for d in devs]
    partial = {}
    for k, t in enumerate(tallies):
        dev = devs[k % len(devs)]
        x = torch.zeros((16, ncol), dtype=torch.int64, device=dev)
        x[:, : t.shape[1]] = torch.from_numpy(
            np.ascontiguousarray(t, np.int64)).to(dev)
        key = (dev.type, dev.index)
        partial[key] = x if key not in partial else partial[key] + x
    out = None
    for x in partial.values():
        x = x.to(devs[0])
        out = x if out is None else out + x
    out = out.cpu().numpy()
    if (out >> 50).any():
        raise OverflowError("transition tallies exceed the two-limb "
                            "collective's exact range")
    return out


def sample_devices(mesh: Optional[Mesh]):
    """Round-robin device assignment for per-sample engines (the
    samples-axis data parallelism: each sample's backend computes on its
    own device). On a multi-process mesh only THIS process's devices are
    returned — each process drives its own samples."""
    if mesh is None:
        return None
    me = process_index()
    local = [e.device for e in mesh.devices.reshape(-1)
             if e.process_index == me]
    return local or None


# ---------------------------------------------------------------------------
# multi-process (hosts x cards) distribution
# ---------------------------------------------------------------------------

def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: str = "nccl", **kw) -> None:
    """Join the default torch.distributed process group (idempotent).

    coordinator_address "host:port" (or a full init URL) with
    num_processes and process_id; without an address the launcher's
    environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE: torchrun) is
    read. backend "nccl" between cards, one card per process (the
    collectives' tensors go on torch.cuda.current_device(): call
    torch.cuda.set_device first); "gloo" on the CPU and for processes
    that share a card. The reference has no multi-node story at all
    (SURVEY.md §2.3/§5.8); this is the hosts axis the TPU build adds."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://", **kw)
        return
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id, **kw)


def mesh_processes(mesh: Mesh):
    """Sorted process indices participating in a mesh."""
    return sorted({e.process_index for e in mesh.devices.reshape(-1)})


def pod_mesh(samples: Optional[int] = None,
             devices: Optional[Sequence] = None) -> Mesh:
    """Global (samples, pairs) mesh over every process's devices,
    host-major: the samples axis spans processes (the slow hops carry
    only the 16 x Q sum once per selfConsist round), the pairs axis stays
    within each process's devices. devices are this process's (default:
    every CUDA card it sees; raises without one); each process's list is
    exchanged with all_gather_object. Defaults to samples = process
    count."""
    import torch.distributed as dist

    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for a mesh; "
                               "pass devices=cpu_devices(n) to run on the "
                               "CPU")
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    local = [str(_local_device(torch.device(d))) for d in devices]
    world = dist.get_world_size()
    gathered = [None] * world
    dist.all_gather_object(gathered, local)
    entries = [MeshDevice(p, torch.device(d))
               for p in range(world) for d in gathered[p]]
    if samples is None:
        samples = max(1, world)
    return make_mesh(devices=entries, samples=samples)


def _collective_device() -> torch.device:
    """Where this process's collective tensors live: its current card
    under NCCL, the CPU otherwise."""
    import torch.distributed as dist

    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _allgather_blobs(blob: bytes):
    """Exchange one variable-length byte blob per process; returns the
    list of every process's blob in process order. Sizes are agreed
    first, then the padded uint8 buffers travel in one all_gather (bytes
    are bit-exact transport for packed float64/int64 payloads)."""
    import torch.distributed as dist

    dev = _collective_device()
    world = dist.get_world_size()
    arr = torch.from_numpy(np.frombuffer(blob, np.uint8).copy())
    size = torch.tensor([arr.numel()], dtype=torch.int64, device=dev)
    sizes = [torch.zeros_like(size) for _ in range(world)]
    dist.all_gather(sizes, size)
    sizes = [int(s.item()) for s in sizes]
    padded = torch.zeros(max(1, max(sizes)), dtype=torch.uint8, device=dev)
    padded[: arr.numel()] = arr.to(dev)
    outs = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(outs, padded)
    return [outs[p][: sizes[p]].cpu().numpy().tobytes()
            for p in range(world)]


def _pack_sample_summaries(items) -> bytes:
    """Serialize (global_index, name, sequences, abundances, quals)
    tuples; quals travel as exact float64 bytes."""
    import io
    import pickle

    out = io.BytesIO()
    payload = []
    for gidx, name, seqs, ab, quals in items:
        payload.append((int(gidx), name, list(seqs),
                        np.asarray(ab, np.int64).tobytes(),
                        None if quals is None else
                        (quals.shape, np.asarray(quals, np.float64)
                         .tobytes())))
    pickle.dump(payload, out, protocol=4)
    return out.getvalue()


def _unpack_sample_summaries(blob: bytes):
    """Inverse of _pack_sample_summaries (blobs of this program's
    processes only: unpickling runs code)."""
    import pickle

    out = []
    for gidx, name, seqs, ab_b, quals_t in pickle.loads(blob):
        ab = np.frombuffer(ab_b, np.int64)
        quals = None
        if quals_t is not None:
            shape, qb = quals_t
            quals = np.frombuffer(qb, np.float64).reshape(shape)
        out.append((gidx, name, seqs, ab, quals))
    return out


def gather_sample_summaries(local_items):
    """Allgather per-sample unique summaries (sequences + abundances +
    average quals) across every process, returned sorted by global
    sample index — the distributed dedup exchange for pool=TRUE
    (SURVEY.md §7 hard-part 7; reads never leave their process, only the
    dereplicated uniques travel).

    local_items: iterable of (global_index, name, sequences,
    abundances, quals)."""
    blobs = _allgather_blobs(_pack_sample_summaries(local_items))
    merged = []
    for b in blobs:
        merged.extend(_unpack_sample_summaries(b))
    merged.sort(key=lambda t: t[0])
    return merged


def accumulate_trans_global(local_tallies, mesh: Mesh):
    """Exact global accumulateTrans across every process: sum this
    process's tallies in int64 on the host, agree on the widest Q, then
    one int64 all_reduce (torch carries int64 exactly under gloo and
    NCCL, so the JAX package's two int32 limbs are not needed).
    Bit-identical to running errors.accumulate_trans over every process's
    tallies in one place; raises OverflowError at the JAX package's
    bound.

    reference: R/errorModels.R:462-471 is the single-node semantics.
    """
    import torch.distributed as dist

    from ..errors import accumulate_trans

    local = (accumulate_trans(local_tallies) if local_tallies
             else np.zeros((16, 1), np.int64))
    dev = _collective_device()
    # processes may hold different Q widths (ragged, as in the
    # reference): agree on the global width first
    ncol = torch.tensor([local.shape[1]], dtype=torch.int64, device=dev)
    dist.all_reduce(ncol, op=dist.ReduceOp.MAX)
    padded = np.zeros((16, int(ncol.item())), np.int64)
    padded[:, : local.shape[1]] = local
    if (padded >> 50).any():
        raise OverflowError("transition tally exceeds the two-limb "
                            "collective's exact range")
    total = torch.from_numpy(padded).to(dev)
    dist.all_reduce(total, op=dist.ReduceOp.SUM)
    return total.cpu().numpy()
