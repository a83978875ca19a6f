"""dada(): high-resolution sample inference (the public driver).

reference: R/dada.R:144-488. Orchestrates per-sample engine runs, the
selfConsist error-learning loop, pooling/pseudo-pooling, and priors.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import pandas as pd

from . import trace
from .core.backend_cuda import CudaBackend, resolve_device
from .core.engine import Engine
from .core.output import finalize
from .core.raws import make_rawset
from .derep import Derep, combine_dereps, derep_fastq, get_derep
from .encode import is_acgt
from .errors import accumulate_trans, get_errors, loess_errfun, noqual_errfun
from .options import DadaOptions, current_options
from .trace import PHASES

TRANS_ROWNAMES = ["A2A", "A2C", "A2G", "A2T", "C2A", "C2C", "C2G", "C2T",
                  "G2A", "G2C", "G2G", "G2T", "T2A", "T2C", "T2G", "T2T"]


@dataclass
class DadaResult:
    """dada-class equivalent (reference: R/allClasses.R:18-41)."""

    denoised: Dict[str, int]
    clustering: pd.DataFrame
    sequence: List[str]
    quality: np.ndarray
    birth_subs: pd.DataFrame
    trans: np.ndarray
    map: np.ndarray           # 0-based uniques->ASV index; -1 = not corrected
    pval: np.ndarray
    err_in: object
    err_out: Optional[np.ndarray]
    opts: DadaOptions
    name: Optional[str] = None

    def __repr__(self):
        nseq = len(self.denoised)
        nin = int(np.sum(list(self.denoised.values())))
        return (f"DadaResult: {nseq} sequence variants were inferred from "
                f"{len(self.map)} input unique sequences.")


def _split_pooled(pooled: DadaResult, member: np.ndarray,
                  drp: Derep) -> DadaResult:
    """One sample's result out of the pooled one (R/dada.R:443-475): the
    pooled clusters its uniques map to, renumbered in pooled order, with
    the sample's own abundances; member holds each of the sample's
    uniques' index in the pool (Derep.pool_index)."""
    nclust = len(pooled.clustering)
    own = pooled.map[member]            # pooled cluster, -1 not corrected
    hit = own >= 0
    keep = np.zeros(nclust, dtype=bool)
    keep[own[hit]] = True
    newBi = np.cumsum(keep) - 1         # pooled idx -> own idx
    own_map = np.full(len(member), -1, dtype=np.int64)
    own_map[hit] = newBi[own[hit]]
    # per-sample abundances (R/dada.R:470-471)
    ab = np.zeros(int(keep.sum()), dtype=np.int64)
    np.add.at(ab, own_map[hit], drp.abundances[hit])
    cl = pooled.clustering[keep].reset_index(drop=True)
    cl["abundance"] = ab
    bs = pooled.birth_subs
    clust = bs["clust"].to_numpy() - 1
    bs = bs[keep[clust]].copy()
    bs["clust"] = newBi[clust[keep[clust]]] + 1
    return DadaResult(
        denoised=dict(zip(cl["sequence"], ab.tolist())), clustering=cl,
        sequence=list(cl["sequence"]), quality=pooled.quality[keep],
        birth_subs=bs, trans=pooled.trans, map=own_map, pval=None,
        err_in=pooled.err_in, err_out=pooled.err_out, opts=pooled.opts,
        name=drp.name)


def _make_backend(rawset, opts, use_quals, err_ncol, device=None):
    """The CUDA backend (kernel B1, the vectorized banded aligner; B4 for
    the configurations B1 does not serve). device None takes the
    process-wide mesh of parallel.use_mesh if one is set, else CUDA.
    OracleBackend remains a test oracle only."""
    return CudaBackend(rawset, use_quals=use_quals, device=device)


def dada_uniques(
    sequences: Sequence[str],
    abundances: Sequence[int],
    priors: Sequence[bool],
    err: np.ndarray,
    quals: Optional[np.ndarray],
    opts: DadaOptions,
    max_clust: int,
    use_quals: bool,
    backend=None,
    device=None,
) -> dict:
    """Run the core engine on one set of uniques.

    device: where the backend computes ("cuda" by default, or the
    process-wide mesh of parallel.use_mesh; raises if there is no card
    unless "cpu" is passed). Ignored when backend is given.

    reference: src/Rmain.cpp:30-295 (dada_uniques).
    """
    n = len(sequences)
    if n == 0:
        raise ValueError("Zero input sequences.")
    lens = [len(s) for s in sequences]
    if min(lens) <= 5:
        raise ValueError("Input sequences must all be longer than the kmer-size (5).")
    with PHASES("dada.setup"):
        if backend is None:
            rawset = make_rawset(sequences, abundances, priors,
                                 quals if use_quals else None)
        else:
            # the caller's backend already owns the identical rawset
            # (same sequences/abundances/quals); rebuilding it costs
            # real host time at production scale. Priors CAN change
            # across selfConsist passes (pseudo-pooling), and only the
            # engine reads them — refresh in place.
            rawset = backend.rs
            rawset.priors = np.asarray(priors, dtype=bool)
        err = np.asarray(err, dtype=np.float64)
        if err.shape[0] != 16:
            raise ValueError("Error matrix must have 16 rows.")
        if backend is None:
            backend = _make_backend(rawset, opts, use_quals, err.shape[1],
                                    device=device)
        eng = Engine(rawset, err, opts, backend, use_quals=use_quals)
    eng.run(max_clust=max_clust)
    with PHASES("finalize"):
        return finalize(eng, opts, err.shape[1], opts.OMEGA_C)


def dada(
    derep,
    err,
    errorEstimationFunction: Optional[Callable] = None,
    selfConsist: bool = False,
    pool: Union[bool, str] = False,
    priors: Sequence[str] = (),
    verbose: Union[bool, int] = True,
    multithread: bool = True,
    checkpoint: Optional[str] = None,
    mesh=None,
    device=None,
    **opt_overrides,
):
    """Sample inference from dereplicated amplicon reads.

    reference: R/dada.R:144-488. Returns a DadaResult, or dict of name ->
    DadaResult when multiple samples are given.

    checkpoint: optional path; in selfConsist mode the error-matrix state
    is saved there after every round and a restarted call resumes from the
    last completed round (SURVEY.md §5.4 — the reference has no native
    checkpointing; its idiom is workflow-level saveRDS).

    mesh: optional parallel.dist.Mesh with a ``samples`` axis (make_mesh,
    pod_mesh) — the multi-device data-parallel mode. Each sample's engine
    computes on its round-robin-assigned mesh device of this process, and
    every selfConsist round's 16 x Q transition tally is summed over the
    mesh's devices (the reduction replacing accumulateTrans, reference:
    R/errorModels.R:462-471). On a mesh spanning several processes
    (torch.distributed, see parallel.dist.init_distributed) each process
    passes and drives its own samples: the tally is all-reduced every
    round, pooled runs exchange dereplicated summaries, and each process
    returns its own samples' results. Results are bit-identical to
    mesh=None over all samples in one process.

    device: torch device every sample's backend computes on; by default
    CUDA, or the process-wide mesh of parallel.use_mesh that shards each
    compare sweep's blocks; raises if there is no card. Pass "cpu" to run
    the kernels' plain PyTorch versions on the CPU. Mutually exclusive
    with mesh.
    """
    # verbose >= 2 traces the call and prints each sample's own counters
    # and phases
    with trace.tracing(int(verbose) >= 2), PHASES("dada.call"):
        return _dada(derep, err, errorEstimationFunction, selfConsist, pool,
                     priors, int(verbose), multithread, checkpoint, mesh,
                     device, opt_overrides)


def _dada(derep, err, errorEstimationFunction, selfConsist, pool, priors,
          verbose, multithread, checkpoint, mesh, device, opt_overrides):
    if mesh is not None and device is not None:
        raise ValueError("dada(): mesh and device are mutually exclusive")
    if device is not None:
        device = resolve_device(device)
    opts = current_options().replace(**opt_overrides)

    # --- derep argument handling (R/dada.R:171-180) ---
    single_input = False
    input_names = None
    if isinstance(derep, Derep):
        derep = [derep]
        single_input = True
    elif isinstance(derep, str):
        d = derep_fastq(derep)
        if isinstance(d, Derep):
            derep = [d]
            single_input = True
        else:
            derep = list(d.values())
    elif isinstance(derep, dict):
        # R keeps the input list's names on the result (R/dada.R:478);
        # dict keys take precedence over each Derep's own name
        input_names = list(derep.keys())
        derep = list(derep.values())
    else:
        derep = [get_derep(d) for d in derep]

    priors = list(priors)

    # --- process topology (multi-process pools need it before combining) ---
    from .parallel.dist import mesh_processes, process_index, sample_devices

    procs = mesh_processes(mesh) if mesh is not None else [0]
    multihost = len(procs) > 1
    if multihost:
        my_rank = procs.index(process_index())
    mesh_devs = sample_devices(mesh)
    if mesh is not None and mesh_devs is None:
        raise ValueError("the mesh holds no device of this process")

    # --- pooling (R/dada.R:186-196) ---
    pseudo = False
    pseudo_priors: List[str] = []
    derep_in = None
    if len(derep) <= 1 and not multihost:
        pool = False
    if isinstance(pool, str):
        if pool == "pseudo":
            pool = False
            pseudo = True
        else:
            raise ValueError("Invalid pool argument.")
    elif pool:
        derep_in = derep
        with PHASES("dada.pool"):
            if multihost:
                # distributed dedup (SURVEY.md §7 hard-part 7): reads
                # never leave their process — only each sample's
                # dereplicated unique summaries are allgathered; every
                # process then builds the IDENTICAL pooled derep and runs
                # the pooled engine redundantly, splitting back only its
                # local samples.
                from .parallel.dist import gather_sample_summaries

                items = [((my_rank << 32) + i, d.name or f"p{my_rank}s{i}",
                          d.sequences, d.abundances, d.quals)
                         for i, d in enumerate(derep_in)]
                gathered = gather_sample_summaries(items)
                all_drps = [
                    Derep(uniques={s: int(a) for s, a in zip(seqs, ab)},
                          quals=quals, map=np.zeros(0, np.int64), name=name)
                    for _, name, seqs, ab, quals in gathered]
                pooled_drp = combine_dereps(all_drps)
                # this process's samples among the gathered ones
                keys = [g[0] for g in gathered]
                pool_index = [pooled_drp.pool_index[keys.index(it[0])]
                              for it in items]
            else:
                pooled_drp = combine_dereps(derep_in)
                pool_index = pooled_drp.pool_index
            derep = [pooled_drp]
            trace.COUNTERS.add("pooled_uniques", len(pooled_drp.uniques))
            if trace.is_on():
                trace.attrs(samples=len(pool_index),
                            uniques_in=int(sum(len(ix) for ix in pool_index)),
                            uniques_pooled=len(pooled_drp.uniques))

    # --- err validation (R/dada.R:198-205) ---
    initializeErr = False
    if selfConsist and err is None:
        initializeErr = True
    else:
        err = get_errors(err, enforce=True)

    opts.validate()
    opts = opts.normalized()

    if not opts.USE_QUALS:
        errorEstimationFunction = noqual_errfun
    elif errorEstimationFunction is None:
        errorEstimationFunction = loess_errfun

    # --- main loop (R/dada.R:256-405) ---
    cur = None
    nconsist = 0 if initializeErr else 1
    errs_history: List[np.ndarray] = []
    if checkpoint is not None and selfConsist:
        import os as _os
        if _os.path.exists(checkpoint):
            ck = np.load(checkpoint, allow_pickle=True)
            err = ck["err"]
            errs_history = [e for e in ck["history"]]
            nconsist = int(ck["nconsist"])
            pseudo_priors = [str(s) for s in ck["pseudo_priors"]]
            initializeErr = False
            if verbose:
                print(f"Resuming selfConsist from checkpoint round "
                      f"{nconsist}.")
    clustering = [None] * len(derep)
    clusterquals = [None] * len(derep)
    backends = [None] * len(derep)
    birth_subs = [None] * len(derep)
    trans = [None] * len(derep)
    maps = [None] * len(derep)
    pvals = [None] * len(derep)

    def _one_sample(i, drpi):
        with PHASES("sample"):
            if trace.is_on():
                trace.attrs(index=i, name=sample_names[i],
                            uniques=len(drpi.uniques),
                            reads=int(drpi.abundances.sum()),
                            round=nconsist)
            _sample(i, drpi)
            if verbose >= 2:
                print("   " + trace.unit_report())

    def _sample(i, drpi):
        seqs = drpi.sequences
        if not all(is_acgt(seqs)):
            raise ValueError("Sequences must be made up only of A/C/G/T.")
        if opts.USE_QUALS:
            if drpi.quals is None:
                raise ValueError("derep must include quals if USE_QUALS.")
            qmax = int(np.ceil(np.nanmax(drpi.quals)))
            if qmax > 250:
                raise ValueError(f"Invalid maximum quality score {qmax}.")
        else:
            qmax = 0
        if initializeErr:
            erri = np.ones((16, max(41, qmax + 1)))
        else:
            erri = np.asarray(err, dtype=np.float64)
        # extend error matrix by repeating the last column (R/dada.R:302-313)
        if erri.shape[1] < qmax + 1:
            extra = np.tile(erri[:, -1:], (1, qmax + 1 - erri.shape[1]))
            erri = np.hstack([erri, extra])

        prset = set(priors) | set(pseudo_priors)
        prior_flags = [s in prset for s in seqs]
        if backends[i] is None:
            # one backend per sample for the WHOLE selfConsist loop:
            # packed candidate tiles, kmer tables and geometry caches
            # are error-independent, so later rounds skip their rebuild
            with PHASES("dada.backend_init"):
                rawset = make_rawset(seqs, drpi.abundances, prior_flags,
                                     drpi.quals if opts.USE_QUALS else None)
                backends[i] = _make_backend(
                    rawset, opts, True, erri.shape[1],
                    device=(mesh_devs[i % len(mesh_devs)] if mesh_devs
                            else device))
        res = dada_uniques(
            seqs, drpi.abundances, prior_flags, erri,
            drpi.quals if opts.USE_QUALS else None, opts,
            max_clust=1 if initializeErr else opts.MAX_CLUST,
            use_quals=True,  # R passes TRUE unconditionally (R/dada.R:344)
            backend=backends[i],
        )
        clustering[i] = res["clustering"]
        clusterquals[i] = res["clusterquals"].T
        birth_subs[i] = res["birth_subs"]
        trans[i] = res["subqual"]
        maps[i] = res["map"]
        pvals[i] = res["pval"]
        if verbose and nconsist <= 1:
            nread = int(drpi.abundances.sum())
            print(f"Sample {i + 1} - {nread} reads in "
                  f"{len(seqs)} unique sequences.")

    # multi-process mesh: each process passes (and drives) ITS OWN
    # samples — derep IO is never duplicated across processes. The 16 x Q
    # tally is reduced globally every round, so the error model (and the
    # selfConsist stopping decision) is bit-identical on every process;
    # each returns its own samples' results. With pool=TRUE every process
    # holds the identical pooled derep (built above), runs the
    # deterministic pooled engine redundantly, and the tally is NOT
    # globally summed (it would count the pooled sample once per process).
    own = list(range(len(derep)))
    redundant_pool = multihost and derep_in is not None

    # thread-pool over samples: per-sample engines are independent, and
    # interleaving them overlaps device dispatch/fetch latency with the
    # other samples' host bookkeeping (replaces the reference's
    # per-sample fork, R/filter.R:461-477 idiom)
    nworkers = 1
    if multithread and len(derep) > 1:
        import os as _os
        nworkers = min(len(derep),
                       int(multithread) if not isinstance(multithread, bool)
                       else max(2, (_os.cpu_count() or 2) // 2))

    sample_names = (input_names if input_names is not None
                    and len(input_names) == len(derep) else
                    [d.name or str(k) for k, d in enumerate(derep)])
    trace.attrs(samples=len(derep), workers=nworkers)

    while True:
        if nconsist > 0:
            errs_history.append(np.asarray(err))
        todo = [(i, derep[i]) for i in own]
        if nworkers > 1:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=nworkers) as ex:
                list(ex.map(lambda a: _one_sample(*a), todo))
        else:
            for i, drpi in todo:
                _one_sample(i, drpi)

        if multihost and not redundant_pool:
            # exact cross-process reduction (one int64 all_reduce)
            from .parallel.dist import accumulate_trans_global

            with PHASES("dada.trans_global"):
                cur = accumulate_trans_global([trans[i] for i in own], mesh)
        elif mesh is not None and not multihost:
            # reduction over the mesh's devices
            from .parallel.dist import accumulate_trans_mesh

            with PHASES("dada.trans_mesh"):
                cur = accumulate_trans_mesh(mesh, trans)
        else:
            # meshless, or every process's identical pooled tally
            cur = accumulate_trans(trans)

        if errorEstimationFunction is None:
            err = None
        else:
            try:
                with PHASES("dada.errfun"):
                    err = errorEstimationFunction(cur)
            except Exception:
                if selfConsist or verbose >= 2:
                    print("Error rates could not be estimated.")
                err = None
        if selfConsist:
            get_errors(err, enforce=True)
        if initializeErr:
            initializeErr = False
            err[[0, 5, 10, 15], :] = 1.0  # pin self-transitions (R/dada.R:387)

        done = (not selfConsist
                or any(np.array_equal(e, err) for e in errs_history)
                or nconsist >= opts.MAX_CONSIST)
        if done and (not pseudo or nconsist >= 2):
            break

        if pseudo and nconsist >= 1:
            # prior selection by the prevalence/abundance thresholds the
            # sequence table applies (R/dada.R:399-401)
            if multihost:
                # across processes: allgather every process's per-sample
                # (ASV sequence, abundance) summaries, so that every
                # process selects the same priors in the same order
                # (first encounter)
                from .parallel.dist import gather_sample_summaries

                gathered = gather_sample_summaries(
                    [((my_rank << 32) + k, f"p{my_rank}s{k}",
                      list(cl["sequence"]), cl["abundance"].to_numpy(), None)
                     for k, cl in enumerate(clustering)])
                tot: dict = {}
                nsam: dict = {}
                for _, _, seqs_g, ab_g, _ in gathered:
                    for s, a in zip(seqs_g, ab_g):
                        tot[s] = tot.get(s, 0) + int(a)
                        if a > 0:
                            nsam[s] = nsam.get(s, 0) + 1
                pseudo_priors = [
                    s for s in tot
                    if nsam.get(s, 0) >= opts.PSEUDO_PREVALENCE
                    or tot[s] >= opts.PSEUDO_ABUNDANCE]
            else:
                # one process: the sequence table's columns, in its order
                # (decreasing total abundance), as the checkpoint keeps them
                from .seqtab import make_sequence_table

                st = make_sequence_table({str(k): clustering[k]
                                          for k in range(len(clustering))})
                prevalence = (st.values > 0).sum(axis=0)
                totals = st.values.sum(axis=0)
                keep = ((prevalence >= opts.PSEUDO_PREVALENCE)
                        | (totals >= opts.PSEUDO_ABUNDANCE))
                pseudo_priors = [c for c, k in zip(st.columns, keep) if k]

        nconsist += 1
        if checkpoint is not None and selfConsist:
            hist = (np.stack(errs_history) if errs_history
                    else np.zeros((0,) + np.asarray(err).shape))
            np.savez(checkpoint if checkpoint.endswith(".npz")
                     else checkpoint + ".npz_tmp", err=err,
                     history=hist, nconsist=nconsist,
                     pseudo_priors=np.array(pseudo_priors, dtype=object))
            if not checkpoint.endswith(".npz"):
                import os as _os
                _os.replace(checkpoint + ".npz_tmp.npz", checkpoint)

    if selfConsist and verbose:
        if nconsist >= opts.MAX_CONSIST:
            print("Self-consistency loop terminated before convergence.")
        else:
            print(f"Convergence after {nconsist} rounds.")

    # --- construct return objects (R/dada.R:416-440) ---
    results = []
    for i, drpi in enumerate(derep):
        cl = clustering[i]
        denoised = {s: int(a) for s, a in
                    zip(cl["sequence"], cl["abundance"])}
        results.append(DadaResult(
            denoised=denoised, clustering=cl,
            sequence=list(cl["sequence"]), quality=clusterquals[i],
            birth_subs=birth_subs[i], trans=trans[i], map=maps[i],
            pval=pvals[i],
            err_in=errs_history if selfConsist else errs_history[0],
            err_out=err, opts=opts, name=drpi.name,
        ))

    # --- pool=True: split pooled result back per sample (R/dada.R:443-475) ---
    if derep_in is not None:
        with PHASES("dada.split"):
            results = [_split_pooled(results[0], ix, drpi)
                       for ix, drpi in zip(pool_index, derep_in)]
        derep = derep_in

    if len(results) == 1 and single_input:
        return results[0]
    if input_names is not None and len(input_names) == len(results):
        names = input_names
    else:
        names = [d.name or str(i) for i, d in enumerate(derep)]
    return dict(zip(names, results))
