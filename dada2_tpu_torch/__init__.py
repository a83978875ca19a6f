"""dada2_tpu_torch: DADA2 amplicon sample inference on PyTorch and CUDA.

The PyTorch/CUDA port of dada2_tpu, module for module. Host logic (engine,
exact lambdas, R-exact Poisson tails, loess, fastq io, the native C++
helpers) is carried over unchanged; the compare sweep runs on an NVIDIA
Hopper card through a hand-written wavefront Needleman-Wunsch kernel
(ops/nw_wavefront.py, csrc/nw_wavefront.cu), and every compare after a
bud screens its rows against the engine's store threshold on the card
and fetches only the shortlist, in one buffer (kernel B5,
ops/store_screen.py, csrc/store_screen.cu). Entry points run on CUDA
unless given device="cpu", and raise when there is no card.

Ported so far: derep_fastq -> dada (incl. selfConsist, pool, pseudo, and
the scalar, homopolymer, unbanded and wide-window aligners through the
batch aligner ops/nw_batch.py, csrc/nw_batch.cu) -> learn_errors on one
device, then merge_pairs -> make_sequence_table -> collapse_no_mismatch ->
remove_bimera_denovo (chimera removal through the kernel's pairs mode) ->
is_shift_denovo; and the workflow's two ends: filter_and_trim,
remove_primers and derep_fasta before dada (host code), assign_taxonomy
(its scorer in torch ops on the card), assign_species and add_species
after it, with the diagnostics, plots and reference-database builders;
and multi-device and multi-process runs (parallel/: dada(mesh=) over a
mesh's devices, a compare sweep's blocks sharded by use_mesh, the
collectives on torch.distributed).
"""
# Allocator policy first: large numpy temporaries must reuse heap pages
# (see utils/hostmem.py).
from .utils.hostmem import tune_malloc as _tune_malloc

_tune_malloc()

from .options import (DadaOptions, DEFAULT_OPTIONS, get_dada_opt,
                      set_dada_opt)
from .derep import Derep, derep_fastq, derep_fasta, combine_dereps
from .dada import DadaResult, dada, dada_uniques
from .errors import (loess_errfun, noqual_errfun, pacbio_errfun,
                     make_binned_qual_errfun, inflate_err, get_errors,
                     accumulate_trans)
from .encode import rc, is_acgt
from .learn import learn_errors
from .paired import (merge_pairs, nwalign, nwhamming, nweval,
                     nwextract, eval_pair, pair_consensus)
from .seqtab import (make_sequence_table, collapse_no_mismatch,
                     merge_sequence_tables, get_uniques, get_sequences,
                     uniques_to_fasta, seqtab_to_qiime)
from .chimeras import (is_bimera, is_bimera_denovo, is_bimera_denovo_table,
                       remove_bimera_denovo, is_shift_denovo)
from .filter import (filter_and_trim, fastq_filter, fastq_paired_filter,
                     is_phix, seq_complexity, remove_primers)
from .taxonomy import (assign_taxonomy, assign_species, add_species)
from .plot import plot_errors, plot_quality_profile, plot_complexity
from .diagnostics import (kmer_dist, kord_dist, kmer_matches,
                          kdist_matches, check_convergence, pfasta,
                          seqtab_to_mothur, samdf_to_qiime2)
from .core.backend_cuda import CudaBackend
from . import data, interop, refdb, trace
from .refdb import tax_check
from .trace import COUNTERS, PHASES, profile_trace

__version__ = "0.1.0"
