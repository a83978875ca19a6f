"""dada2_tpu_torch: DADA2 amplicon sample inference on PyTorch and CUDA.

The PyTorch/CUDA port of dada2_tpu, module for module. Host logic (engine,
exact lambdas, R-exact Poisson tails, loess, fastq io, the native C++
helpers) is carried over unchanged; the compare sweep runs on an NVIDIA
Hopper card through a hand-written wavefront Needleman-Wunsch kernel
(ops/nw_wavefront.py, csrc/nw_wavefront.cu). Entry points run on CUDA
unless given device="cpu", and raise when there is no card.

Ported so far: derep_fastq -> dada (incl. selfConsist, pool, pseudo) ->
learn_errors on one device, then make_sequence_table ->
remove_bimera_denovo (chimera removal through the kernel's pairs mode).
"""
# Allocator policy first: large numpy temporaries must reuse heap pages
# (see utils/hostmem.py).
from .utils.hostmem import tune_malloc as _tune_malloc

_tune_malloc()

from .options import (DadaOptions, DEFAULT_OPTIONS, get_dada_opt,
                      set_dada_opt)
from .derep import Derep, derep_fastq, combine_dereps
from .dada import DadaResult, dada, dada_uniques
from .errors import (loess_errfun, noqual_errfun, pacbio_errfun,
                     make_binned_qual_errfun, inflate_err, get_errors,
                     accumulate_trans)
from .encode import rc, is_acgt
from .learn import learn_errors
from .seqtab import (make_sequence_table, merge_sequence_tables,
                     get_uniques, get_sequences)
from .chimeras import (is_bimera, is_bimera_denovo, is_bimera_denovo_table,
                       remove_bimera_denovo)
from .core.backend_cuda import CudaBackend
from . import data, interop, trace
from .trace import COUNTERS, PHASES, profile_trace

__version__ = "0.1.0"
