"""smithwaterman_tpu — a pairwise sequence-alignment framework on JAX.

A ground-up JAX/XLA re-design, with a CUDA fill kernel for NVIDIA GPUs, of
the capabilities of the reference `yamule/smithwaterman` suite:
Smith-Waterman (local), Needleman-Wunsch (global) and end-gap-free (glocal)
affine alignment, string-exact with EMBOSS water/needle; FASTA I/O; scoring matrices (BLOSUM62, match/mismatch, file
parser, position-specific); batch and clustering drivers; multi-card scaling
via jax.sharding.
"""

from .utils.jaxcache import enable_compilation_cache as _enable_cache

_enable_cache()

from .config import GLOBAL, GLOCAL, LOCAL, AlignConfig
from .aligner import Aligner, AlignResult
from .batch_aligner import BatchAligner
from .io.fasta import SeqData, load_fasta
from .matrices import PositionSpecificMatrix, SubstitutionMatrix

__version__ = "0.1.0"

__all__ = [
    "GLOBAL",
    "GLOCAL",
    "LOCAL",
    "AlignConfig",
    "Aligner",
    "AlignResult",
    "BatchAligner",
    "SeqData",
    "load_fasta",
    "SubstitutionMatrix",
    "PositionSpecificMatrix",
]
