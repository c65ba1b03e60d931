"""dnascent_tpu — a nanopore base-analogue detection framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of MBoemo/DNAscent
v4.1.1: BrdU/EdU detection in Oxford Nanopore R10.4.1 reads, replication
fork / origin / termination / stall calling, and DNA break frequency
analysis — built for accelerators (batched padded kernels, SPMD over device
meshes) rather than per-read CPU threads.  The accelerator it is measured on
is an NVIDIA H100; ``dnascent_tpu.platform`` says which kernel each platform
gets.

Subcommand parity with the reference binary:

    index | detect | align | forkSense | seeBreaks | trainCNN | trainGMM

See ``dnascent_tpu.cli`` (or the ``dnascent-tpu`` console entry point).
"""

__version__ = "0.1.0"

from .utils.jaxcache import enable_compilation_cache as _ecc

_ecc()

from .config import DNA_R10, SubstrateConfig, get_config  # noqa: F401
