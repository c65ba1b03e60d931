"""Build a complete on-disk synthetic dataset: FASTA + pod5/fast5 + BAM +
index — the same file quartet a DNAscent user feeds the reference binary.
Used by CLI end-to-end tests and benchmarks."""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..config import SubstrateConfig, DNA_R10
from ..io import bam as bam_io
from ..io import fasta as fasta_io
from ..io import fast5_io, pod5_io
from ..io.index_io import build_index
from ..io.poremodel import PoreModelSet
from ..testing.simulate import random_sequence, simulate_read
from ..utils.seqtools import reverse_complement


@dataclass
class SyntheticDataset:
    reference_fa: str
    bam: str
    signal_dir: str
    index: str
    read_ids: list


def build_dataset(outdir: str, models: PoreModelSet,
                  cfg: SubstrateConfig = DNA_R10, n_reads: int = 8,
                  read_length: int = 3000, contig_length: int = 50000,
                  signal_format: str = "fast5", seed: int = 0,
                  reverse_fraction: float = 0.3,
                  analogue_painter=None) -> SyntheticDataset:
    """Simulate reads from a random reference contig and write all files.

    Reads map perfectly (cigar = all-M), a fraction on the reverse strand.
    ``signal_format``: "fast5", "pod5" (VBZ rows) or "pod5_raw"
    (uncompressed pod5 rows).
    ``analogue_painter(seed, n_kmers) -> bool mask`` optionally paints
    analogue tracks.
    """
    os.makedirs(outdir, exist_ok=True)
    rng = np.random.default_rng(seed)
    contig = random_sequence(rng, contig_length)
    ref = {"chrS": contig}
    fa = os.path.join(outdir, "reference.fa")
    fasta_io.write_fasta(ref, fa)

    signal_dir = os.path.join(outdir, "signal")
    os.makedirs(signal_dir, exist_ok=True)

    reads = []
    records = []
    read_ids = []
    for i in range(n_reads):
        start = int(rng.integers(0, contig_length - read_length))
        refseq = contig[start : start + read_length]
        is_rev = rng.random() < reverse_fraction
        # sequencing-direction sequence
        seq_seq = reverse_complement(refseq) if is_rev else refseq
        mask = None
        if analogue_painter is not None:
            mask = analogue_painter(seed + i, read_length)
        sim = simulate_read(models.pore_model, cfg, seed=seed + i,
                            sequence=seq_seq,
                            analogue_model=models.analogue_model,
                            analogue_mask=mask)
        read_id = f"0000{i:04d}-0000-4000-8000-{seed:012d}"[-36:]
        read_id = f"{i:08x}-0000-4000-8000-{seed & 0xFFFFFFFFFFFF:012x}"
        read_ids.append(read_id)
        reads.append((read_id, sim.raw))
        flag = bam_io.FLAG_REVERSE if is_rev else 0
        # SAM stores SEQ in reference-forward orientation
        records.append(bam_io.build_record(
            read_id, 0, start, 60, [(bam_io.BAM_CMATCH, read_length)],
            refseq, flag=flag))

    if signal_format == "fast5":
        fast5_io.write_fast5(os.path.join(signal_dir, "batch0.fast5"), reads)
    else:
        # "pod5_raw": uncompressed signal rows (no zstd needed to read them)
        pod5_io.write_pod5(os.path.join(signal_dir, "batch0.pod5"), reads,
                           compress=signal_format != "pod5_raw")

    bam_path = os.path.join(outdir, "alignment.bam")
    header = "@HD\tVN:1.6\tSO:unknown\n@SQ\tSN:chrS\tLN:%d\n" % contig_length
    w = bam_io.BamWriter(bam_path, header, ["chrS"], [contig_length])
    for r in records:
        w.write_record(r)
    w.close()

    index_path = os.path.join(outdir, "index.dnascent")
    build_index(signal_dir, index_path)
    return SyntheticDataset(fa, bam_path, signal_dir, index_path, read_ids)
