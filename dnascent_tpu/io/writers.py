"""Output writers for detect results.

``DetectHRWriter`` reproduces the reference's human-readable ``.detect``
format byte-for-byte modulo header provenance fields: ``#``-prefixed header
(detect.cpp:196-232), per-read ``>readID contig refStart refEnd strand``
records, and tab-separated ``coord  EdU  BrdU  kmer`` rows — note the
EdU-before-BrdU column order (detect.cpp:698, a documented reference quirk).
Reverse reads' rows are emitted in ascending-coordinate order via the same
line reversal as runCNN (detect.cpp:722).

Floats use 6 decimal places to match std::to_string.
"""

from __future__ import annotations

import datetime
import io
from typing import Optional

from .. import __version__
from ..pipeline.detect import DetectedRead


def detect_header(bam: str, reference: str, index: str, threads: int,
                  quality: int, length: int, compute: str = "CPU",
                  mode: str = "CNN") -> str:
    """``compute`` names the platform that ran detect (GPU or CPU)."""
    now = datetime.datetime.now().strftime("%d/%m/%Y %H:%M:%S")
    out = []
    out.append(f"#Alignment {bam}")
    out.append(f"#Genome {reference}")
    out.append(f"#Index {index}")
    out.append(f"#Threads {threads}")
    out.append(f"#Compute {compute}")
    out.append(f"#Mode {mode}")
    out.append(f"#MappingQuality {quality}")
    out.append(f"#MappingLength {length}")
    out.append(f"#SystemStartTime {now}")
    out.append("#Software dnascent_tpu")
    out.append(f"#Version {__version__}")
    out.append("#Commit none")
    return "\n".join(out) + "\n"


class DetectHRWriter:
    """Human-readable .detect writer (OutputWriter HR strategy,
    detect.h:21-64)."""

    def __init__(self, path: str, mode: str = "w"):
        self._fh: Optional[io.TextIOBase] = open(path, mode)

    def write_header(self, header: str) -> None:
        self._fh.write(header)

    def write(self, d: DetectedRead) -> None:
        rec = d.record
        lines = []
        for i in range(d.ref_coords.shape[0]):
            lines.append(f"{d.ref_coords[i]}\t{d.edu_prob[i]:.6f}"
                         f"\t{d.brdu_prob[i]:.6f}\t{d.kmers_ref[i]}")
        if rec.is_reverse:
            lines.reverse()
        self._fh.write(f">{rec.read_id} {rec.contig} {rec.ref_start} "
                       f"{rec.ref_end} {rec.strand}\n")
        if lines:
            self._fh.write("\n".join(lines) + "\n")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class AlignHRWriter:
    """Human-readable .align writer: passthrough of per-read eventalign text
    (alignment.cpp:701-736)."""

    def __init__(self, path: str):
        self._fh = open(path, "w")

    def write_text(self, text: str) -> None:
        self._fh.write(text)

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
