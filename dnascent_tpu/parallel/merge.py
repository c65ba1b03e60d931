"""Deterministic merge of per-host pipeline outputs.

The reference is single-process, so output order is BAM record order
(SURVEY §5).  In a multi-host deployment each host writes its shard's
results to ``<out>.host<k>``; this module merges them into one file in a
canonical order — (contig, refStart, refEnd, readID) — so results are
byte-stable regardless of host count or scheduling.

Merging streams: shards are indexed first (one (sort_key, file offset,
length) tuple per read block), the index is sorted, and blocks are copied
by seek+read — memory stays O(#reads), not O(file bytes), which matters for
PromethION-scale detect files (tens of GB).
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass
class _Block:
    key: tuple
    path_i: int
    offset: int
    length: int


def _index_blocks(path: str, path_i: int):
    """Scan a detect/forkSense/align-style file once, recording the byte
    span of each ``>readID ...`` block and passing through the header."""
    header_lines = []
    blocks: list[_Block] = []
    cur_key = None
    cur_off = 0
    off = 0
    with open(path, "rb") as fh:
        for line in fh:
            if line.startswith(b"#"):
                header_lines.append(line.decode())
                off += len(line)
                continue
            if line.startswith(b">"):
                if cur_key is not None:
                    blocks.append(_Block(cur_key, path_i, cur_off,
                                         off - cur_off))
                fields = line[1:].split()
                # (contig, refStart, refEnd, readID)
                cur_key = (fields[1].decode(), int(fields[2]),
                           int(fields[3]), fields[0].decode())
                cur_off = off
            off += len(line)
    if cur_key is not None:
        blocks.append(_Block(cur_key, path_i, cur_off, off - cur_off))
    return "".join(header_lines), blocks


def merge_host_outputs(shard_paths: list[str], output_path: str) -> int:
    """Merge per-host human-readable outputs deterministically (streaming —
    only the block index is held in memory).  Returns the number of reads
    written."""
    paths = sorted(shard_paths)
    header = ""
    all_blocks: list[_Block] = []
    for i, p in enumerate(paths):
        h, blocks = _index_blocks(p, i)
        if h and not header:
            header = h
        all_blocks.extend(blocks)
    all_blocks.sort(key=lambda b: b.key)
    handles = [open(p, "rb") for p in paths]
    try:
        with open(output_path, "wb") as out:
            out.write(header.encode())
            for b in all_blocks:
                fh = handles[b.path_i]
                fh.seek(b.offset)
                out.write(fh.read(b.length))
    finally:
        for fh in handles:
            fh.close()
    return len(all_blocks)


def merge_bed_outputs(shard_paths: list[str], output_path: str) -> int:
    """Merge per-host bed files: header from the first shard, rows sorted by
    (contig, start, end, readID)."""
    paths = sorted(shard_paths)
    header_lines: list[str] = []
    rows = []
    for i, p in enumerate(paths):
        with open(p) as fh:
            for line in fh:
                if line.startswith("#"):
                    if i == 0:
                        header_lines.append(line)
                    continue
                cols = line.split()
                if len(cols) >= 4:
                    rows.append(((cols[0], int(cols[1]), int(cols[2]),
                                  cols[3]), line))
    rows.sort(key=lambda r: r[0])
    with open(output_path, "w") as out:
        out.writelines(header_lines)
        for _, line in rows:
            out.write(line)
    return len(rows)


def host_shard_path(output_path: str, process_index: int) -> str:
    return f"{output_path}.host{process_index}"


def all_shards_present(output_path: str, process_count: int) -> bool:
    return all(os.path.exists(host_shard_path(output_path, i))
               for i in range(process_count))
