"""detect: the flagship pipeline — per-thymidine BrdU/EdU probabilities.

Batched re-design of ``detect_main`` (reference: src/detect.cpp:735-920):

  read source -> prep (events/scaling/banded, batched on device)
              -> eventalign wavefront (batched windowed Viterbi on device)
              -> CNN forward (batched, bucketed by position count)
              -> per-read call tables -> writer (human-readable / modbam)

Reads fail the same QC gates as the reference (banded QC, Theil-Sen
sentinel); failures are counted, not fatal (detect.cpp:878-897).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import jax
import jax.numpy as jnp

from ..config import SubstrateConfig, DNA_R10
from ..io.poremodel import PoreModelSet
from ..models import cnn as cnn_mod
from ..parallel import compute
from ..utils.seqtools import _COMP_TABLE as _COMP_U8
from .eventalign import AlignedPositions, run_eventalign
from .prep import PreparedRead, prepare_reads
from .source import ReadRecord


@dataclass
class DetectedRead:
    """Per-read detect output (mirrors the call side of DNAscent::read)."""

    record: ReadRecord
    # per *output* position (centre base T), ascending genome coordinate
    ref_coords: np.ndarray      # (C,) int64
    edu_prob: np.ndarray        # (C,) float32
    brdu_prob: np.ndarray       # (C,) float32
    kmer_starts: np.ndarray     # (C,) int64 into record.reference_seq
    # modbam side: per-position query indices in sequencing orientation,
    # filtered by the deletion mask (detect.cpp:704)
    query_indices: np.ndarray   # (Cq,) int64
    edu_prob_q: np.ndarray
    brdu_prob_q: np.ndarray
    _kmers: Optional[list] = None

    @property
    def kmers_ref(self) -> list:
        """Reference-oriented 9-mer strings, built lazily (only the
        human-readable writer needs them) from one vectorised byte-window
        pass instead of per-position string slicing."""
        if self._kmers is None:
            k = 9
            seq = np.frombuffer(self.record.reference_seq.encode("ascii"),
                                np.uint8)
            if seq.shape[0] < k or self.kmer_starts.shape[0] == 0:
                self._kmers = [""] * self.kmer_starts.shape[0]
                return self._kmers
            wins = np.lib.stride_tricks.sliding_window_view(
                seq, k)[self.kmer_starts]
            if self.record.is_reverse:
                wins = _COMP_U8[wins][:, ::-1]
            flat = wins.tobytes()
            self._kmers = [flat[i : i + k].decode("ascii")
                           for i in range(0, len(flat), k)]
        return self._kmers


@dataclass
class DetectStats:
    processed: int = 0
    failed: int = 0


def _bucket_len(n: int) -> int:
    """Pad position counts to multiples of 2048 (powers of two waste up to
    half the padded transfer at long read lengths)."""
    if n <= 256:
        return 256
    return ((n + 2047) // 2048) * 2048


def _bucket_up(n: int, step: int) -> int:
    return max(step, ((n + step - 1) // step) * step)


def _pack_sig_stream(flat: np.ndarray):
    """Block-bit-pack the flat u8 CNN signal stream for upload
    (ops/blockpack.py): nanopore signal uses ~6 of its 8 quantised bits per
    128-sample block, so the pipeline's largest transfer shrinks ~25% with
    bit-exact device-side reconstruction.  Returns the device argument
    triple (payload, widths, mins) or None to use the unpacked path (packing
    disabled, or a pathological stream that doesn't compress).
    """
    import os
    if os.environ.get("DNASCENT_PACK_SIG", "1") == "0" or not flat.shape[0]:
        return None
    from ..ops import blockpack as bpk
    payload, widths, mins, n_pay = bpk.pack_u8_host(flat)
    # 32 KB payload buckets: fine enough to keep the saving, coarse enough
    # that a long run sees only a handful of distinct executables
    n_bucket = _bucket_up(n_pay, 1 << 15)
    if n_bucket >= flat.shape[0]:
        return None    # incompressible; ship the plain stream
    pay = np.zeros(n_bucket, dtype=np.uint8)
    pay[:n_pay] = payload[:n_pay]
    return (compute.put_rep(pay), compute.put_rep(widths),
            compute.put_rep(mins))


def _pack_aux_stream(counts: np.ndarray, ks_delta_u8: np.ndarray):
    """Pack the per-position sample counts (values 0..RAWDEPTH, ~5 bits) and
    kmer-start deltas (0..a few, ~2 bits) as one concatenated u8 stream —
    together they are the second-largest per-batch upload after the signal.
    Returns the (payload, widths, mins) device triple or None."""
    import os
    if os.environ.get("DNASCENT_PACK_SIG", "1") == "0":
        return None
    from ..ops import blockpack as bpk
    aux = np.concatenate([counts.reshape(-1), ks_delta_u8.reshape(-1)])
    payload, widths, mins, n_pay = bpk.pack_u8_host(aux)
    n_bucket = _bucket_up(n_pay, 1 << 14)
    if n_bucket >= aux.shape[0]:
        return None
    pay = np.zeros(n_bucket, dtype=np.uint8)
    pay[:n_pay] = payload[:n_pay]
    return (compute.put_rep(pay), compute.put_rep(widths),
            compute.put_rep(mins))


def _pack_td_stream(t_delta_u16: np.ndarray):
    """Pack the u16 centre-T index increments (typical spacing 1..8 → ~4 of
    16 bits).  Returns the (payload, widths, mins) device triple or None."""
    import os
    if os.environ.get("DNASCENT_PACK_SIG", "1") == "0":
        return None
    from ..ops import blockpack as bpk
    payload, widths, mins, n_pay = bpk.pack_u16_host(t_delta_u16)
    n_bucket = _bucket_up(n_pay, 1 << 12)
    if n_bucket >= 2 * t_delta_u16.shape[0]:
        return None
    pay = np.zeros(n_bucket, dtype=np.uint8)
    pay[:n_pay] = payload[:n_pay]
    return (compute.put_rep(pay), compute.put_rep(widths),
            compute.put_rep(mins))


class _PosChunk:
    """A halo-padded slice of one read's AlignedPositions for chunked CNN
    inference over ultra-long reads (SURVEY §5 long-context: the conv
    stack's receptive field is local, so chunking with a halo is exact).

    Rows [lo, hi) of the parent enter the CNN; only the core rows
    [core_lo, core_hi) — whose distance to the chunk edge exceeds the
    receptive field — contribute output T positions."""

    __slots__ = ("parent", "lo", "hi", "core_lo", "core_hi", "flat_lo",
                 "flat_hi", "order")

    def __init__(self, pos: AlignedPositions, lo, hi, core_lo, core_hi,
                 flat_bounds, order):
        self.parent = pos
        self.lo, self.hi = lo, hi
        self.core_lo, self.core_hi = core_lo, core_hi
        self.flat_lo, self.flat_hi = flat_bounds
        self.order = order

    @property
    def coord(self):
        return self.parent.coord[self.lo : self.hi]

    @property
    def kmer_start(self):
        return self.parent.kmer_start[self.lo : self.hi]

    @property
    def signal_u8_flat(self):
        if self.parent.signal_u8_flat is None:
            return None
        return self.parent.signal_u8_flat[self.flat_lo : self.flat_hi]

    @property
    def signal_counts(self):
        return self.parent.signal_counts[self.lo : self.hi]

    @property
    def signal(self):
        return self.parent.signal[self.lo : self.hi]

    @property
    def n_signals(self):
        return self.parent.n_signals[self.lo : self.hi]

    @property
    def core_idx(self):
        return self.parent.core_idx[self.lo : self.hi]

    @property
    def residual_idx(self):
        return self.parent.residual_idx[self.lo : self.hi]

    @property
    def center_is_T(self):
        # only the core region emits outputs; halo rows are masked off
        m = self.parent.center_is_T[self.lo : self.hi].copy()
        m[: self.core_lo - self.lo] = False
        m[self.core_hi - self.lo :] = False
        return m


def _chunk_positions(pos: AlignedPositions, chunk: int, halo: int):
    """Split one read's positions into halo-padded chunks (exact for any
    local receptive field <= halo)."""
    n = pos.coord.shape[0]
    if pos.signal_u8_flat is not None:
        flat_offs = np.concatenate(
            [[0], np.cumsum(pos.signal_counts.astype(np.int64))])
    out = []
    order = 0
    for core_lo in range(0, n, chunk):
        core_hi = min(n, core_lo + chunk)
        lo = max(0, core_lo - halo)
        hi = min(n, core_hi + halo)
        fb = ((int(flat_offs[lo]), int(flat_offs[hi]))
              if pos.signal_u8_flat is not None else (0, 0))
        out.append(_PosChunk(pos, lo, hi, core_lo, core_hi, fb, order))
        order += 1
    return out


# positions per CNN call before halo chunking kicks in; the halo is sized
# from the model's receptive field at call time
CNN_CHUNK_POSITIONS = int(__import__("os").environ.get(
    "DNASCENT_CNN_CHUNK", str(32768)))


def run_cnn_batched(model, params, results: dict, prepped: list[PreparedRead],
                    batch_positions: int = 1 << 19,
                    chunk_positions: Optional[int] = None):
    """Run the CNN over all QC-passed reads, bucketing by padded position
    count.  Returns {read_id: (Ct,3) float32 probabilities at the read's
    centre-T positions}, in AlignedPositions order restricted to
    ``center_is_T`` (the only positions the reference reports,
    detect.cpp:690).  Signal windows travel as a flat u8 sample stream +
    per-position counts and only T-position probabilities come back, so
    both transfer directions stay small.

    Ultra-long reads (> ``chunk_positions`` aligned positions) are split
    into halo-padded chunks sized to the model's receptive field, so a 1 Mb
    read reuses the same compiled kernel buckets as everything else instead
    of compiling (and padding) a megaposition tensor (SURVEY §7.3 item 3).
    Chunking is logically exact (the halo covers the receptive field;
    asserted bitwise on CPU); on an accelerator the bf16 convolutions of
    different padded-length buckets accumulate in different orders, so
    chunked and unchunked probabilities can differ by ~1e-3 — the same
    noise class any length-bucket change produces, far below call
    thresholds.
    """
    if chunk_positions is None:
        chunk_positions = CNN_CHUNK_POSITIONS
    halo = 512
    rf = getattr(model, "receptive_field", None)
    if callable(rf):
        halo = max(256, int(-(-model.receptive_field() // 256)) * 256)
    jobs = []
    for p in prepped:
        res = results.get(p.record.read_id)
        if res is None or not res.qc_passed or res.positions is None:
            continue
        pos = res.positions
        if pos.coord.shape[0] > chunk_positions:
            for ch in _chunk_positions(pos, chunk_positions, halo):
                jobs.append((p, ch))
        else:
            jobs.append((p, pos))
    out: dict[str, np.ndarray] = {}
    parts: dict[str, list] = {}
    buckets: dict[int, list] = {}
    for p, pos in jobs:
        buckets.setdefault(_bucket_len(pos.coord.shape[0]), []).append((p, pos))
    # rank-derived path: when every read in a chunk shares prep's resident
    # flat rank array and its kmer_start increments fit u16, the two i16
    # sequence-index planes are replaced by one u16 delta plane (half the
    # bytes) and derived on device
    dispatched = []
    for L, group in sorted(buckets.items()):
        # batch size bounded so padded tensors stay modest
        bs = max(1, batch_positions // L)
        for i in range(0, len(group), bs):
            chunk = group[i : i + bs]
            # rows padded to the compute mesh's data extent (padded rows
            # have zero counts / index 0 and are never gathered)
            B = compute.pad_rows(len(chunk))
            shared_flat = chunk[0][0].flat_ranks_device
            use_ranks = shared_flat is not None and all(
                p.flat_ranks_device is shared_flat for p, _ in chunk)
            counts = np.zeros((B, L), dtype=np.uint8)
            ks_base = np.zeros(B, dtype=np.int32)
            ks_delta32 = np.zeros((B, L), dtype=np.int32)
            flat_off = np.zeros(B, dtype=np.int32)
            n_pos = np.zeros(B, dtype=np.int32)
            core = resid = None
            flats = []
            t_idx_parts = []
            t_spans = []
            for b, (p, pos) in enumerate(chunk):
                n = pos.coord.shape[0]
                if use_ranks:
                    d = np.diff(pos.kmer_start, prepend=pos.kmer_start[:1])
                    if d.min() < 0 or d.max() >= (1 << 16):
                        use_ranks = False
                    else:
                        ks_base[b] = pos.kmer_start[0]
                        ks_delta32[b, :n] = d
                        flat_off[b] = p.flat_ranks_offset
                        n_pos[b] = n
                if pos.signal_u8_flat is not None:
                    # fast path: eventalign already built the stream
                    counts[b, :n] = pos.signal_counts
                    flats.append(pos.signal_u8_flat)
                else:
                    q = cnn_mod.quantise_signal_u8(pos.signal)
                    c = np.minimum(pos.n_signals,
                                   cnn_mod.RAWDEPTH).astype(np.uint8)
                    counts[b, :n] = c
                    take = (np.arange(cnn_mod.RAWDEPTH)[None, :]
                            < c[:, None].astype(np.int64))
                    flats.append(q[take])
                tpos = np.flatnonzero(pos.center_is_T).astype(np.int64)
                t_idx_parts.append(b * L + tpos)
                t_spans.append(tpos.shape[0])
            if not use_ranks:
                core = np.zeros((B, L), dtype=np.int16)
                resid = np.zeros((B, L), dtype=np.int16)
                for b, (p, pos) in enumerate(chunk):
                    n = pos.coord.shape[0]
                    core[b, :n] = pos.core_idx
                    resid[b, :n] = pos.residual_idx
            flat = np.concatenate(flats) if flats else np.zeros(0, np.uint8)
            flat = np.pad(flat, (0, _bucket_up(flat.shape[0], 1 << 18)
                                 - flat.shape[0]))
            t_index = (np.concatenate(t_idx_parts) if t_idx_parts
                       else np.zeros(0, np.int64))
            nt = t_index.shape[0]
            # ship T positions as index increments: u16 when they fit
            # (always, for position buckets below ~32k), i32 otherwise —
            # the jitted gather cumsums either dtype
            t_delta = np.diff(t_index, prepend=np.int64(0))
            t_delta = np.pad(t_delta, (0, _bucket_up(nt, 1 << 13) - nt))
            t_delta = (t_delta.astype(np.uint16)
                       if (nt == 0 or t_delta.max() < (1 << 16))
                       else t_delta.astype(np.int32))
            # kmer-start deltas likewise drop to u8 when they fit (the
            # common case: consecutive positions advance by 0..a few bases)
            sig_args = _pack_sig_stream(flat)
            if use_ranks:
                ks_delta = (ks_delta32.astype(np.uint8)
                            if ks_delta32.max(initial=0) < 256
                            else ks_delta32.astype(np.uint16))
                aux_args = td_args = None
                if (sig_args is not None and ks_delta.dtype == np.uint8
                        and t_delta.dtype == np.uint16):
                    aux_args = _pack_aux_stream(counts, ks_delta)
                    td_args = _pack_td_stream(t_delta)
                if aux_args is not None and td_args is not None:
                    probs_dev = cnn_mod.apply_model_from_flat_ranks_f16_packed(
                        model, params, compute.put_rows(ks_base),
                        compute.put_rows(flat_off), compute.put_rows(n_pos),
                        shared_flat, *sig_args, *aux_args, *td_args, L=L)
                else:
                    probs_dev = cnn_mod.apply_model_from_flat_ranks_f16(
                        model, params, compute.put_rows(ks_base),
                        compute.put_rows(ks_delta), compute.put_rows(flat_off),
                        compute.put_rows(n_pos), shared_flat,
                        compute.put_rep(flat), compute.put_rows(counts),
                        compute.put_rep(t_delta))
            elif sig_args is not None:
                probs_dev = cnn_mod.apply_model_flat_f16_packed(
                    model, params, compute.put_rows(core),
                    compute.put_rows(resid), *sig_args,
                    compute.put_rows(counts), compute.put_rep(t_delta))
            else:
                probs_dev = cnn_mod.apply_model_flat_f16(
                    model, params, compute.put_rows(core),
                    compute.put_rows(resid), compute.put_rep(flat),
                    compute.put_rows(counts), compute.put_rep(t_delta))
            from .eventalign import _enqueue_d2h
            _enqueue_d2h(probs_dev)
            dispatched.append((chunk, t_spans, probs_dev))
    for chunk, t_spans, probs_dev in dispatched:
        probs = np.asarray(probs_dev).astype(np.float32)
        o = 0
        for (p, pos), ct in zip(chunk, t_spans):
            if isinstance(pos, _PosChunk):
                parts.setdefault(p.record.read_id, []).append(
                    (pos.order, probs[o : o + ct]))
            else:
                out[p.record.read_id] = probs[o : o + ct]
            o += ct
    for rid, lst in parts.items():
        lst.sort(key=lambda t: t[0])
        out[rid] = np.concatenate([a for _, a in lst])
    return out


def collect_calls(rec: ReadRecord, pos: AlignedPositions,
                  probs_t: np.ndarray) -> DetectedRead:
    """Unpack CNN output per the reference's runCNN bookkeeping
    (detect.cpp:686-714).  ``probs_t`` holds probabilities at the read's
    centre-T positions only (run_cnn_batched gathers them on device);
    columns are [BrdU, EdU] (the unmodified-T column never leaves the
    device — detect reports only these two, detect.cpp:698)."""
    sel = pos.center_is_T
    coords = pos.coord[sel]
    brdu = probs_t[:, 0].astype(np.float32)
    edu = probs_t[:, 1].astype(np.float32)
    # modbam side: skip positions whose reference index is in a deletion
    qsel_t = ~rec.ref_to_del[pos.ref_idx[sel]]
    return DetectedRead(
        record=rec,
        ref_coords=coords,
        edu_prob=edu,
        brdu_prob=brdu,
        kmer_starts=pos.kmer_start[sel],
        query_indices=pos.query_idx[sel][qsel_t],
        edu_prob_q=edu[qsel_t],
        brdu_prob_q=brdu[qsel_t],
    )


def detect_reads(records: Iterable[ReadRecord], models: PoreModelSet,
                 model=None, params=None, cfg: SubstrateConfig = DNA_R10,
                 batch_size: int = 32, stats: Optional[DetectStats] = None,
                 collect_failures: bool = False, strict_windows: bool = False,
                 pipeline_depth: int = 10, timer=None):
    """Generator over DetectedRead results, processing in read batches.

    Batches are software-pipelined ``pipeline_depth`` deep across worker
    threads: the per-batch stage chain (prep -> eventalign -> CNN) has three
    unavoidable host<->device sync points; overlapping batch k's device
    waits with batch k±1's host numpy hides most of both.  Output order is
    preserved (results are consumed in batch submission order), matching
    the reference's buffered OpenMP loop + ordered writer
    (detect.cpp:852-906).

    Defaults (batch 32, depth 10) are not yet tuned on the GPU; host memory
    in flight scales as batch_size x depth x raw bytes
    (~50 MB at 10 kb, ~3 GB at 1 Mb reads) — drop both for ultra-long
    datasets on small hosts.
    """
    if model is None:
        model = cnn_mod.create_model()
    if params is None:
        params = cnn_mod.default_params(model)
    # CNN params ride replicated over the active compute mesh (the
    # reference replicates its SavedModel per GPU; SURVEY §2.3)
    params = compute.put_rep_tree(params)

    # optional utils.progress.StageTimer: per-stage wall-clock telemetry
    # (the framework's replacement for the reference's commented chrono
    # probes, event_handling.cpp:150-151).  Totals are approximate when
    # pipeline workers overlap (telemetry, not accounting).
    from contextlib import nullcontext
    tctx = ((lambda name: timer.time(name)) if timer is not None
            else (lambda name: nullcontext()))

    def process(batch):
        with tctx("prep(events+scaling+banded)"):
            prepped = prepare_reads(batch, models, cfg)
        with tctx("eventalign(viterbi)"):
            results = run_eventalign(prepped, models, cfg, collect_text=False,
                                     strict=strict_windows)
        with tctx("cnn_forward"):
            probs_by_read = run_cnn_batched(model, params, results, prepped)
        out = []
        for p in prepped:
            rid = p.record.read_id
            res = results.get(rid)
            if (res is None or not res.qc_passed or res.positions is None
                    or rid not in probs_by_read):
                out.append((rid, None))
                continue
            out.append((rid, collect_calls(p.record, res.positions,
                                           probs_by_read[rid])))
        return out

    # prefetch record batches (signal IO / pod5 decompress) on a thread
    # while earlier batches run
    import threading
    import queue
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    q: "queue.Queue" = queue.Queue(maxsize=pipeline_depth)

    def producer():
        cur: list[ReadRecord] = []
        try:
            for rec in records:
                cur.append(rec)
                if len(cur) >= batch_size:
                    q.put(cur)
                    cur = []
            if cur:
                q.put(cur)
            q.put(None)
        except BaseException as e:  # re-raised on the consumer side
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()

    def drain(fut):
        for rid, d in fut.result():
            if d is None:
                if stats is not None:
                    stats.failed += 1
                    stats.processed += 1
                if collect_failures:
                    yield rid, None
            else:
                if stats is not None:
                    stats.processed += 1
                yield rid, d

    with ThreadPoolExecutor(max_workers=pipeline_depth) as ex:
        pending: deque = deque()
        while True:
            batch = q.get()
            if batch is None:
                break
            if isinstance(batch, BaseException):
                t.join()
                raise batch
            pending.append(ex.submit(process, batch))
            while len(pending) >= pipeline_depth:
                yield from drain(pending.popleft())
        while pending:
            yield from drain(pending.popleft())
    t.join()
