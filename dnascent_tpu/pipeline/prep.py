"""Pipeline stage 1-3: signal -> events -> scaling -> banded alignment.

This is the batched re-design of ``normaliseEvents`` (reference:
src/event_handling.cpp:544-607) plus the per-read front half of detect/align
(detect.cpp:852-887): instead of one read per OpenMP thread, reads are
prepared host-side, bucketed into padded batches, pushed through the batched
banded fill (the route ``platform.routes().banded_fill`` names), backtraced
natively on the host, and their scalings refined by the batched Theil-Sen
kernel.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from .. import platform
from ..config import SubstrateConfig, DNA_R10
from ..io.poremodel import PoreModelSet
from ..ops import banded, reference as refops, scaling
from ..parallel import compute
from ..utils.seqtools import kmer_ranks
from .source import ReadRecord
from .. import native


@dataclass
class PreparedRead:
    record: ReadRecord
    # merged events (first-event-zero-mean quirk preserved):
    event_mean: np.ndarray       # (E,) f64
    event_raw_start: np.ndarray  # (E,) i64
    event_raw_end: np.ndarray    # (E,) i64
    et_n: int                    # raw event count (for eventsPerBase)
    kmer_ranks_query: np.ndarray
    kmer_ranks_ref: np.ndarray
    shift: float = 0.0
    scale: float = 1.0
    events_per_base: float = 0.0
    event_alignment: np.ndarray = field(
        default_factory=lambda: np.empty((0, 2), dtype=np.int64))
    qc_fail_reason: Optional[str] = None
    # device-resident flat reference-rank array shared across the prep batch
    # (uploaded once; eventalign windows index into it by offset)
    flat_ranks_device: object = None
    flat_ranks_offset: int = 0
    # quantile-scaling parameters (pre-Theil-Sen; shift/scale above hold the
    # refined values after prep) + the banded fill's device-resident scaled
    # event array, so eventalign can rebuild its observation stream on device
    # instead of re-uploading it (obs = affine(events_dev[row]) since both
    # scalings are affine in the raw event mean)
    shift_q: float = 0.0
    scale_q: float = 1.0
    events_dev: object = None     # (B_g, E_g) f16/f32 fill input, resident
    events_row: int = -1          # this read's row in events_dev
    events_stride: int = 0        # E_g (row stride of events_dev)

    @property
    def passed(self) -> bool:
        return self.qc_fail_reason is None

    @property
    def n_events(self) -> int:
        return int(self.event_mean.shape[0])

    @property
    def n_kmers(self) -> int:
        return int(self.kmer_ranks_query.shape[0])


def _detect_and_merge(raw: np.ndarray, cfg: SubstrateConfig):
    ed = cfg.events
    if native.available():
        return native.event_detect(raw, ed.window_length1, ed.window_length2,
                                   ed.threshold1, ed.threshold2, ed.peak_height)
    et = refops.detect_events(raw, ed)
    me = refops.merge_events(et, raw.shape[0])
    return me.mean, me.raw_start, me.raw_end, me.n_raw_events


# reads per banded-fill dispatch on each device (detect's batch size)
FILL_BATCH = 32


def _bucket(value: int, step: int) -> int:
    return ((value + step - 1) // step) * step


def _enqueue_d2h(*arrays) -> None:
    """Non-blocking device->host copy start (see eventalign._enqueue_d2h)."""
    compute.count_d2h(*arrays)
    for a in arrays:
        try:
            a.copy_to_host_async()
        except AttributeError:
            pass


def _dispatch_fill(group, E, K, models, mesh, fill_kw):
    """Upload one bucket chunk and start its banded fill.  Returns the host
    scaled events and the device (trace, rights, best_event)."""
    # rows padded to the compute mesh's data extent (padded rows carry zero
    # events/kmers; their fill output is garbage-but-defined and never
    # decoded)
    B = compute.pad_rows(len(group))
    scaled = np.zeros((B, E), dtype=np.float32)
    n_ev = np.zeros(B, dtype=np.int32)
    n_km = np.zeros(B, dtype=np.int32)
    ranks = np.full((B, K), -1, dtype=np.int32)
    for b, p in enumerate(group):
        ne, nk = p.n_events, p.n_kmers
        scaled[b, :ne] = (p.event_mean - p.shift) / p.scale
        n_ev[b], n_km[b] = ne, nk
        # N-containing kmers take the A-substituted rank like the
        # reference's defaulting map (data_IO.cpp:131)
        ranks[b, :nk] = np.where(p.kmer_ranks_query < 0, 0,
                                 p.kmer_ranks_query)
        p.shift_q, p.scale_q = p.shift, p.scale
        p.events_row, p.events_stride = b, E
    mu, inv_sigma, lp_const = banded.prepare_emission_coefficients(
        ranks, models.pore_model)
    scaled_dev = compute.put_rows(scaled)
    for p in group:
        p.events_dev = scaled_dev
    args = (scaled_dev, compute.put_rows(mu), compute.put_rows(inv_sigma),
            compute.put_rows(lp_const), compute.put_rows(n_ev),
            compute.put_rows(n_km))
    if mesh is not None:
        tp, rp, best_e, _ = banded.banded_fill_sharded(mesh, *args, **fill_kw)
    else:
        tp, rp, best_e, _ = banded.banded_fill_jit(*args, **fill_kw)
    _enqueue_d2h(tp, rp, best_e)
    return scaled, tp, rp, best_e


def prepare_reads(records: list[ReadRecord], models: PoreModelSet,
                  cfg: SubstrateConfig = DNA_R10,
                  bucket_step_events: int = 4096,
                  bucket_step_kmers: int = 4096) -> list[PreparedRead]:
    """Run events + quantile scaling + banded alignment + Theil-Sen for a
    batch of reads.  Failed reads carry ``qc_fail_reason`` and are kept (the
    caller counts them the way the reference's progress bar does)."""
    k = cfg.kmer_len
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=2) as ex:
        detected = list(ex.map(lambda r: _detect_and_merge(r.raw, cfg),
                               records))
    prepped: list[PreparedRead] = []
    for rec, (mean, rs, re_, et_n) in zip(records, detected):
        rq = kmer_ranks(rec.basecall, k)
        rr = kmer_ranks(rec.reference_seq, k)
        pr = PreparedRead(rec, mean, rs, re_, et_n, rq, rr)
        if mean.shape[0] < 2 or rq.shape[0] < 2 or rr.shape[0] < 2:
            pr.qc_fail_reason = "too_few_events"
        prepped.append(pr)

    live = [p for p in prepped if p.passed]
    if not live:
        return prepped

    # quantile scaling against reference-sequence model means
    # (event_handling.cpp:594-595); undefined kmers take the A-substituted
    # rank like the reference's defaulting map lookup (data_IO.cpp:131)
    for p in live:
        safe_rr = np.where(p.kmer_ranks_ref < 0, 0, p.kmer_ranks_ref)
        model_means = models.pore_model[safe_rr, 0].astype(np.float64)
        p.shift, p.scale = refops.estimate_scaling_quantiles(
            p.event_mean, model_means, cfg.scaling)

    # --- banded alignment, bucketed ---
    max_fill_batch = FILL_BATCH * compute.data_axis_size()
    buckets: dict[tuple[int, int], list[PreparedRead]] = {}
    for p in live:
        key = (_bucket(p.n_events, bucket_step_events),
               _bucket(p.n_kmers, bucket_step_kmers))
        buckets.setdefault(key, []).append(p)

    bw = cfg.banded.bandwidth
    fill_kw = dict(bandwidth=bw, epsilon_skip=cfg.banded.epsilon_skip,
                   p_trim=cfg.banded.p_trim,
                   impl=platform.routes().banded_fill)
    cleaned_per_read: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    mesh = compute.get_compute_mesh()

    # phase 1: dispatch every bucket's fill (jax queues transfers and kernels
    # asynchronously, so buckets overlap); phase 2 backtraces on the host
    dispatched = []
    for (E, K), group in buckets.items():
        for c in range(0, len(group), max_fill_batch):
            chunk = group[c : c + max_fill_batch]
            dispatched.append((chunk, *_dispatch_fill(
                chunk, E, K, models, mesh, fill_kw)))

    for group, scaled, tp, rp, best_e in dispatched:
        tp = np.asarray(tp)
        rp = np.asarray(rp)
        best_e = np.asarray(best_e)
        for b, p in enumerate(group):
            ne, nk = p.n_events, p.n_kmers
            n_bands = ne + nk + 2
            q2r = np.full(p.n_kmers, -1, dtype=np.int64)
            q2r_src = p.record.query_to_ref[: p.n_kmers]
            q2r[: q2r_src.shape[0]] = q2r_src
            mu_b, inv_b, lpc_b = banded.prepare_emission_coefficients(
                p.kmer_ranks_query[None, :], models.pore_model)
            pairs, cs, cr, avg_em, spanned, max_gap = \
                native.banded_backtrace(
                    tp, rp, b, n_bands, bw, ne, nk, int(best_e[b]),
                    p.event_mean, scaled[b, :ne], mu_b[0], inv_b[0],
                    lpc_b[0], q2r, p.kmer_ranks_ref)
            qc = (avg_em >= cfg.banded.min_average_log_emission and spanned
                  and max_gap <= cfg.banded.max_gap_threshold
                  and cs.shape[0] >= cfg.banded.min_cleaned_events)
            if qc:
                p.event_alignment = pairs
            else:
                p.qc_fail_reason = "banded_qc"
            cleaned_per_read[id(p)] = (cs, cr)

    # --- Theil-Sen refinement, batched on device ---
    # stride-subsample on host (scaling.theilsen_pregather) so only the
    # <=1000 selected points per read are uploaded, not the padded
    # cleaned-event arrays
    live2 = [p for p in live if p.passed]
    if live2:
        mp = cfg.scaling.theilsen_max_points
        B = compute.pad_rows(len(live2))
        sig = np.zeros((B, mp), dtype=np.float32)
        mms = np.zeros((B, mp), dtype=np.float32)
        npts = np.zeros(B, dtype=np.int32)
        # padded rows pass through untouched (shift 0 / scale 1, discarded)
        passth = np.ones(B, dtype=bool)
        sh = np.zeros(B, dtype=np.float32)
        sc = np.ones(B, dtype=np.float32)
        for b, p in enumerate(live2):
            cs, cr = cleaned_per_read[id(p)]
            sig[b], mms[b], npts[b], passth[b] = scaling.theilsen_pregather(
                cs, cr, models.pore_model, mp, cfg.scaling.theilsen_trim)
            sh[b], sc[b] = p.shift, p.scale
        new_sh, new_sc = scaling.theilsen_refine_pregathered(
            compute.put_rows(sig), compute.put_rows(mms),
            compute.put_rows(npts), compute.put_rows(passth),
            compute.put_rows(sh), compute.put_rows(sc),
            max_points=mp)
        _enqueue_d2h(new_sh, new_sc)
        new_sh = np.asarray(new_sh); new_sc = np.asarray(new_sc)
        for b, p in enumerate(live2):
            p.shift, p.scale = float(new_sh[b]), float(new_sc[b])
            if p.shift == -1.0:  # Theil-Sen failure sentinel
                p.qc_fail_reason = "theilsen"
                p.event_alignment = np.empty((0, 2), dtype=np.int64)
            # eventsPerBase uses the raw event count and basecall length - k
            # (event_handling.cpp:606)
            p.events_per_base = p.et_n / max(1, len(p.record.basecall) - cfg.kmer_len)

    # upload the batch's reference sequences once as one flat u8 code stream
    # and rebuild the flat i32 rank array on device (4x fewer bytes than
    # uploading ranks); eventalign window batches then only ship
    # start offsets.  Each read's segment carries its k-1 trailing bases, so
    # ranks at offsets [off, off + n_kmers) are exact; the k-1 spill ranks at
    # each segment tail are garbage no consumer addresses (windows clamp to
    # n_states <= n_kmers - ref_index).
    passed = [p for p in prepped if p.passed]
    if passed and (platform.routes().device_resident_ranks
                   or compute.data_axis_size() > 1):
        from ..utils.seqtools import encode_bases
        chunks = []
        off = 0
        for p in passed:
            codes = encode_bases(p.record.reference_seq).astype(np.uint8)
            p.flat_ranks_offset = off
            chunks.append(codes)
            off += codes.shape[0]
        # length padded to a coarse bucket so batch-size changes do not
        # recompile kernels that trace the flat array's shape
        cat = np.concatenate(chunks)
        padded = np.zeros(max(1 << 16, -(-cat.shape[0] // (1 << 16)) << 16),
                          dtype=np.uint8)
        padded[: cat.shape[0]] = cat
        # ship the sequence 2-bit packed + non-ACGT bitmap (4x fewer bytes)
        from ..ops.seqcodes import flat_ranks_from_packed_jit, pack_codes_host
        packed, badmap = pack_codes_host(padded)
        flat = flat_ranks_from_packed_jit(compute.put_rep(packed),
                                          compute.put_rep(badmap),
                                          padded.shape[0])
        for p in passed:
            p.flat_ranks_device = flat
    return prepped
