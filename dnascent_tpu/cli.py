"""Command-line interface: the reference's seven subcommands, same flags.

Dispatcher mirrors src/main/DNAscent.cpp:26-82.  Run as
``python -m dnascent_tpu <subcommand> ...`` or via the ``dnascent-tpu``
entry point.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import __version__
from .config import DNA_R10, get_config

GENERAL_HELP = f"""dnascent_tpu v{__version__} — DNAscent in JAX
Usage: dnascent-tpu [subprogram] [arguments]
The subprograms are:

  index      generate an index file for fast5/pod5 files,
  detect     detect base analogues in Oxford Nanopore reads,
  align      align nanopore signals to reference k-mers,
  forkSense  call replication origins, fork movement, and fork stalling,
  seeBreaks  detect an elevated frequency of DNA breaks at forks,
  trainCNN   build training data for neural network training,
  trainGMM   estimate the mean and standard deviation of a base analogue's current.
"""


def _load_models(cfg):
    from .io.poremodel import load_model_set
    return load_model_set(cfg)


# ---------------------------------------------------------------------------
# index
# ---------------------------------------------------------------------------

def main_index(argv):
    p = argparse.ArgumentParser(prog="dnascent-tpu index")
    p.add_argument("-f", "--files", required=True,
                   help="full path to fast5 or pod5 files")
    p.add_argument("-s", "--sequencing-summary", default=None)
    p.add_argument("-o", "--output", default="index.dnascent")
    a = p.parse_args(argv)
    from .io.index_io import build_index
    n = build_index(a.files.rstrip("/"), a.output, a.sequencing_summary)
    print(f"Indexed {n} reads -> {a.output}")
    return 0


# ---------------------------------------------------------------------------
# detect / trainCNN shared front end
# ---------------------------------------------------------------------------

def _detect_parser(prog, min_l_default):
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("-b", "--bam", required=True)
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-i", "--index", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("-q", "--quality", type=int, default=20)
    p.add_argument("-l", "--length", type=int, default=min_l_default)
    p.add_argument("-m", "--maxReads", type=int, default=None)
    p.add_argument("--GPU", default=None, help="accepted for compatibility; "
                   "device placement is controlled by JAX")
    p.add_argument("--HMM", action="store_true")
    p.add_argument("--cnn-weights", default=None,
                   help="npz weights for the detect CNN (dnascent-tpu "
                   "extension; untrained weights otherwise)")
    p.add_argument("--model", default=None,
                   help="reference TF SavedModel directory "
                   "(dnn_models/detect_model_BrdUEdU_DNAr10_4_1): runs the "
                   "reference's trained CNN topology — requires the "
                   "variables.data-* shards (src/tensor.cpp:12-106)")
    p.add_argument("--allow-untrained-cnn", action="store_true",
                   help="run the CNN path with untrained (random) weights — "
                   "for pipeline testing only; analogue probabilities are "
                   "noise.  Without this flag detect refuses to run without "
                   "--cnn-weights, like the reference refuses without its "
                   "SavedModel (src/tensor.cpp:48)")
    p.add_argument("--devices", default=None,
                   help="shard pipeline batches over N local devices "
                   "('all' = every visible device; dnascent-tpu extension — "
                   "replaces the reference's OpenMP read loop, "
                   "src/detect.cpp:852)")
    p.add_argument("--nprocs", type=int, default=1,
                   help="number of cooperating processes/hosts (each takes "
                   "every nprocs-th read; shard outputs are merged "
                   "deterministically)")
    p.add_argument("--procid", type=int, default=None,
                   help="this process's index in [0, nprocs); defaults to "
                   "jax.process_index() when --coordinator is used")
    p.add_argument("--coordinator", default=None,
                   help="host:port of the jax.distributed coordinator "
                   "(multi-host runs)")
    p.add_argument("--resume", action="store_true",
                   help="skip reads already present in the output file "
                   "(dnascent-tpu extension: restartable runs)")
    p.add_argument("--strict-windows", action="store_true",
                   help="reproduce the reference's sequential window "
                   "coupling (measured 2.2x slower end-to-end; the default "
                   "batched independent-window mode matches it to mean "
                   "|dprob| ~2e-4 with <0.5%% of T positions moving by "
                   ">0.01 — see test_detect_fast_vs_strict_probabilities)")
    return p


def _open_source(a, cfg, min_l, shard=None):
    from .io.fasta import import_reference
    from .io.index_io import parse_index
    from .pipeline.source import BamSignalSource
    ref = import_reference(a.reference)
    idx = parse_index(a.index)
    missing_log = []
    src = BamSignalSource(a.bam, ref, idx, min_mapq=a.quality,
                          min_length=min_l, max_reads=a.maxReads,
                          on_missing=missing_log.append, shard=shard)
    return src, ref, missing_log


def _setup_parallel(a):
    """Activate the compute mesh / distributed runtime from the detect-family
    flags; returns (process_index, process_count)."""
    from .parallel import compute
    from .parallel.mesh import init_distributed
    if a.coordinator:
        init_distributed(a.coordinator, a.nprocs, a.procid)
    procid = a.procid
    if procid is None:
        if a.coordinator:
            import jax
            procid = jax.process_index()
        else:
            procid = 0
    if a.devices:
        n = None if a.devices == "all" else int(a.devices)
        compute.set_compute_mesh(compute.make_data_mesh(n))
    return procid, max(1, a.nprocs)


def _load_cnn(a):
    if a.model:
        from .models import reference_cnn
        return reference_cnn.load_savedmodel(a.model)
    from .models import cnn as cnn_mod
    if a.cnn_weights and os.path.exists(a.cnn_weights):
        params = cnn_mod.load_params(a.cnn_weights)
        if "gru0" in params:
            # npz written by `trainCNN --fit --fit-arch reference`:
            # the reference topology fitted in-framework
            from .models import reference_cnn
            return reference_cnn.create_model(), params
        return cnn_mod.create_model(), params
    if a.allow_untrained_cnn:
        model = cnn_mod.create_model()
        print("Warning: --allow-untrained-cnn — analogue probabilities "
              "will be noise (no trained CNN weights supplied).",
              file=sys.stderr)
        return model, cnn_mod.default_params(model)
    # the reference refuses to run without its trained SavedModel
    # (src/tensor.cpp:48); random weights silently emitting noise
    # probabilities would be worse than failing here
    raise SystemExit(
        "Exiting with error.  No trained CNN weights: pass "
        "--cnn-weights <npz> (or --allow-untrained-cnn to force "
        "untrained weights for pipeline testing).")


def main_detect(argv):
    a = _detect_parser("dnascent-tpu detect", 1000).parse_args(argv)
    ext = a.output.rsplit(".", 1)[-1]
    if ext not in ("detect", "bam"):
        print(f"Exiting with error.  Invalid output extension: {ext}",
              file=sys.stderr)
        return 1
    human_readable = ext == "detect"
    cfg = DNA_R10
    procid, nprocs = _setup_parallel(a)
    shard = (procid, nprocs) if nprocs > 1 else None
    if shard and not human_readable:
        print("--nprocs > 1 supports human-readable .detect output only "
              "(shards are merged as text)", file=sys.stderr)
        return 1
    out_path = a.output
    if shard:
        from .parallel.merge import host_shard_path
        out_path = host_shard_path(a.output, procid)
    models = _load_models(cfg)
    src, ref, missing = _open_source(a, cfg, a.length, shard=shard)

    # countRecords pre-pass for the progress bar total (the reference scans
    # the BAM before streaming, detect.cpp:829 + htsInterface.cpp:15-30)
    from .utils.progress import ProgressBar, StageTimer
    total = src.count_records()

    done_ids = set()
    if a.resume and human_readable and os.path.exists(out_path):
        # checkpoint/resume: the reference restarts whole runs only (SURVEY
        # §5); here completed reads are skipped and output is appended
        with open(out_path) as fh:
            for line in fh:
                if line.startswith(">"):
                    done_ids.add(line[1:].split()[0])
        print(f"resume: skipping {len(done_ids)} completed reads",
              file=sys.stderr)
        src = (r for r in src if r.read_id not in done_ids)

    from .io.writers import DetectHRWriter, detect_header
    from .pipeline.detect import DetectStats, detect_reads
    from .platform import current_platform
    compute = current_platform().upper()

    stats = DetectStats()
    # progress bar with ETA + failure counter (reference: common.h:30-88)
    bar = ProgressBar(max(1, total - len(done_ids)))
    timer = (StageTimer()
             if os.environ.get("DNASCENT_STAGE_TIMES") == "1" else None)
    if a.HMM:
        from .pipeline.hmm_detect import hmm_detect_reads
        writer = DetectHRWriter(out_path) if human_readable else None
        if writer is None:
            print("--HMM supports human-readable output only (as in the "
                  "reference's legacy path)", file=sys.stderr)
            return 1
        writer.write_header(detect_header(a.bam, a.reference, a.index,
                                          a.threads, a.quality, a.length,
                                          compute=compute, mode="HMM"))
        for rid, text in hmm_detect_reads(src, models, cfg, stats=stats):
            if text:
                writer._fh.write(text)
            bar.display(stats.processed, stats.failed)
        writer.close()
    else:
        model, params = _load_cnn(a)
        if human_readable:
            mode = "a" if (a.resume and done_ids) else "w"
            with DetectHRWriter(out_path, mode=mode) as w:
                if mode == "w":
                    w.write_header(detect_header(a.bam, a.reference, a.index,
                                                 a.threads, a.quality,
                                                 a.length, compute=compute))
                for _rid, d in detect_reads(
                        src, models, model, params, cfg, stats=stats,
                        strict_windows=a.strict_windows,
                        collect_failures=True, timer=timer):
                    if d is not None:
                        w.write(d)
                    bar.display(stats.processed, stats.failed)
        else:
            from .io.bam import BamReader
            from .io.modbam import ModBamWriter
            hdr_reader = BamReader(a.bam)
            with ModBamWriter(a.output, hdr_reader.header_text,
                              hdr_reader.ref_names,
                              hdr_reader.ref_lengths) as w:
                hdr_reader.close()
                for _rid, d in detect_reads(
                        src, models, model, params, cfg, stats=stats,
                        strict_windows=a.strict_windows,
                        collect_failures=True, timer=timer):
                    if d is not None:
                        w.write(d)
                    bar.display(stats.processed, stats.failed)
    bar.display(stats.processed, stats.failed)
    bar.finish()
    if timer is not None:
        print("stage wall-clock totals:", file=sys.stderr)
        timer.report()
    log = os.path.splitext(out_path)[0] + ".detect.log"
    with open(log, "w") as fh:
        for rid in missing:
            fh.write(f"ReadID {rid} missing from index. Skipping.\n")
    print(f"\ndetect: {stats.processed} reads, {stats.failed} failed QC")
    if shard:
        # deterministic shard merge: with a coordinator every host reaches
        # this barrier and host 0 merges; without one (independent shard
        # runs) whichever invocation completes the set merges
        from .parallel.merge import (all_shards_present, host_shard_path,
                                     merge_host_outputs)
        if a.coordinator:
            from jax.experimental import multihost_utils
            multihost_utils.sync_global_devices("detect_shards_done")
        if (procid == 0 or not a.coordinator) and all_shards_present(
                a.output, nprocs):
            n = merge_host_outputs(
                [host_shard_path(a.output, i) for i in range(nprocs)],
                a.output)
            print(f"merged {nprocs} shards -> {a.output} ({n} reads)")
        elif not a.coordinator:
            print(f"shard {procid}/{nprocs} written to {out_path}; the "
                  "final shard run merges all shards", file=sys.stderr)
    return 0


def main_align(argv):
    p = _detect_parser("dnascent-tpu align", 100)
    p.add_argument("--fast-windows", action="store_true",
                   help="use the batched independent-window geometry "
                   "instead of the reference's sequential window coupling "
                   "(faster; rows differ where the couplings diverge)")
    a = p.parse_args(argv)
    cfg = DNA_R10
    procid, nprocs = _setup_parallel(a)
    # multi-process sharding mirrors detect (reference: the same OpenMP read
    # loop drives align, src/alignment.cpp:826): each process takes every
    # nprocs-th read, writes its own shard file, and the shards are merged
    # deterministically once all are present
    shard = (procid, nprocs) if nprocs > 1 else None
    out_path = a.output
    if shard:
        from .parallel.merge import host_shard_path
        out_path = host_shard_path(a.output, procid)
    models = _load_models(cfg)
    src, ref, missing = _open_source(a, cfg, a.length, shard=shard)
    from .io.writers import AlignHRWriter
    from .pipeline.prep import prepare_reads
    from .pipeline.eventalign import run_eventalign

    # align's product IS the reference's eventalign table, so the
    # reference-parity (strict) window geometry is the default here —
    # the speculative wavefront keeps it within ~1.6x of fast mode
    strict = a.strict_windows or not a.fast_windows
    n_ok = n_fail = 0
    # progress bar with ETA + failure counter (reference: common.h:30-88,
    # fed by the countRecords pre-pass like align_main, alignment.cpp:806)
    from .utils.progress import ProgressBar
    bar = ProgressBar(max(1, src.count_records()))
    # batches are software-pipelined like detect's (detect_reads):
    # strict mode's per-round syncs and the transfer waits of neighbouring
    # batches overlap, with ordered draining so the output file keeps
    # submission order (depth not yet tuned on the GPU)
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    depth = 10

    def process(batch):
        prepped = prepare_reads(batch, models, cfg)
        results = run_eventalign(prepped, models, cfg, collect_text=True,
                                 strict=strict)
        return prepped, results

    with AlignHRWriter(out_path) as w, \
            ThreadPoolExecutor(max_workers=depth) as ex:
        pending: deque = deque()

        def drain(fut):
            nonlocal n_ok, n_fail
            prepped, results = fut.result()
            for p_ in prepped:
                res = results.get(p_.record.read_id)
                if res is not None and res.qc_passed and res.text:
                    w.write_text(res.text)
                    n_ok += 1
                else:
                    n_fail += 1
            bar.display(n_ok + n_fail, n_fail)

        batch = []
        for rec in src:
            batch.append(rec)
            if len(batch) >= 32:
                pending.append(ex.submit(process, batch))
                batch = []
                while len(pending) >= depth:
                    drain(pending.popleft())
        if batch:
            pending.append(ex.submit(process, batch))
        while pending:
            drain(pending.popleft())
    bar.finish()
    log = os.path.splitext(out_path)[0] + ".align.log"
    with open(log, "w") as fh:
        for rid in missing:
            fh.write(f"ReadID {rid} missing from index. Skipping.\n")
    print(f"\nalign: {n_ok} reads, {n_fail} failed QC")
    if shard:
        from .parallel.merge import (all_shards_present, host_shard_path,
                                     merge_host_outputs)
        if a.coordinator:
            from jax.experimental import multihost_utils
            multihost_utils.sync_global_devices("align_shards_done")
        if (procid == 0 or not a.coordinator) and all_shards_present(
                a.output, nprocs):
            n = merge_host_outputs(
                [host_shard_path(a.output, i) for i in range(nprocs)],
                a.output)
            print(f"merged {nprocs} shards -> {a.output} ({n} reads)")
        elif not a.coordinator:
            print(f"shard {procid}/{nprocs} written to {out_path}; the "
                  "final shard run merges all shards", file=sys.stderr)
    return 0


def _add_distributed_flags(p):
    p.add_argument("--devices", default=None)
    p.add_argument("--nprocs", type=int, default=1)
    p.add_argument("--procid", type=int, default=None)
    p.add_argument("--coordinator", default=None)


def main_forksense(argv):
    p = argparse.ArgumentParser(prog="dnascent-tpu forkSense")
    p.add_argument("-d", "--detect", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--order", required=True,
                   choices=["EdU,BrdU", "BrdU,EdU"])
    p.add_argument("-t", "--threads", type=int, default=1)
    p.add_argument("--markAnalogues", action="store_true")
    p.add_argument("--markOrigins", action="store_true")
    p.add_argument("--markTerminations", action="store_true")
    p.add_argument("--markForks", action="store_true")
    p.add_argument("--makeSignatures", action="store_true")
    _add_distributed_flags(p)
    a = p.parse_args(argv)
    cfg = DNA_R10
    procid, nprocs = _setup_parallel(a)
    from .pipeline import forksense as fsm

    ext = a.detect.rsplit(".", 1)[-1]
    if ext == "detect":
        reads = list(fsm.parse_detect_file(a.detect))
        human_readable = True
    elif ext == "bam":
        from .io.modbam import iter_modbam_detected_reads
        reads = list(iter_modbam_detected_reads(a.detect))
        human_readable = False
    else:
        print(f"Exiting with error.  Invalid detect extension: {ext}",
              file=sys.stderr)
        return 1

    ordinals = None
    if nprocs > 1:
        # shard reads across hosts; pass 1 statistics are allgathered
        # inside forksense_run so every host's 2-means is identical
        ordinals = list(range(procid, len(reads), nprocs))
        reads = [reads[i] for i in ordinals]
    from .utils.progress import ProgressBar
    bar = ProgressBar(max(1, len(reads)), show_failures=False)
    inc, outputs = fsm.forksense_run(
        reads, a.order, cfg, read_ordinals=ordinals,
        progress_cb=bar.display,
        mark_origins=a.markOrigins, mark_terms=a.markTerminations,
        mark_forks=a.markForks, mark_analogues=a.markAnalogues,
        make_signatures=a.makeSignatures, human_readable=human_readable)
    bar.finish()

    print(f"Estimated fraction of BrdU substitution in BrdU-positive "
          f"regions: {inc.centroid_1}", file=sys.stderr)
    print(f"Estimated fraction of EdU substitution in EdU-positive "
          f"regions: {inc.centroid_2}", file=sys.stderr)

    import datetime
    now = datetime.datetime.now().strftime("%d/%m/%Y %H:%M:%S")

    def hdr(extra=""):
        return (f"#DetectFile {a.detect}\n#Threads {a.threads}\n"
                f"#Compute CPU\n#SystemStartTime {now}\n"
                f"#Software dnascent_tpu\n#Version {__version__}\n"
                f"#Commit none\n{extra}")

    from .parallel.merge import (all_shards_present, host_shard_path,
                                 merge_bed_outputs, merge_host_outputs)
    shard_mode = nprocs > 1
    main_path = host_shard_path(a.output, procid) if shard_mode else a.output
    with open(main_path, "w") as fh:
        fh.write(hdr(f"#EstimatedRegionBrdU {inc.centroid_1:.6f}\n"
                     f"#EstimatedRegionEdU {inc.centroid_2:.6f}\n"))
        for o in outputs:
            for block in o.main:
                fh.write(block)

    bed_names = []

    def write_bed(name, lines_attr):
        bed_names.append(name)
        path = host_shard_path(name, procid) if shard_mode else name
        with open(path, "w") as fh:
            fh.write(hdr())
            for o in outputs:
                for line in getattr(o, lines_attr):
                    fh.write(line)

    if a.markTerminations:
        write_bed("terminations_DNAscent_forkSense.bed", "terminations")
    if a.markOrigins:
        write_bed("origins_DNAscent_forkSense.bed", "origins")
    if a.markForks:
        write_bed("leftForks_DNAscent_forkSense.bed", "left_forks")
        write_bed("rightForks_DNAscent_forkSense.bed", "right_forks")
    if a.makeSignatures:
        write_bed("leftForks_DNAscent_forkSense_stressSignatures.bed",
                  "left_signatures")
        write_bed("rightForks_DNAscent_forkSense_stressSignatures.bed",
                  "right_signatures")
    if a.markAnalogues:
        write_bed("BrdU_DNAscent_forkSense.bed", "brdu_beds")
        write_bed("EdU_DNAscent_forkSense.bed", "edu_beds")

    if shard_mode:
        from .parallel.collectives import barrier
        if a.coordinator:
            barrier("forksense_shards_done")
        if (procid == 0 or not a.coordinator) and all_shards_present(
                a.output, nprocs):
            merge_host_outputs(
                [host_shard_path(a.output, i) for i in range(nprocs)],
                a.output)
            for name in bed_names:
                if all_shards_present(name, nprocs):
                    merge_bed_outputs(
                        [host_shard_path(name, i) for i in range(nprocs)],
                        name)
            print(f"merged {nprocs} forkSense shards -> {a.output}")
    return 0


def main_seebreaks(argv):
    p = argparse.ArgumentParser(prog="dnascent-tpu seeBreaks")
    p.add_argument("-l", "--left", default=None)
    p.add_argument("-r", "--right", default=None)
    p.add_argument("-a", "--analogue", required=True)
    p.add_argument("-d", "--detect", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--fast", action="store_true",
                   help="vectorised bootstrap instead of reference-exact RNG")
    _add_distributed_flags(p)
    a = p.parse_args(argv)
    if not (a.left or a.right):
        print("Exiting with error.  Insufficient arguments passed to "
              "DNAscent seeBreaks.", file=sys.stderr)
        return 1
    cfg = DNA_R10
    procid, nprocs = _setup_parallel(a)
    import numpy as np
    from .pipeline.seebreaks import run_seebreaks, write_seebreaks_output

    # the detect-file span scan is the only heavy input: shard it across
    # hosts, then allgather the spans so every host computes the identical
    # statistics (global read-length vector; src/seeBreaks.cpp:288-350)
    ext = a.detect.rsplit(".", 1)[-1]
    spans = []
    ordinals = []
    n_seen = 0

    def take(rs, re_):
        nonlocal n_seen
        if n_seen % nprocs == procid:
            spans.append((rs, re_))
            ordinals.append(n_seen)
        n_seen += 1

    if ext == "detect":
        with open(a.detect) as fh:
            for line in fh:
                if line.startswith(">"):
                    cols = line.split()
                    take(int(cols[2]), int(cols[3]))
    else:
        from .io.bam import BamReader, get_ref_span
        rd = BamReader(a.detect)
        for rec in rd:
            rs, re_ = get_ref_span(rec.cigar(), rec.pos)
            take(rs, re_)
        rd.close()
    spans = np.asarray(spans, dtype=np.int64).reshape(-1, 2)
    if nprocs > 1:
        from .parallel.collectives import gather_ordered
        spans = gather_ordered(spans, np.asarray(ordinals, np.int64))

    def by_minlen(minlen):
        keep = (spans[:, 1] - spans[:, 0]) >= minlen
        return spans[keep, 0], spans[keep, 1]

    res = run_seebreaks(a.left, a.right, a.analogue, spans[:, 0], by_minlen,
                        cfg.seebreaks, parity=not a.fast)
    if nprocs == 1 or procid == 0:
        # every host computed the identical result from the gathered spans;
        # one writes it
        write_seebreaks_output(res, a.output, a.detect, a.left or "",
                               a.right or "")
    print(f"\nNumber of forks: {res.n_forks}")
    print("Expected number of analogue tracks at read ends")
    print(f"   Estimate: {res.sim_mean:.6g}")
    print(f"   StandardError: {res.sim_std:.6g}")
    print("Observed number of analogue tracks at read ends")
    print(f"   Estimate: {res.obs_mean:.6g}")
    print(f"   StandardError: {res.obs_std:.6g}")
    print("Difference between observed and expected")
    print(f"   Estimate: {res.diff_mean:.6g}")
    print(f"   StandardError: {res.diff_std:.6g}")
    print(f"   95% Confidence Interval: [{res.ci_low:.6g}, {res.ci_high:.6g}]")
    return 0


def main_traincnn(argv):
    p = _detect_parser("dnascent-tpu trainCNN", 100)
    p.add_argument("--fit", default=None, metavar="OUT_NPZ",
                   help="also FIT a detect model on these reads and save "
                   "the weights (requires --fit-label) — the in-framework "
                   "training path; the reference only emits tables and "
                   "trains offline in TF")
    p.add_argument("--fit-label", choices=sorted({"Thym", "BrdU", "EdU"}),
                   default=None,
                   help="sample-wide ground-truth class of this run (the "
                   "reference's training sets are analogue-only runs, so "
                   "every T position carries the run's label)")
    p.add_argument("--fit-arch", choices=["detectcnn", "reference"],
                   default="detectcnn",
                   help="architecture to fit: the in-framework DetectCNN or "
                   "the reference's GRU+separable-conv topology")
    p.add_argument("--fit-epochs", type=int, default=1)
    p.add_argument("--fit-lr", type=float, default=3e-4)
    a = p.parse_args(argv)
    if a.fit and a.fit_label is None:
        print("Exiting with error.  --fit requires --fit-label.",
              file=sys.stderr)
        return 1
    cfg = DNA_R10
    _setup_parallel(a)
    models = _load_models(cfg)
    src, ref, missing = _open_source(a, cfg, a.length)
    model, params = _load_cnn(a)
    from .pipeline.traincnn import (LABEL_IDS, batches_from_labelled_reads,
                                    generate_training_tables,
                                    reference_arch_trainer, train_detect_cnn)
    import numpy as np
    n = 0
    train_batches = []
    with open(a.output, "w") as fh:
        batch = []
        def flush(batch):
            nonlocal n
            for text in generate_training_tables(batch, models, model,
                                                 params, cfg):
                fh.write(text)
                n += 1
            if a.fit:
                lab = LABEL_IDS[a.fit_label]
                pairs = [(r, np.full(len(r.reference_seq), lab, np.int32))
                         for r in batch]
                train_batches.extend(
                    batches_from_labelled_reads(pairs, models, cfg))
        for rec in src:
            batch.append(rec)
            if len(batch) >= 32:
                flush(batch); batch = []
        if batch:
            flush(batch)
    print(f"\ntrainCNN: {n} reads written")
    if a.fit:
        from .models import cnn as cnn_mod
        if a.fit_arch == "reference":
            fmodel, fparams, opt = reference_arch_trainer(
                learning_rate=a.fit_lr)
        else:
            fmodel = cnn_mod.create_model()
            fparams, opt = cnn_mod.default_params(fmodel), None
        fparams, losses = train_detect_cnn(
            train_batches, model=fmodel, params=fparams,
            learning_rate=a.fit_lr, epochs=a.fit_epochs, optimizer=opt,
            checkpoint_path=a.fit)
        if losses:
            print(f"trainCNN fit [{a.fit_arch}]: {len(losses)} steps, "
                  f"loss {losses[0]:.4f} -> {losses[-1]:.4f} -> {a.fit}")
    return 0


def main_traingmm(argv):
    p = argparse.ArgumentParser(prog="dnascent-tpu trainGMM")
    p.add_argument("-d", "--trainingData", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-pi", dest="pi", type=float, default=0.5)
    p.add_argument("-m", "--max-reads", type=int, default=100000)
    p.add_argument("-e", "--max-events", type=int, default=10000)
    p.add_argument("-t", "--threads", type=int, default=1)
    a = p.parse_args(argv)
    cfg = DNA_R10
    if a.pi != cfg.traingmm.default_pi:
        cfg = cfg.replace(traingmm=cfg.traingmm.__class__(
            **{**cfg.traingmm.__dict__, "default_pi": a.pi}))
    models = _load_models(cfg)
    from .pipeline.traingmm import parse_align_events, train_gmm, write_gmm_table
    pools = parse_align_events(a.trainingData, cfg.kmer_len, a.max_events,
                               a.max_reads)
    fits = train_gmm(pools, models, cfg)
    write_gmm_table(fits, a.output, cfg.kmer_len)
    print(f"Done. {len(fits)} k-mers fitted -> {a.output}")
    return 0


SUBCOMMANDS = {
    "index": main_index,
    "detect": main_detect,
    "align": main_align,
    "forkSense": main_forksense,
    "seeBreaks": main_seebreaks,
    "trainCNN": main_traincnn,
    "trainGMM": main_traingmm,
}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(GENERAL_HELP)
        return 0
    if argv[0] in ("-v", "--version"):
        print(__version__)
        return 0
    fn = SUBCOMMANDS.get(argv[0])
    if fn is None:
        print(GENERAL_HELP)
        print(f"Unknown subprogram: {argv[0]}", file=sys.stderr)
        return 1
    return fn(argv[1:])


if __name__ == "__main__":
    sys.exit(main())
