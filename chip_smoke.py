#!/usr/bin/env python
"""Smoke test of detect on one NVIDIA GPU, through the entry points a user
calls, at full model width with seeded random weights.

    python chip_smoke.py                # one card: phases 1-3
    python chip_smoke.py --four-cards   # four cards: phase 4 only
    python chip_smoke.py --rehearse     # any device, toy sizes, no result

Phases, each printing one JSON line:

1. device: platform, device kind and count, the card's name and power limit
   (``nvidia-smi``, run in a child that stays off JAX), and which of flax,
   pyarrow, zstandard and h5py import;
2. kernels at real widths, each compiled for the card (no interpret mode),
   with ``memory_analysis()``, compared once with the plain reference and
   timed: the banded fill (CUDA kernel vs the XLA scan, B=32 x 10 kb reads
   and one 100 kb read; vs the numpy oracle on two rows and the CPU scan on
   all rows), the host backtrace chase, the windowed Viterbi (W=2048,
   T in {192, 384}, N=48; paths vs ``reference.builtin_viterbi``), and the
   reference-topology CNN forward on one 32-read batch (vs the same forward
   on the CPU);
3. ``python -m dnascent_tpu detect --model <dir>`` in this process on a
   seeded 64-read 10 kb R10.4.1 dataset (pod5, with uncompressed signal
   rows where zstandard is missing), checked against a CPU run of the same
   command (a ``JAX_PLATFORMS=cpu`` child) on the first 8 reads;
4. (``--four-cards`` only) the same CLI detect with ``--devices 4`` and
   ``--devices 1`` in one process: read ids and coordinates equal,
   probabilities within the bf16 tolerance below (each card runs the CNN
   on a quarter of the rows, so XLA may pick other convolution algorithms).

The last line of standard output is ``{"ok": true, "device": {...}}``.  Any
failed phase fails the script (non-zero exit, no result line), as does a
platform other than ``gpu``.  Long artefacts go to ``chiprun_out/smoke/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback

OUT_DIR = os.path.join("chiprun_out", "smoke")

# probabilities: the CNN trunk rounds every convolution's output to bfloat16
# (8-bit mantissa), so two devices that sum a convolution in different orders
# round some outputs the other way, and 30+ layers carry that into the
# softmax.  The CPU-vs-H100 difference is the size of the bf16 rounding
# itself: the same forward on one CPU differs between bf16 and f32
# convolutions by 0.021 at worst and 0.0034 on average (2 x 2048 positions,
# seeded weights), and CPU vs H100 measured 0.027 / 0.0034 (32 x 10240).
CNN_PROB_MAX_ATOL = 5e-2
CNN_PROB_MEAN_ATOL = 1e-2
# banded start score: XLA may contract the final-row score + n * lp_trim
# into one fused multiply-add, which the kernel does not (1 ulp class)
FILL_SCORE_RTOL = 1e-6
# banded trace vs the CPU scan: XLA's CPU backend contracts multiply-adds
# into FMAs, so a near-tied cell can resolve the other way (8 of 29.5M cells
# at 32 x 10 kb on an H100); rights and start events must still agree
FILL_TRACE_CPU_RATE = 1e-4


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def note(msg: str) -> None:
    print(f"[smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def timed(fn, reps: int):
    """Median wall seconds of ``fn()`` after one warm call; each call ends
    in block_until_ready."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return median(ts), ts


def mem(compiled) -> dict:
    m = compiled.memory_analysis()
    if m is None:
        return {}
    return {k: int(getattr(m, k)) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "generated_code_size_in_bytes")
        if hasattr(m, k)}


def nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"unavailable: {e}"


def importable(names) -> dict:
    code = ("import importlib, json, sys\nout = {}\nfor n in sys.argv[1:]:\n"
            "    try:\n        importlib.import_module(n); out[n] = True\n"
            "    except Exception:\n        out[n] = False\n"
            "print(json.dumps(out))\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code, *names],
                       capture_output=True, text=True, env=env, timeout=300)
    return json.loads(r.stdout.strip().splitlines()[-1])


# ---------------------------------------------------------------------------
# phase 2 helpers
# ---------------------------------------------------------------------------

def fill_inputs(records, models, cfg):
    """prep's front half for a list of reads: events, quantile scaling and
    the padded fill arrays (E, K bucketed to 4096 like prep)."""
    import numpy as np
    from dnascent_tpu.ops import banded, reference as refops
    from dnascent_tpu.pipeline.prep import _bucket, _detect_and_merge
    from dnascent_tpu.utils.seqtools import kmer_ranks

    reads = []
    for rec in records:
        mean, _, _, _ = _detect_and_merge(rec.raw, cfg)
        rq = kmer_ranks(rec.basecall, cfg.kmer_len)
        rr = kmer_ranks(rec.reference_seq, cfg.kmer_len)
        safe = np.where(rr < 0, 0, rr)
        shift, scale = refops.estimate_scaling_quantiles(
            mean, models.pore_model[safe, 0].astype(np.float64), cfg.scaling)
        reads.append(dict(rec=rec, mean=mean, rq=np.where(rq < 0, 0, rq),
                          rr=rr, shift=shift, scale=scale))
    B = len(reads)
    E = _bucket(max(r["mean"].shape[0] for r in reads), 4096)
    K = _bucket(max(r["rq"].shape[0] for r in reads), 4096)
    scaled = np.zeros((B, E), np.float32)
    ranks = np.full((B, K), -1, np.int32)
    n_ev = np.zeros(B, np.int32)
    n_km = np.zeros(B, np.int32)
    for b, r in enumerate(reads):
        ne, nk = r["mean"].shape[0], r["rq"].shape[0]
        scaled[b, :ne] = (r["mean"] - r["shift"]) / r["scale"]
        ranks[b, :nk] = r["rq"]
        n_ev[b], n_km[b] = ne, nk
    mu, inv_s, lpc = banded.prepare_emission_coefficients(
        ranks, models.pore_model)
    return reads, (scaled, mu, inv_s, lpc, n_ev, n_km)


def compare_fill(got, want) -> dict:
    import numpy as np
    g = [np.asarray(x) for x in got]
    w = [np.asarray(x) for x in want]
    finite = np.isfinite(w[3])
    rel = (np.abs(g[3][finite] - w[3][finite])
           / np.maximum(np.abs(w[3][finite]), 1e-30))
    return {"trace_cells_differing": int((g[0] != w[0]).sum()),
            "trace_cells": int(w[0].size),
            "rights_differing": int((g[1] != w[1]).sum()),
            "best_event_differing": int((g[2] != w[2]).sum()),
            "best_score_max_rel": float(rel.max()) if rel.size else 0.0,
            "best_score_inf_match": bool(
                (np.isfinite(g[3]) == finite).all())}


def fill_equal(c: dict, trace_rate: float = 0.0) -> bool:
    return (c["trace_cells_differing"] <= trace_rate * c["trace_cells"]
            and c["rights_differing"] == 0
            and c["best_event_differing"] == 0 and c["best_score_inf_match"]
            and c["best_score_max_rel"] <= FILL_SCORE_RTOL)


def probs_close(d: dict) -> bool:
    return (d["max_abs_diff"] <= CNN_PROB_MAX_ATOL
            and d["mean_abs_diff"] <= CNN_PROB_MEAN_ATOL)


def host_chase(reads, args, tp, rp, best_e, bw):
    """prep's host route: download the packed trace and backtrace each read
    natively from it.  Returns the per-read event-alignment pairs."""
    import numpy as np
    from dnascent_tpu import native
    from dnascent_tpu.ops import banded
    scaled, mu, inv_s, lpc, n_ev, n_km = args
    tp, rp, best_e = np.asarray(tp), np.asarray(rp), np.asarray(best_e)
    out = []
    for b, r in enumerate(reads):
        ne, nk = int(n_ev[b]), int(n_km[b])
        n_bands = ne + nk + 2
        q2r = np.arange(nk, dtype=np.int64)
        pairs = native.banded_backtrace(
            tp, rp, b, n_bands, bw, ne, nk,
            int(best_e[b]), r["mean"], scaled[b, :ne], mu[b, :nk],
            inv_s[b, :nk], lpc[b, :nk], q2r, r["rr"])[0]
        out.append(pairs)
    return out


def viterbi_batch(models, cfg, W, T, N, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    obs = np.zeros((W, T), np.float32)
    n_obs = np.zeros(W, np.int32)
    ranks = np.full((W, N), -1, np.int32)
    n_states = np.zeros(W, np.int32)
    windows = []
    for w in range(W):
        ns = int(rng.integers(30, 43))
        r = rng.integers(0, 4 ** cfg.kmer_len, size=ns)
        reps = rng.integers(1, 4, size=ns)
        while reps.sum() > T:
            reps = np.maximum(1, reps - 1)
        o = (np.repeat(models.pore_model[r, 0].astype(np.float64), reps)
             + rng.normal(0, 0.03, int(reps.sum())))
        obs[w, : o.shape[0]] = o
        n_obs[w] = o.shape[0]
        ranks[w, :ns] = r
        n_states[w] = ns
        windows.append((r, o))
    return windows, obs, n_obs, ranks, n_states


def phase_kernels(a, models, cfg) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from dnascent_tpu import platform
    from dnascent_tpu.models import reference_cnn as rc
    from dnascent_tpu.ops import banded, reference as refops, viterbi as vit
    from dnascent_tpu.pipeline.source import SimulatedSource

    out = {"phase": "kernels"}
    ok = True
    cpu = jax.devices("cpu")[0]
    bw = cfg.banded.bandwidth
    kw = dict(bandwidth=bw, epsilon_skip=cfg.banded.epsilon_skip,
              p_trim=cfg.banded.p_trim)
    impl = platform.routes().banded_fill
    out["banded_fill_route"] = impl
    reps = 2 if a.rehearse else 5

    # --- banded fill, B=32 x 10 kb ---
    n_reads, length = (4, 1500) if a.rehearse else (32, 10000)
    recs = list(SimulatedSource(models, cfg, n_reads=n_reads, length=length,
                                seed=11))
    reads, args = fill_inputs(recs, models, cfg)
    dargs = [jnp.asarray(x) for x in args]
    fill = {"B": n_reads, "read_bp": length, "E": int(args[0].shape[1]),
            "K": int(args[1].shape[1])}
    f_hand = jax.jit(lambda *x: banded.banded_fill_jit(*x, impl=impl, **kw))
    f_xla = jax.jit(lambda *x: banded.banded_fill_jit(*x, impl="xla", **kw))
    t0 = time.perf_counter()
    fill["memory_kernel"] = mem(f_hand.lower(*dargs).compile())
    fill["compile_kernel_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fill["memory_xla"] = mem(f_xla.lower(*dargs).compile())
    fill["compile_xla_s"] = time.perf_counter() - t0
    got = f_hand(*dargs)
    want = f_xla(*dargs)
    fill["vs_xla_gpu"] = compare_fill(got, want)
    cpu_args = [jax.device_put(x, cpu) for x in args]
    fill["vs_xla_cpu"] = compare_fill(got, banded.banded_fill_jit(
        *cpu_args, impl="xla", **kw))
    ok &= (fill_equal(fill["vs_xla_gpu"])
           and fill_equal(fill["vs_xla_cpu"], FILL_TRACE_CPU_RATE))
    fill["time_kernel_s"], _ = timed(lambda: f_hand(*dargs), reps)
    fill["time_xla_s"], _ = timed(lambda: f_xla(*dargs), reps)
    fill["speedup_vs_xla"] = fill["time_xla_s"] / fill["time_kernel_s"]
    out["banded_fill_32x10kb"] = fill

    # --- banded fill, one 100 kb read ---
    long_len = 3000 if a.rehearse else 100_000
    lreads, largs = fill_inputs(
        list(SimulatedSource(models, cfg, n_reads=1, length=long_len,
                             seed=12)), models, cfg)
    ldargs = [jnp.asarray(x) for x in largs]
    lf = {"read_bp": long_len, "E": int(largs[0].shape[1]),
          "K": int(largs[1].shape[1])}
    lf["memory_kernel"] = mem(f_hand.lower(*ldargs).compile())
    lf["memory_xla"] = mem(f_xla.lower(*ldargs).compile())
    lgot = f_hand(*ldargs)
    lf["vs_xla_gpu"] = compare_fill(lgot, f_xla(*ldargs))
    ok &= fill_equal(lf["vs_xla_gpu"])
    lf["time_kernel_s"], _ = timed(lambda: f_hand(*ldargs), 2)
    lf["time_xla_s"], _ = timed(lambda: f_xla(*ldargs), 1)
    out["banded_fill_1x100kb"] = lf

    # --- backtrace chase: host C++ (prep's route) ---
    ch = {}
    t0 = time.perf_counter()
    host_pairs = host_chase(reads, args, *got[:3], bw)
    ch["host_s"] = time.perf_counter() - t0
    ch["host_s_per_read"] = ch["host_s"] / n_reads
    ch["reads_with_pairs"] = sum(int(p.shape[0] > 0) for p in host_pairs)
    ok &= ch["reads_with_pairs"] == n_reads
    out["banded_chase"] = ch

    # --- fill + chase vs the numpy oracle on two rows ---
    tp, rp = np.asarray(got[0]), np.asarray(got[1])
    orc = []
    for b in range(2):
        r = reads[b]
        res = refops.adaptive_banded_align(
            r["mean"], r["rq"], r["rq"], {i: i for i in range(len(r["rq"]))},
            models.pore_model, r["shift"], r["scale"], cfg.banded,
            keep_matrices=True)
        nb = int(args[4][b]) + int(args[5][b]) + 2
        tr, rg = banded.unpack_trace(tp[:, b : b + 1], rp[:, b : b + 1], nb)
        row = {"rights_equal": bool((rg[: nb - 2, 0] == (
                   np.diff(res.band_lower_left[:, 1]) == 1)[1:]).all()),
               "trace_mismatch_rate": float(
                   (tr[: nb - 2, 0] != res.trace[2:nb]).mean()),
               "alignment_equal": bool(
                   host_pairs[b].shape == res.event_alignment.shape
                   and (host_pairs[b] == res.event_alignment).all())}
        orc.append(row)
        # traces may differ in rare float ties (f32 device vs the oracle)
        ok &= (row["rights_equal"] and row["trace_mismatch_rate"] < 1e-3
               and row["alignment_equal"])
    fill["vs_oracle_rows"] = orc

    # --- windowed Viterbi, W=2048, T in {192, 384}, N=48 ---
    hmm = cfg.hmm
    hp = (hmm.external_D2D, hmm.external_D2M, hmm.external_I2M,
          hmm.external_M2D, hmm.internal_M2I, hmm.internal_I2I)
    table = jnp.asarray(models.pore_model.astype(np.float32))
    vit_out = {}
    for T in (192, 384):
        W = 64 if a.rehearse else 2048
        windows, obs, n_obs, ranks, n_states = viterbi_batch(
            models, cfg, W, T, 48, seed=T)
        epb = np.full(W, 2.0, np.float32)
        vargs = [jnp.asarray(x) for x in (obs, n_obs, ranks)] + [table] + [
            jnp.asarray(n_states), jnp.asarray(epb)]
        fv = jax.jit(lambda *x: vit.viterbi_from_ranks_jit(*x, hp))
        v = {"W": W, "T": T, "N": 48,
             "memory": mem(fv.lower(*vargs).compile())}
        pcp, pl, _ = fv(*vargs)
        pc = vit.unpack_path_codes(np.asarray(pcp))
        pl = np.asarray(pl)
        bad = 0
        for w in range(8):
            r, o = windows[w]
            want_p = refops.builtin_viterbi(o, r, models.pore_model, 0.0,
                                            1.0, events_per_base=2.0).path
            codes = pc[w][(pc[w] & 3) != vit.KIND_PAD]
            kinds, pos = vit.decode_path(codes, int(n_states[w]))
            got_p = np.stack([kinds.astype(np.int64), pos], axis=1)
            bad += int(got_p.shape != want_p.shape
                       or not (got_p == want_p).all())
        v["oracle_windows_differing"] = bad
        v["oracle_windows_checked"] = 8
        ok &= bad == 0
        v["time_s"], _ = timed(lambda: fv(*vargs), reps)
        vit_out[f"T{T}"] = v
    out["viterbi"] = vit_out

    # --- reference CNN forward, one 32-read batch ---
    from dnascent_tpu.pipeline.detect import _bucket_len
    B, L = (4, 256) if a.rehearse else (32, _bucket_len(10000))
    rng = np.random.default_rng(7)
    core = rng.integers(1, 1025, (B, L)).astype(np.int32)
    resid = rng.integers(1, 257, (B, L)).astype(np.int32)
    sig = rng.integers(0, 256, (B, L, rc.RAWDEPTH)).astype(np.uint8)
    model = rc.create_model()
    params = rc.params_from_tensors(rc.synthetic_tensors(0))
    fwd = jax.jit(lambda p, c, r, s: model.apply(p, c, r, s))
    cargs = (params, jnp.asarray(core), jnp.asarray(resid), jnp.asarray(sig))
    cnn = {"B": B, "L": L, "memory": mem(fwd.lower(*cargs).compile())}
    probs = np.asarray(fwd(*cargs))
    nb = min(B, 2)
    cpu_probs = np.asarray(fwd(*jax.device_put(
        (params, core[:nb], resid[:nb], sig[:nb]), cpu)))
    d = np.abs(probs[:nb] - cpu_probs)
    cnn["vs_cpu"] = {"rows": nb, "max_abs_diff": float(d.max()),
                     "mean_abs_diff": float(d.mean()),
                     "tolerance_max": CNN_PROB_MAX_ATOL,
                     "tolerance_mean": CNN_PROB_MEAN_ATOL}
    cnn["finite"] = bool(np.isfinite(probs).all())
    ok &= cnn["finite"] and probs_close(cnn["vs_cpu"])
    cnn["time_s"], _ = timed(lambda: fwd(*cargs), reps)
    out["cnn_forward"] = cnn
    out["ok"] = bool(ok)
    return out


# ---------------------------------------------------------------------------
# phases 3 and 4: the CLI
# ---------------------------------------------------------------------------

def signal_format(mods: dict) -> str:
    """The signal container this machine can read: VBZ pod5 needs pyarrow
    and zstandard, uncompressed pod5 rows only pyarrow, fast5 h5py."""
    if mods["pyarrow"]:
        return "pod5" if mods["zstandard"] else "pod5_raw"
    if mods["h5py"]:
        return "fast5"
    raise RuntimeError("no signal reader imports (pyarrow for pod5, h5py "
                       "for fast5)")


def build_inputs(root, models, cfg, n_reads, length, fmt):
    from dnascent_tpu.models import reference_cnn as rc
    from dnascent_tpu.testing.dataset import build_dataset
    from dnascent_tpu.testing.tf_bundle_writer import write_savedmodel_dir
    ds = build_dataset(os.path.join(root, "ds"), models, cfg,
                       n_reads=n_reads, read_length=length,
                       contig_length=max(50_000, 4 * length),
                       signal_format=fmt, seed=2024)
    model_dir = os.path.join(root, "detect_model")
    write_savedmodel_dir(model_dir, rc.synthetic_tensors(5))
    return ds, model_dir


def detect_argv(ds, model_dir, out, extra=()):
    return ["detect", "-b", ds.bam, "-r", ds.reference_fa, "-i", ds.index,
            "-o", out, "-l", "1000", "--model", model_dir, *extra]


def parse_detect(path) -> dict:
    """{read_id: (header, [(coord, edu, brdu, kmer), ...])}"""
    reads, cur = {}, None
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            if line.startswith(">"):
                cur = line[1:].split()[0]
                reads[cur] = (line.strip(), [])
            elif line.strip():
                c = line.rstrip("\n").split("\t")
                reads[cur][1].append((int(c[0]), float(c[1]), float(c[2]),
                                      c[3]))
    return reads


def compare_detect(got: dict, want: dict) -> dict:
    import numpy as np
    common = [r for r in want if r in got]
    coords_equal = all(
        got[r][0] == want[r][0]
        and [x[0] for x in got[r][1]] == [x[0] for x in want[r][1]]
        and [x[3] for x in got[r][1]] == [x[3] for x in want[r][1]]
        for r in common)
    d = np.concatenate([
        np.abs(np.asarray([x[1:3] for x in got[r][1]])
               - np.asarray([x[1:3] for x in want[r][1]])).ravel()
        for r in common if coords_equal and want[r][1]] or [np.zeros(1)])
    return {"reads_compared": len(common),
            "reads_missing": len(want) - len(common),
            "ids_and_coords_equal": bool(coords_equal),
            "max_abs_diff": float(d.max()), "mean_abs_diff": float(d.mean())}


def phase_cli(a, models, cfg, device_line) -> dict:
    from dnascent_tpu import cli
    out = {"phase": "cli_detect"}
    mods = device_line["imports"]
    fmt = signal_format(mods)
    n_reads, length = (6, 2000) if a.rehearse else (64, 10000)
    n_cpu = 3 if a.rehearse else 8
    out.update(signal_format=fmt, n_reads=n_reads, read_bp=length)
    root = tempfile.mkdtemp(prefix="smoke_cli_")
    ds, model_dir = build_inputs(root, models, cfg, n_reads, length, fmt)
    cpu_out = os.path.join(root, "cpu.detect")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    child_log = os.path.join(root, "cpu_child.log")
    with open(child_log, "w") as log:
        child = subprocess.Popen(
            [sys.executable, "-m", "dnascent_tpu",
             *detect_argv(ds, model_dir, cpu_out, ("-m", str(n_cpu)))],
            env=env, stdout=log, stderr=subprocess.STDOUT)
    runs = []
    for i in range(2):   # cold (compiles), then warm
        gpu_out = os.path.join(root, f"gpu{i}.detect")
        t0 = time.perf_counter()
        rc_ = cli.main(detect_argv(ds, model_dir, gpu_out))
        dt = time.perf_counter() - t0
        got = parse_detect(gpu_out)
        runs.append({"rc": rc_, "wall_s": dt, "reads_out": len(got),
                     "reads_per_s": n_reads / dt})
    out["runs"] = runs
    out["flax_imported"] = "flax" in sys.modules
    t0 = time.perf_counter()
    child.wait()
    out["cpu_child_wait_s"] = time.perf_counter() - t0
    out["cpu_child_rc"] = child.returncode
    ok = (all(r["rc"] == 0 and r["reads_out"] > 0 for r in runs)
          and not out["flax_imported"] and child.returncode == 0)
    if child.returncode == 0:
        cmp_ = compare_detect(got, parse_detect(cpu_out))
        out["vs_cpu"] = cmp_
        ok &= (cmp_["ids_and_coords_equal"] and cmp_["reads_missing"] == 0
               and cmp_["reads_compared"] > 0 and probs_close(cmp_))
    else:
        out["cpu_child_log"] = open(child_log).read()[-2000:]
    with open(gpu_out) as fh:
        out["compute_header"] = [l.strip() for l in fh
                                 if l.startswith("#Compute")][:1]
    out["ok"] = bool(ok)
    return out


def phase_four_cards(a, models, cfg, device_line) -> dict:
    """CLI detect with --devices 4 against --devices 1 on the same data in
    one process."""
    from dnascent_tpu import cli
    from dnascent_tpu.parallel import compute
    out = {"phase": "four_cards"}
    mods = device_line["imports"]
    fmt = signal_format(mods)
    n_reads, length = (8, 2000) if a.rehearse else (64, 10000)
    out.update(signal_format=fmt, n_reads=n_reads, read_bp=length)
    root = tempfile.mkdtemp(prefix="smoke_4c_")
    ds, model_dir = build_inputs(root, models, cfg, n_reads, length, fmt)

    def run(n):
        path = os.path.join(root, f"d{n}.detect")
        rc_ = cli.main(detect_argv(ds, model_dir, path,
                                   ("--devices", str(n))))
        compute.set_compute_mesh(None)
        return rc_, parse_detect(path)

    res = {}
    warm = {}
    for rep in range(2):        # cold (compiles), then warm
        for n in (4, 1):
            t0 = time.perf_counter()
            rc_, rows = run(n)
            res[n] = (rc_, time.perf_counter() - t0, rows)
            if rep:
                warm[n] = res[n][1]
    out["warm_reads_per_s"] = {f"devices{n}": n_reads / t
                               for n, t in warm.items()}
    out["devices4"] = {"rc": res[4][0], "wall_s": res[4][1]}
    out["devices1"] = {"rc": res[1][0], "wall_s": res[1][1]}
    out["bitwise_equal"] = res[4][2] == res[1][2]
    cmp_ = compare_detect(res[4][2], res[1][2])
    out["vs_one_card"] = cmp_
    out["ok"] = bool(res[4][0] == 0 and res[1][0] == 0
                     and cmp_["reads_compared"] > 0
                     and cmp_["ids_and_coords_equal"]
                     and cmp_["reads_missing"] == 0 and probs_close(cmp_))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card CLI detect check")
    ap.add_argument("--rehearse", action="store_true",
                    help="toy sizes on whatever device JAX has; prints no "
                    "result line")
    a = ap.parse_args()
    try:
        import jax
        from dnascent_tpu.config import DNA_R10
        from dnascent_tpu.io.poremodel import synthetic_model_set
    except ImportError as e:
        print(f"chip_smoke: cannot import the system: {e}", file=sys.stderr)
        return 2
    devs = jax.devices()
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    if dev["platform"] != "gpu" and not a.rehearse:
        print(f"chip_smoke: needs a GPU, JAX found {dev}", file=sys.stderr)
        return 3
    if a.four_cards and dev["count"] < 4:
        print(f"chip_smoke: --four-cards needs 4 devices, found {dev}",
              file=sys.stderr)
        return 3
    os.makedirs(OUT_DIR, exist_ok=True)
    smi = nvidia_smi()
    device_line = {"phase": "device", **dev, "nvidia_smi": smi,
                   "imports": importable(["flax", "pyarrow", "zstandard",
                                          "h5py"])}
    emit(device_line)
    print(f"card: {smi}", flush=True)
    cfg = DNA_R10
    models = synthetic_model_set(cfg)
    phases = ([phase_four_cards] if a.four_cards
              else [phase_kernels, phase_cli])
    failed = []
    for ph in phases:
        note(f"{ph.__name__} ...")
        t0 = time.perf_counter()
        try:
            if ph is phase_kernels:
                line = ph(a, models, cfg)
            else:
                line = ph(a, models, cfg, device_line)
        except Exception:
            line = {"phase": ph.__name__, "ok": False,
                    "error": traceback.format_exc()[-3000:]}
        line["phase_s"] = time.perf_counter() - t0
        emit(line)
        with open(os.path.join(OUT_DIR, f"{line['phase']}.json"), "w") as fh:
            json.dump(line, fh, indent=1)
        if not line.get("ok"):
            failed.append(line["phase"])
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    if a.rehearse:
        print("chip_smoke: rehearsal passed (not a chip result)",
              file=sys.stderr)
        return 0
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
