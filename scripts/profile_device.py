#!/usr/bin/env python
"""Device-vs-host-vs-transfer split at bench shapes (current pipeline API).

Usage: python scripts/profile_device.py [n_reads] [read_len]
"""

import sys
import time

import numpy as np
import jax
import jax.numpy as jnp


from dnascent_tpu.config import DNA_R10
from dnascent_tpu.io.poremodel import synthetic_model_set
from dnascent_tpu.models import cnn as cnn_mod
from dnascent_tpu.pipeline import eventalign as ea
from dnascent_tpu.pipeline.detect import run_cnn_batched, collect_calls
from dnascent_tpu.pipeline.prep import prepare_reads
from dnascent_tpu.pipeline.source import SimulatedSource

cfg = DNA_R10
models = synthetic_model_set(cfg)
n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 16
read_len = int(sys.argv[2]) if len(sys.argv) > 2 else 10000

records = list(SimulatedSource(models, cfg, n_reads=n_reads,
                               length=read_len, seed=1234))
model = cnn_mod.create_model()
params = cnn_mod.default_params(model)

prepped = prepare_reads(records, models, cfg)
results = ea.run_eventalign(prepped, models, cfg)
probs = run_cnn_batched(model, params, results, prepped)

hmm = cfg.hmm
hmm_probs = tuple(getattr(hmm, k) for k in ea.HMM_KEY)
t_buckets = (128, 256, 512, 1024)


def bench_once(tag):
    print(f"--- {tag}: {n_reads} reads x {read_len} bp")
    t0 = time.perf_counter()
    prepped = prepare_reads(records, models, cfg)
    t_prep = time.perf_counter() - t0

    t0 = time.perf_counter()
    states = [ea._build_state(p, models, cfg)
              for p in prepped if p.passed and p.event_alignment.shape[0]]
    t_state = time.perf_counter() - t0

    t0 = time.perf_counter()
    sets = []
    n_windows = 0
    for st in states:
        ws = ea._build_window_set(st, cfg, t_buckets[-1])
        if ws is not None and ws.ri.shape[0]:
            sets.append((st, ws, n_windows, n_windows + ws.ri.shape[0]))
            n_windows += ws.ri.shape[0]
    t_wb = time.perf_counter() - t0

    t0 = time.perf_counter()
    obs_parts, base = [], 0
    for st, ws, w0, w1 in sets:
        st.flat_obs_base = base
        obs_parts.append(st.g_obs)
        base += st.g_obs.shape[0]
    obs_flat = np.zeros(ea._bucket_up(base, 1 << 17), dtype=np.float16)
    obs_flat[:base] = np.concatenate(obs_parts)
    obs_flat_dev = jnp.asarray(obs_flat)
    for st in states:
        st.rank_off = st.p.flat_ranks_offset
    all_lens = np.concatenate([ws.g1 - ws.g0 for _, ws, _, _ in sets])
    all_ostarts = np.concatenate(
        [st.flat_obs_base + ws.g0 for st, ws, _, _ in sets])
    all_rstarts = np.concatenate(
        [st.rank_off + ws.ri for st, ws, _, _ in sets])
    all_ns = np.concatenate([ws.ns for _, ws, _, _ in sets])
    all_epb = np.concatenate([np.full(ws.ri.shape[0], st.p.events_per_base)
                              for st, ws, _, _ in sets])
    wbucket = np.searchsorted(np.asarray(t_buckets), all_lens, side="left")
    handles = []
    for bi in range(len(t_buckets)):
        order = np.flatnonzero(wbucket == bi)
        for c0 in range(0, order.shape[0], 8192):
            cid = order[c0:c0 + 8192]
            handles.append((cid, ea._viterbi_dispatch_flat_arrays(
                all_lens[cid], all_ostarts[cid], all_rstarts[cid],
                all_ns[cid], all_epb[cid], obs_flat_dev,
                states[0].p.flat_ranks_device, models, cfg, hmm_probs, 72,
                t_buckets)))
    t_disp = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _, h in handles:
        h[0].block_until_ready()
    t_wait = time.perf_counter() - t0

    t0 = time.perf_counter()
    results = {}
    for cid, h in handles:
        for wid, res in zip(cid, ea._viterbi_windows_collect(h)):
            results[wid] = res
    t_col = time.perf_counter() - t0

    t0 = time.perf_counter()
    for st, ws, w0, w1 in sets:
        ea._process_read_windows_batched(
            st, ws, [results[i] for i in range(w0, w1)], cfg)
    t_post = time.perf_counter() - t0

    from dnascent_tpu.pipeline.eventalign import (EventalignResult,
                                                  AlignedPositions, RAWDEPTH)
    t0 = time.perf_counter()
    res = {}
    for st in states:
        rid = st.p.record.read_id
        acc = st.acc
        if not acc["coord"]:
            res[rid] = EventalignResult(None, None, False)
            continue
        n_signals = np.concatenate([np.atleast_1d(np.asarray(x, np.int64))
                                    for x in acc["nsig"]])
        pos = AlignedPositions(
            coord=np.concatenate(acc["coord"]),
            kmer_start=np.concatenate(acc["kmer_start"]),
            query_idx=np.concatenate(acc["query_idx"]),
            ref_idx=np.concatenate(acc["ref_idx"]),
            core_idx=np.concatenate(acc["core"]),
            residual_idx=np.concatenate(acc["res"]),
            n_signals=n_signals,
            center_is_T=np.concatenate(acc["centerT"]),
            indel_score=np.concatenate(acc["indel"]),
            signal_u8_flat=np.concatenate(acc["sigflat"]),
            signal_counts=np.minimum(n_signals, RAWDEPTH).astype(np.uint8),
            _sig_store=acc["sigstore"][0])
        res[rid] = EventalignResult(pos, None, True)
    t_fin = time.perf_counter() - t0

    t0 = time.perf_counter()
    probs = run_cnn_batched(model, params, res, prepped)
    t_cnn = time.perf_counter() - t0

    t0 = time.perf_counter()
    outs = []
    for p in prepped:
        r = res.get(p.record.read_id)
        if r is not None and r.qc_passed and p.record.read_id in probs:
            outs.append(collect_calls(p.record, r.positions,
                                      probs[p.record.read_id]))
    t_cc = time.perf_counter() - t0

    print(f"  prep total             {1000*t_prep:8.1f} ms")
    print(f"  ea state build         {1000*t_state:8.1f} ms")
    print(f"  ea window build        {1000*t_wb:8.1f} ms")
    print(f"  ea upload+dispatch     {1000*t_disp:8.1f} ms")
    print(f"  ea device wait         {1000*t_wait:8.1f} ms")
    print(f"  ea collect (dl+unpack) {1000*t_col:8.1f} ms")
    print(f"  ea post-process        {1000*t_post:8.1f} ms")
    print(f"  ea finalize            {1000*t_fin:8.1f} ms")
    print(f"  cnn (incl wait)        {1000*t_cnn:8.1f} ms")
    print(f"  collect_calls          {1000*t_cc:8.1f} ms")


bench_once("steady1")
bench_once("steady2")
