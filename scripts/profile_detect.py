#!/usr/bin/env python
"""Stage-level wall-clock profile of the detect pipeline on the current JAX
backend.  Usage: python scripts/profile_detect.py [n_reads] [read_len]."""

import sys
import time

import numpy as np


from dnascent_tpu.config import DNA_R10
from dnascent_tpu.io.poremodel import synthetic_model_set
from dnascent_tpu.models import cnn as cnn_mod
from dnascent_tpu.pipeline import eventalign as ea
from dnascent_tpu.pipeline.detect import run_cnn_batched, collect_calls
from dnascent_tpu.pipeline.prep import prepare_reads
from dnascent_tpu.pipeline.source import SimulatedSource


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    read_len = int(sys.argv[2]) if len(sys.argv) > 2 else 5000
    cfg = DNA_R10
    models = synthetic_model_set(cfg)
    model = cnn_mod.create_model()
    params = cnn_mod.default_params(model)

    def run_once(records, tag):
        t = {}
        t0 = time.perf_counter()
        prepped = prepare_reads(records, models, cfg)
        t["prep(events+banded+ts)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = ea.run_eventalign(prepped, models, cfg)
        t["eventalign(fast)"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        probs = run_cnn_batched(model, params, results, prepped)
        t["cnn"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_calls = 0
        for p in prepped:
            r = results.get(p.record.read_id)
            if r and r.qc_passed and p.record.read_id in probs:
                d = collect_calls(p.record, r.positions, probs[p.record.read_id])
                n_calls += d.ref_coords.shape[0]
        t["collect"] = time.perf_counter() - t0
        total = sum(t.values())
        print(f"--- {tag}: {len(records)} reads x {read_len} bp, "
              f"{n_calls} calls, total {total:.2f}s "
              f"({len(records)/total:.2f} reads/s)")
        for k, v in t.items():
            print(f"  {k:28s} {v*1000:9.1f} ms")

    src = SimulatedSource(models, cfg, n_reads=n_reads, length=read_len,
                          seed=77)
    records = list(src)
    run_once(records[:4], "warmup/compile")
    run_once(records, "steady")
    run_once(records, "steady2")


if __name__ == "__main__":
    main()
