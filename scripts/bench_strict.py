#!/usr/bin/env python
"""Fast-mode vs strict-mode detect throughput on the current backend.

VERDICT r2 item 7 acceptance: strict-mode reads/s within 3x of fast mode.
Usage: python scripts/bench_strict.py [n] [len]
"""

import sys
import time


from dnascent_tpu.config import DNA_R10
from dnascent_tpu.io.poremodel import synthetic_model_set
from dnascent_tpu.models import cnn as cnn_mod
from dnascent_tpu.pipeline.detect import detect_reads, DetectStats
from dnascent_tpu.pipeline.source import SimulatedSource


def run(records, models, model, params, strict, reps=2):
    best = 0.0
    for _ in range(reps):
        stats = DetectStats()
        t0 = time.perf_counter()
        n = sum(1 for _ in detect_reads(
            records, models, model, params, DNA_R10,
            stats=stats, strict_windows=strict))
        dt = time.perf_counter() - t0
        best = max(best, stats.processed / dt)
    return best, n


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    read_len = int(sys.argv[2]) if len(sys.argv) > 2 else 10000
    cfg = DNA_R10
    models = synthetic_model_set(cfg)
    model = cnn_mod.create_model()
    params = cnn_mod.default_params(model)
    records = list(SimulatedSource(models, cfg, n_reads=n_reads,
                                   length=read_len, seed=99))
    # warmup/compile both modes
    run(records[:16], models, model, params, strict=False, reps=1)
    run(records[:16], models, model, params, strict=True, reps=1)
    fast, _ = run(records, models, model, params, strict=False)
    strict, _ = run(records, models, model, params, strict=True)
    print(f"fast:   {fast:7.2f} reads/s ({n_reads} x {read_len} bp)")
    print(f"strict: {strict:7.2f} reads/s  -> fast/strict = "
          f"{fast / max(strict, 1e-9):.2f}x (target <= 3x)")


if __name__ == "__main__":
    main()
