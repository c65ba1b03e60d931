#!/usr/bin/env python
"""Fine-grained substage profile of detect on the current backend.

Times the production ``run_eventalign`` fast path by instrumenting its
internals (state build / window-set build / obs build / viterbi dispatch /
viterbi collect / post-process) plus prep and CNN, at bench shapes.

Usage: python scripts/profile_fine.py [n_reads] [read_len]
"""

import sys
import time
from collections import defaultdict

import numpy as np


from dnascent_tpu.config import DNA_R10
from dnascent_tpu.io.poremodel import synthetic_model_set
from dnascent_tpu.models import reference_cnn
from dnascent_tpu.pipeline import eventalign as ea
from dnascent_tpu.pipeline.detect import run_cnn_batched
from dnascent_tpu.pipeline.prep import prepare_reads
from dnascent_tpu.pipeline.source import SimulatedSource

T = defaultdict(float)


def _wrap(mod, name, key):
    fn = getattr(mod, name)

    def timed(*a, **k):
        t0 = time.perf_counter()
        r = fn(*a, **k)
        T[key] += time.perf_counter() - t0
        return r

    setattr(mod, name, timed)
    return fn


def main():
    n_reads = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    read_len = int(sys.argv[2]) if len(sys.argv) > 2 else 10000
    cfg = DNA_R10
    models = synthetic_model_set(cfg)
    model = reference_cnn.create_model()
    params = reference_cnn.params_from_tensors(
        reference_cnn.synthetic_tensors(0))
    records = list(SimulatedSource(models, cfg, n_reads=n_reads,
                                   length=read_len, seed=77))

    _wrap(ea, "_build_state", "ea: state build")
    _wrap(ea, "_build_window_set", "ea: window-set build")
    _wrap(ea, "_obs_build_jit", "ea: obs build (device)")
    _wrap(ea, "_viterbi_dispatch_flat_arrays", "ea: viterbi dispatch")
    _wrap(ea, "_viterbi_windows_collect", "ea: viterbi collect")
    _wrap(ea, "_process_read_windows_batched", "ea: post-process")

    for tag in ("warm", "steady", "steady2"):
        T.clear()
        t0 = time.perf_counter()
        prepped = prepare_reads(records, models, cfg)
        t_prep = time.perf_counter() - t0
        t0 = time.perf_counter()
        results = ea.run_eventalign(prepped, models, cfg, collect_text=False)
        t_ea = time.perf_counter() - t0
        t0 = time.perf_counter()
        run_cnn_batched(model, params, results, prepped)
        t_cnn = time.perf_counter() - t0
        total = t_prep + t_ea + t_cnn
        print(f"--- {tag}: {n_reads} reads x {read_len} bp, "
              f"total {total:.2f}s ({n_reads/total:.2f} reads/s unpipelined)")
        print(f"  prep                  {t_prep*1000:9.1f} ms")
        print(f"  eventalign            {t_ea*1000:9.1f} ms")
        for k in sorted(T):
            print(f"    {k:22s} {T[k]*1000:7.1f} ms")
        print(f"  cnn                   {t_cnn*1000:9.1f} ms")


if __name__ == "__main__":
    main()
