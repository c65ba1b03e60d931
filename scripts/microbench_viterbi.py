#!/usr/bin/env python
"""Device-time microbench of the viterbi kernel at typical chunk shapes.
Honours DNASCENT_VIT_FILL_UNROLL / DNASCENT_VIT_BT_UNROLL."""
import os, sys, time
import numpy as np, jax, jax.numpy as jnp
from dnascent_tpu.config import DNA_R10
from dnascent_tpu.ops import viterbi as vit

cfg = DNA_R10
hmm = cfg.hmm
HMM_KEY = ("external_D2D", "external_D2M", "external_I2M", "external_M2D",
           "internal_M2I", "internal_I2I")
hmm_probs = tuple(getattr(hmm, k) for k in HMM_KEY)
rng = np.random.default_rng(0)
obs_flat = jnp.asarray(rng.normal(0, 1, 1 << 17).astype(np.float16))
ranks_flat = jnp.asarray(rng.integers(0, 4**9, 1 << 16).astype(np.int32))
table = jnp.asarray(np.stack([rng.normal(90, 10, 4**9),
                              rng.uniform(1, 3, 4**9)], 1).astype(np.float32))
shapes = [(2048, 128), (2048, 256), (512, 512)]
print(f"fill_unroll={vit._FILL_UNROLL} bt_unroll={vit._BT_UNROLL}")
for W, T in shapes:
    ostarts = jnp.asarray(rng.integers(0, (1<<17) - T, W).astype(np.int32))
    n_obs = jnp.asarray(np.full(W, T * 3 // 4, np.int32))
    rstarts = jnp.asarray(rng.integers(0, (1<<16) - 72, W).astype(np.int32))
    n_states = jnp.asarray(np.full(W, 42, np.int32))
    epb = jnp.asarray(np.full(W, 1.8, np.float32))
    args = (obs_flat, ostarts, n_obs, rstarts, ranks_flat, table, n_states,
            epb, hmm_probs, 72, T)
    t0 = time.perf_counter()
    pc, pl, sc = vit.viterbi_from_flat_jit(*args)
    pc.block_until_ready()
    t_compile = time.perf_counter() - t0
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        pc, pl, sc = vit.viterbi_from_flat_jit(*args)
        pc.block_until_ready()
        ts.append(time.perf_counter() - t0)
    print(f"W={W} T={T}: compile {t_compile:.1f}s, steady {1000*min(ts):.1f} ms")
