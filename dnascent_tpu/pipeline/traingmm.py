"""trainGMM: per-9-mer Gaussian mixture fitting from align output.

Re-design of the reference trainer (reference: src/trainGMM.cpp:376-530):
event pools per k-mer (cap 10000), 1-D DBSCAN outlier removal
(eps 0.5 pA, minPoints 2.5% of pool), then a 2-component EM where component 1
is pinned to the ONT model (gaussianMixtureEM_PRIOR, trainGMM.cpp:185-265).

Device re-design: the 4^9 independent EM problems are embarrassingly parallel —
they run as one batched, masked, log-space EM on device (chunked over k-mers),
with per-kmer convergence freezing.  The 1-D DBSCAN reduces to an
order-independent rule (non-noise = within eps of a core point), vectorised
with prefix sums over sorted pools.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SubstrateConfig, DNA_R10, TrainGMMParams
from ..io.poremodel import PoreModelSet
from ..utils.seqtools import index2kmer, kmer2index


def parse_align_events(path: str, kmer_len: int, max_events: int,
                       max_reads: int | None = None) -> dict[int, np.ndarray]:
    """Stream align output, pooling scaled event means per k-mer
    (trainGMM.cpp:424-463).  Column 2 is the scaled event, column 3 the
    k-mer; N-containing insertion rows are skipped."""
    pools: dict[int, list] = {}
    reads = 0
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line[0] == "#":
                continue
            if line[0] == ">":
                reads += 1
                if max_reads is not None and reads > max_reads:
                    break
                continue
            cols = line.rstrip("\n").split("\t")
            kmer = cols[3]
            if "N" in kmer:
                continue
            idx = kmer2index(kmer, kmer_len)
            pool = pools.setdefault(idx, [])
            if len(pool) < max_events:
                pool.append(float(cols[2]))
    return {k: np.asarray(v) for k, v in pools.items()}


def dbscan_filter_1d(events: np.ndarray, eps: float,
                     min_points: int) -> np.ndarray:
    """Non-noise mask for 1-D DBSCAN (DBSCAN, trainGMM.cpp:143-182).

    A point survives iff it lies within eps of a *core* point (core points
    are within eps of themselves).  Equivalent to the reference's cluster
    expansion, order-independently."""
    order = np.argsort(events, kind="stable")
    s = events[order]
    lo = np.searchsorted(s, s - eps, side="left")
    hi = np.searchsorted(s, s + eps, side="right")
    n_nb = hi - lo
    core = n_nb >= min_points
    # survivors: within eps of any core point
    core_vals = s[core]
    if core_vals.size == 0:
        keep_sorted = np.zeros_like(core)
    else:
        j = np.searchsorted(core_vals, s)
        left = np.where(j > 0, np.abs(s - core_vals[np.maximum(j - 1, 0)]),
                        np.inf)
        right = np.where(j < core_vals.size,
                         np.abs(core_vals[np.minimum(j, core_vals.size - 1)] - s),
                         np.inf)
        keep_sorted = np.minimum(left, right) <= eps
    keep = np.zeros(events.shape[0], dtype=bool)
    keep[order] = keep_sorted
    return keep


@functools.partial(jax.jit, static_argnames=("max_iter",))
def _em_prior_batch(data: jnp.ndarray,     # (K, M) f32
                    mask: jnp.ndarray,     # (K, M) bool
                    mu1: jnp.ndarray, sigma1: jnp.ndarray,   # (K,) pinned
                    mu2_0: jnp.ndarray, sigma2_0: jnp.ndarray,
                    pi_init: float, tolerance: float, max_iter: int = 100):
    """Batched, masked, log-space EM with component 1 frozen
    (gaussianMixtureEM_PRIOR, trainGMM.cpp:185-265)."""
    K, M = data.shape
    n = jnp.maximum(mask.sum(axis=1).astype(jnp.float32), 1.0)

    def log_norm(x, mu, sigma):
        z = (x - mu[:, None]) / sigma[:, None]
        return (-0.5 * jnp.log(2.0 * jnp.pi * sigma[:, None] ** 2)
                - 0.5 * z * z)

    def loglik(pi1, pi2, mu2, sigma2):
        l1 = jnp.log(pi1)[:, None] + log_norm(data, mu1, sigma1)
        l2 = jnp.log(pi2)[:, None] + log_norm(data, mu2, sigma2)
        lse = jnp.logaddexp(l1, l2)
        return jnp.sum(jnp.where(mask, lse, 0.0), axis=1), l1, l2, lse

    pi1 = jnp.full((K,), 1.0 - pi_init)
    pi2 = jnp.full((K,), pi_init)
    mu2 = mu2_0
    sigma2 = sigma2_0
    ll_old, _, _, _ = loglik(pi1, pi2, mu2, sigma2)
    frozen = jnp.zeros((K,), dtype=bool)

    def body(state, _):
        pi1, pi2, mu2, sigma2, ll_old, frozen = state
        _, l1, l2, lse = loglik(pi1, pi2, mu2, sigma2)
        r2 = jnp.where(mask, jnp.exp(l2 - lse), 0.0)
        r1 = jnp.where(mask, 1.0 - r2, 0.0)
        nk1 = r1.sum(axis=1)
        nk2 = jnp.maximum(r2.sum(axis=1), 1e-12)
        pi1n = nk1 / n
        pi2n = nk2 / n
        mu2n = (r2 * data).sum(axis=1) / nk2
        var2 = (r2 * (data - mu2n[:, None]) ** 2).sum(axis=1) / nk2
        sigma2n = jnp.sqrt(jnp.maximum(var2, 1e-12))
        ll_new, _, _, _ = loglik(pi1n, pi2n, mu2n, sigma2n)
        improved = (ll_new - ll_old) > tolerance
        keep = frozen | ~improved
        pi1 = jnp.where(frozen, pi1, pi1n)
        pi2 = jnp.where(frozen, pi2, pi2n)
        mu2 = jnp.where(frozen, mu2, mu2n)
        sigma2 = jnp.where(frozen, sigma2, sigma2n)
        ll_old = jnp.where(frozen, ll_old, ll_new)
        return (pi1, pi2, mu2, sigma2, ll_old, keep), None

    (pi1, pi2, mu2, sigma2, _, _), _ = jax.lax.scan(
        body, (pi1, pi2, mu2, sigma2, ll_old, frozen), None, length=max_iter)
    return pi1, pi2, mu2, sigma2


@dataclass
class GMMFit:
    kmer_index: int
    ont_mean: float
    ont_stdv: float
    pi1: float
    mu1: float
    sigma1: float
    pi2: float
    mu2: float
    sigma2: float
    n_imported: int
    n_filtered: int


def train_gmm(pools: dict[int, np.ndarray], models: PoreModelSet,
              cfg: SubstrateConfig = DNA_R10,
              chunk: int = 2048) -> list[GMMFit]:
    """Full trainGMM: DBSCAN filter + batched device EM (train_main,
    trainGMM.cpp:376-530)."""
    p = cfg.traingmm
    jobs = []
    for idx, ev in pools.items():
        if ev.shape[0] < p.min_raw_events:
            continue
        min_points = int(p.dbscan_min_points_fraction * ev.shape[0])
        keep = dbscan_filter_1d(ev, p.dbscan_epsilon, min_points)
        filt = ev[keep]
        if filt.shape[0] < p.min_filtered_events:
            continue
        jobs.append((idx, ev.shape[0], filt))
    if not jobs:
        return []

    fits: list[GMMFit] = []
    for c0 in range(0, len(jobs), chunk):
        group = jobs[c0 : c0 + chunk]
        K = len(group)
        M = max(f.shape[0] for _, _, f in group)
        data = np.zeros((K, M), dtype=np.float32)
        mask = np.zeros((K, M), dtype=bool)
        mu1 = np.zeros(K, dtype=np.float32)
        s1 = np.ones(K, dtype=np.float32)
        for i, (idx, _, filt) in enumerate(group):
            data[i, : filt.shape[0]] = filt
            mask[i, : filt.shape[0]] = True
            mu1[i] = models.pore_model[idx, 0]
            s1[i] = models.pore_model[idx, 1]
        mu2_0 = mu1.copy()
        s2_0 = (p.prior_stdv_multiplier * s1).astype(np.float32)
        pi1, pi2, mu2, sigma2 = _em_prior_batch(
            jnp.asarray(data), jnp.asarray(mask), jnp.asarray(mu1),
            jnp.asarray(s1), jnp.asarray(mu2_0), jnp.asarray(s2_0),
            p.default_pi, p.em_tolerance, p.em_max_iterations)
        pi1 = np.asarray(pi1); pi2 = np.asarray(pi2)
        mu2 = np.asarray(mu2); sigma2 = np.asarray(sigma2)
        for i, (idx, n_raw, filt) in enumerate(group):
            fits.append(GMMFit(idx, float(mu1[i]), float(s1[i]),
                               float(pi1[i]), float(mu1[i]), float(s1[i]),
                               float(pi2[i]), float(mu2[i]), float(sigma2[i]),
                               n_raw, filt.shape[0]))
    return fits


def write_gmm_table(fits: list[GMMFit], path: str, kmer_len: int = 9) -> None:
    """Fitted-model TSV in the reference layout (trainGMM.cpp:468,519-523) —
    the file import_poreModel_fitStdv consumes."""
    with open(path, "w") as fh:
        fh.write("6mer\tONT_mean\tONT_stdv\tpi_1\tmean_1\tstdv_1\tpi_2\t"
                 "mean_2\tstdv_2\timported_events\tfiltered_events\n")
        for f in fits:
            kmer = index2kmer(f.kmer_index, kmer_len)
            fh.write(f"{kmer}\t{f.ont_mean:.6f}\t{f.ont_stdv:.6f}"
                     f"\t{f.pi1:.6f}\t{f.mu1:.6f}\t{f.sigma1:.6f}"
                     f"\t{f.pi2:.6f}\t{f.mu2:.6f}\t{f.sigma2:.6f}"
                     f"\t{f.n_imported}\t{f.n_filtered}\n")
