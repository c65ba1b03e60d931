"""Batched adaptive banded event alignment — the plain XLA fill.

A from-scratch JAX re-design of the nanopolish-style adaptive banded DP
(reference: src/event_handling.cpp:148-316).  Instead of one read per CPU
thread, a whole padded batch of reads advances in lockstep through their
anti-diagonal bands:

* the band (width 100) is the minor array axis; the read batch is the major
  one;
* Suzuki's adaptive placement rule (event_handling.cpp:234-253) is evaluated
  per read each step; predecessor bands reduce to one-cell shifts of the
  previous two bands selected by the right/down decisions;
* per-band emission windows are fetched with batched dynamic slices of
  precomputed per-kmer emission coefficients;
* 2-bit traceback codes are packed four bands per byte; the backtrace itself
  is a sequential pointer chase done host-side (native.banded_backtrace),
  with band placements reconstructed from a packed per-band right/down
  bitstream.

The final-row start cell search (event_handling.cpp:324-340) is folded into
the scan carry so no extra score matrix leaves the device.

:func:`banded_fill` is the reference every fill is checked against and the
route on the CPU; ``impl="cuda"`` selects the one-block-per-read CUDA kernel
(dnascent_tpu/cuda/banded_fill_kernel.h) with the same contract.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from ..config import BandedAlignmentParams

NEG = np.float32(-np.inf)
FROM_D, FROM_U, FROM_L = 0, 1, 2
LOG_INV_SQRT_2PI = float(np.log(0.3989422804014327))


@dataclass
class BandedDeviceOut:
    """Device outputs of the banded fill, everything the host backtrace needs."""

    trace_packed: np.ndarray  # (ceil(n_bands/4), B, W) uint8, 4x 2-bit codes per byte
    rights_packed: np.ndarray  # (ceil(n_bands/4), B) uint8, 4x right/down bits
    best_event: np.ndarray    # (B,) int32 backtrace start event index
    best_score: np.ndarray    # (B,) float32


def _shift_up(p: jnp.ndarray) -> jnp.ndarray:
    """out[o] = p[o+1] (drop lane 0, append -inf)."""
    return jnp.concatenate([p[:, 1:], jnp.full((p.shape[0], 1), NEG)], axis=1)


def _shift_down(p: jnp.ndarray) -> jnp.ndarray:
    """out[o] = p[o-1] (prepend -inf)."""
    return jnp.concatenate([jnp.full((p.shape[0], 1), NEG), p[:, :-1]], axis=1)


def _batched_slice(arr: jnp.ndarray, start: jnp.ndarray, width: int) -> jnp.ndarray:
    """out[b, o] = arr[b, start[b] + o]; ``arr`` must be pre-padded so all
    accessed indices are in range."""
    return jax.vmap(lambda a, s: jax.lax.dynamic_slice(a, (s,), (width,)))(arr, start)


def _transition_logs(n_events, n_kmers, epsilon_skip):
    """Per-read (lp_stay, lp_step): p_stay depends on events per k-mer
    (event_handling.cpp:174-182)."""
    events_per_kmer = n_events.astype(jnp.float32) / n_kmers.astype(jnp.float32)
    p_stay = 1.0 - (1.0 / (events_per_kmer + 1.0))
    lp_stay = jnp.log(p_stay).astype(jnp.float32)
    lp_step = jnp.log1p(-(jnp.float32(epsilon_skip) + p_stay)).astype(jnp.float32)
    return lp_stay, lp_step


def banded_fill(scaled_events: jnp.ndarray,   # (B, E) f32, (mean-shift)/scale
                mu: jnp.ndarray,              # (B, K) f32 model mean per query kmer
                inv_sigma: jnp.ndarray,       # (B, K) f32
                lp_const: jnp.ndarray,        # (B, K) f32 log(1/(sigma*sqrt(2pi)))
                n_events: jnp.ndarray,        # (B,) i32
                n_kmers: jnp.ndarray,         # (B,) i32
                bandwidth: int = 100,
                epsilon_skip: float = 1e-30,
                p_trim: float = 0.01):
    """Run the adaptive banded fill for a padded batch.

    Returns (trace_packed, rights_packed, best_event, best_score) as jnp
    arrays.  Transition log-probabilities are per read since p_stay depends on
    events-per-kmer (event_handling.cpp:174-182).
    """
    B, E = scaled_events.shape
    K = mu.shape[1]
    W = bandwidth
    half = W // 2
    n_bands = E + K + 2
    n_steps = (n_bands - 2 + 3) // 4  # bands 2..n_bands-1, 4 per step
    lp_stay, lp_step = _transition_logs(n_events, n_kmers, epsilon_skip)
    lp_skip = jnp.float32(np.log(epsilon_skip))
    lp_trim = jnp.float32(np.log(p_trim))

    # pad coefficient arrays with W slack on both sides so batched dynamic
    # slices never go out of range (slack lanes carry -inf emissions)
    pad_cfg = ((0, 0), (W, W))
    mu_p = jnp.pad(mu, pad_cfg)
    is_p = jnp.pad(inv_sigma, pad_cfg, constant_values=1.0)
    lc_p = jnp.pad(lp_const, pad_cfg, constant_values=NEG)
    # reversed events so that slice at (E-1-e0) yields ev[e0], ev[e0-1], ...
    rev_ev = jnp.pad(scaled_events[:, ::-1], pad_cfg)

    offs = jnp.arange(W, dtype=jnp.int32)[None, :]  # (1, W)

    # bands 0 and 1 (event_handling.cpp:212-228)
    band0 = jnp.full((B, W), NEG).at[:, half].set(0.0)
    band1 = jnp.full((B, W), NEG).at[:, half].set(lp_trim)
    e0_init = jnp.full((B,), half, dtype=jnp.int32)        # band 1: (half, -1-half)
    k0_init = jnp.full((B,), -1 - half, dtype=jnp.int32)
    right_prev_init = jnp.zeros((B,), dtype=jnp.bool_)     # band 1 was a down-move

    def one_band(carry, band_idx):
        prev2, prev1, e0p, k0p, right_prev, best_score, best_event = carry
        ll = prev1[:, 0]
        ur = prev1[:, W - 1]
        both_ob = (ll == NEG) & (ur == NEG)
        right = jnp.where(both_ob, (band_idx % 2) == 1, ll < ur)
        e0 = e0p + jnp.where(right, 0, 1).astype(jnp.int32)
        k0 = k0p + jnp.where(right, 1, 0).astype(jnp.int32)

        mu_s = _batched_slice(mu_p, k0 + W, W)
        is_s = _batched_slice(is_p, k0 + W, W)
        lc_s = _batched_slice(lc_p, k0 + W, W)
        ev_s = _batched_slice(rev_ev, (E - 1) - e0 + W, W)

        up = jnp.where(right[:, None], _shift_up(prev1), prev1)
        left = jnp.where(right[:, None], prev1, _shift_down(prev1))
        dd = right.astype(jnp.int32) + right_prev.astype(jnp.int32)  # 0,1,2
        diag = jnp.select(
            [dd[:, None] == 0, dd[:, None] == 1],
            [_shift_down(prev2), prev2],
            _shift_up(prev2),
        )

        a = (ev_s - mu_s) * is_s
        em = lc_s - jnp.float32(0.5) * a * a
        score_d = diag + lp_step[:, None] + em
        score_u = up + lp_stay[:, None] + em
        score_l = left + lp_skip
        # tie-break mirrors event_handling.cpp:300-306
        max_du = jnp.maximum(score_d, score_u)
        from_du = jnp.where(max_du == score_u, FROM_U, FROM_D)
        max_all = jnp.maximum(max_du, score_l)
        frm = jnp.where(max_all == score_l, FROM_L, from_du).astype(jnp.uint8)

        e = e0[:, None] - offs
        k = k0[:, None] + offs
        valid = (e >= 0) & (e < n_events[:, None]) & (k >= 0) & (k < n_kmers[:, None])
        band = jnp.where(valid, max_all, NEG)
        frm = jnp.where(valid, frm, jnp.uint8(0))

        # trim state (event_handling.cpp:255-265)
        ot = -1 - k0                      # (B,)
        e_trim = e0 - ot
        trim_ok = (ot >= 0) & (ot < W) & (e_trim >= 0) & (e_trim < n_events)
        is_trim_cell = (offs == ot[:, None]) & trim_ok[:, None]
        band = jnp.where(is_trim_cell,
                         lp_trim * (e_trim[:, None].astype(jnp.float32) + 1.0), band)
        frm = jnp.where(is_trim_cell, jnp.uint8(FROM_U), frm)

        # fold the final-kmer start-cell search into the carry
        # (event_handling.cpp:324-340)
        o_fin = (n_kmers - 1) - k0
        e_fin = e0 - o_fin
        fin_ok = (o_fin >= 0) & (o_fin < W) & (e_fin >= 0) & (e_fin < n_events)
        fin_val = jnp.take_along_axis(band, jnp.clip(o_fin, 0, W - 1)[:, None],
                                      axis=1)[:, 0]
        cand = fin_val + (n_events - e_fin).astype(jnp.float32) * lp_trim
        better = fin_ok & (cand > best_score)
        best_score = jnp.where(better, cand, best_score)
        best_event = jnp.where(better, e_fin, best_event)

        carry = (prev1, band, e0, k0, right, best_score, best_event)
        return carry, (frm, right)

    def four_bands(carry, step_idx):
        base = 2 + step_idx * 4
        frm_acc = jnp.zeros((B, W), dtype=jnp.uint8)
        right_acc = jnp.zeros((B,), dtype=jnp.uint8)
        for j in range(4):
            carry, (frm, right) = one_band(carry, base + j)
            frm_acc = frm_acc | (frm << (2 * j))
            right_acc = right_acc | (right.astype(jnp.uint8) << j)
        return carry, (frm_acc, right_acc)

    init = (band0, band1, e0_init, k0_init, right_prev_init,
            jnp.full((B,), NEG), jnp.zeros((B,), dtype=jnp.int32))
    carry, (trace_packed, rights_packed) = jax.lax.scan(
        four_bands, init, jnp.arange(n_steps, dtype=jnp.int32))
    _, _, _, _, _, best_score, best_event = carry
    return trace_packed, rights_packed, best_event, best_score


def banded_fill_cuda(scaled_events, mu, inv_sigma, lp_const, n_events,
                     n_kmers, bandwidth=100, epsilon_skip=1e-30, p_trim=0.01):
    """The CUDA kernel (one thread block per read) behind the
    :func:`banded_fill` contract; CUDA devices only (jax.ffi, no interpret
    mode)."""
    from .. import cuda
    cuda.ensure_registered()
    B, E = scaled_events.shape
    K = mu.shape[1]
    n_steps = (E + K + 3) // 4
    lp_stay, lp_step = _transition_logs(n_events, n_kmers, epsilon_skip)
    out_types = (
        jax.ShapeDtypeStruct((n_steps, B, bandwidth), jnp.uint8),
        jax.ShapeDtypeStruct((n_steps, B), jnp.uint8),
        jax.ShapeDtypeStruct((B,), jnp.int32),
        jax.ShapeDtypeStruct((B,), jnp.float32),
    )
    f32 = lambda x: x.astype(jnp.float32)
    return jax.ffi.ffi_call(cuda.BANDED_FILL_TARGET, out_types)(
        f32(scaled_events), f32(mu), f32(inv_sigma), f32(lp_const),
        n_events.astype(jnp.int32), n_kmers.astype(jnp.int32),
        lp_stay, lp_step,
        lp_skip=np.float32(np.log(epsilon_skip)),
        lp_trim=np.float32(np.log(p_trim)))


_FILL_IMPLS = {"xla": banded_fill, "cuda": banded_fill_cuda}


@functools.partial(jax.jit, static_argnames=("bandwidth", "epsilon_skip",
                                             "p_trim", "impl"))
def banded_fill_jit(scaled_events, mu, inv_sigma, lp_const, n_events, n_kmers,
                    bandwidth=100, epsilon_skip=1e-30, p_trim=0.01,
                    impl="xla"):
    """``impl`` names the fill ("xla" scan or "cuda" kernel; see
    dnascent_tpu.platform)."""
    return _FILL_IMPLS[impl](scaled_events, mu, inv_sigma, lp_const,
                             n_events, n_kmers, bandwidth, epsilon_skip,
                             p_trim)


@functools.lru_cache(maxsize=None)
def _banded_fill_sharded_fn(mesh, bandwidth, epsilon_skip, p_trim, impl):
    from jax.sharding import PartitionSpec as P

    def inner(scaled_events, mu, inv_sigma, lp_const, n_events, n_kmers):
        return _FILL_IMPLS[impl](scaled_events, mu, inv_sigma, lp_const,
                                 n_events, n_kmers, bandwidth, epsilon_skip,
                                 p_trim)

    row2 = P("data", None)
    sm = jax.shard_map(
        inner, mesh=mesh, check_vma=False,
        in_specs=(row2, row2, row2, row2, P("data"), P("data")),
        out_specs=(P(None, "data", None), P(None, "data"), P("data"),
                   P("data")))
    return jax.jit(sm)


def banded_fill_sharded(mesh, scaled_events, mu, inv_sigma, lp_const,
                        n_events, n_kmers, bandwidth=100, epsilon_skip=1e-30,
                        p_trim=0.01, impl="xla"):
    """Explicitly batch-sharded fill: each mesh device runs the fill on its
    row shard (shard_map, no cross-device collectives; an FFI call has no
    partitioning rule of its own).  Per-row math is identical to
    :func:`banded_fill_jit`, so N-device output is bitwise equal to
    1-device."""
    return _banded_fill_sharded_fn(mesh, bandwidth, epsilon_skip, p_trim,
                                   impl)(
        scaled_events, mu, inv_sigma, lp_const, n_events, n_kmers)


def prepare_emission_coefficients(kmer_ranks: np.ndarray, model: np.ndarray):
    """Host helper: gather (mu, 1/sigma, lp_const) for a (B, K) rank array.
    Ranks < 0 (undefined kmers) get -inf lp_const so they never win."""
    safe = np.where(kmer_ranks < 0, 0, kmer_ranks)
    mu = model[safe, 0].astype(np.float32)
    sigma = model[safe, 1].astype(np.float32)
    inv_sigma = (1.0 / sigma).astype(np.float32)
    lp_const = (LOG_INV_SQRT_2PI - np.log(sigma)).astype(np.float32)
    lp_const[kmer_ranks < 0] = -np.inf
    return mu, inv_sigma, lp_const


def unpack_trace(trace_packed: np.ndarray, rights_packed: np.ndarray,
                 n_bands: int) -> tuple[np.ndarray, np.ndarray]:
    """Host helper: expand packed outputs back to per-band arrays.

    Returns (trace (n_bands, B, W) uint8, rights (n_bands, B) bool) where
    index 0 corresponds to band 2 (the first adaptively placed band).
    """
    S, B, W = trace_packed.shape
    tr = np.zeros((S * 4, B, W), dtype=np.uint8)
    rg = np.zeros((S * 4, B), dtype=bool)
    for j in range(4):
        # step s emits band (2 + 4s + j) in bit position 2j, so [j::4] is
        # exactly the band-major order
        tr[j::4] = (trace_packed >> (2 * j)) & 0x3
        rg[j::4] = ((rights_packed >> j) & 1).astype(bool)
    return tr[: n_bands - 2], rg[: n_bands - 2]
