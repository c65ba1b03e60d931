"""Signal-scaling kernels: quantile regression and batched Theil-Sen.

The reference computes per-read shift/scale twice: a quantile regression
against the reference-sequence model means (event_handling.cpp:451-541), then
a Theil-Sen median-of-slopes refinement over up to 1000 cleaned points from
the banded backtrace (event_handling.cpp:24-110) — an O(500k) slope sort per
read on the CPU.

On the device the sort is replaced by an exact k-th-smallest selection via binary
search over the *bit patterns* of float32 (a monotone reinterpretation), which
turns the median into ~32 batched masked-count reductions — no sort, no
gather, fully vectorised across the read batch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _float32_to_ordered_uint(x: jnp.ndarray) -> jnp.ndarray:
    """Monotone bijection float32 -> uint32 (IEEE-754 total-order trick):
    flip all bits of negatives, flip only the sign bit of non-negatives."""
    u = jax.lax.bitcast_convert_type(x, jnp.uint32)
    sign = (u >> 31).astype(jnp.uint32)
    return u ^ jnp.where(sign == 1, jnp.uint32(0xFFFFFFFF), jnp.uint32(0x80000000))


def _ordered_uint_to_float32(u: jnp.ndarray) -> jnp.ndarray:
    sign = (u >> 31).astype(jnp.uint32)
    raw = u ^ jnp.where(sign == 0, jnp.uint32(0xFFFFFFFF), jnp.uint32(0x80000000))
    return jax.lax.bitcast_convert_type(raw, jnp.float32)


def masked_kth_smallest(values: jnp.ndarray, mask: jnp.ndarray,
                        k: jnp.ndarray) -> jnp.ndarray:
    """Exact k-th smallest (0-based) masked element per batch row.

    ``values``: (B, N) float32; ``mask``: (B, N) bool; ``k``: (B,) int32 with
    k < count(mask).  Greedy bitwise search for the largest v with
    count(u < v) <= k over the monotone uint32 representation: 32 masked
    count-reductions instead of a sort.  NaNs must be masked out by the
    caller.
    """
    u = _float32_to_ordered_uint(values)
    u = jnp.where(mask, u, jnp.uint32(0xFFFFFFFF))  # park masked at the top
    ku = k.astype(jnp.uint32)

    def body(lo, bit):
        mid = lo | (jnp.uint32(1) << bit.astype(jnp.uint32))
        cnt = jnp.sum((u < mid[:, None]), axis=1).astype(jnp.uint32)
        lo = jnp.where(cnt <= ku, mid, lo)
        return lo, None

    lo0 = jnp.zeros(values.shape[:1], dtype=jnp.uint32)
    lo, _ = jax.lax.scan(body, lo0, jnp.arange(31, -1, -1))
    return _ordered_uint_to_float32(lo)


def masked_median_lower(values: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Median as sorted[m // 2] over masked elements — matches the reference's
    ``slopes[slopes.size()/2]`` convention (event_handling.cpp:78)."""
    m = jnp.sum(mask, axis=1).astype(jnp.int32)
    return masked_kth_smallest(values, mask, m // 2)


@functools.partial(jax.jit, static_argnames=("max_points", "trim"))
def theilsen_refine(cleaned_signals: jnp.ndarray,  # (B, P) f32, zero-padded
                    model_means: jnp.ndarray,      # (B, P) f32 at cleaned ranks
                    n_cleaned: jnp.ndarray,        # (B,) i32
                    shift: jnp.ndarray,            # (B,) f32
                    scale: jnp.ndarray,            # (B,) f32
                    max_points: int = 1000,
                    trim: int = 50):
    """Batched Theil-Sen refinement (event_handling.cpp:24-110).

    Returns (new_shift, new_scale); rows with n_cleaned < max_points pass
    their inputs through unchanged; zero median slope yields (-1, -1).
    """
    B = cleaned_signals.shape[0]
    effective = n_cleaned - 2 * trim
    skip = jnp.where(effective > max_points, effective // max_points, 1)
    num_points = jnp.minimum(effective, max_points)

    j = jnp.arange(max_points, dtype=jnp.int32)
    idx = trim + skip[:, None] * j[None, :]
    pt_mask = j[None, :] < num_points[:, None]
    idx = jnp.clip(idx, 0, cleaned_signals.shape[1] - 1)
    sig = jnp.take_along_axis(cleaned_signals, idx, axis=1)
    y = jnp.take_along_axis(model_means, idx, axis=1)
    x = (sig - shift[:, None]) / scale[:, None]

    dy = y[:, :, None] - y[:, None, :]
    dx = x[:, :, None] - x[:, None, :]
    pair_mask = (pt_mask[:, :, None] & pt_mask[:, None, :]
                 & (j[None, :, None] < j[None, None, :]))
    slopes = jnp.where(pair_mask & (dx != 0), dy / jnp.where(dx == 0, 1.0, dx), 0.0)
    # dx==0 pairs produce +-inf in the reference and land at the sort ends;
    # mirror by assigning signed infinity by dy's sign
    inf_val = jnp.where(dy >= 0, jnp.float32(jnp.inf), jnp.float32(-jnp.inf))
    slopes = jnp.where(pair_mask & (dx == 0), inf_val, slopes)
    m_slope = masked_median_lower(slopes.reshape(B, -1), pair_mask.reshape(B, -1))

    intercepts = y - m_slope[:, None] * x
    b_int = masked_median_lower(intercepts, pt_mask)

    new_shift = shift + (-b_int / m_slope) * scale
    new_scale = scale * (1.0 / m_slope)
    failed = m_slope == 0.0
    new_shift = jnp.where(failed, -1.0, new_shift)
    new_scale = jnp.where(failed, -1.0, new_scale)
    passthrough = n_cleaned < max_points  # minLength==max_points, :30-33
    new_shift = jnp.where(passthrough, shift, new_shift)
    new_scale = jnp.where(passthrough, scale, new_scale)
    return new_shift, new_scale


@functools.partial(jax.jit, static_argnames=("max_points",))
def theilsen_refine_pregathered(sig: jnp.ndarray,      # (B, max_points) f32
                                y: jnp.ndarray,        # (B, max_points) f32
                                num_points: jnp.ndarray,  # (B,) i32
                                passthrough: jnp.ndarray,  # (B,) bool
                                shift: jnp.ndarray,    # (B,) f32
                                scale: jnp.ndarray,    # (B,) f32
                                max_points: int = 1000):
    """Upload-lean Theil-Sen: the deterministic stride subsample
    (``idx = trim + skip*j``, event_handling.cpp:63-65) is applied on the
    host so only the <=1000 selected (signal, model-mean) points per read
    cross the interconnect instead of the full padded cleaned-event arrays.
    Masked positions (j >= num_points) may hold arbitrary values.  Math from
    the rescale onward is identical to :func:`theilsen_refine`."""
    B = sig.shape[0]
    j = jnp.arange(max_points, dtype=jnp.int32)
    pt_mask = j[None, :] < num_points[:, None]
    x = (sig - shift[:, None]) / scale[:, None]

    dy = y[:, :, None] - y[:, None, :]
    dx = x[:, :, None] - x[:, None, :]
    pair_mask = (pt_mask[:, :, None] & pt_mask[:, None, :]
                 & (j[None, :, None] < j[None, None, :]))
    slopes = jnp.where(pair_mask & (dx != 0), dy / jnp.where(dx == 0, 1.0, dx), 0.0)
    inf_val = jnp.where(dy >= 0, jnp.float32(jnp.inf), jnp.float32(-jnp.inf))
    slopes = jnp.where(pair_mask & (dx == 0), inf_val, slopes)
    m_slope = masked_median_lower(slopes.reshape(B, -1), pair_mask.reshape(B, -1))

    intercepts = y - m_slope[:, None] * x
    b_int = masked_median_lower(intercepts, pt_mask)

    new_shift = shift + (-b_int / m_slope) * scale
    new_scale = scale * (1.0 / m_slope)
    failed = m_slope == 0.0
    new_shift = jnp.where(failed, -1.0, new_shift)
    new_scale = jnp.where(failed, -1.0, new_scale)
    new_shift = jnp.where(passthrough, shift, new_shift)
    new_scale = jnp.where(passthrough, scale, new_scale)
    return new_shift, new_scale


def theilsen_pregather(cleaned_signals: np.ndarray, model_ranks: np.ndarray,
                       pore_model: np.ndarray, max_points: int, trim: int):
    """Host-side stride subsample matching theilsen_refine's device gather
    exactly (within the point mask idx < n always holds, so padding never
    leaks in).  Returns (sig_pts, y_pts, num_points, passthrough) for one
    read."""
    n = cleaned_signals.shape[0]
    effective = n - 2 * trim
    skip = effective // max_points if effective > max_points else 1
    num_points = min(effective, max_points)
    sig = np.zeros(max_points, dtype=np.float32)
    y = np.zeros(max_points, dtype=np.float32)
    if n > 0 and num_points > 0:
        j = np.arange(max_points, dtype=np.int64)
        idx = np.clip(trim + skip * j, 0, n - 1)
        sig[:] = cleaned_signals[idx]
        safe = np.where(model_ranks[idx] < 0, 0, model_ranks[idx])
        y[:] = pore_model[safe, 0]
    return sig, y, max(num_points, 0), n < max_points


@functools.partial(jax.jit, static_argnames=("n_quantiles",))
def quantile_scaling_device(event_means: jnp.ndarray,   # (B, E) f32, +inf pad
                            n_events: jnp.ndarray,      # (B,) i32
                            model_means: jnp.ndarray,   # (B, K) f32, +inf pad
                            n_kmers: jnp.ndarray,       # (B,) i32
                            n_quantiles: int = 10):
    """Batched device quantile regression (event_handling.cpp:451-541):
    sort both vectors, take the reference's quantile medians, least-squares
    fit model->signal.  Pads must be +inf so they sort to the tail.
    Returns (shift, scale) per row."""
    i = jnp.arange(n_quantiles)

    def qmed(sorted_vals, n):
        step = (n // n_quantiles)[:, None]
        idx = (i[None, :] * step * 2 + step) // 2
        idx = jnp.clip(idx, 0, sorted_vals.shape[1] - 1)
        return jnp.take_along_axis(sorted_vals, idx, axis=1)

    sq = qmed(jnp.sort(event_means, axis=1), n_events)
    mq = qmed(jnp.sort(model_means, axis=1), n_kmers)
    n = jnp.float32(n_quantiles)
    sum_x = mq.sum(axis=1)
    sum_x2 = (mq * mq).sum(axis=1)
    sum_y = sq.sum(axis=1)
    sum_xy = (mq * sq).sum(axis=1)
    slope = (n * sum_xy - sum_x * sum_y) / (n * sum_x2 - sum_x * sum_x)
    intercept = (sum_y - slope * sum_x) / n
    return intercept, slope  # shift, scale


def quantile_scaling_batch(event_means: np.ndarray, n_events: np.ndarray,
                           model_means: np.ndarray, n_kmers: np.ndarray,
                           n_quantiles: int = 10) -> tuple[np.ndarray, np.ndarray]:
    """Host-side batched quantile regression (event_handling.cpp:451-541).

    Sorting ragged short arrays is cheap on host; kept in numpy.  Returns
    (shift, scale) per read.
    """
    B = event_means.shape[0]
    shift = np.zeros(B)
    scale = np.ones(B)
    for b in range(B):
        ev = np.sort(event_means[b, : n_events[b]])
        mm = np.sort(model_means[b, : n_kmers[b]])
        i = np.arange(n_quantiles)
        ne = ev.shape[0] // n_quantiles
        nm = mm.shape[0] // n_quantiles
        sq = ev[(i * ne + (i + 1) * ne) // 2]
        mq = mm[(i * nm + (i + 1) * nm) // 2]
        n = n_quantiles
        sum_x = mq.sum(); sum_x2 = (mq * mq).sum()
        sum_y = sq.sum(); sum_xy = (mq * sq).sum()
        sl = (n * sum_xy - sum_x * sum_y) / (n * sum_x2 - sum_x * sum_x)
        shift[b] = (sum_y - sl * sum_x) / n
        scale[b] = sl
    return shift, scale
