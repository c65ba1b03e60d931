"""Batched forward-HMM log-likelihood — the legacy --HMM detect path.

Device re-design of ``sequenceProbability`` (reference: src/detect.cpp:235-378):
windows are batched in lanes, the time recursion is a ``lax.scan``, and the
intra-column deletion chain — a sequential log-sum-exp recurrence in the
reference (detect.cpp:343-348) — becomes an associative scan with logaddexp.

Each window is scored twice (analogue-substituted and unmodified emission
tables); the caller differences the two for the log-likelihood ratio.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

NEG = np.float32(-np.inf)


def forward_batch(obs: jnp.ndarray,        # (W, T) f32 scaled observations
                  n_obs: jnp.ndarray,      # (W,) i32
                  mu: jnp.ndarray,         # (W, N) f32 per-state means
                  sigma: jnp.ndarray,      # (W, N) f32
                  n_states: jnp.ndarray,   # (W,) i32 (always 2*window here)
                  events_per_base: jnp.ndarray,  # (W,) f32
                  hmm_probs: tuple) -> jnp.ndarray:
    """Forward log-probability per window (detect.cpp:235-378)."""
    W, T = obs.shape
    N = mu.shape[1]
    eD2D_f, eD2M_f, eI2M_f, eM2D_f, iM2I_f, iI2I_f = hmm_probs
    eD2D = jnp.float32(np.log(eD2D_f))
    eD2M = jnp.float32(np.log(eD2M_f))
    eI2M = jnp.float32(np.log(eI2M_f))
    eM2D = jnp.float32(np.log(eM2D_f))
    iM2I = jnp.float32(np.log(iM2I_f))
    iI2I = jnp.float32(np.log(iI2I_f))
    iM2M = jnp.log(1.0 - (1.0 / events_per_base)).astype(jnp.float32)[:, None]
    eM2M = jnp.log(1.0 - eM2D_f - iM2I_f
                   - (1.0 - 1.0 / events_per_base)).astype(jnp.float32)[:, None]
    ln25 = jnp.float32(np.log(0.25))
    ln50 = jnp.float32(np.log(0.5))

    sidx = jnp.arange(N, dtype=jnp.int32)[None, :]
    in_range = sidx < n_states[:, None]
    is0 = sidx == 0
    lp_const = (-0.5 * jnp.log(2.0 * jnp.pi * sigma * sigma))
    inv_sigma = 1.0 / sigma

    D0 = jnp.where(in_range, ln25 + sidx.astype(jnp.float32) * eD2D, NEG)
    I0 = jnp.full((W, N), NEG)
    M0 = jnp.full((W, N), NEG)
    firstI0 = jnp.full((W, 1), NEG)

    def shift(v):
        return jnp.concatenate([jnp.full((W, 1), NEG), v[:, :-1]], axis=1)

    def step(carry, t):
        I_prev, M_prev, D_prev, firstI_prev = carry
        active = (t < n_obs)[:, None]
        start_prev = jnp.where(t == 0, jnp.float32(0.0), NEG)
        start_prev = jnp.full((W, 1), start_prev)
        xt = jax.lax.dynamic_slice_in_dim(obs, t, 1, axis=1)
        a = (xt - mu) * inv_sigma
        em = lp_const - jnp.float32(0.5) * a * a

        firstI_curr = jnp.logaddexp(start_prev + ln25, firstI_prev + ln25)
        I_curr = jnp.logaddexp(I_prev + iI2I, M_prev + iM2I)
        M_base = jnp.logaddexp(
            jnp.logaddexp(shift(I_prev) + eI2M, shift(M_prev) + eM2M),
            jnp.logaddexp(M_prev + iM2M, shift(D_prev) + eD2M))
        M0_base = jnp.logaddexp(
            jnp.logaddexp(firstI_prev + ln50, M_prev + iM2M),
            start_prev + ln50)
        M_curr = jnp.where(is0, M0_base, M_base) + em
        # deletion chain via associative logaddexp scan:
        # D[i] = lse(D[0] + i*eD2D, lse_{j<=i-1}(M[j] - j*eD2D)
        #            + eM2D + (i-1)*eD2D)
        fj = sidx.astype(jnp.float32)
        D_first = firstI_curr + ln25                      # detect.cpp:309
        A = M_curr - fj * eD2D
        cum = jax.lax.associative_scan(jnp.logaddexp, A, axis=1)
        cum_excl = shift(cum)
        D_chain = cum_excl + eM2D + (fj - 1.0) * eD2D
        D_curr = jnp.where(is0, D_first,
                           jnp.logaddexp(D_first + fj * eD2D, D_chain))

        I_curr = jnp.where(active & in_range, I_curr,
                           jnp.where(in_range, I_prev, NEG))
        M_curr = jnp.where(active & in_range, M_curr,
                           jnp.where(in_range, M_prev, NEG))
        D_curr = jnp.where(active & in_range, D_curr,
                           jnp.where(in_range, D_prev, NEG))
        firstI_curr = jnp.where(active, firstI_curr, firstI_prev)
        return (I_curr, M_curr, D_curr, firstI_curr), None

    (I_f, M_f, D_f, _), _ = jax.lax.scan(step, (I0, M0, D0, firstI0),
                                         jnp.arange(T, dtype=jnp.int32))
    last = jnp.clip(n_states - 1, 0, N - 1)[:, None]
    Dl = jnp.take_along_axis(D_f, last, axis=1)[:, 0]
    Ml = jnp.take_along_axis(M_f, last, axis=1)[:, 0]
    Il = jnp.take_along_axis(I_f, last, axis=1)[:, 0]
    eM2MorD = jnp.logaddexp(eM2M[:, 0], eM2D)
    return jnp.logaddexp(jnp.logaddexp(Dl, Ml + eM2MorD), Il + eI2M)


@functools.partial(jax.jit, static_argnames=("hmm_probs",))
def forward_batch_jit(obs, n_obs, mu, sigma, n_states, events_per_base,
                      hmm_probs):
    return forward_batch(obs, n_obs, mu, sigma, n_states, events_per_base,
                         hmm_probs)
