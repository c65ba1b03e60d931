"""Batched windowed Viterbi eventalign — device kernel (plain XLA scans).

Re-design of the reference's per-50-bp-window 3-state (M/I/D per k-mer)
max-product Viterbi (reference: src/alignment.cpp:193-516).  The reference
runs one window at a time per CPU thread; here every window of every read in
a batch is a lane of one device computation:

* the time recursion is a ``lax.scan`` over observation columns with
  (W, N) state blocks (W = windows in flight, N = padded state count);
* the intra-column deletion chain D[i] = f(D[i-1], M[i-1]) — sequential in
  the reference (alignment.cpp:405-427) — is closed-form vectorised:
  D[i] = max_{j<i}(M[j] - j*eD2D) + eM2D + (i-1)*eD2D via a cumulative max;
* backtrace pointers are packed one byte per (t, state) and the backtrace
  walk itself runs on device, vectorised across windows (a ~T+N step scan of
  per-window gathers), so only the compact per-window paths leave the device.

State kinds are 0=D, 1=M, 2=I (matching the reference's D/M/I offsets);
kind 3 marks padding in the emitted paths.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np

# scan unroll factors: both the fill scan (T steps of (N, W) math) and the
# backtrace scan (T+N steps of (W,) gathers) run hundreds of small
# sequential steps, so per-step loop overhead is a real cost; unrolling
# trades compile time for it.  Env-tunable for experiments.
_FILL_UNROLL = int(os.environ.get("DNASCENT_VIT_FILL_UNROLL", "1"))
_BT_UNROLL = int(os.environ.get("DNASCENT_VIT_BT_UNROLL", "1"))

NEG = np.float32(-np.inf)
KIND_D, KIND_M, KIND_I, KIND_PAD = 0, 1, 2, 3

# backtrace pointer codes, packed into one uint8 per (t, state):
#   bits 0-1: I-state predecessor (0=I same, 1=M same, 2=start)
#   bits 2-4: M-state predecessor (0=I[i-1], 1=M[i-1], 2=M[i], 3=D[i-1], 4=start)
#   bit 5:    D-state predecessor (0=M[i-1], 1=D[i-1])
_I_SHIFT, _M_SHIFT, _D_SHIFT = 0, 2, 5


def viterbi_fill_backtrace(obs: jnp.ndarray,        # (W, T) f32 scaled observations
                           n_obs: jnp.ndarray,      # (W,) i32
                           mu: jnp.ndarray,         # (W, N) f32 per-state model mean
                           inv_sigma: jnp.ndarray,  # (W, N) f32
                           lp_const: jnp.ndarray,   # (W, N) f32
                           n_states: jnp.ndarray,   # (W,) i32
                           events_per_base: jnp.ndarray,  # (W,) f32 (per read)
                           hmm_probs: tuple[float, float, float, float, float, float],
                           bt_len: int | None = None,
                           ):
    """Returns (path_code (W, L) uint8, path_len (W,), score (W,)) with
    L = T + N + 2.  Each byte is ``kind | (pos_delta << 2)`` where pos_delta
    is the backward position decrement of the step — one byte per step
    instead of (kind, pos) pairs; decode with ``decode_path``.  Paths are in
    forward order occupying the LAST path_len entries of each row (leading
    entries are KIND_PAD)."""
    W, T = obs.shape
    N = mu.shape[1]
    # state-major (N, W) layout: W (thousands of windows) is the minor,
    # contiguous axis of every (N, W) plane
    obs_T = obs.T.astype(jnp.float32)                    # (T, W)
    muT = mu.T
    invT = inv_sigma.T
    lpcT = lp_const.T                                    # (N, W)
    eD2D_f, eD2M_f, eI2M_f, eM2D_f, iM2I_f, iI2I_f = hmm_probs
    eD2D = jnp.float32(np.log(eD2D_f))
    eD2M = jnp.float32(np.log(eD2M_f))
    eI2M = jnp.float32(np.log(eI2M_f))
    eM2D = jnp.float32(np.log(eM2D_f))
    iM2I = jnp.float32(np.log(iM2I_f))
    iI2I = jnp.float32(np.log(iI2I_f))
    # per-read transitions (alignment.cpp:207-210)
    iM2M = jnp.log(1.0 - (1.0 / events_per_base)).astype(jnp.float32)
    eM2M = jnp.log(1.0 - eM2D_f - iM2I_f - (1.0 - 1.0 / events_per_base)
                   ).astype(jnp.float32)
    eM2MorD = jnp.logaddexp(eM2M, eM2D)
    eOrIM2M = jnp.logaddexp(eM2M, iM2M)

    sidx = jnp.arange(N, dtype=jnp.int32)[:, None]       # (N, 1)
    in_range = sidx < n_states[None, :]                  # (N, W)
    is0 = sidx == 0                                      # (N, 1)

    # initial column: start -> D0 -> D1 -> ... (alignment.cpp:239-251)
    D0 = jnp.where(in_range, eM2D + sidx.astype(jnp.float32) * eD2D, NEG)
    I0 = jnp.full((N, W), NEG)
    M0 = jnp.full((N, W), NEG)

    def step(carry, t):
        I_prev, M_prev, D_prev = carry                   # (N, W)
        active = (t < n_obs)[None, :]                    # (1, W)
        start_prev = jnp.where(t == 0, jnp.float32(0.0), NEG)  # scalar
        start_prev = jnp.full((1, W), start_prev)
        xt = jax.lax.dynamic_slice_in_dim(obs_T, t, 1, axis=0)  # (1, W)
        a = (xt - muT) * invT
        em = lpcT - jnp.float32(0.5) * a * a

        # --- insertions (alignment.cpp:277-302, 350-369) ---
        cI = jnp.stack([I_prev + iI2I, M_prev + iM2I,
                        jnp.where(is0, start_prev + iM2I, NEG)])
        I_curr = cI.max(axis=0)
        aI = jnp.argmax(cI, axis=0).astype(jnp.uint8)    # first-wins ties

        # --- matches (alignment.cpp:304-323, 371-402) ---
        shift = lambda v: jnp.concatenate(
            [jnp.full((1, W), NEG), v[:-1, :]], axis=0)  # v[i-1]
        # candidate order must mirror lnArgMax order at :377-381 for states
        # i>=1 and :308-310 for state 0
        cM_i = jnp.stack([shift(I_prev) + eI2M, shift(M_prev) + eM2M[None, :],
                          M_prev + iM2M[None, :], shift(D_prev) + eD2M])
        cM0 = jnp.stack([M_prev + iM2M[None, :],
                         jnp.where(is0, start_prev + eOrIM2M[None, :], NEG)])
        M_curr_i = cM_i.max(axis=0) + em
        aM_i = jnp.argmax(cM_i, axis=0).astype(jnp.uint8)
        M_curr_0 = cM0.max(axis=0) + em
        aM_0 = jnp.argmax(cM0, axis=0).astype(jnp.uint8)
        # encode state-0 codes into the i>=1 code space: 0->M[i] int (code 2),
        # 1->start (code 4)
        aM_0 = jnp.where(aM_0 == 0, jnp.uint8(2), jnp.uint8(4))
        M_curr = jnp.where(is0, M_curr_0, M_curr_i)
        aM = jnp.where(is0, aM_0, aM_i)

        # --- deletions, closed-form chain (alignment.cpp:405-427) ---
        # D[i] = max_{j<=i-1}(M[j] - j*eD2D) + eM2D + (i-1)*eD2D
        fj = sidx.astype(jnp.float32)
        A = M_curr - fj * eD2D
        cmax_excl = shift(jax.lax.cummax(A, axis=0))     # max over j <= i-1
        D_curr = jnp.where(is0, NEG, cmax_excl + eM2D + (fj - 1.0) * eD2D)
        # pointer: M[i-1]+eM2D vs D[i-1]+eD2D, M wins ties (lnArgMax order)
        c0 = shift(M_curr) + eM2D
        c1 = shift(D_curr) + eD2D
        aD = jnp.where(c0 >= c1, jnp.uint8(0), jnp.uint8(1))

        # keep the previous column for inactive (padded) timesteps
        I_curr = jnp.where(active & in_range, I_curr, jnp.where(in_range, I_prev, NEG))
        M_curr = jnp.where(active & in_range, M_curr, jnp.where(in_range, M_prev, NEG))
        D_curr = jnp.where(active & in_range, D_curr, jnp.where(in_range, D_prev, NEG))

        code = (aI << _I_SHIFT) | (aM << _M_SHIFT) | (aD << _D_SHIFT)
        return (I_curr, M_curr, D_curr), code

    (I_fin, M_fin, D_fin), codes = jax.lax.scan(
        step, (I0, M0, D0), jnp.arange(T, dtype=jnp.int32),
        unroll=_FILL_UNROLL)
    # codes: (T, N, W) uint8
    return _terminate_and_backtrace(codes, I_fin, M_fin, D_fin, n_obs,
                                    n_states, eM2MorD, eI2M, W, T, N,
                                    bt_len)


def _terminate_and_backtrace(codes, I_fin, M_fin, D_fin, n_obs, n_states,
                             eM2MorD, eI2M, W, T, N, bt_len=None):
    # --- termination (alignment.cpp:445-476) ---
    last = jnp.clip(n_states - 1, 0, N - 1)[None, :]
    Dl = jnp.take_along_axis(D_fin, last, axis=0)[0]
    Ml = jnp.take_along_axis(M_fin, last, axis=0)[0]
    Il = jnp.take_along_axis(I_fin, last, axis=0)[0]
    cand = jnp.stack([Dl, Ml + eM2MorD, Il + eI2M])
    score = cand.max(axis=0)
    kind0 = jnp.argmax(cand, axis=0).astype(jnp.int32)   # 0=D,1=M,2=I

    # --- vectorised backtrace across windows ---
    # the walk is <= n_obs + n_states + 2 steps; callers that know the
    # batch's true maxima pass bt_len (host-computed static) so the scan
    # does not pay for the T/N padding (T+N+2 = 330 vs ~224 at bench
    # shapes — each scan step is a scattered (W,) gather from the code
    # planes, the dominant backtrace cost)
    L = min(bt_len, T + N + 2) if bt_len else T + N + 2
    cur_kind = kind0
    cur_pos = (n_states - 1).astype(jnp.int32)
    cur_col = n_obs.astype(jnp.int32)                    # DP column index
    done = jnp.zeros((W,), dtype=bool)
    widx = jnp.arange(W, dtype=jnp.int32)

    def bt_step(carry, _):
        cur_kind, cur_pos, cur_col, done = carry
        # fetch code at (col-1, pos, w): codes are indexed by emission t =
        # col-1; the initial column (col==0) has fixed pointers
        t_idx = jnp.clip(cur_col - 1, 0, T - 1)
        byte = codes[t_idx, jnp.clip(cur_pos, 0, N - 1), widx]
        cI = (byte >> _I_SHIFT) & 0x3
        cM = (byte >> _M_SHIFT) & 0x7
        cD = (byte >> _D_SHIFT) & 0x1

        at_init = cur_col == 0
        # defaults for each kind (non-init columns)
        # D: same column
        nk_D = jnp.where(cD == 0, KIND_M, KIND_D)
        np_D = cur_pos - 1
        nc_D = cur_col
        fin_D = jnp.zeros_like(done)
        # init-column D chain: D(i)->D(i-1)->...->D(0)->start
        nk_D = jnp.where(at_init, KIND_D, nk_D)
        np_D = jnp.where(at_init, cur_pos - 1, np_D)
        fin_D = jnp.where(at_init & (cur_pos == 0), True, fin_D)
        # M: predecessors at col-1
        nk_M = jnp.select([cM == 0, cM == 1, cM == 2, cM == 3],
                          [KIND_I, KIND_M, KIND_M, KIND_D], KIND_M)
        np_M = jnp.select([cM == 0, cM == 1, cM == 2, cM == 3],
                          [cur_pos - 1, cur_pos - 1, cur_pos, cur_pos - 1],
                          cur_pos)
        fin_M = cM == 4
        nc_M = cur_col - 1
        # I: predecessors at col-1
        nk_I = jnp.where(cI == 0, KIND_I, KIND_M)
        np_I = cur_pos
        fin_I = cI == 2
        nc_I = cur_col - 1

        is_D = cur_kind == KIND_D
        is_M = cur_kind == KIND_M
        nk = jnp.where(is_D, nk_D, jnp.where(is_M, nk_M, nk_I))
        npos = jnp.where(is_D, np_D, jnp.where(is_M, np_M, np_I))
        ncol = jnp.where(is_D, nc_D, jnp.where(is_M, nc_M, nc_I))
        fin = jnp.where(is_D, fin_D, jnp.where(is_M, fin_M, fin_I))

        delta = jnp.clip(cur_pos - npos, 0, 1)
        out_code = jnp.where(
            done, jnp.uint8(KIND_PAD),
            (cur_kind | (delta << 2)).astype(jnp.uint8))
        new_done = done | fin
        cur_kind = jnp.where(done, cur_kind, nk)
        cur_pos = jnp.where(done, cur_pos, npos)
        cur_col = jnp.where(done, cur_col, ncol)
        return (cur_kind, cur_pos, cur_col, new_done), out_code

    (_, _, _, done), rc = jax.lax.scan(
        bt_step, (cur_kind, cur_pos, cur_col, done), None, length=L,
        unroll=_BT_UNROLL)
    # rc: (L, W) in reverse order; flip to forward order
    path_code = rc[::-1].T                               # (W, L)
    path_len = jnp.sum((path_code & 3) != KIND_PAD, axis=1).astype(jnp.int32)
    return path_code, path_len, score


def pack_path_codes(path_code: jnp.ndarray) -> jnp.ndarray:
    """Bit-pack path codes (3 significant bits each) eight per three bytes
    — 2.67 codes/byte vs the previous nibble pack's 2, cutting the largest
    remaining d2h stream another 25%.  Pads leading KIND_PAD entries to a
    multiple of 8; consumers PAD-filter, so leading pads are free."""
    W, L = path_code.shape
    pad = (-L) % 8
    if pad:
        path_code = jnp.concatenate(
            [jnp.full((W, pad), KIND_PAD, dtype=jnp.uint8), path_code],
            axis=1)
        L += pad
    c = path_code.reshape(W, L // 8, 8).astype(jnp.int32)
    c0, c1, c2, c3 = c[:, :, 0], c[:, :, 1], c[:, :, 2], c[:, :, 3]
    c4, c5, c6, c7 = c[:, :, 4], c[:, :, 5], c[:, :, 6], c[:, :, 7]
    b0 = c0 | (c1 << 3) | ((c2 & 3) << 6)
    b1 = (c2 >> 2) | (c3 << 1) | (c4 << 4) | ((c5 & 1) << 7)
    b2 = (c5 >> 1) | (c6 << 2) | (c7 << 5)
    return (jnp.stack([b0, b1, b2], axis=2)
            .reshape(W, 3 * (L // 8)).astype(jnp.uint8))


def unpack_path_codes(packed: np.ndarray) -> np.ndarray:
    """Host-side inverse of :func:`pack_path_codes` -> (W, 8*Lp/3) uint8."""
    W, P = packed.shape
    b = packed.reshape(W, P // 3, 3).astype(np.int64)
    b0, b1, b2 = b[:, :, 0], b[:, :, 1], b[:, :, 2]
    cols = [
        b0 & 7,
        (b0 >> 3) & 7,
        ((b0 >> 6) & 3) | ((b1 & 1) << 2),
        (b1 >> 1) & 7,
        (b1 >> 4) & 7,
        ((b1 >> 7) & 1) | ((b2 & 3) << 1),
        (b2 >> 2) & 7,
        (b2 >> 5) & 7,
    ]
    return np.stack(cols, axis=2).reshape(W, 8 * (P // 3)).astype(np.uint8)


@functools.partial(jax.jit, static_argnames=("hmm_probs",))
def viterbi_jit(obs, n_obs, mu, inv_sigma, lp_const, n_states, events_per_base,
                hmm_probs):
    return viterbi_fill_backtrace(obs, n_obs, mu, inv_sigma, lp_const,
                                  n_states, events_per_base, hmm_probs)


def _viterbi_from_flat_ranks(obs, n_obs, starts, flat_ranks, model_table,
                             n_states, events_per_base, hmm_probs,
                             n_state_pad):
    N = n_state_pad
    idx = starts[:, None] + jnp.arange(N, dtype=jnp.int32)[None, :]
    r = flat_ranks[jnp.clip(idx, 0, flat_ranks.shape[0] - 1)]
    in_range = jnp.arange(N, dtype=jnp.int32)[None, :] < n_states[:, None]
    ranks = jnp.where(in_range, r, -1)
    pc, pl, score = viterbi_from_ranks_core(obs, n_obs, ranks, model_table,
                                            n_states, events_per_base,
                                            hmm_probs)
    return pack_path_codes(pc), pl, score


@functools.partial(jax.jit, static_argnames=("hmm_probs", "n_state_pad"))
def viterbi_from_flat_ranks_jit(obs, n_obs, starts, flat_ranks, model_table,
                                n_states, events_per_base, hmm_probs,
                                n_state_pad):
    """Upload-lean variant: windows carry only a start offset into a flat
    per-batch reference-rank array resident on device (uploaded once by
    prep), so the per-call metadata is a few KB."""
    return _viterbi_from_flat_ranks(obs, n_obs, starts, flat_ranks,
                                    model_table, n_states, events_per_base,
                                    hmm_probs, n_state_pad)


@functools.lru_cache(maxsize=None)
def _viterbi_from_flat_ranks_sharded_fn(mesh, hmm_probs, n_state_pad):
    from jax.sharding import PartitionSpec as P

    def inner(obs, n_obs, starts, flat_ranks, model_table, n_states, epb):
        return _viterbi_from_flat_ranks(obs, n_obs, starts, flat_ranks,
                                        model_table, n_states, epb,
                                        hmm_probs, n_state_pad)

    sm = jax.shard_map(
        inner, mesh=mesh, check_vma=False,
        in_specs=(P("data", None), P("data"), P("data"), P(), P(),
                  P("data"), P("data")),
        out_specs=(P("data", None), P("data"), P("data")))
    return jax.jit(sm)


def viterbi_from_flat_ranks_sharded(mesh, obs, n_obs, starts, flat_ranks,
                                    model_table, n_states, events_per_base,
                                    hmm_probs, n_state_pad):
    """Window-sharded variant (shard_map over the mesh's data axis): each
    device runs the fill on its window shard."""
    return _viterbi_from_flat_ranks_sharded_fn(mesh, hmm_probs, n_state_pad)(
        obs, n_obs, starts, flat_ranks, model_table, n_states,
        events_per_base)


def _viterbi_from_flat_core(obs_flat, obs_starts, n_obs, rank_starts,
                            flat_ranks, model_table, n_states,
                            events_per_base, hmm_probs, n_state_pad, t_pad,
                            bt_len=None):
    T = t_pad
    oidx = obs_starts[:, None] + jnp.arange(T, dtype=jnp.int32)[None, :]
    obs = obs_flat[jnp.clip(oidx, 0, obs_flat.shape[0] - 1)]
    N = n_state_pad
    ridx = rank_starts[:, None] + jnp.arange(N, dtype=jnp.int32)[None, :]
    r = flat_ranks[jnp.clip(ridx, 0, flat_ranks.shape[0] - 1)]
    in_range = jnp.arange(N, dtype=jnp.int32)[None, :] < n_states[:, None]
    ranks = jnp.where(in_range, r, -1)
    return viterbi_from_ranks_core(obs, n_obs, ranks, model_table,
                                   n_states, events_per_base,
                                   hmm_probs, bt_len=bt_len)


def _viterbi_from_flat(obs_flat, obs_starts, n_obs, rank_starts, flat_ranks,
                       model_table, n_states, events_per_base, hmm_probs,
                       n_state_pad, t_pad, bt_len=None):
    pc, pl, score = _viterbi_from_flat_core(
        obs_flat, obs_starts, n_obs, rank_starts, flat_ranks, model_table,
        n_states, events_per_base, hmm_probs, n_state_pad, t_pad, bt_len)
    return pack_path_codes(pc), pl, score


def compact_path_codes(pc, n_obs, n_states, sb: int):
    """Scatter every window's non-PAD path codes into ONE flat stream at
    per-window offsets ``cumsum(n_obs + n_states + 2)`` (a bound on any
    window's path length), then 3-bit pack.

    The padded (W, bt_len) layout downloads ~4x its true content at bench
    shapes: the window axis is bucket-padded and every window pays the
    chunk-max backtrace length.  The flat stream's size is the sum of the
    per-window BOUNDS — computable host-side before dispatch, so the
    consumer can slice windows back out without any length download.
    Unwritten slots keep KIND_PAD and are filtered host-side exactly like
    the padded layout's gaps.  ``sb`` must be a multiple of 8 (no leading
    pad from the 3-bit pack shifts the offsets).
    """
    W, L = pc.shape
    bound = n_obs + n_states + 2
    off = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(bound)[:-1]])
    nonpad = (pc & 3) != KIND_PAD
    rank = jnp.cumsum(nonpad.astype(jnp.int32), axis=1) - nonpad
    # clamp to the per-window bound: if a backtrace ever emitted more codes
    # than n_obs + n_states + 2 (invariant at :198), overflow must DROP
    # rather than scatter into the next window's region
    keep = nonpad & (rank < bound[:, None])
    idx = jnp.where(keep, off[:, None] + rank, sb)       # sb = drop slot
    out = jnp.full((sb,), KIND_PAD, jnp.uint8)
    out = out.at[idx.reshape(-1)].set(pc.reshape(-1), mode="drop")
    return pack_path_codes(out[None, :])[0]


def viterbi_from_flat_compact_jit(obs_flat, obs_starts, n_obs, rank_starts,
                                  flat_ranks, model_table, n_states,
                                  events_per_base, hmm_probs, n_state_pad,
                                  t_pad, bt_len, sb):
    """:func:`viterbi_from_flat_jit` with the path codes compacted into one
    flat bounded stream (see :func:`compact_path_codes`) — the d2h bytes
    drop from (W_pad x bt_len) to sum-of-bounds."""
    return _viterbi_from_flat_compact_cached(hmm_probs, n_state_pad, t_pad,
                                             bt_len, sb)(
        obs_flat, obs_starts, n_obs, rank_starts, flat_ranks, model_table,
        n_states, events_per_base)


@functools.lru_cache(maxsize=None)
def _viterbi_from_flat_compact_cached(hmm_probs, n_state_pad, t_pad, bt_len,
                                      sb):
    def inner(obs_flat, obs_starts, n_obs, rank_starts, flat_ranks,
              model_table, n_states, events_per_base):
        pc, pl, score = _viterbi_from_flat_core(
            obs_flat, obs_starts, n_obs, rank_starts, flat_ranks,
            model_table, n_states, events_per_base, hmm_probs, n_state_pad,
            t_pad, bt_len)
        return compact_path_codes(pc, n_obs, n_states, sb), pl, score
    return jax.jit(inner)


@functools.partial(jax.jit, static_argnames=("hmm_probs", "n_state_pad",
                                             "t_pad", "bt_len"))
def viterbi_from_flat_jit(obs_flat, obs_starts, n_obs, rank_starts, flat_ranks,
                          model_table, n_states, events_per_base, hmm_probs,
                          n_state_pad, t_pad, bt_len=None):
    """Fully flat variant: observations AND ranks are gathered on device
    from resident flat arrays (each uploaded once per read batch), so a
    window chunk ships only its i32 offset vectors.  ``t_pad`` is the static
    time bucket; junk beyond ``n_obs`` is masked by the scan.  Path codes
    come back nibble-packed."""
    return _viterbi_from_flat(obs_flat, obs_starts, n_obs, rank_starts,
                              flat_ranks, model_table, n_states,
                              events_per_base, hmm_probs, n_state_pad, t_pad,
                              bt_len)


@functools.lru_cache(maxsize=None)
def _viterbi_from_flat_sharded_fn(mesh, hmm_probs, n_state_pad, t_pad,
                                  bt_len=None):
    from jax.sharding import PartitionSpec as P

    def inner(obs_flat, obs_starts, n_obs, rank_starts, flat_ranks,
              model_table, n_states, epb):
        return _viterbi_from_flat(obs_flat, obs_starts, n_obs, rank_starts,
                                  flat_ranks, model_table, n_states, epb,
                                  hmm_probs, n_state_pad, t_pad, bt_len)

    sm = jax.shard_map(
        inner, mesh=mesh, check_vma=False,
        in_specs=(P(), P("data"), P("data"), P("data"), P(), P(),
                  P("data"), P("data")),
        out_specs=(P("data", None), P("data"), P("data")))
    return jax.jit(sm)


def viterbi_from_flat_sharded(mesh, obs_flat, obs_starts, n_obs, rank_starts,
                              flat_ranks, model_table, n_states,
                              events_per_base, hmm_probs, n_state_pad, t_pad,
                              bt_len=None):
    """Window-sharded flat variant: the flat observation/rank streams are
    replicated, the per-window offset vectors are sharded, and each device
    runs its shard's fill under shard_map."""
    return _viterbi_from_flat_sharded_fn(mesh, hmm_probs, n_state_pad,
                                         t_pad, bt_len)(
        obs_flat, obs_starts, n_obs, rank_starts, flat_ranks, model_table,
        n_states, events_per_base)


def viterbi_from_ranks_core(obs, n_obs, ranks, model_table, n_states,
                            events_per_base, hmm_probs, bt_len=None):
    obs = obs.astype(jnp.float32)
    safe = jnp.clip(ranks, 0, model_table.shape[0] - 1)
    mu = model_table[safe, 0]
    sigma = jnp.maximum(model_table[safe, 1], 1e-6)
    inv_sigma = 1.0 / sigma
    lp_const = jnp.float32(np.log(0.3989422804014327)) - jnp.log(sigma)
    lp_const = jnp.where(ranks < 0, NEG, lp_const)
    return viterbi_fill_backtrace(obs, n_obs, mu, inv_sigma, lp_const,
                                  n_states, events_per_base, hmm_probs,
                                  bt_len=bt_len)


@functools.partial(jax.jit, static_argnames=("hmm_probs",))
def viterbi_from_ranks_jit(obs, n_obs, ranks, model_table, n_states,
                           events_per_base, hmm_probs):
    """Variant taking per-state k-mer ranks + the (4^k, 2) pore-model table
    (device-resident) instead of three per-window coefficient planes — one
    i32 upload instead of three f32 uploads per batch.  Path codes come back
    nibble-packed (see :func:`pack_path_codes`)."""
    mu = model_table[ranks, 0]
    sigma = jnp.maximum(model_table[ranks, 1], 1e-6)  # guard zero rows
    inv_sigma = 1.0 / sigma
    lp_const = jnp.float32(np.log(0.3989422804014327)) - jnp.log(sigma)
    lp_const = jnp.where(ranks < 0, NEG, lp_const)
    pc, pl, score = viterbi_fill_backtrace(obs, n_obs, mu, inv_sigma, lp_const,
                                           n_states, events_per_base, hmm_probs)
    return pack_path_codes(pc), pl, score


@functools.lru_cache(maxsize=None)
def _viterbi_from_ranks_sharded_fn(mesh, hmm_probs):
    from jax.sharding import PartitionSpec as P

    def inner(obs, n_obs, ranks, model_table, n_states, epb):
        pc, pl, score = viterbi_from_ranks_core(obs, n_obs, ranks,
                                                model_table, n_states, epb,
                                                hmm_probs)
        return pack_path_codes(pc), pl, score

    sm = jax.shard_map(
        inner, mesh=mesh, check_vma=False,
        in_specs=(P("data", None), P("data"), P("data", None), P(),
                  P("data"), P("data")),
        out_specs=(P("data", None), P("data"), P("data")))
    return jax.jit(sm)


def viterbi_from_ranks_sharded(mesh, obs, n_obs, ranks, model_table,
                               n_states, events_per_base, hmm_probs):
    """Window-sharded rank variant (shard_map over the mesh's data axis)."""
    return _viterbi_from_ranks_sharded_fn(mesh, hmm_probs)(
        obs, n_obs, ranks, model_table, n_states, events_per_base)


def decode_path(codes: np.ndarray, n_states: int):
    """Host decode of one forward-order code array -> (kinds, positions).

    pos[last] anchors at n_states-1; pos[t] = n_states-1 - sum of deltas
    after t."""
    kinds = (codes & 3).astype(np.uint8)
    deltas = ((codes >> 2) & 1).astype(np.int64)
    csum = np.cumsum(deltas)
    total = csum[-1] if csum.shape[0] else 0
    poss = (n_states - 1) - (total - csum)
    return kinds, poss
