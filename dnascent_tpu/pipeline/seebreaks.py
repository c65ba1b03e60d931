"""seeBreaks: bootstrap test for elevated DNA breaks at replication forks.

Re-implementation of the reference's Monte-Carlo analysis (reference:
src/seeBreaks.cpp:505-652).  Two execution paths:

* parity mode (default): the bootstrap draws run through the native C++
  helpers which use libstdc++'s ``std::mt19937(221005)`` + distributions, so
  outputs are bit-identical to the reference binary on the same inputs;
* fast mode: a fully vectorised ``numpy`` bootstrap (different RNG stream,
  same statistics) for very large fork sets.

The end-tolerance sweep, duplicate-read handling, minimum read length
(mean + 3 sigma of track lengths) and the 1.96-sigma confidence interval
mirror seeBreaks.cpp:505-616.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..config import SeeBreaksParams
from .. import native


@dataclass
class AnalogueTrack:
    is_right: bool
    read_id: str
    gap5: int
    gap3: int


@dataclass
class SeeBreaksResult:
    n_forks: int
    sim_mean: float
    sim_std: float
    obs_mean: float
    obs_std: float
    diff_mean: float
    diff_std: float
    ci_low: float
    ci_high: float
    sim_runoffs: np.ndarray
    obs_runoffs: np.ndarray


def _parse_bed(path: str):
    rows = []
    with open(path) as fh:
        for line in fh:
            if not line.strip() or line[0] == "#":
                continue
            rows.append(line.split())
    return rows


def scan_read_ids(paths: list[str]):
    """Duplicate readID detection across fork beds (seeBreaks.cpp:223-253)."""
    seen: set = set()
    dups: set = set()
    for p in paths:
        for cols in _parse_bed(p):
            rid = cols[3]
            if rid in seen:
                dups.add(rid)
            else:
                seen.add(rid)
    return seen, dups


def analogue_unpack(path: str, dups: set):
    """readID -> (pulse5', pulse3') from the analogue bed
    (seeBreaks.cpp:256-285)."""
    out = {}
    for cols in _parse_bed(path):
        rid = cols[3]
        if rid in dups:
            continue
        out[rid] = (int(cols[1]), int(cols[2]))
    return out


def analogue_track_lengths(path: str, is_right: bool, readid2analogue: dict,
                           dups: set, fs_boundary: int):
    """Track lengths + R9/R10 column-count sniffing
    (getAnalogueTrackLen, seeBreaks.cpp:288-350)."""
    lengths = []
    is_r9 = False
    for cols in _parse_bed(path):
        if len(cols) == 8:
            is_r9 = True
        elif len(cols) != 9:
            raise ValueError(f"unexpected column count in {path}")
        rid = cols[3]
        if rid in dups or rid not in readid2analogue:
            continue
        p5, p3 = int(cols[1]), int(cols[2])
        r5, r3 = int(cols[4]), int(cols[5])
        a5, a3 = readid2analogue[rid]
        if is_right and p3 == a3:
            pass
        elif (not is_right) and p5 == a5:
            pass
        else:
            continue
        gap3 = r3 - a3
        gap5 = a5 - r5
        if gap3 > fs_boundary and gap5 > fs_boundary:
            lengths.append(a3 - a5)
    return np.asarray(lengths, dtype=np.int64), is_r9


def fork_unpack(path: str, is_right: bool, readid2analogue: dict, dups: set,
                fs_boundary: int, min_read_length: int):
    """Fork tracks + fork count (forkUnpack, seeBreaks.cpp:353-411)."""
    tracks = []
    n_forks = 0
    for cols in _parse_bed(path):
        rid = cols[3]
        if rid in dups or rid not in readid2analogue:
            continue
        p5, p3 = int(cols[1]), int(cols[2])
        r5, r3 = int(cols[4]), int(cols[5])
        if r3 - r5 < min_read_length:
            continue
        a5, a3 = readid2analogue[rid]
        if is_right and p3 == a3:
            pass
        elif (not is_right) and p5 == a5:
            pass
        else:
            continue
        gap3 = r3 - a3
        gap5 = a5 - r5
        if is_right and gap5 > fs_boundary:
            n_forks += 1
        elif (not is_right) and gap3 > fs_boundary:
            n_forks += 1
        tracks.append(AnalogueTrack(is_right, rid, gap5, gap3))
    return tracks, n_forks


def check_runoffs(tracks: list[AnalogueTrack], fs_boundary: int,
                  end_tolerance: int) -> np.ndarray:
    """Observed run-offs (checkRunOffs, seeBreaks.cpp:414-427)."""
    out = []
    for t in tracks:
        if t.is_right and t.gap5 > fs_boundary:
            out.append(t.gap3 < end_tolerance)
        elif (not t.is_right) and t.gap3 > fs_boundary:
            out.append(t.gap5 < end_tolerance)
    return np.asarray(out, dtype=bool)


def simulation_fast(v5, v3, fork_len, n_forks, iterations, seed, fs_boundary,
                    end_tolerance):
    """Vectorised null bootstrap (statistics of seeBreaks.cpp:430-474 without
    the libstdc++ RNG stream)."""
    rng = np.random.default_rng(seed)
    ri = rng.integers(0, v5.shape[0], size=(iterations, n_forks))
    li = rng.integers(0, fork_len.shape[0], size=(iterations, n_forks))
    r5 = v5[ri]
    r3 = v3[ri]
    lo = r5 + fs_boundary
    hi = r3 - fs_boundary
    start = lo + (rng.random((iterations, n_forks))
                  * (hi - lo + 1)).astype(np.int64)
    runoff = (r3 - end_tolerance - start) < fork_len[li]
    return runoff.mean(axis=1)


def observation_fast(runoffs: np.ndarray, iterations, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, runoffs.shape[0], size=(iterations, runoffs.shape[0]))
    return runoffs[idx].mean(axis=1)


_BOOTSTRAP_JIT = None


def _bootstrap_device_jit():
    """Device bootstrap (SURVEY §5 long-context row / §7.1 item 5: the
    5000×n_forks draw grid is one ``jax.random`` batch).  Statistics match
    the numpy fast path (same math, different RNG stream); parity mode
    stays on the native libstdc++ RNG.  The jitted fn is cached at module
    level and only the SHAPES are static — seed and the end-tolerance
    sweep value are traced, so the 6-point sweep reuses one executable
    instead of recompiling per tolerance."""
    global _BOOTSTRAP_JIT
    if _BOOTSTRAP_JIT is not None:
        return _BOOTSTRAP_JIT
    import functools
    import jax
    import jax.numpy as jnp

    @functools.partial(jax.jit, static_argnames=("iterations", "n_forks",
                                                 "n_obs"))
    def f(v5, v3, fork_len, runoffs, seed, fs_boundary, end_tolerance, *,
          iterations, n_forks, n_obs):
        key = jax.random.PRNGKey(seed)
        k1, k2, k3, k4 = jax.random.split(key, 4)
        ri = jax.random.randint(k1, (iterations, n_forks), 0, v5.shape[0])
        li = jax.random.randint(k2, (iterations, n_forks), 0,
                                fork_len.shape[0])
        r5 = v5[ri]
        r3 = v3[ri]
        lo = r5 + fs_boundary
        hi = r3 - fs_boundary
        u = jax.random.uniform(k3, (iterations, n_forks))
        start = lo + (u * (hi - lo + 1).astype(jnp.float32)).astype(jnp.int32)
        runoff = (r3 - end_tolerance - start) < fork_len[li]
        sim = runoff.mean(axis=1, dtype=jnp.float32)
        oi = jax.random.randint(k4, (iterations, n_obs), 0, n_obs)
        obs = runoffs[oi].mean(axis=1, dtype=jnp.float32)
        return sim, obs

    _BOOTSTRAP_JIT = f
    return f


def bootstrap_fast_device(v5, v3, fork_len, runoffs, iterations, seed,
                          fs_boundary, end_tolerance):
    """Both bootstrap grids (null simulation + observed resampling) in one
    device dispatch; returns numpy (sim, obs)."""
    import jax.numpy as jnp
    f = _bootstrap_device_jit()
    sim, obs = f(jnp.asarray(v5), jnp.asarray(v3), jnp.asarray(fork_len),
                 jnp.asarray(runoffs), jnp.int32(seed),
                 jnp.int32(fs_boundary), jnp.int32(end_tolerance),
                 iterations=int(iterations),
                 n_forks=int(runoffs.shape[0]), n_obs=int(runoffs.shape[0]))
    return np.asarray(sim), np.asarray(obs)


def run_seebreaks(left_bed: Optional[str], right_bed: Optional[str],
                  analogue_bed: str, detect_reads_5p: np.ndarray,
                  detect_reads_3p_by_minlen, params: SeeBreaksParams,
                  parity: bool = True) -> SeeBreaksResult:
    """Full seeBreaks analysis.

    ``detect_reads_5p``/``detect_reads_3p_by_minlen``: because the minimum
    read length depends on track statistics computed *from the beds*
    (seeBreaks.cpp:537-539), callers pass a callable
    ``detect_reads_3p_by_minlen(min_len) -> (v5, v3)`` that filters the
    detect-read span list.
    """
    paths = [p for p in (left_bed, right_bed) if p]
    _, dups = scan_read_ids(paths)
    readid2analogue = analogue_unpack(analogue_bed, dups)

    lengths_all = []
    is_r9 = False
    if left_bed:
        l, r9 = analogue_track_lengths(left_bed, False, readid2analogue, dups,
                                       params.forksense_boundary)
        lengths_all.append(l)
        is_r9 |= r9
    if right_bed:
        l, r9 = analogue_track_lengths(right_bed, True, readid2analogue, dups,
                                       params.forksense_boundary)
        lengths_all.append(l)
        is_r9 |= r9
    track_lengths = np.concatenate(lengths_all) if lengths_all else np.empty(0, np.int64)
    if track_lengths.size == 0:
        raise ValueError("no usable analogue tracks for seeBreaks")
    mean_len = float(track_lengths.mean())
    # population stdv with the reference's vectorStdv (n-1 denominator,
    # common.h:206-218)
    std_len = float(track_lengths.std(ddof=1)) if track_lengths.size > 1 else 0.0
    min_read_length = int(mean_len + 3.0 * std_len)

    v5, v3 = detect_reads_3p_by_minlen(min_read_length)
    v5 = np.asarray(v5, dtype=np.int64)
    v3 = np.asarray(v3, dtype=np.int64)

    left_tracks, n_left = ([], 0)
    right_tracks, n_right = ([], 0)
    if left_bed:
        left_tracks, n_left = fork_unpack(left_bed, False, readid2analogue,
                                          dups, params.forksense_boundary,
                                          min_read_length)
    if right_bed:
        right_tracks, n_right = fork_unpack(right_bed, True, readid2analogue,
                                            dups, params.forksense_boundary,
                                            min_read_length)
    n_forks = n_left + n_right

    end_tol = params.end_tolerance_r9 if is_r9 else params.end_tolerance_r10
    sim_all, obs_all = [], []
    for tol in range(end_tol, end_tol + params.end_tolerance_sweep + 1,
                     params.end_tolerance_step):
        runoffs = np.concatenate([
            check_runoffs(right_tracks, params.forksense_boundary, tol),
            check_runoffs(left_tracks, params.forksense_boundary, tol),
        ])
        if runoffs.size == 0 or v5.size == 0:
            continue
        if parity and native.available():
            lib = native.get_lib()
            sim = np.empty(params.bootstrap_iterations, dtype=np.float64)
            lib.seebreaks_simulation(
                np.ascontiguousarray(v5), np.ascontiguousarray(v3),
                v5.shape[0], np.ascontiguousarray(track_lengths),
                track_lengths.shape[0], int(runoffs.shape[0]),
                params.bootstrap_iterations, params.rng_seed,
                params.forksense_boundary, tol, sim)
            obs = np.empty(params.bootstrap_iterations, dtype=np.float64)
            lib.seebreaks_observation(
                runoffs.astype(np.uint8), runoffs.shape[0], params.rng_seed,
                params.bootstrap_iterations, obs)
        else:
            from .. import platform
            if platform.routes().device_bootstrap:
                # fast mode on an accelerator: both bootstrap grids as one
                # jax.random device batch
                sim, obs = bootstrap_fast_device(
                    v5.astype(np.int32), v3.astype(np.int32),
                    track_lengths.astype(np.int32), runoffs,
                    params.bootstrap_iterations, params.rng_seed,
                    params.forksense_boundary, tol)
            else:
                sim = simulation_fast(v5, v3, track_lengths,
                                      runoffs.shape[0],
                                      params.bootstrap_iterations,
                                      params.rng_seed,
                                      params.forksense_boundary, tol)
                obs = observation_fast(runoffs, params.bootstrap_iterations,
                                       params.rng_seed)
        sim_all.append(sim)
        obs_all.append(obs)

    sim = np.concatenate(sim_all) if sim_all else np.zeros(1)
    obs = np.concatenate(obs_all) if obs_all else np.zeros(1)
    sim_mean, sim_std = float(sim.mean()), float(sim.std(ddof=1))
    obs_mean, obs_std = float(obs.mean()), float(obs.std(ddof=1))

    if parity and native.available():
        lib = native.get_lib()
        diff = np.empty(sim.shape[0], dtype=np.float64)
        lib.seebreaks_difference(obs_mean, obs_std, sim_mean, sim_std,
                                 sim.shape[0], params.rng_seed, diff)
    else:
        rng = np.random.default_rng(params.rng_seed)
        diff = (rng.normal(obs_mean, obs_std, sim.shape[0])
                - rng.normal(sim_mean, sim_std, sim.shape[0]))
    diff_mean, diff_std = float(diff.mean()), float(diff.std(ddof=1))
    return SeeBreaksResult(
        n_forks=n_forks,
        sim_mean=sim_mean, sim_std=sim_std,
        obs_mean=obs_mean, obs_std=obs_std,
        diff_mean=diff_mean, diff_std=diff_std,
        ci_low=diff_mean - params.ci_z * diff_std,
        ci_high=diff_mean + params.ci_z * diff_std,
        sim_runoffs=sim, obs_runoffs=obs,
    )


def write_seebreaks_output(res: SeeBreaksResult, path: str, detect_file: str,
                           left_bed: str, right_bed: str) -> None:
    """Output file (seeBreaks.cpp:618-649)."""
    import datetime
    from .. import __version__
    now = datetime.datetime.now().strftime("%d/%m/%Y %H:%M:%S")
    with open(path, "w") as fh:
        fh.write(f"#DetectFile {detect_file}\n")
        fh.write(f"#ForkFiles {left_bed} {right_bed}\n")
        fh.write(f"#SystemStartTime {now}\n")
        fh.write("#Software dnascent_tpu\n")
        fh.write(f"#Version {__version__}\n")
        fh.write("#Commit none\n")
        fh.write(f"#nForks {res.n_forks}\n")
        fh.write(f"#ExpectedReadEndFraction {res.sim_mean:.6g}\n")
        fh.write(f"#ExpectedReadEndFraction_StdErr {res.sim_std:.6g}\n")
        fh.write(f"#ObservedReadEndFraction {res.obs_mean:.6g}\n")
        fh.write(f"#ObservedReadEndFraction_StdErr {res.obs_std:.6g}\n")
        fh.write(f"#Difference {res.diff_mean:.6g}\n")
        fh.write(f"#Difference_StdErr {res.diff_std:.6g}\n")
        fh.write(f"#95ConfidenceInterval {res.ci_low:.6g} {res.ci_high:.6g}\n")
        fh.write(">ExpectedReadEndFractions:\n")
        for v in res.sim_runoffs:
            fh.write(f"{v:.6g}\n")
        fh.write(">ObservedReadEndFractions:\n")
        for v in res.obs_runoffs:
            fh.write(f"{v:.6g}\n")
