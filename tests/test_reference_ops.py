"""End-to-end sanity tests of the numpy oracle kernels on simulated signal.

These validate that the oracle pipeline (event detection -> quantile scaling
-> banded alignment -> Theil-Sen -> Viterbi) recovers the generative truth on
synthetic reads, which pins down the semantics the device kernels must match.
"""

import numpy as np
import pytest

from dnascent_tpu.config import DNA_R10
from dnascent_tpu.ops import reference as ref
from dnascent_tpu.testing.simulate import simulate_read
from dnascent_tpu.utils import seqtools


def test_kmer2index_roundtrip():
    assert seqtools.kmer2index("AAAAAAAAA") == 0
    assert seqtools.kmer2index("AAAAAAAAT") == 1
    assert seqtools.kmer2index("CCCCCCCCC") == 4 ** 9 - 1
    for i in [0, 5, 123456, 4 ** 9 - 1]:
        assert seqtools.kmer2index(seqtools.index2kmer(i, 9)) == i


def test_kmer_ranks_vectorised_matches_scalar():
    seq = "ATGCCGTTAGGCATCGATT"
    k = 9
    ranks = seqtools.kmer_ranks(seq, k)
    for i in range(len(seq) - k + 1):
        assert ranks[i] == seqtools.kmer2index(seq[i : i + k])


def test_kmer_ranks_flags_undefined():
    ranks = seqtools.kmer_ranks("NTGCAGTTAGGCA", 9)
    assert ranks[0] == -1  # contains N
    assert ranks[1] != -1


def test_reverse_complement():
    assert seqtools.reverse_complement("ATGC") == "GCAT"
    assert seqtools.reverse_complement("NRY") == "RYN"


def test_event_detection_finds_levels():
    rng = np.random.default_rng(0)
    # 20 segments of clearly distinct levels
    levels = rng.uniform(60, 120, size=20)
    raw = np.repeat(levels, 50) + rng.normal(0, 0.8, 1000)
    et = ref.detect_events(raw)
    # scrappie's detector oversegments noise (stays are absorbed downstream);
    # what matters is that every true level transition has a boundary nearby
    bounds = et.start
    true_bounds = 50 * np.arange(1, 20)
    for tb in true_bounds:
        assert np.min(np.abs(bounds - tb)) <= 3
    # and every event mean should sit near SOME generating level
    for m, ln in zip(et.mean, et.length):
        if ln >= 5:
            assert np.min(np.abs(levels - m)) < 2.5


def test_merge_events_first_event_zero_mean_quirk():
    # the reference's merge loop emits the first event with mean 0.0
    # (event_handling.cpp:550-575); mirror that
    et = ref.EventTable(
        start=np.array([0, 10, 20, 30]),
        length=np.array([10, 10, 10, 10], dtype=np.float32),
        mean=np.array([5.0, 6.0, 7.0, 8.0], dtype=np.float32),
        stdv=np.ones(4, dtype=np.float32),
    )
    me = ref.merge_events(et, 40)
    assert me.mean.shape[0] == 3  # last raw event dropped
    assert me.mean[0] == 0.0
    assert me.mean[1] == 6.0
    assert me.raw_start[0] == 0 and me.raw_end[0] == 9
    assert me.raw_start[1] == 10 and me.raw_end[1] == 19


def test_quantile_scaling_recovers_truth(models):
    cfg = DNA_R10
    sim = simulate_read(models.pore_model, cfg, length=3000, seed=1)
    et = ref.detect_events(sim.raw)
    me = ref.merge_events(et, sim.raw.shape[0])
    ranks = seqtools.kmer_ranks(sim.sequence, cfg.kmer_len)
    model_means = models.pore_model[np.where(ranks < 0, 0, ranks), 0]
    shift, scale = ref.estimate_scaling_quantiles(me.mean, model_means)
    assert abs(shift - sim.shift) < 4.0
    assert abs(scale - sim.scale) / sim.scale < 0.08


@pytest.fixture(scope="module")
def banded_setup(models):
    cfg = DNA_R10
    sim = simulate_read(models.pore_model, cfg, length=2500, seed=7)
    et = ref.detect_events(sim.raw)
    me = ref.merge_events(et, sim.raw.shape[0])
    ranks = seqtools.kmer_ranks(sim.sequence, cfg.kmer_len)
    ranks = np.where(ranks < 0, 0, ranks)
    model_means = models.pore_model[ranks, 0]
    shift, scale = ref.estimate_scaling_quantiles(me.mean, model_means)
    # error-free simulation: query == reference, identity coordinate map
    q2r = {i: i for i in range(len(sim.sequence))}
    res = ref.adaptive_banded_align(me.mean, ranks, ranks, q2r,
                                    models.pore_model, shift, scale,
                                    cfg.banded, keep_matrices=True)
    return cfg, sim, me, ranks, shift, scale, res


def test_banded_alignment_qc_pass(banded_setup):
    cfg, sim, me, ranks, shift, scale, res = banded_setup
    assert res.spanned
    assert res.max_gap <= cfg.banded.max_gap_threshold
    assert res.avg_log_emission > cfg.banded.min_average_log_emission
    assert res.qc_pass
    assert res.event_alignment.shape[0] > 0


def test_banded_alignment_is_monotone(banded_setup):
    _, _, _, _, _, _, res = banded_setup
    ev = res.event_alignment[:, 0]
    km = res.event_alignment[:, 1]
    assert (np.diff(ev) >= 0).all()
    assert (np.diff(km) >= 0).all()
    assert (np.diff(ev) + np.diff(km) > 0).all()


def test_banded_alignment_tracks_truth(banded_setup):
    # aligned kmer position should track the dwell-derived true position
    cfg, sim, me, ranks, shift, scale, res = banded_setup
    # true sample->kmer mapping
    dwell_edges = np.concatenate([[0], np.cumsum(sim.dwell_samples)])
    pairs = res.event_alignment
    errs = []
    for e_idx, k_idx in pairs[:: max(1, pairs.shape[0] // 200)]:
        sample = me.raw_start[e_idx]
        true_k = np.searchsorted(dwell_edges, sample, side="right") - 1
        errs.append(abs(int(true_k) - int(k_idx)))
    assert np.median(errs) <= 2


def test_theilsen_refines_scaling(banded_setup):
    cfg, sim, me, ranks, shift, scale, res = banded_setup
    from dnascent_tpu.io.poremodel import synthetic_model_set
    models = synthetic_model_set(cfg)
    mm = models.pore_model[res.cleaned_ranks, 0]
    s2, sc2 = ref.estimate_scaling_theilsen(res.cleaned_signals, mm, shift, scale)
    assert abs(s2 - sim.shift) <= abs(shift - sim.shift) + 0.5
    assert abs(sc2 - sim.scale) / sim.scale < 0.03


def test_theilsen_short_read_passthrough():
    s, sc = ref.estimate_scaling_theilsen(np.ones(10), np.ones(10), 3.0, 1.1)
    assert (s, sc) == (3.0, 1.1)


def test_viterbi_perfect_signal(models):
    # observations generated exactly from the model means should align M-only
    cfg = DNA_R10
    rng = np.random.default_rng(3)
    n_states = 42
    ranks = rng.integers(0, 4 ** 9, size=n_states)
    mu = models.pore_model[ranks, 0].astype(np.float64)
    obs = mu * 1.0  # shift=0 scale=1
    res = ref.builtin_viterbi(obs, ranks, models.pore_model, 0.0, 1.0,
                              events_per_base=2.0)
    kinds = res.path[:, 0]
    m_states = res.path[kinds == 1]
    # every kmer matched exactly once, in order
    assert m_states.shape[0] == n_states
    assert (m_states[:, 1] == np.arange(n_states)).all()


def test_viterbi_with_stays_and_skips(models):
    cfg = DNA_R10
    rng = np.random.default_rng(4)
    n_states = 30
    ranks = rng.integers(0, 4 ** 9, size=n_states)
    mu = models.pore_model[ranks, 0].astype(np.float64)
    # duplicate some observations (stays), drop one kmer's observation (skip)
    obs = np.repeat(mu, rng.integers(1, 3, size=n_states))
    res = ref.builtin_viterbi(obs, ranks, models.pore_model, 0.0, 1.0,
                              events_per_base=2.0)
    m_pos = res.path[res.path[:, 0] == 1][:, 1]
    assert (np.diff(np.unique(m_pos)) >= 1).all()
    assert np.unique(m_pos).shape[0] >= n_states - 2


def test_forward_hmm_prefers_matching_model(models):
    cfg = DNA_R10
    rng = np.random.default_rng(5)
    w = 12
    n = 2 * w
    ranks = rng.integers(0, 4 ** 9, size=n + cfg.kmer_len)
    hasT = np.ones(n + cfg.kmer_len, dtype=bool)
    mu_un = models.unlabelled_model[ranks[:n], 0].astype(np.float64)
    mu_an = models.analogue_model[ranks[:n], 0].astype(np.float64)
    brdu_start, brdu_end = w - 4, w + 4
    sel = np.zeros(n, dtype=bool)
    sel[brdu_start : brdu_end + 1] = True
    obs_analogue = np.where(sel, mu_an, mu_un)
    ll_an = ref.sequence_probability(obs_analogue, ranks, hasT, w, True,
                                     models.unlabelled_model, models.analogue_model,
                                     0.0, 1.0, 2.0, brdu_start, brdu_end)
    ll_un = ref.sequence_probability(obs_analogue, ranks, hasT, w, False,
                                     models.unlabelled_model, models.analogue_model,
                                     0.0, 1.0, 2.0, 0, 0)
    assert ll_an > ll_un
    obs_thym = mu_un
    ll_an2 = ref.sequence_probability(obs_thym, ranks, hasT, w, True,
                                      models.unlabelled_model, models.analogue_model,
                                      0.0, 1.0, 2.0, brdu_start, brdu_end)
    ll_un2 = ref.sequence_probability(obs_thym, ranks, hasT, w, False,
                                      models.unlabelled_model, models.analogue_model,
                                      0.0, 1.0, 2.0, 0, 0)
    assert ll_un2 > ll_an2
