"""Device banded-fill kernel + native backtrace vs the numpy oracle."""

import numpy as np
import pytest

from dnascent_tpu.config import DNA_R10
from dnascent_tpu.ops import banded, reference as ref
from dnascent_tpu.testing.simulate import simulate_read
from dnascent_tpu.utils import seqtools
from dnascent_tpu import native


def _prep_read(models, seed, length):
    cfg = DNA_R10
    sim = simulate_read(models.pore_model, cfg, length=length, seed=seed)
    et = ref.detect_events(sim.raw)
    me = ref.merge_events(et, sim.raw.shape[0])
    ranks = seqtools.kmer_ranks(sim.sequence, cfg.kmer_len)
    ranks = np.where(ranks < 0, 0, ranks)
    model_means = models.pore_model[ranks, 0]
    shift, scale = ref.estimate_scaling_quantiles(me.mean, model_means)
    return sim, me, ranks, shift, scale


@pytest.fixture(scope="module")
def batch(models):
    reads = [_prep_read(models, seed, ln)
             for seed, ln in [(11, 1200), (12, 1500), (13, 900)]]
    B = len(reads)
    E = max(r[1].mean.shape[0] for r in reads)
    K = max(r[2].shape[0] for r in reads)
    scaled = np.zeros((B, E), dtype=np.float32)
    mu = np.zeros((B, K), dtype=np.float32)
    inv_s = np.ones((B, K), dtype=np.float32)
    lpc = np.full((B, K), -np.inf, dtype=np.float32)
    n_ev = np.zeros(B, dtype=np.int32)
    n_km = np.zeros(B, dtype=np.int32)
    for b, (sim, me, ranks, shift, scale) in enumerate(reads):
        ne, nk = me.mean.shape[0], ranks.shape[0]
        scaled[b, :ne] = (me.mean - shift) / scale
        m, i, l = banded.prepare_emission_coefficients(ranks[None, :], models.pore_model)
        mu[b, :nk], inv_s[b, :nk], lpc[b, :nk] = m[0], i[0], l[0]
        n_ev[b], n_km[b] = ne, nk
    return reads, scaled, mu, inv_s, lpc, n_ev, n_km


@pytest.fixture(scope="module")
def device_out(batch):
    reads, scaled, mu, inv_s, lpc, n_ev, n_km = batch
    tp, rp, best_e, best_s = banded.banded_fill_jit(
        scaled, mu, inv_s, lpc, n_ev, n_km)
    return (np.asarray(tp), np.asarray(rp), np.asarray(best_e),
            np.asarray(best_s))


def _oracle(models, read):
    sim, me, ranks, shift, scale = read
    q2r = {i: i for i in range(len(sim.sequence))}
    return ref.adaptive_banded_align(me.mean, ranks, ranks, q2r,
                                     models.pore_model, shift, scale,
                                     DNA_R10.banded, keep_matrices=True)


def test_fill_matches_oracle_traces(models, batch, device_out):
    reads, scaled, mu, inv_s, lpc, n_ev, n_km = batch
    tp, rp, best_e, best_s = device_out
    for b, read in enumerate(reads):
        res = _oracle(models, read)
        ne, nk = int(n_ev[b]), int(n_km[b])
        n_bands = ne + nk + 2
        tr, rg = banded.unpack_trace(tp[:, b : b + 1], rp[:, b : b + 1], n_bands)
        tr = tr[:, 0, :]
        rg = rg[:, 0]
        # band placement decisions must match exactly
        oracle_rights = (np.diff(res.band_lower_left[:, 1]) == 1)[1:]  # bands 2..
        assert (rg[: n_bands - 2] == oracle_rights).all()
        # trace codes over valid cells: tolerate rare float tie divergence
        mismatch = (tr[: n_bands - 2] != res.trace[2:n_bands]).mean()
        assert mismatch < 1e-3, f"trace mismatch rate {mismatch}"
        # device best-start should equal the oracle's start event
        # (recompute oracle's start from its matrices)
        NEGF = np.float32(-np.inf)
        lp_trim = np.float32(np.log(DNA_R10.banded.p_trim))
        best = NEGF
        best_event = 0
        for e in range(ne):
            band_idx = (e + 1) + nk
            off = int(res.band_lower_left[band_idx, 0]) - e
            if 0 <= off < DNA_R10.banded.bandwidth:
                s = res.bands[band_idx, off] + np.float32(ne - e) * lp_trim
                if s > best:
                    best, best_event = s, e
        assert int(best_e[b]) == best_event


def test_native_backtrace_matches_oracle(models, batch, device_out):
    if not native.available():
        pytest.skip("native library unavailable")
    reads, scaled, mu, inv_s, lpc, n_ev, n_km = batch
    tp, rp, best_e, best_s = device_out
    for b, read in enumerate(reads):
        sim, me, ranks, shift, scale = read
        res = _oracle(models, read)
        ne, nk = int(n_ev[b]), int(n_km[b])
        n_bands = ne + nk + 2
        q2r = np.arange(len(sim.sequence), dtype=np.int64)
        pairs, cs, cr, avg_em, spanned, max_gap = native.banded_backtrace(
            tp, rp, b, n_bands, DNA_R10.banded.bandwidth, ne, nk,
            int(best_e[b]),
            me.mean, scaled[b, :ne], mu[b, :nk], inv_s[b, :nk], lpc[b, :nk],
            q2r, ranks.astype(np.int64))
        # oracle comparison (oracle clears pairs when qc fails; compare raw)
        assert spanned == res.spanned
        assert max_gap == res.max_gap
        assert abs(avg_em - res.avg_log_emission) < 5e-3
        np.testing.assert_array_equal(cr, res.cleaned_ranks)
        np.testing.assert_allclose(cs, res.cleaned_signals, rtol=1e-12)
        if res.qc_pass:
            np.testing.assert_array_equal(pairs, res.event_alignment)


def test_native_event_detect_matches_oracle(models):
    if not native.available():
        pytest.skip("native library unavailable")
    sim = simulate_read(models.pore_model, DNA_R10, length=800, seed=21)
    et = ref.detect_events(sim.raw)
    me = ref.merge_events(et, sim.raw.shape[0])
    mean, start, end, et_n = native.event_detect(sim.raw)
    assert et_n == et.mean.shape[0]
    np.testing.assert_allclose(mean, me.mean, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(start, me.raw_start)
    np.testing.assert_array_equal(end, me.raw_end)


@pytest.mark.parametrize("kind", ["static_sigma", "fitted_sigma"])
def test_xla_fill_matches_oracle_both_model_kinds(models, kind):
    """The XLA fill + native backtrace reproduce the numpy oracle's
    alignment for the shipping static-sigma table and for a per-k-mer
    sigma table like the ones trainGMM fits."""
    import dataclasses
    if kind == "fitted_sigma":
        pm = models.pore_model.copy()
        pm[:, 1] = np.random.default_rng(9).uniform(0.08, 0.3, pm.shape[0])
        models = dataclasses.replace(models, pore_model=pm)
    read = _prep_read(models, 31, 1600)
    sim, me, ranks, shift, scale = read
    ne, nk = me.mean.shape[0], ranks.shape[0]
    scaled = ((me.mean - shift) / scale).astype(np.float32)[None, :]
    mu, inv_s, lpc = banded.prepare_emission_coefficients(
        ranks[None, :], models.pore_model)
    n_ev, n_km = np.array([ne], np.int32), np.array([nk], np.int32)
    tp, rp, best_e, _ = (np.asarray(x) for x in banded.banded_fill_jit(
        scaled, mu, inv_s, lpc, n_ev, n_km))
    res = _oracle(models, read)
    assert res.qc_pass     # the oracle keeps its alignment
    n_bands = ne + nk + 2
    tr, rg = banded.unpack_trace(tp, rp, n_bands)
    assert (rg[:, 0] == (np.diff(res.band_lower_left[:, 1]) == 1)[1:]).all()
    assert (tr[:, 0, :] != res.trace[2:n_bands]).mean() < 1e-3
    pairs = native.banded_backtrace(
        tp, rp, 0, n_bands, DNA_R10.banded.bandwidth, ne, nk,
        int(best_e[0]), me.mean,
        scaled[0], mu[0], inv_s[0], lpc[0],
        np.arange(nk, dtype=np.int64), ranks.astype(np.int64))[0]
    np.testing.assert_array_equal(pairs, res.event_alignment)


def test_sharded_fill_equals_single_device(batch, device_out):
    """The shard_map fill over the 8-device mesh (rows padded to 8) is
    bitwise the single-device fill."""
    from dnascent_tpu.parallel import compute
    reads, scaled, mu, inv_s, lpc, n_ev, n_km = batch
    pad = lambda x, v=0: np.concatenate(
        [x, np.full((8 - x.shape[0],) + x.shape[1:], v, x.dtype)])
    args = (pad(scaled), pad(mu), pad(inv_s, 1), pad(lpc, -np.inf),
            pad(n_ev), pad(n_km))
    mesh = compute.make_data_mesh(8)
    compute.set_compute_mesh(mesh)
    try:
        out = banded.banded_fill_sharded(
            mesh, *(compute.put_rows(a) for a in args))
    finally:
        compute.set_compute_mesh(None)
    tp, rp, best_e, best_s = (np.asarray(x) for x in out)
    B = scaled.shape[0]
    np.testing.assert_array_equal(tp[:, :B], device_out[0])
    np.testing.assert_array_equal(rp[:, :B], device_out[1])
    np.testing.assert_array_equal(best_e[:B], device_out[2])
    np.testing.assert_array_equal(best_s[:B], device_out[3])
