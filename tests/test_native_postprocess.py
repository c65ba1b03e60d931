"""Native C++ window post-processing vs the numpy oracle path."""

import numpy as np
import pytest

from dnascent_tpu import native
from dnascent_tpu.config import DNA_R10
from dnascent_tpu.pipeline.eventalign import run_eventalign
from dnascent_tpu.pipeline.prep import prepare_reads
from dnascent_tpu.pipeline.source import SimulatedSource


@pytest.mark.skipif(not native.available(), reason="native lib unavailable")
def test_native_matches_numpy_postprocess(models, monkeypatch):
    cfg = DNA_R10
    records = list(SimulatedSource(models, cfg, n_reads=4, length=3000,
                                   seed=99))
    prepped = prepare_reads(records, models, cfg)

    res_native = run_eventalign(prepped, models, cfg)
    monkeypatch.setattr(native, "available", lambda: False)
    res_numpy = run_eventalign(prepped, models, cfg)

    for rid, rn in res_native.items():
        rp = res_numpy[rid]
        assert rn.qc_passed == rp.qc_passed
        if not rn.qc_passed:
            continue
        a, b = rn.positions, rp.positions
        np.testing.assert_array_equal(a.coord, b.coord)
        np.testing.assert_array_equal(a.kmer_start, b.kmer_start)
        np.testing.assert_array_equal(a.query_idx, b.query_idx)
        np.testing.assert_array_equal(a.ref_idx, b.ref_idx)
        np.testing.assert_array_equal(a.core_idx, b.core_idx)
        np.testing.assert_array_equal(a.residual_idx, b.residual_idx)
        np.testing.assert_array_equal(a.n_signals, b.n_signals)
        np.testing.assert_array_equal(a.center_is_T, b.center_is_T)
        np.testing.assert_array_equal(a.indel_score, b.indel_score)
        np.testing.assert_array_equal(a.signal_u8_flat, b.signal_u8_flat)
        np.testing.assert_array_equal(a.signal_counts, b.signal_counts)
        np.testing.assert_allclose(a.signal, b.signal, rtol=0, atol=0)
