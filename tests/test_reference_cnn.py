"""Reference detect-CNN topology: manifest census, weight import through a
fabricated SavedModel bundle, and the detect CLI's --model path."""

import json
import os

import numpy as np
import jax.numpy as jnp
import pytest

from dnascent_tpu.models import reference_cnn as rc


def test_topology_matches_manifest_census():
    """The reconstruction instantiates exactly the manifest's tensor
    inventory: every tensor has a home with the recorded shape."""
    man = json.load(open(os.path.join(
        os.path.dirname(rc.__file__), "reference_cnn_manifest.json")))
    tensors = rc.synthetic_tensors(0)
    assert len(tensors) == man["n_tensors"] == 268
    # shapes agree with the manifest, name by name
    for name, spec in man["tensors"].items():
        if name.startswith("trainable_variables/"):
            key = f"trainable{int(name.split('/')[1])}"
        else:
            layer, part = name.split("/")[:2]
            key = f"layer{int(layer.split('-')[1])}/{part}"
        assert key in tensors, key
        assert list(tensors[key].shape) == spec["shape"], key
    # and the params tree consumes every tensor
    params = rc.params_from_tensors(tensors)
    n_leaves = sum(len(v) for v in params.values())
    assert n_leaves == 268


def test_forward_shapes_and_probabilities():
    m = rc.create_model()
    params = rc.params_from_tensors(rc.synthetic_tensors(1))
    rng = np.random.default_rng(0)
    B, L = 2, 64
    core = rng.integers(1, 1025, size=(B, L)).astype(np.int32)
    resid = rng.integers(1, 257, size=(B, L)).astype(np.int32)
    sig = rng.normal(0, 1, size=(B, L, rc.RAWDEPTH)).astype(np.float32)
    sig[:, :, 10:] = 0.0
    out = np.asarray(m.apply(params, jnp.asarray(core), jnp.asarray(resid),
                             jnp.asarray(sig)))
    assert out.shape == (B, L, 3)
    np.testing.assert_allclose(out.sum(-1), 1.0, atol=1e-5)
    assert (out > 0).all()
    assert m.receptive_field() == 249


def test_gru_masking_semantics():
    """Zero-padded samples leave the GRU state unchanged (Keras Masking)."""
    params = rc.params_from_tensors(rc.synthetic_tensors(2))
    rng = np.random.default_rng(1)
    x = rng.normal(1.0, 0.5, size=(5, rc.RAWDEPTH)).astype(np.float32)
    x[:, 8:] = 0.0
    h_full = np.asarray(rc._gru_scan(jnp.asarray(x), jnp.asarray(x != 0),
                                     params["gru0"], params["gru1"]))
    short = x[:, :8]
    h_short = np.asarray(rc._gru_scan(jnp.asarray(short),
                                      jnp.asarray(short != 0),
                                      params["gru0"], params["gru1"]))
    np.testing.assert_array_equal(h_full, h_short)


def test_u8_forward_masks_the_zero_straddling_code_consistently():
    """apply() on quantised u8 windows equals apply() on the same windows
    dequantised by the same XLA ops — including the u8 codes around the one
    whose dequant lands on 0.0, which the GRU masks as padding (Keras
    Masking ``!= 0.0``) exactly when the device-computed value is 0.0."""
    from dnascent_tpu.models.cnn import SIG_QUANT_SCALE, SIG_QUANT_LO

    q = jnp.arange(256, dtype=jnp.float32)
    deq = np.asarray(jnp.where(q == 0.0, 0.0,
                               (q - 1.0) / SIG_QUANT_SCALE + SIG_QUANT_LO))
    straddle = int(np.argmin(np.abs(deq[1:]))) + 1
    assert abs(deq[straddle]) < 1e-5
    params = rc.params_from_tensors(rc.synthetic_tensors(0))
    rng = np.random.default_rng(5)
    B, L = 2, 32
    xq = rng.integers(1, 256, (B, L, rc.RAWDEPTH)).astype(np.uint8)
    xq[:, ::3, 5] = straddle
    xq[:, 1::3, 7] = straddle - 1
    xq[:, 2::3, 9] = straddle + 1
    xq[:, :, 15:] = 0     # padded tails
    core = jnp.asarray(rng.integers(1, 1025, (B, L)).astype(np.int32))
    resid = jnp.asarray(rng.integers(1, 257, (B, L)).astype(np.int32))
    model = rc.create_model()
    from_u8 = np.asarray(model.apply(params, core, resid, jnp.asarray(xq)))
    from_f32 = np.asarray(model.apply(params, core, resid,
                                      jnp.asarray(deq[xq])))
    np.testing.assert_array_equal(from_u8, from_f32)
    # the GRU itself: the straddling samples are carried through exactly
    # when their dequant is 0.0
    flat = deq[xq].reshape(B * L, rc.RAWDEPTH)
    h = np.asarray(rc._gru_scan(jnp.asarray(flat), jnp.asarray(flat != 0.0),
                                params["gru0"], params["gru1"]))
    assert np.isfinite(h).all()


def test_savedmodel_bundle_roundtrip(tmp_path):
    """Fabricated SavedModel dir -> architecture check -> tensor load ->
    forward (writer and reader are independent implementations of the TF
    bundle format, so this guards both against drift)."""
    from dnascent_tpu.models import cnn_import
    from dnascent_tpu.testing.tf_bundle_writer import write_savedmodel_dir

    tensors = rc.synthetic_tensors(3)
    model_dir = str(tmp_path / "detect_model")
    write_savedmodel_dir(model_dir, tensors)
    assert cnn_import.check_savedmodel_architecture(model_dir) == []
    loaded = cnn_import.load_savedmodel_tensors(model_dir)
    assert set(loaded) == set(tensors)
    for k in tensors:
        np.testing.assert_array_equal(loaded[k], tensors[k])
    model, params = rc.load_savedmodel(model_dir)
    out = np.asarray(model.apply(
        params, jnp.zeros((1, 32), jnp.int32), jnp.zeros((1, 32), jnp.int32),
        jnp.zeros((1, 32, rc.RAWDEPTH), jnp.float32)))
    assert out.shape == (1, 32, 3)


def test_savedmodel_architecture_mismatch_detected(tmp_path):
    from dnascent_tpu.models import cnn_import
    from dnascent_tpu.testing.tf_bundle_writer import write_savedmodel_dir

    tensors = rc.synthetic_tensors(4)
    tensors["layer2/kernel"] = tensors["layer2/kernel"][:, :32, :]
    model_dir = str(tmp_path / "bad_model")
    write_savedmodel_dir(model_dir, tensors)
    problems = cnn_import.check_savedmodel_architecture(model_dir)
    assert any("layer_with_weights-2/kernel" in p for p in problems)
    with pytest.raises(ValueError):
        rc.load_savedmodel(model_dir)


def test_cli_detect_with_reference_model(tmp_path, models):
    """detect --model <savedmodel-dir> runs the reference topology end to
    end over the synthetic dataset."""
    from dnascent_tpu import cli
    from dnascent_tpu.testing.dataset import build_dataset
    from dnascent_tpu.testing.tf_bundle_writer import write_savedmodel_dir

    ds = build_dataset(str(tmp_path / "ds"), models, n_reads=2,
                       read_length=1200, signal_format="fast5", seed=21)
    model_dir = str(tmp_path / "detect_model")
    write_savedmodel_dir(model_dir, rc.synthetic_tensors(5))
    out = str(tmp_path / "ref.detect")
    rc_code = cli.main(["detect", "-b", ds.bam, "-r", ds.reference_fa,
                        "-i", ds.index, "-o", out, "-l", "1000",
                        "--model", model_dir])
    assert rc_code == 0
    text = open(out).read()
    rows = [l for l in text.splitlines() if l and l[0] not in "#>"]
    assert len(rows) > 200
    for r in rows[:20]:
        cols = r.split("\t")
        assert len(cols) == 4
        assert 0.0 <= float(cols[1]) <= 1.0 and 0.0 <= float(cols[2]) <= 1.0
