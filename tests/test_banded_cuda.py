"""The CUDA banded fill: its block body run on the CPU (tests/cuda_emu.cpp)
against the XLA scan, and its JAX wrapper's shapes and sharding.

The kernel itself needs a CUDA device; ``chip_smoke.py`` compiles it for the
card and compares it there with the same references."""

import ctypes
import dataclasses
import os
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dnascent_tpu.ops import banded

from test_banded_kernel import _prep_read

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("cuda_emu") / "cuda_emu.so")
    subprocess.run(
        ["g++", "-std=c++20", "-O2", "-ffp-contract=off", "-pthread",
         "-shared", "-fPIC", "-I", os.path.join(_REPO, "dnascent_tpu", "cuda"),
         os.path.join(_REPO, "tests", "cuda_emu.cpp"), "-o", out],
        check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    lib.banded_fill_emulated.restype = None
    lib.banded_fill_emulated.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2)
    return lib


def _emulated_fill(lib, scaled, mu, inv_s, lpc, n_ev, n_km, bandwidth=100,
                   epsilon_skip=1e-30, p_trim=0.01):
    B, E = scaled.shape
    K = mu.shape[1]
    S = (E + K + 3) // 4
    lp_stay, lp_step = (np.asarray(x) for x in banded._transition_logs(
        jnp.asarray(n_ev), jnp.asarray(n_km), epsilon_skip))
    trace = np.zeros((S, B, bandwidth), np.uint8)
    rights = np.zeros((S, B), np.uint8)
    best_e = np.zeros(B, np.int32)
    best_s = np.zeros(B, np.float32)
    c = lambda x, dt: np.ascontiguousarray(x, dtype=dt)
    arrs = [c(scaled, np.float32), c(mu, np.float32), c(inv_s, np.float32),
            c(lpc, np.float32), c(n_ev, np.int32), c(n_km, np.int32),
            c(lp_stay, np.float32), c(lp_step, np.float32)]
    ptr = lambda x: x.ctypes.data_as(ctypes.c_void_p)
    lib.banded_fill_emulated(
        *[ptr(x) for x in arrs], ptr(trace), ptr(rights), ptr(best_e),
        ptr(best_s), B, E, K, bandwidth, S,
        ctypes.c_float(np.float32(np.log(epsilon_skip))),
        ctypes.c_float(np.float32(np.log(p_trim))))
    return trace, rights, best_e, best_s


def _fitted(models, seed=3):
    """A per-k-mer-sigma table, like one written by trainGMM."""
    rng = np.random.default_rng(seed)
    pm = models.pore_model.copy()
    pm[:, 1] = rng.uniform(0.08, 0.3, pm.shape[0])
    return dataclasses.replace(models, pore_model=pm)


def _batch(pore, reads, pad_rows=0):
    B = len(reads) + pad_rows
    E = max(r[1].mean.shape[0] for r in reads)
    K = max(r[2].shape[0] for r in reads)
    scaled = np.zeros((B, E), np.float32)
    mu = np.zeros((B, K), np.float32)
    inv_s = np.ones((B, K), np.float32)
    lpc = np.full((B, K), -np.inf, np.float32)
    n_ev = np.zeros(B, np.int32)
    n_km = np.zeros(B, np.int32)
    for b, (sim, me, ranks, shift, scale) in enumerate(reads):
        ne, nk = me.mean.shape[0], ranks.shape[0]
        scaled[b, :ne] = (me.mean - shift) / scale
        m, i, l = banded.prepare_emission_coefficients(ranks[None, :], pore)
        mu[b, :nk], inv_s[b, :nk], lpc[b, :nk] = m[0], i[0], l[0]
        n_ev[b], n_km[b] = ne, nk
    return scaled, mu, inv_s, lpc, n_ev, n_km


def _assert_fill_equal(got, want):
    """Traces, rights and start events bit for bit; the start score to
    1e-6 relative: XLA may contract its final-row ``score + n * lp_trim``
    into one fused multiply-add, which the kernel does not."""
    for name, w, g in zip(("trace", "rights", "best_event"), want, got):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)


@pytest.mark.parametrize("kind", ["static_sigma", "fitted_sigma"])
def test_emulated_kernel_equals_xla_fill(emu, models, kind):
    """The kernel body reproduces the XLA scan for both pore-model kinds,
    with two padded (empty) rows in the batch."""
    pore = models.pore_model if kind == "static_sigma" else \
        _fitted(models).pore_model
    reads = [_prep_read(models, seed, ln)
             for seed, ln in [(21, 700), (22, 900)]]
    args = _batch(pore, reads, pad_rows=2)
    want = [np.asarray(x) for x in banded.banded_fill_jit(*args)]
    _assert_fill_equal(_emulated_fill(emu, *args), want)


def test_emulated_kernel_narrow_band(emu, models):
    """A bandwidth that is not a warp multiple (and below one warp)."""
    reads = [_prep_read(models, 23, 500)]
    args = _batch(models.pore_model, reads)
    kw = dict(bandwidth=20)
    want = [np.asarray(x) for x in banded.banded_fill_jit(*args, **kw)]
    _assert_fill_equal(_emulated_fill(emu, *args, **kw), want)


def _abstract_args(B, E, K):
    f = lambda *s: jax.ShapeDtypeStruct(s, jnp.float32)
    i = lambda *s: jax.ShapeDtypeStruct(s, jnp.int32)
    return f(B, E), f(B, K), f(B, K), f(B, K), i(B), i(B)


@pytest.mark.parametrize("B,E,K,W", [(3, 37, 41, 100), (32, 4096, 4096, 100),
                                     (1, 100, 50, 20)])
def test_cuda_wrapper_shapes_match_xla(monkeypatch, B, E, K, W):
    """The FFI call promises the XLA fill's output shapes and dtypes."""
    from dnascent_tpu import cuda
    monkeypatch.setattr(cuda, "ensure_registered", lambda: None)
    args = _abstract_args(B, E, K)
    want = jax.eval_shape(lambda *a: banded.banded_fill(*a, bandwidth=W),
                          *args)
    got = jax.eval_shape(lambda *a: banded.banded_fill_cuda(*a, bandwidth=W),
                         *args)
    assert [(x.shape, x.dtype) for x in got] == \
        [(x.shape, x.dtype) for x in want]


def test_cuda_sharded_wrapper_traces_per_shard(monkeypatch):
    """Under the 8-device mesh the CUDA fill runs per row shard (shard_map):
    the FFI call sees B/8 rows and the global outputs keep the XLA fill's
    shapes."""
    from dnascent_tpu import cuda
    from dnascent_tpu.parallel import compute
    monkeypatch.setattr(cuda, "ensure_registered", lambda: None)
    mesh = compute.make_data_mesh(8)
    args = _abstract_args(16, 300, 280)
    fn = banded._banded_fill_sharded_fn(mesh, 100, 1e-30, 0.01, "cuda")
    jaxpr = jax.make_jaxpr(fn)(*args)
    text = str(jaxpr)
    assert "dnascent_banded_fill" in text
    assert "f32[2,300]" in text           # one shard's events
    out = jax.eval_shape(fn, *args)
    assert out[0].shape == (145, 16, 100) and out[1].shape == (145, 16)


@pytest.mark.gpu
def test_cuda_fill_equals_xla_fill_on_device(gpu_device, models):
    """On a CUDA device the kernel's outputs equal the XLA scan's on the
    same card (chip_smoke.py runs this at B=32 x 10 kb)."""
    reads = [_prep_read(models, seed, ln)
             for seed, ln in [(41, 1500), (42, 1200), (43, 900)]]
    args = [jax.device_put(a, gpu_device)
            for a in _batch(models.pore_model, reads)]
    want = [np.asarray(x) for x in banded.banded_fill_jit(*args, impl="xla")]
    got = [np.asarray(x) for x in banded.banded_fill_jit(*args, impl="cuda")]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
