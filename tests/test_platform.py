"""The platform module's routes, prep's dispatch on them, the compile-cache
location, and the flax-free detect path."""

import os
import subprocess
import sys

import numpy as np
import pytest

from dnascent_tpu import platform
from dnascent_tpu.ops import banded
from dnascent_tpu.parallel import compute
from dnascent_tpu.pipeline import prep
from dnascent_tpu.pipeline.source import SimulatedSource

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("name,fill,resident,bootstrap", [
    ("cpu", "xla", False, False),
    ("gpu", "cuda", True, True),
    ("rocm", "xla", True, True),      # unknown: plain XLA, no hand kernels
])
def test_routes_by_platform(name, fill, resident, bootstrap):
    r = platform.routes(name)
    assert (r.banded_fill, r.device_resident_ranks, r.device_bootstrap) == \
        (fill, resident, bootstrap)


def test_default_platform_is_the_first_device():
    # the conftest pins JAX to the CPU: no fallback, no guessing
    assert platform.current_platform() == "cpu"
    assert platform.routes() == platform.CPU


@pytest.fixture
def fill_spy(monkeypatch):
    """Records the fill route prep asks for and runs the XLA fill in its
    place (the CUDA kernel has no CPU implementation)."""
    calls = []
    real_jit, real_sharded = banded.banded_fill_jit, banded.banded_fill_sharded

    def jit(*a, impl, **kw):
        calls.append(("single", impl))
        return real_jit(*a, impl="xla", **kw)

    def sharded(mesh, *a, impl, **kw):
        calls.append(("sharded", impl))
        return real_sharded(mesh, *a, impl="xla", **kw)

    monkeypatch.setattr(banded, "banded_fill_jit", jit)
    monkeypatch.setattr(banded, "banded_fill_sharded", sharded)
    return calls


def _alignments(prepped):
    return {p.record.read_id: (p.qc_fail_reason, p.event_alignment,
                               round(p.shift, 9), round(p.scale, 9))
            for p in prepped}


@pytest.mark.parametrize("n_devices", [None, 8])
def test_prep_dispatch_on_gpu_platform(models, cfg, fill_spy, monkeypatch,
                                       n_devices):
    """On a (patched) gpu platform prep sends the fill to the CUDA route —
    per device under shard_map when a mesh is active — keeps the reference
    ranks device-resident, and backtraces on the host; its alignments
    equal the CPU route's."""
    recs = list(SimulatedSource(models, cfg, n_reads=3, length=1200, seed=4))
    want = _alignments(prep.prepare_reads(recs, models, cfg))
    assert [c[1] for c in fill_spy] == ["xla"]
    fill_spy.clear()
    monkeypatch.setattr(platform, "current_platform", lambda: "gpu")
    compute.set_compute_mesh(
        compute.make_data_mesh(n_devices) if n_devices else None)
    try:
        prepped = prep.prepare_reads(recs, models, cfg)
    finally:
        compute.set_compute_mesh(None)
    kind = "sharded" if n_devices else "single"
    assert fill_spy == [(kind, "cuda")]
    assert all(p.flat_ranks_device is not None for p in prepped if p.passed)
    got = _alignments(prepped)
    assert got.keys() == want.keys()
    for rid in want:
        assert got[rid][0] == want[rid][0]
        np.testing.assert_array_equal(got[rid][1], want[rid][1])
        assert got[rid][2:] == want[rid][2:]


def _cache_dir_in_child(env_extra):
    code = ("import jax, dnascent_tpu\n"
            "from dnascent_tpu.utils import jaxcache\n"
            "print(jax.config.jax_compilation_cache_dir)\n"
            "print(jaxcache.cache_dir())\n")
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(env_extra, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=_REPO, check=True)
    return r.stdout.split()


def test_compile_cache_honours_env(tmp_path):
    d = str(tmp_path / "cache")
    assert _cache_dir_in_child({"JAX_COMPILATION_CACHE_DIR": d}) == [d, d]


def test_compile_cache_default_is_fixed_path_in_checkout():
    want = os.path.join(_REPO, ".jax_cache")
    assert _cache_dir_in_child({}) == [want, want]


def test_detect_with_reference_model_imports_no_flax(tmp_path, models):
    """detect --model runs with flax made unimportable."""
    from dnascent_tpu.models import reference_cnn as rc
    from dnascent_tpu.testing.dataset import build_dataset
    from dnascent_tpu.testing.tf_bundle_writer import write_savedmodel_dir

    ds = build_dataset(str(tmp_path / "ds"), models, n_reads=2,
                       read_length=1200, signal_format="fast5", seed=8)
    model_dir = str(tmp_path / "model")
    write_savedmodel_dir(model_dir, rc.synthetic_tensors(1))
    out = str(tmp_path / "out.detect")
    code = ("import sys\nsys.modules['flax'] = None\n"
            "from dnascent_tpu import cli\n"
            "rc = cli.main(sys.argv[1:])\n"
            "assert 'flax' not in sys.modules or sys.modules['flax'] is None\n"
            "sys.exit(rc)\n")
    r = subprocess.run(
        [sys.executable, "-c", code, "detect", "-b", ds.bam, "-r",
         ds.reference_fa, "-i", ds.index, "-o", out, "-l", "1000",
         "--model", model_dir],
        capture_output=True, text=True, cwd=_REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [l for l in open(out) if l and l[0] not in "#>"]
    assert len(rows) > 100
    assert "#Compute CPU\n" in open(out).read()
