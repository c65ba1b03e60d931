"""Which implementation each device stage uses, by platform.

This is the one place that looks at the device.  Stages ask
:func:`routes` and never ``jax.default_backend()`` themselves.  The map is
explicit and never swaps the device or the route quietly:

* nothing falls back to the CPU: the platform is that of
  ``jax.devices()[0]``, whatever JAX was started with;
* no stage runs a Pallas kernel in interpret mode;
* a platform missing from the map gets the plain XLA route, with no
  hand-written kernels.

Stages that have a single implementation on every platform (Theil-Sen, the
Viterbi fill and backtrace, the GRU encoder and conv trunk, the HMM forward)
are plain JAX and do not appear here.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Routes:
    # "xla" (ops.banded.banded_fill) or "cuda" (ops.banded.banded_fill_cuda)
    banded_fill: str
    # keep the batch's reference sequences on the device as one flat rank
    # array that eventalign and the CNN index (else they are built per call
    # on the host)
    device_resident_ranks: bool
    # seeBreaks --fast draws its bootstrap grids with jax.random on the
    # device (else numpy on the host)
    device_bootstrap: bool


CPU = Routes(banded_fill="xla", device_resident_ranks=False,
             device_bootstrap=False)
GPU = Routes(banded_fill="cuda", device_resident_ranks=True,
             device_bootstrap=True)
PLAIN_XLA = Routes(banded_fill="xla", device_resident_ranks=True,
                   device_bootstrap=True)

_BY_PLATFORM = {"cpu": CPU, "gpu": GPU}


def current_platform() -> str:
    import jax
    return jax.devices()[0].platform


def routes(platform: str | None = None) -> Routes:
    """The routes for ``platform`` (default: the platform JAX runs on)."""
    return _BY_PLATFORM.get(platform or current_platform(), PLAIN_XLA)
