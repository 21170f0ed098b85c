"""Hand-written Pallas kernels (Triton route) and the one place that decides
how they are built."""

from __future__ import annotations

import jax


def interpret_mode(platform: str | None = None) -> bool:
    """Whether a Pallas kernel runs in interpret mode on ``platform``
    (default: JAX's default backend).

    * ``cpu``: interpret — the kernel's jaxpr runs as ordinary XLA ops,
      which is how the tests exercise it;
    * ``gpu``: compiled through Triton;
    * anything else has no kernel build and raises.
    """
    platform = platform or jax.default_backend()
    if platform == "cpu":
        return True
    if platform == "gpu":
        return False
    raise RuntimeError(
        f"no Pallas kernel build for platform {platform!r} "
        "(supported: gpu through Triton, cpu in interpret mode)"
    )
