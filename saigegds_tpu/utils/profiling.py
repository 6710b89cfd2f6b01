"""Device introspection and profiling hooks.

The reference exposes a SIMD-dispatch introspection call (``SIMD()`` ->
``saige_simd_version``, R/saige_main.r:64, src/vectorization.cpp:33-94) and
brackets phases with wall-clock prints (R/saige_main.r:260-261).  The
equivalents here: a device/topology report and JAX profiler traces viewable
in TensorBoard/XProf.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator


def device_info() -> str:
    """Describe the compute backend (the ``SIMD()`` analog)."""
    import jax
    devs = jax.devices()
    d = devs[0]
    parts = [
        f"backend={d.platform}",
        f"devices={len(devs)}",
        f"kind={getattr(d, 'device_kind', '?')}",
        f"process_count={jax.process_count()}",
        f"x64={jax.config.jax_enable_x64}",
    ]
    return " ".join(parts)


@contextlib.contextmanager
def profile_trace(logdir: str) -> Iterator[None]:
    """Capture a JAX profiler trace (open with TensorBoard / xprof)."""
    import jax
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def phase_timer(label: str, verbose: bool = True) -> Iterator[None]:
    """Wall-clock phase bracket (the reference's date() prints)."""
    t0 = time.perf_counter()
    if verbose:
        print(f"[{label}] start")
    try:
        yield
    except BaseException:
        if verbose:
            print(f"[{label}] FAILED after {time.perf_counter() - t0:.2f}s")
        raise
    else:
        if verbose:
            print(f"[{label}] done in {time.perf_counter() - t0:.2f}s")
