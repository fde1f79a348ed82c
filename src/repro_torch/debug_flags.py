"""The one place the port reads its environment flags (port of
``repro.debug_flags``).

Every read goes through :func:`flags`, which re-reads the environment
through one code path and hands back one immutable typed snapshot, so a
mid-process change (a test setting a flag, a script switching the tuner
on for one phase) is seen by every module or by none.

The prefix is ``RTORCH_``: the JAX package's linter rule RL008 flags any
direct read of a ``REPRO_*`` name outside ``repro.debug_flags``.

Flags:
  RTORCH_DEBUG=1          ``ContinuousEngine``'s per-step pool and mirror
                          checks, when the constructor is not told
  RTORCH_SANITIZE=1       the compile-count sanitizer counts kernel
                          library loads, tuner searches, planner cache
                          misses and new engine step variants
                          (``repro_torch.analysis.sanitize``)
  RTORCH_AUTOTUNE         launch-plan selection (``kernels/autotune.py``):
                          "" (default) uses a warm JSON cache when
                          RTORCH_AUTOTUNE_CACHE names a readable one, else
                          the fixed planners; "0" always the fixed
                          planners; "1" measures the candidates of a cold
                          shape class on the card and records the winner
  RTORCH_AUTOTUNE_CACHE   path of the tuner's JSON cache ("" = none:
                          measured winners stay in the process)

Two flags of the JAX package have no counterpart: ``REPRO_STRICT_KERNELS``
makes a kernel's fallback raise, and the port has no fallback to make
strict; ``REPRO_DEQUANT_IMPL`` switches the card to the plain versions,
which is the fallback the port does not have.
"""
from __future__ import annotations

import dataclasses
import os

PREFIX = "RTORCH_"


@dataclasses.dataclass(frozen=True)
class Flags:
    """Typed snapshot of the RTORCH_* environment flags."""

    debug: bool
    sanitize: bool
    autotune: str          # "", "0" or "1"
    autotune_cache: str    # cache file path ("" = none)


_ENV_KEYS = tuple(PREFIX + k for k in ("DEBUG", "SANITIZE", "AUTOTUNE",
                                       "AUTOTUNE_CACHE"))
_VALID_BOOL = ("", "0", "1")
_VALID_AUTOTUNE = ("", "0", "1")

# (raw values, parsed Flags): rebuilt only when the raw values change
_cache: tuple = (None, None)


def flags() -> Flags:
    """The current snapshot. Re-reads the environment on every call,
    memoized on the raw values so an unchanged environment returns the
    same object. Raises ValueError on a value a flag does not take."""
    global _cache
    raw = tuple(os.environ.get(k, "") for k in _ENV_KEYS)
    if raw != _cache[0]:
        for key, value in zip(_ENV_KEYS[:2], raw[:2]):
            if value not in _VALID_BOOL:
                raise ValueError(f"{key}={value!r}: expected one of "
                                 f"{_VALID_BOOL}")
        if raw[2] not in _VALID_AUTOTUNE:
            raise ValueError(f"{_ENV_KEYS[2]}={raw[2]!r}: expected one of "
                             f"{_VALID_AUTOTUNE}")
        _cache = (raw, Flags(debug=raw[0] == "1", sanitize=raw[1] == "1",
                             autotune=raw[2], autotune_cache=raw[3]))
    return _cache[1]


def debug_enabled() -> bool:
    return flags().debug


def sanitize_enabled() -> bool:
    return flags().sanitize
