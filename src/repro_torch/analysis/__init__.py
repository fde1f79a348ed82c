"""Runtime checks of the port (port of ``repro.analysis``'s sanitizer half).

* :mod:`repro_torch.analysis.sanitize`: the compile-count sanitizer. With
  ``RTORCH_SANITIZE=1`` each compile-like event of the port (a kernel
  library built or loaded, a cold tuner search, a planner cache miss, a
  new shape-bucket variant at an engine step entry point) is counted per
  key; a seeded traffic replay run twice must add none the second time.

The JAX package's linter (``repro.analysis.lint``) already lints all of
``src/``, the port included, so it has no counterpart here; its rules
RL002-RL007 are about jit, donation, ``pallas_call`` and PartitionSpecs,
which the port does not have.
"""
