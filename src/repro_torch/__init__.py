"""PyTorch/CUDA port of the Norm-Tweaking serving stack (package ``repro``).

The JAX package ``repro`` stays the reference; this package re-implements
its serving path in PyTorch with hand-written CUDA kernels for the NVIDIA
H100 (``sm_90a``). It imports ``torch`` and numpy only — never ``jax`` and
never ``repro`` — and keeps ``repro``'s module layout so each module's
counterpart is easy to find.

Entry points (``models.transformer.init_lm``,
``core.quant.deploy.quantize_params_for_serving``,
``serve.engine.ContinuousEngine``) take ``device=`` and default to
``"cuda"``; they raise when CUDA is absent instead of dropping to the CPU.
Pass ``device="cpu"`` to run the kernels' plain PyTorch versions.
"""
