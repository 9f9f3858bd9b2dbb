"""llmrankers_tpu_torch: the PyTorch/CUDA port of llmrankers_tpu.

Same subpackage layout and module names as ``llmrankers_tpu``, which stays
the reference. The port imports ``torch`` and never ``jax``; the modules of
the reference that import no ``jax`` (``types``, ``algos``,
``models.config``, ``utils.native``, ``utils.metering``, ``data``) are
imported from it, not copied. Kernels are written by hand for Hopper
(``csrc/``) and built with nvcc at first use (``ops/_build.py``).
"""
