"""llmrankers_tpu_torch: the PyTorch/CUDA port of llmrankers_tpu.

Same subpackage layout and module names as ``llmrankers_tpu``, which stays
the reference. The port imports ``torch`` and never ``jax``, and nothing of
``llmrankers_tpu``: the reference's host modules it needs (``types``,
``algos.scheduler``, ``algos.setwise_sort``, ``models.config``,
``utils.native``, ``utils.metering``, ``data.trec``, ``data.docstore``,
``engine.prefix``) and its Rank-R1 prompt packs (``prompts/``) are copied
here under the same paths. Kernels are written
by hand for Hopper (``csrc/``) and built with nvcc at first use
(``ops/_build.py``).
"""
