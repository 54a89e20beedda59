"""PyTorch/CUDA port of the DAK direct-access offloading system.

Laid out like ``repro`` (the JAX reference): ``configs``, ``core``,
``models``, ``kernels`` (hand-written Hopper kernels under
``kernels/csrc``), ``frontend``, ``runtime``, ``serving`` and ``launch``.
It imports nothing of ``repro`` or JAX.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""
