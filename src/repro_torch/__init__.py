"""PyTorch/CUDA port of the TRACE reproduction.

A package of its own beside the JAX reference ``repro``: the same module
layout (``configs``, ``core``, ``kernels``, ``models``, ``runtime``,
``launch``), PyTorch on the host and hand-written CUDA kernels for
NVIDIA Hopper (``csrc/``) where the reference wrote Pallas kernels.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
