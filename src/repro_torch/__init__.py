"""PyTorch + CUDA port of the `repro` KWS system, for NVIDIA H100.

Same module layout as `repro` (``core``, ``kernels``, ``serving``), so
each module's counterpart is easy to find. The port imports torch, numpy
and the standard library only, never JAX or `repro`; the JAX package
stays the reference its tests hold the port against. Entry points run on
the card unless the caller names another device (``device="cpu"``).
"""
