"""PyTorch/CUDA port of the ``repro`` COMtune system.

A second package beside the JAX reference (``src/repro``): the same split-LM
distributed-inference round, written against ``torch`` with hand-written
Hopper kernels where the reference used Pallas.  It imports neither ``jax``
nor any ``repro`` module.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``.
"""
