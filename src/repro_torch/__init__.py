"""PyTorch/CUDA port of the Holon Streaming dataplane.

Mirrors the module layout of the JAX package ``repro`` (``core``,
``kernels``, ``streaming``, ``launch``, ``obs``) so each module has an
obvious counterpart.  Replica state carries a leading stacked-partition
dimension ``[S, ...]``: one GPU stands in for the ``data`` mesh of the JAX
package (``launch/mesh.py``).  The fold, top-k and gated delta-merge kernels
are CUDA C++ under ``csrc/``; a tensor on the CPU takes their plain PyTorch
versions in ``kernels/ref.py``.
"""
