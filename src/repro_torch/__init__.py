"""PyTorch/CUDA port of the Holon Streaming dataplane.

Mirrors the module layout of the JAX package ``repro`` (``core``,
``kernels``, ``streaming``, ``launch``, ``obs``) so each module has an
obvious counterpart.  Replica state carries a leading stacked-partition
dimension ``[S, ...]``: one GPU stands in for the ``data`` mesh of the JAX
package (``launch/mesh.py``).  The five kernels (the windowed fold, the
sorted segment reduce, top-k, the gated delta merge and the replica-stack
join) are CUDA C++ under ``csrc/``; a tensor on the CPU takes their plain
PyTorch versions in ``kernels/ref.py``.
"""
