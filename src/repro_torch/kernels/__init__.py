"""CUDA kernels of the dataplane, their plain versions, build and dispatch."""
