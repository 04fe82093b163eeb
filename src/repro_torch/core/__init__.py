"""Lattices, window assigners, CRDTs and Windowed CRDTs on stacked replicas."""
