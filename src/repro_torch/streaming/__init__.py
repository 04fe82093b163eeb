"""Nexmark event model, device-side log generator and the global-aggregation queries."""
