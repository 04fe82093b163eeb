"""Collectives over the stacked partition dimension and the production dataplane."""
