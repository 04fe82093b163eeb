"""The benchmark's frozen copy of the program's Nexmark generator."""
