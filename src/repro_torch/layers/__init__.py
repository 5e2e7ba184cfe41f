"""Layers of the lm family under the mixed-precision policy."""
