"""Precision policy (the paper-numerics modules are a later slice)."""
