"""Hand-written Hopper kernels, their wrappers and plain versions.

Nothing here imports the CUDA loader at import time; the first launch
builds the sources (``kernels._build``).
"""
