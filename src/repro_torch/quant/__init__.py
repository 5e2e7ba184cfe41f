"""Quantization: codecs, prepared storage and static calibration."""
