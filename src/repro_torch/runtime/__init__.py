"""Fault-tolerant runtime of the port (``runtime/fault_tolerance.py``)."""
