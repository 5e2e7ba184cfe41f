"""The port's tools (mirror of the reference's ``tools/``), each run as
``python -m repro_torch.tools.<name>``:

  * ``calibrate_area`` — fit the area/power calibration (scipy);
  * ``trace_report``   — summarize a serving engine's Chrome trace.

``tools/fp_convert.py`` needs no port (a numpy converter the tests
import); ``plan_report``, ``mem_probe``, ``exchange_bench`` and
``roofline_table`` wait for the planner's search and the training
stack.
"""
