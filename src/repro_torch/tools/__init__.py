"""The port's tools (mirror of the reference's ``tools/``), each run as
``python -m repro_torch.tools.<name>``:

  * ``calibrate_area`` — fit the area/power calibration (scipy);
  * ``trace_report``   — summarize a serving engine's Chrome trace;
  * ``plan_report``    — render a precision plan as a markdown Pareto
    report.

``tools/fp_convert.py`` needs no port (a numpy converter the tests
import); ``mem_probe``, ``exchange_bench`` and ``roofline_table`` wait
for the fabric, the benchmarks and the training stack.
"""
