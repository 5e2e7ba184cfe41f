"""The port's tools (mirror of the reference's ``tools/``), each run as
``python -m repro_torch.tools.<name>``:

  * ``calibrate_area`` — fit the area/power calibration (scipy);
  * ``trace_report``   — summarize a serving engine's Chrome trace;
  * ``plan_report``    — render a precision plan as a markdown Pareto
    report;
  * ``exchange_bench`` — the cross-pod gradient exchange's wire bytes
    on a fake 512-rank world;
  * ``mem_probe``      — bisect the train step's per-device memory
    through the dry-run;
  * ``roofline_table`` — render the dry-run's records as roofline
    tables.

``tools/fp_convert.py`` needs no port (a numpy converter the tests
import).
"""
