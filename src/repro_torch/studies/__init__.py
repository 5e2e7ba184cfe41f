"""The paper's studies on the port (mirror of the figure and table
scripts of the reference's ``benchmarks/``), each through
``repro_torch.exp``:

  * ``fig3_error``     — the approximate FP-IP's error against IPU
    precision, through ``repro_torch.core.ipu`` (on ``--device``);
  * ``table1``, ``fig7_breakdown``, ``fig8_perf``, ``fig9_expdiff``,
    ``fig10_tradeoff`` — the numpy simulator and area/power models;
  * ``run``            — all six, or ``--only NAME``.

Each runs as ``python -m repro_torch.studies.<name>`` with the
reference's flags and writes ``results/bench_torch/<name>.json``
(``$BENCH_TORCH_OUT`` overrides the directory), never the reference's
``results/bench/``.
"""
