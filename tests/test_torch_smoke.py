"""The port's serving surfaces against the reference's, on the CPU:
``serving.metrics.slo_report``, ``obs.trace.validate_chrome_trace`` and
``python -m repro_torch.serving smoke``.

* ``slo_report`` and ``validate_chrome_trace`` give the reference's
  outputs on the inputs of ``tests/test_serving.py`` (``TestMetrics``)
  and ``tests/test_obs.py`` (``TestValidateChromeTrace``), and on a
  trace of the port's own ``Tracer``.
* The smoke, through ``__main__.main``, meets every contract of the
  reference's smoke on the CPU (``--device cpu``), with ``--trace``,
  and its trace passes both validators; ``--decode-block 1`` exits 2,
  as the reference's does; without CUDA and without ``--device cpu`` it
  raises.
"""
import json

import numpy as np
import pytest
import torch

from repro.obs import validate_chrome_trace as ref_validate
from repro.serving.engine import Request as RefRequest
from repro.serving.metrics import slo_report as ref_slo_report
from repro_torch.obs import Tracer, validate_chrome_trace
from repro_torch.serving import Request, slo_report
from repro_torch.serving.__main__ import main as cli
from repro_torch.serving.smoke import REQUEST_STAGES, TICK_PHASES


def _req(cls, rid, submit, first, finish, n_new):
    r = cls(rid=rid, prompt=np.zeros(2, np.int32))
    if first is not None:
        r.tokens = [0, 0] + [1] * n_new
    r.submit_time = submit
    r.first_token_time, r.finish_time = first, finish
    return r


# (submit, first token, finish, new tokens) per request; first None:
# a request that never produced a token
SLO_CASES = {
    "attain_and_miss": ([(0.0, 0.5, 2.0, 10), (0.0, 2.0, 4.0, 6),
                         (0.0, None, None, 0)], 1.0),
    "empty": ([], 1.0),
    "all_in_flight": ([(0.0, 0.5, None, 3)], 1.0),
    "none_attain": ([(1.0, 3.0, 5.0, 4), (2.0, 4.5, 6.0, 2)], 0.5),
    "mixed_finish": ([(0.0, 0.2, None, 5), (0.5, 0.9, 3.0, 7),
                      (1.0, 2.5, 4.0, 1)], 1.0),
}


@pytest.mark.parametrize("case", sorted(SLO_CASES))
def test_slo_report_equals_the_reference(case):
    rows, slo = SLO_CASES[case]
    got = slo_report([_req(Request, i, *r) for i, r in enumerate(rows)],
                     ttft_slo_s=slo)
    want = ref_slo_report([_req(RefRequest, i, *r)
                           for i, r in enumerate(rows)], ttft_slo_s=slo)
    assert got == want


def test_slo_report_values():
    """``tests/test_serving.py::TestMetrics::test_slo_report``'s numbers."""
    rows, slo = SLO_CASES["attain_and_miss"]
    rep = slo_report([_req(Request, i, *r) for i, r in enumerate(rows)],
                     ttft_slo_s=slo)
    assert rep["n"] == 2 and rep["completed"] == 2
    assert rep["attainment"] == pytest.approx(0.5)
    assert rep["goodput_tok_per_s"] == pytest.approx(10 / 4.0)


_EV = {"name": "a", "ph": "i", "ts": 0, "pid": 1, "tid": 0}
TRACE_CASES = {
    "object": {"traceEvents": [_EV]},
    "bare_list": [_EV],
    "not_a_trace": 42,
    "no_events": {"nope": []},
    "no_name": [{"ph": "i"}],
    "unknown_phase": [dict(_EV, ph="Z")],
    "span_without_dur": [dict(_EV, ph="X")],
    "negative_dur": [dict(_EV, ph="X", dur=-1)],
    "ts_not_a_number": [dict(_EV, ts="late")],
    "not_an_object": [_EV, "event"],
    "truncated": [{"ph": "Q"}] * 12,
}


@pytest.mark.parametrize("case", sorted(TRACE_CASES))
def test_validate_chrome_trace_equals_the_reference(case):
    data = TRACE_CASES[case]
    got = validate_chrome_trace(data)
    assert got == ref_validate(data)
    assert (got == []) == (case in ("object", "bare_list"))


def test_port_tracer_dump_validates(tmp_path):
    """A session of the port's ``Tracer`` (as ``tests/test_obs.py``
    records one) dumps a trace both validators accept."""
    t = iter(np.arange(0.5, 100, 0.5))
    tr = Tracer(clock=lambda: float(next(t)), enabled=True)
    with tr.span("admission"):
        pass
    tr.req_begin(7, "queued", args={"prompt_len": 3})
    with tr.span("block_dispatch", args={"n": 4}):
        pass
    tr.req_end(7, "queued")
    tr.req_instant(7, "first_token")
    tr.instant("tick_done")
    with open(tr.dump(str(tmp_path / "t.json"))) as f:
        data = json.load(f)
    assert data["traceEvents"]
    assert validate_chrome_trace(data) == ref_validate(data) == []


def test_smoke_meets_the_contract_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.serving smoke --device cpu --trace PATH``
    returns 0 (every contract assertion held) and its trace passes both
    validators with every tick phase and request stage in it."""
    path = str(tmp_path / "trace.json")
    assert cli(["smoke", "--device", "cpu", "--trace", path]) == 0
    assert "serving-smoke OK on cpu" in capsys.readouterr().out
    with open(path) as f:
        data = json.load(f)
    assert validate_chrome_trace(data) == ref_validate(data) == []
    names = {e["name"] for e in data["traceEvents"]}
    assert set(TICK_PHASES) | set(REQUEST_STAGES) <= names


def test_cli_usage_and_exit_codes(capsys):
    """The reference's usage and exit codes: no command 2, help 0, an
    unknown command 2, and ``--decode-block 1`` an argument error (2),
    in the reference's smoke too."""
    from repro.serving.__main__ import main as ref_cli
    assert cli([]) == ref_cli([]) == 2
    assert cli(["--help"]) == ref_cli(["--help"]) == 0
    assert cli(["bench"]) == ref_cli(["bench"]) == 2
    for main in (cli, ref_cli):
        with pytest.raises(SystemExit) as e:
            main(["smoke", "--decode-block", "1", "--device", "cpu"]
                 if main is cli else ["smoke", "--decode-block", "1"])
        assert e.value.code == 2
    assert "usage: python -m repro_torch.serving smoke" in \
        capsys.readouterr().out


def test_smoke_raises_without_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli(["smoke"])
