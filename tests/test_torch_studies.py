"""The port's studies, examples and tools against the reference's, on
the same inputs, on the CPU.

* Fig. 3 (``repro_torch.studies.fig3_error``, through
  ``repro_torch.core.ipu`` with ``device="cpu"``): every cell's raw
  accumulator bit-equal to ``benchmarks/fig3_error.py``'s (jax), every
  row ``==``, the claims ``==`` and all true.
* Table 1, Fig. 7, Fig. 9 and Fig. 10 (numpy models): every row ``==``
  and the emitted JSON byte-identical to the reference's; a few Fig. 8
  points ``==`` (the whole Fig. 8 sweep takes minutes).
* ``tools/calibrate_area``: the fitted vector within a relative 1e-9 of
  the reference's (the same scipy call on the same residuals gives the
  same floats; the bound only allows for a last-bit difference), and
  the printed report identical.
* ``examples/quickstart`` (``--device cpu``) and ``accelerator_study
  --arch qwen2-0.5b`` print exactly the reference scripts' text (each
  run in a subprocess); ``serve_lm``'s workload equals the reference's
  request by request; ``tools/trace_report`` prints the reference tool's
  text on a trace the port's traced engine writes.
* The copied ``core.exact_ref`` functions equal the reference's.

The reference's studies and examples run in subprocesses, started
before the port's side and waited for after it, so the two sides run
side by side.
"""
import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch import exp
from repro_torch.studies import (common, fig3_error, fig7_breakdown,
                                 fig8_perf, fig9_expdiff, fig10_tradeoff,
                                 table1)

from _torch_parity import one_intra_op_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUDIES = {"table1": table1, "fig7_breakdown": fig7_breakdown,
           "fig9_expdiff": fig9_expdiff, "fig10_tradeoff": fig10_tradeoff,
           "fig3_error": fig3_error}

# a few Fig. 8 points: backward at 12 bits on 8-input tiles, a forward
# cluster of 1, and the skip-empty ablation (fig10 covers resnet50_fwd)
FIG8_POINTS = (
    dict(case="resnet18_bwd", n_inputs=8, w=12, cluster=None,
         skip_empty=False),
    dict(case="resnet18_fwd", n_inputs=16, w=16, cluster=1,
         skip_empty=False),
    dict(case="resnet50_fwd", n_inputs=16, w=12, cluster=None,
         skip_empty=True),
)

CALIBRATE_REL = 1e-9

_REFERENCE_SCRIPT = r"""
import contextlib, io, json, sys
import numpy as np
from repro import exp
from benchmarks import (fig3_error, fig7_breakdown, fig8_perf,
                        fig9_expdiff, fig10_tradeoff, table1)
out, fig8_points = sys.argv[1], json.loads(sys.argv[2])
for mod in (table1, fig7_breakdown, fig9_expdiff, fig10_tradeoff,
            fig3_error):
    mod.run(verbose=False, engine=exp.EngineConfig(cache=None))
acc = []
for p in fig3_error.spec().points():
    kw = p.kwargs
    rng = np.random.default_rng([kw["seed"],
                                 fig3_error._DIST_IDS[kw["dist"]]])
    shape = (kw["samples"], kw["length"])
    a = np.asarray(fig3_error.draw(rng, kw["dist"], shape), np.float16)
    b = np.asarray(fig3_error.draw(rng, kw["dist"], shape), np.float16)
    cfg = fig3_error.IPUConfig(n=kw["n"], w=max(min(kw["w"], 28), 10),
                               accum=kw["accum"], sw_precision=kw["w"])
    acc.append(fig3_error.approx_value(a, b, cfg).tolist())
fig8 = [fig8_perf.eval_point(**kw) for kw in fig8_points]
import tools.calibrate_area as ca
fits = []
least_squares = ca.least_squares
def recording(*args, **kwargs):
    fits.append(least_squares(*args, **kwargs))
    return fits[-1]
ca.least_squares = recording
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    ca.main()
with open(out, "w") as f:
    json.dump({"fig3_acc": acc, "fig8": fig8,
               "calibrate_x": fits[0].x.tolist(),
               "calibrate_text": buf.getvalue()}, f)
"""

EXAMPLES = {
    "quickstart": (["examples/quickstart.py"],
                   ["-m", "repro_torch.examples.quickstart", "--device",
                    "cpu"]),
    "accelerator_study": (
        ["examples/accelerator_study.py", "--arch", "qwen2-0.5b"],
        ["-m", "repro_torch.examples.accelerator_study", "--arch",
         "qwen2-0.5b"]),
}


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (os.path.join(ROOT, "src"), env.get("PYTHONPATH")) if p)
    return env


def _popen(args, env, **kw):
    return subprocess.Popen([sys.executable] + args, cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, **kw)


def _port_side(bench_dir, monkeypatch):
    """The port's studies (emitting into ``bench_dir``), its Fig. 3
    accumulators, Fig. 8 points and calibration fit."""
    from repro_torch.tools import calibrate_area
    monkeypatch.setattr(common, "RESULTS_DIR", str(bench_dir))
    engine = exp.EngineConfig(cache=None, device="cpu")
    results = {name: mod.run(verbose=False, engine=engine)
               for name, mod in STUDIES.items()}
    acc = []
    for p in fig3_error.spec().points():
        kw = p.kwargs
        a, b = fig3_error.operands(kw["dist"], kw["length"], kw["samples"],
                                   kw["seed"])
        cfg = fig3_error.ipu_config(kw["accum"], kw["w"], kw["n"])
        acc.append(fig3_error.approx_value(a, b, cfg, "cpu"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        calibrate_area.main()
    return {"results": results, "fig3_acc": acc,
            "fig8": [fig8_perf.eval_point(**kw) for kw in FIG8_POINTS],
            "calibrate_x": calibrate_area.fit().x,
            "calibrate_text": buf.getvalue()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    ref_dir = tmp_path_factory.mktemp("ref_bench")
    port_dir = tmp_path_factory.mktemp("port_bench")
    out = ref_dir / "reference.json"
    env = dict(_env(), BENCH_OUT=str(ref_dir))
    procs = {"studies": _popen(["-c", _REFERENCE_SCRIPT, str(out),
                                json.dumps(FIG8_POINTS)], env)}
    for name, (ref_args, port_args) in EXAMPLES.items():
        procs[("ref", name)] = _popen(ref_args, env)
        procs[("port", name)] = _popen(port_args, env)
    try:
        with pytest.MonkeyPatch.context() as mp:
            port = _port_side(port_dir, mp)
        stdout = {}
        for key, proc in procs.items():
            stdout[key], err = proc.communicate(timeout=600)
            assert proc.returncode == 0, (key, err[-3000:])
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(out) as f:
        ref = json.load(f)
    return {"ref": ref, "port": port, "stdout": stdout,
            "ref_dir": ref_dir, "port_dir": port_dir}


def _emitted(runs, name):
    with open(runs["ref_dir"] / f"{name}.json") as f:
        ref = f.read()
    with open(runs["port_dir"] / f"{name}.json") as f:
        port = f.read()
    return ref, port


def _rows():
    """(study, row index) of every row each study emits, with its
    point's label as the test id."""
    cases = []
    for name, mod in STUDIES.items():
        for i, p in enumerate(mod.spec().points()):
            cases.append(pytest.param(name, i, id=f"{name}-{p.label()}"))
    return cases


@pytest.mark.parametrize("name,i", _rows())
def test_row_equals_the_reference(runs, name, i):
    ref, _ = _emitted(runs, name)
    want = json.loads(ref)["rows"][i]
    got = runs["port"]["results"][name]["rows"][i]
    assert got == want


@pytest.mark.parametrize("name", sorted(STUDIES))
def test_emitted_json_equals_the_reference(runs, name):
    ref, port = _emitted(runs, name)
    assert port == ref


@pytest.mark.parametrize("name", ("fig3_error", "fig9_expdiff"))
def test_claims_equal_the_reference_and_hold(runs, name):
    ref, _ = _emitted(runs, name)
    claims = runs["port"]["results"][name]["claims"]
    assert claims == json.loads(ref)["claims"]
    assert all(claims.values()), claims


def test_fig10_headline_equals_the_reference(runs):
    ref, _ = _emitted(runs, "fig10_tradeoff")
    got = runs["port"]["results"]["fig10_tradeoff"]
    assert got["headline"] == json.loads(ref)["headline"]
    assert got["NO-OPT"] == json.loads(ref)["NO-OPT"]


@pytest.mark.parametrize(
    "i", range(len(fig3_error.spec().points())),
    ids=[p.label() for p in fig3_error.spec().points()])
def test_fig3_accumulator_equals_the_reference(runs, i):
    """The raw accumulator in f64 (``approx_value``), every one of the
    cell's 400 inner products, bit for bit."""
    got = runs["port"]["fig3_acc"][i]
    want = np.asarray(runs["ref"]["fig3_acc"][i], np.float64)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("i", range(len(FIG8_POINTS)),
                         ids=[p["case"] for p in FIG8_POINTS])
def test_fig8_point_equals_the_reference(runs, i):
    assert runs["port"]["fig8"][i] == runs["ref"]["fig8"][i]


def test_calibrate_area_fit_equals_the_reference(runs):
    got = np.asarray(runs["port"]["calibrate_x"])
    want = np.asarray(runs["ref"]["calibrate_x"])
    assert got.shape == want.shape
    assert np.max(np.abs(got - want) / np.abs(want)) <= CALIBRATE_REL


def test_calibrate_area_prints_the_reference_report(runs):
    assert runs["port"]["calibrate_text"] == runs["ref"]["calibrate_text"]
    assert "# fitted Calibration:" in runs["port"]["calibrate_text"]


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_prints_the_reference_text(runs, name):
    port = runs["stdout"][("port", name)]
    assert port and port == runs["stdout"][("ref", name)]


def test_fig3_eval_point_takes_the_engine_device_not_a_param():
    (p,) = [p for p in fig3_error.spec().points()
            if p.kwargs["w"] == 16 and p.kwargs["dist"] == "normal"
            and p.kwargs["accum"] == "fp16"]
    assert "device" not in p.kwargs
    small = dict(p.kwargs, samples=8, length=16)
    assert fig3_error.eval_point(**small, device="cpu") \
        == fig3_error.eval_point(**small, device="cpu")


def test_results_go_to_the_ports_own_directory():
    env = {k: v for k, v in _env().items() if k != "BENCH_TORCH_OUT"}
    env["BENCH_OUT"] = "results/bench"
    out = subprocess.run(
        [sys.executable, "-c",
         "from repro_torch.studies import common; print(common.RESULTS_DIR)"],
        cwd=ROOT, env=env, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "results/bench_torch"


def test_run_harness_runs_one_study(capsys, tmp_path, monkeypatch):
    from benchmarks import fig9_expdiff as ref_fig9
    from repro import exp as ref_exp
    from repro_torch.studies import run
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path / "port"))
    run.main(["--only", "fig9_expdiff", "--no-cache", "--quiet-progress"])
    out = capsys.readouterr().out.splitlines()
    monkeypatch.setenv("BENCH_OUT", str(tmp_path / "ref"))
    import benchmarks.common as ref_common
    monkeypatch.setattr(ref_common, "RESULTS_DIR", str(tmp_path / "ref"))
    ref_fig9.run(engine=ref_exp.EngineConfig(cache=None))
    ref_out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["name,us_per_call,derived", "# --- fig9_expdiff ---"]
    assert out[2:2 + len(ref_out)] == ref_out
    assert out[-2].startswith("# engine total: 2 points, 0 cached, "
                              "2 executed")
    with pytest.raises(SystemExit, match="unknown study"):
        run.main(["--only", "serve_bench"])


# ---------------------------------------------------------- serve_lm

def _ref_serve_lm():
    spec = importlib.util.spec_from_file_location(
        "_ref_serve_lm", os.path.join(ROOT, "examples", "serve_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _request(r):
    return (r.rid, r.prompt.dtype.str, r.prompt.tolist(), r.max_new_tokens,
            r.sampling.temperature, r.tags, r.priority)


@pytest.mark.parametrize("arch_cfg", ("reduced", "full"))
@pytest.mark.parametrize("n,max_new,temperature", ((8, 12, 0.0),
                                                   (13, 5, 0.8)))
def test_serve_lm_workload_equals_the_reference(arch_cfg, n, max_new,
                                                temperature):
    from repro.configs import get_config as ref_get_config
    from repro.configs import reduced as ref_reduced
    from repro_torch.configs import get_config, reduced
    from repro_torch.examples import serve_lm
    make, ref_make = ((reduced, ref_reduced) if arch_cfg == "reduced"
                      else (get_config, ref_get_config))
    got = serve_lm._mixed_workload(make("qwen2-0.5b"), n, max_new,
                                   temperature=temperature)
    want = _ref_serve_lm()._mixed_workload(ref_make("qwen2-0.5b"), n,
                                           max_new, temperature=temperature)
    assert [_request(r) for r in got] == [_request(r) for r in want]


def test_serve_lm_keeps_the_reference_cli(capsys, monkeypatch):
    from repro_torch.examples import serve_lm
    flags = ("--policy", "--plan", "--replicas", "--strategy", "--requests",
             "--slots", "--max-new", "--decode-block", "--calibrate",
             "--temperature")
    monkeypatch.setattr(sys, "argv", ["serve_lm.py", "--help"])
    with pytest.raises(SystemExit):
        _ref_serve_lm().main()
    help_text = capsys.readouterr().out
    for flag in flags:
        assert flag in help_text
    args = serve_lm.parse_args(["--policy", "int8_serving", "--calibrate",
                                "--decode-block", "4", "--temperature",
                                "0.5", "--strategy", "least_loaded"])
    assert (args.policy, args.calibrate, args.decode_block, args.temperature,
            args.strategy, args.device) == ("int8_serving", True, 4, 0.5,
                                            "least_loaded", "cuda")
    assert (args.requests, args.slots, args.max_new) == (8, 4, 12)


def test_serve_lm_serves_every_request_on_the_cpu(capsys):
    from repro_torch.configs import reduced
    from repro_torch.examples import serve_lm
    cfg = reduced("qwen2-0.5b")
    args = serve_lm.parse_args(["--device", "cpu", "--requests", "5",
                                "--max-new", "3", "--calibrate",
                                "--decode-block", "2"])
    single = serve_lm.run_single(args, cfg)
    assert single["new_tokens"] == {rid: 3 for rid in range(5)}
    args = serve_lm.parse_args(["--device", "cpu", "--requests", "4",
                                "--max-new", "2", "--replicas",
                                "int8_serving,bf16"])
    fleet = serve_lm.run_router(args, cfg)
    assert fleet["new_tokens"] == {rid: 2 for rid in range(4)}
    out = capsys.readouterr().out
    assert "tok/s on cpu" in out and "calibrated" in out


# ------------------------------------------------------- trace_report

@pytest.fixture(scope="module")
def port_trace(tmp_path_factory):
    from repro_torch.configs import reduced
    from repro_torch.models import registry
    from repro_torch.serving import (EngineConfig, Request, SamplingParams,
                                     ServingEngine)
    cfg = reduced("qwen2-0.5b")
    api = registry.build(cfg)
    params = api.init(seed=0, device="cpu")
    eng = ServingEngine(cfg, api, params, config=EngineConfig(
        batch_slots=2, cache_len=64, decode_block=2, trace=True),
        device="cpu")
    rng = np.random.default_rng(3)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, cfg.vocab, 5 + 3 * rid, dtype=np.int32), max_new_tokens=3,
            sampling=SamplingParams()))
    eng.run_until_drained()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    return eng.dump_trace(str(path))


def _reports(path, *flags):
    from repro_torch.tools import trace_report
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = trace_report.main([path, *flags])
    ref = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "trace_report.py"),
         path, *flags], cwd=ROOT, env=_env(), capture_output=True, text=True)
    return (rc, buf.getvalue()), (ref.returncode, ref.stdout)


@pytest.mark.parametrize("flags", ((), ("--top", "2")), ids=("default",
                                                              "top2"))
def test_trace_report_prints_the_reference_text(port_trace, flags):
    port, ref = _reports(port_trace, *flags)
    assert port == ref
    rc, text = port
    assert rc == 0 and "tick phases:" in text and "request lanes (3):" \
        in text and "compile events" in text


def test_trace_report_refuses_what_the_reference_refuses(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"ph": "X", "name": 3}]}))
    port, ref = _reports(str(bad))
    assert port == ref and port[0] == 1 and "INVALID trace" in port[1]


# --------------------------------------------------------- exact_ref

def test_exact_ref_equals_the_reference():
    from repro.core import exact_ref as ref_exact
    from repro_torch.core import exact_ref
    rng = np.random.default_rng(5)
    vals = np.concatenate([
        rng.normal(0, 1, 200), rng.normal(0, 1e-6, 50),
        [0.0, -0.0, 6.1e-5, 5.96e-8, 65504.0, -1.0, 1.0 + 2 ** -8]])
    for v in vals:
        for fn in ("decompose_fp16", "fp16_value"):
            assert getattr(exact_ref, fn)(v) == getattr(ref_exact, fn)(v), \
                (fn, v)
    a = np.asarray(rng.normal(0, 1, 64), np.float16)
    b = np.asarray(rng.normal(0, 1, 64), np.float16)
    assert exact_ref.exact_dot(a, b) == ref_exact.exact_dot(a, b)
    with pytest.raises(ValueError, match="Inf/NaN"):
        exact_ref.decompose_fp16(np.inf)
