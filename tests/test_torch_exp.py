"""The port's sweep engine (``repro_torch.exp``) against the reference's
(``repro.exp``), on the CPU.

* The unit tests of ``tests/test_exp_engine.py``, mirrored: expansion
  order, zip, filters, encode, key stability across processes, salt and
  module invalidation, corrupt entries, warm runs that execute zero
  points, serial against parallel byte-identical, partial failure
  caching and bad references.
* Across the packages: every study's spec gives the same points, in the
  same order, with the same encoding of every primitive parameter as
  the reference's; dataclass tags name each package's own classes; the
  two packages' keys never address each other's entries.
* The device: an eval function that takes ``device`` gets the engine's,
  in the parent and in spawned workers; the device is in no point, key
  or row; without CUDA the default raises instead of falling back.
* ``python -m repro_torch.exp.smoke`` passes, and the code-version salt
  never imports a model.
"""
import json
import subprocess
import sys

import pytest
import torch

from repro import exp as ref_exp
from repro.exp.sweep import encode as ref_encode
from repro_torch import exp
from repro_torch.exp.sweep import encode

from _torch_parity import one_intra_op_thread  # noqa: F401


SQUARE = "repro_torch.exp.smoke:square"


# ------------------------------------------------------------- expansion

class TestSweepExpansion:
    def test_cartesian_order_last_axis_fastest(self):
        spec = exp.SweepSpec("s", SQUARE, axes={"a": [1, 2], "b": [10, 20]})
        combos = [p.kwargs for p in spec.points()]
        assert combos == [{"a": 1, "b": 10}, {"a": 1, "b": 20},
                          {"a": 2, "b": 10}, {"a": 2, "b": 20}]

    def test_zip_mode(self):
        spec = exp.SweepSpec("s", SQUARE, axes={"a": [1, 2, 3],
                                                "b": [4, 5, 6]},
                             mode="zip")
        combos = [p.kwargs for p in spec.points()]
        assert combos == [{"a": 1, "b": 4}, {"a": 2, "b": 5},
                          {"a": 3, "b": 6}]

    def test_zip_length_mismatch_rejected(self):
        with pytest.raises(ValueError, match="zip axes"):
            exp.SweepSpec("s", SQUARE, axes={"a": [1, 2], "b": [1]},
                          mode="zip")

    def test_filters_drop_points(self):
        spec = exp.SweepSpec(
            "s", SQUARE, axes={"a": [1, 2, 3], "b": [1, 2, 3]},
            filters=[lambda p: p["a"] < p["b"]])
        combos = [(p.kwargs["a"], p.kwargs["b"]) for p in spec.points()]
        assert combos == [(1, 2), (1, 3), (2, 3)]

    def test_fixed_params_on_every_point(self):
        spec = exp.SweepSpec("s", SQUARE, axes={"a": [1]},
                             fixed={"b": "x"})
        assert spec.points()[0].kwargs == {"a": 1, "b": "x"}

    def test_swept_and_fixed_overlap_rejected(self):
        with pytest.raises(ValueError, match="both swept and fixed"):
            exp.SweepSpec("s", SQUARE, axes={"a": [1]}, fixed={"a": 2})

    def test_unencodable_axis_value_rejected_eagerly(self):
        spec = exp.SweepSpec("s", SQUARE, axes={"a": [object()]})
        with pytest.raises(TypeError, match="canonically encode"):
            spec.points()

    def test_tensor_axis_value_rejected_eagerly(self):
        spec = exp.SweepSpec("s", SQUARE, axes={"a": [torch.ones(2)]})
        with pytest.raises(TypeError, match="canonically encode"):
            spec.points()

    def test_encode_distinguishes_types(self):
        assert encode(True) != encode(1)
        assert encode((1, 2)) != encode([1, 2])
        assert encode(1.0) != encode(1)

    def test_encode_distinguishes_mapping_key_types(self):
        assert encode({1: "v"}) != encode({"1": "v"})
        assert encode({True: "v"}) != encode({1: "v"})
        # mixed key types still sort deterministically
        assert encode({1: "a", "x": "b"}) == encode({"x": "b", 1: "a"})

    def test_encode_normalizes_numpy_scalars(self):
        import numpy as np
        assert encode(np.float64(1.5)) == encode(1.5)
        assert encode(np.int64(3)) == encode(3)
        assert encode(np.bool_(True)) == encode(True)

    def test_encode_frozen_dataclass(self):
        from repro_torch.core.simulator import TileConfig
        a = encode(TileConfig())
        b = encode(TileConfig(adder_w=16))
        assert a != b
        assert a == encode(TileConfig())


# ----------------------------------------------------------------- cache

def _point(**params):
    spec = exp.SweepSpec("s", SQUARE,
                         axes={k: [v] for k, v in params.items()})
    return spec.points()[0]


class TestCache:
    def test_key_stable_across_processes(self):
        p = _point(x=3)
        here = exp.point_key(p, salt="fixed")
        prog = (
            "from repro_torch import exp\n"
            "from repro_torch.exp.sweep import ExperimentPoint\n"
            "p = ExperimentPoint(%r, (('x', 3),))\n"
            "print(exp.point_key(p, salt='fixed'))\n" % SQUARE)
        out = subprocess.run([sys.executable, "-c", prog],
                             capture_output=True, text=True, check=True)
        assert out.stdout.strip() == here

    def test_key_independent_of_param_order(self):
        a = exp.ExperimentPoint(SQUARE, (("x", 1), ("y", 2)))
        b = exp.ExperimentPoint(SQUARE, (("y", 2), ("x", 1)))
        assert exp.point_key(a, "s") == exp.point_key(b, "s")

    def test_key_changes_with_salt_fn_and_params(self):
        p = _point(x=3)
        base = exp.point_key(p, salt="a")
        assert exp.point_key(p, salt="b") != base
        assert exp.point_key(_point(x=4), salt="a") != base
        q = exp.ExperimentPoint("other.mod:fn", p.params)
        assert exp.point_key(q, salt="a") != base

    def test_roundtrip_and_salt_invalidation(self, tmp_path):
        cache = exp.ResultCache(str(tmp_path), salt="v1")
        p = _point(x=5)
        assert cache.get(p) == (False, None)
        cache.put(p, {"v": 25})
        assert cache.get(p) == (True, {"v": 25})
        # bumping the code-version salt orphans the old entry
        stale = exp.ResultCache(str(tmp_path), salt="v2")
        assert stale.get(p) == (False, None)

    def test_corrupt_entry_is_a_miss(self, tmp_path):
        cache = exp.ResultCache(str(tmp_path), salt="v1")
        p = _point(x=5)
        cache.put(p, 25)
        path = cache._path(exp.point_key(p, "v1"))
        with open(path, "w") as f:
            f.write("{not json")
        assert cache.get(p) == (False, None)

    def test_default_salt_is_deterministic(self):
        assert exp.code_salt() == exp.code_salt()
        assert len(exp.code_salt()) == 16

    def test_eval_module_edit_invalidates_key(self, tmp_path, monkeypatch):
        from repro_torch.exp import cache as cache_mod
        mod = tmp_path / "exp_torch_tmp_eval_mod.py"
        mod.write_text("def f(x):\n    return x\n")
        monkeypatch.syspath_prepend(str(tmp_path))
        p = exp.ExperimentPoint("exp_torch_tmp_eval_mod:f", (("x", 1),))
        cache_mod._module_salt.cache_clear()
        k1 = exp.point_key(p, salt="s")
        mod.write_text("def f(x):\n    return x + 1\n")
        cache_mod._module_salt.cache_clear()
        assert exp.point_key(p, salt="s") != k1

    def test_salt_hashes_the_port_packages(self):
        from repro_torch.exp import cache as cache_mod
        assert cache_mod._SALT_PACKAGES == (
            "repro_torch.core", "repro_torch.exp", "repro_torch.autotune")

    def test_salt_imports_no_model(self):
        """``repro_torch.autotune`` feeds the salt; hashing it imports
        the plan module but never the model stack."""
        prog = ("import sys\n"
                "from repro_torch.exp import code_salt\n"
                "code_salt()\n"
                "bad = sorted(n for n in sys.modules if n.startswith(\n"
                "    ('repro_torch.models', 'repro_torch.layers',\n"
                "     'repro_torch.serving', 'jax', 'repro.')))\n"
                "assert not bad, bad\n"
                "print('ok')\n")
        out = subprocess.run([sys.executable, "-c", prog],
                             capture_output=True, text=True)
        assert out.returncode == 0, out.stderr
        assert out.stdout.strip() == "ok"


# ---------------------------------------------------------------- runner

def _spec(n=6):
    return exp.SweepSpec("sq", SQUARE, axes={"x": list(range(n))})


class TestRunner:
    def test_inline_run_and_counters(self, tmp_path):
        eng = exp.EngineConfig(jobs=1, cache=exp.ResultCache(str(tmp_path)))
        res, rep = exp.run_sweep(_spec(), eng)
        assert [v for _, v in res] == [0, 1, 4, 9, 16, 25]
        assert (rep.n_points, rep.n_cached, rep.n_executed) == (6, 0, 6)

    def test_warm_cache_executes_zero(self, tmp_path):
        cache = exp.ResultCache(str(tmp_path))
        exp.run_sweep(_spec(), exp.EngineConfig(cache=cache))
        res, rep = exp.run_sweep(_spec(), exp.EngineConfig(cache=cache))
        assert rep.n_executed == 0
        assert rep.n_cached == 6
        assert [v for _, v in res] == [0, 1, 4, 9, 16, 25]

    def test_partial_cache_executes_only_misses(self, tmp_path):
        cache = exp.ResultCache(str(tmp_path))
        exp.run_sweep(_spec(3), exp.EngineConfig(cache=cache))
        _, rep = exp.run_sweep(_spec(6), exp.EngineConfig(cache=cache))
        assert (rep.n_cached, rep.n_executed) == (3, 3)

    def test_no_cache_mode(self, tmp_path):
        eng = exp.EngineConfig(cache=None)
        _, rep = exp.run_sweep(_spec(), eng)
        assert rep.n_executed == 6

    @pytest.mark.parametrize("jobs", [2, 4])
    def test_parallel_matches_serial_byte_identical(self, jobs):
        spec = exp.SweepSpec(
            "smoke", "repro_torch.exp.smoke:eval_point",
            axes={"w": [12, 16], "cluster": [1, 4]},
            fixed={"seed": 0, "source": "forward"})
        serial, _ = exp.run_sweep(spec, exp.EngineConfig(jobs=1, cache=None))
        par, rep = exp.run_sweep(spec, exp.EngineConfig(jobs=jobs,
                                                        cache=None))
        assert rep.n_executed == len(spec.points())
        s = json.dumps(exp.rows_from(serial, "smoke"), sort_keys=True)
        p = json.dumps(exp.rows_from(par, "smoke"), sort_keys=True)
        assert s == p

    def test_parallel_fills_cache_for_serial_rerun(self, tmp_path):
        cache = exp.ResultCache(str(tmp_path))
        spec = _spec()
        _, rep1 = exp.run_sweep(spec, exp.EngineConfig(jobs=3, cache=cache))
        assert rep1.n_executed == 6
        _, rep2 = exp.run_sweep(spec, exp.EngineConfig(jobs=1, cache=cache))
        assert rep2.n_executed == 0

    def test_total_report_accumulates(self, tmp_path):
        eng = exp.EngineConfig(cache=exp.ResultCache(str(tmp_path)))
        exp.run_sweep(_spec(3), eng)
        exp.run_sweep(_spec(6), eng)
        assert eng.total.n_points == 9
        assert eng.total.n_executed == 6
        assert eng.total.n_cached == 3

    def test_parallel_failure_caches_completed_points(self, tmp_path):
        cache = exp.ResultCache(str(tmp_path))
        spec = exp.SweepSpec("mixed", "repro_torch.exp.smoke:square_or_raise",
                             axes={"x": [1, 2, -1, 3]})
        with pytest.raises(ValueError, match="negative"):
            exp.run_sweep(spec, exp.EngineConfig(jobs=2, cache=cache))
        # the three good points were cached despite the failure
        good = exp.SweepSpec("mixed", "repro_torch.exp.smoke:square_or_raise",
                             axes={"x": [1, 2, 3]})
        _, rep = exp.run_sweep(good, exp.EngineConfig(cache=cache))
        assert rep.n_cached == 3 and rep.n_executed == 0

    def test_bad_fn_reference_rejected(self):
        from repro_torch.exp.runner import resolve_fn
        with pytest.raises(ValueError, match="bad fn reference"):
            resolve_fn("no.colon.here")


# ---------------------------------------------------------------- device

_DEVICE_MOD = (
    "def f(x, device='unset'):\n"
    "    return [x, str(device)]\n"
    "def g(x):\n"
    "    return x\n")


@pytest.fixture
def device_mod(tmp_path, monkeypatch):
    (tmp_path / "exp_torch_device_mod.py").write_text(_DEVICE_MOD)
    monkeypatch.syspath_prepend(str(tmp_path))
    return "exp_torch_device_mod"


class TestDevice:
    @pytest.mark.parametrize("jobs", [1, 2])
    def test_eval_fn_gets_the_engine_device(self, device_mod, jobs):
        spec = exp.SweepSpec("d", f"{device_mod}:f", axes={"x": [1, 2, 3]})
        res, rep = exp.run_sweep(spec, exp.EngineConfig(
            jobs=jobs, cache=None, device="cpu"))
        assert rep.n_executed == 3
        assert [v for _, v in res] == [[1, "cpu"], [2, "cpu"], [3, "cpu"]]

    def test_device_is_in_no_point_key_or_row(self, device_mod, tmp_path):
        spec = exp.SweepSpec("d", f"{device_mod}:f", axes={"x": [1]})
        (p,) = spec.points()
        assert "device" not in p.kwargs
        assert p.canonical()[1] == [("x", 1)]
        cache = exp.ResultCache(str(tmp_path))
        res, _ = exp.run_sweep(spec, exp.EngineConfig(cache=cache,
                                                      device="cpu"))
        assert exp.rows_from(res, "d") == [
            {"sweep": "d", "params": {"x": 1}, "value": [1, "cpu"]}]
        # a second engine on another device name hits the same entry
        _, rep = exp.run_sweep(spec, exp.EngineConfig(cache=cache,
                                                      device="cpu:0"))
        assert (rep.n_cached, rep.n_executed) == (1, 0)

    def test_binding_device_as_a_parameter_is_refused(self, device_mod):
        spec = exp.SweepSpec("d", f"{device_mod}:f", axes={"x": [1]},
                             fixed={"device": "cpu"})
        with pytest.raises(ValueError, match="binds 'device'"):
            exp.run_sweep(spec, exp.EngineConfig(cache=None, device="cpu"))

    def test_default_device_raises_without_cuda(self, device_mod,
                                                monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert exp.EngineConfig().device == "cuda"
        spec = exp.SweepSpec("d", f"{device_mod}:f", axes={"x": [1]})
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            exp.run_sweep(spec, exp.EngineConfig(cache=None))
        # an eval function without a device keyword never sees one
        plain = exp.SweepSpec("g", f"{device_mod}:g", axes={"x": [4]})
        res, _ = exp.run_sweep(plain, exp.EngineConfig(cache=None))
        assert [v for _, v in res] == [4]

    def test_cli_adds_device(self):
        import argparse
        ap = argparse.ArgumentParser()
        exp.add_cli_args(ap)
        args = ap.parse_args(["--no-cache"])
        assert args.device == "cuda"
        eng = exp.EngineConfig.from_args(ap.parse_args(
            ["--no-cache", "--device", "cpu", "--jobs", "3"]))
        assert (eng.device, eng.jobs, eng.cache) == ("cpu", 3, None)


# ------------------------------------------------------ across packages

def _study_specs(pkg):
    """Every study's sweeps: {name: SweepSpec}."""
    import importlib
    out = {}
    for name in ("table1", "fig7_breakdown", "fig9_expdiff", "fig3_error",
                 "fig10_tradeoff"):
        mod = importlib.import_module(f"{pkg}.{name}")
        out[name] = mod.spec()
    fig8 = importlib.import_module(f"{pkg}.fig8_perf")
    for spec in fig8._specs():
        out[spec.name] = spec
    return out


SPEC_NAMES = ("table1", "fig7_breakdown", "fig9_expdiff", "fig3_error",
              "fig10_tradeoff", "fig8a_precision", "fig8b_cluster",
              "fig8c_skip_empty")


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_study_spec_gives_the_reference_points(name):
    ref = _study_specs("benchmarks")[name]
    port = _study_specs("repro_torch.studies")[name]
    assert port.name == ref.name and port.mode == ref.mode
    ref_points, points = ref.points(), port.points()
    assert [p.params for p in points] == [p.params for p in ref_points]
    assert [[(k, encode(v)) for k, v in p.params] for p in points] \
        == [[(k, ref_encode(v)) for k, v in p.params] for p in ref_points]
    # the eval function is the port's own module of the same name
    assert port.fn_ref == ref.fn_ref.replace("benchmarks.",
                                             "repro_torch.studies.")


PRIMITIVES = (None, 0, -3, 2 ** 40, 1.5, -0.0, float("inf"), 1e-300, "s",
              True, False, (1, "a"), [1.0, None], {"k": (1, 2), 3: [True]},
              ((), []), {(1, 2): {"x": 0.1}})


@pytest.mark.parametrize("value", PRIMITIVES, ids=repr)
def test_encode_of_primitives_equals_the_reference(value):
    assert encode(value) == ref_encode(value)


def test_dataclass_tags_name_each_package_class():
    from repro.core.simulator import TileConfig as RefTile
    from repro_torch.core.simulator import TileConfig
    assert encode(TileConfig())[1] == "repro_torch.core.simulator.TileConfig"
    assert ref_encode(RefTile())[1] == "repro.core.simulator.TileConfig"
    assert encode(TileConfig())[2] == ref_encode(RefTile())[2]


def test_keys_never_address_the_other_package(tmp_path):
    p = _point(x=7)
    ref_p = ref_exp.ExperimentPoint(p.fn, p.params)
    # same function path, params and salt: the schema keeps them apart
    assert exp.point_key(p, salt="s") != ref_exp.point_key(ref_p, salt="s")
    assert exp.code_salt() != ref_exp.code_salt()
    port_cache = exp.ResultCache(str(tmp_path), salt="s")
    ref_cache = ref_exp.ResultCache(str(tmp_path), salt="s")
    port_cache.put(p, 49)
    assert ref_cache.get(ref_p) == (False, None)
    ref_cache.put(ref_p, -1)
    assert port_cache.get(p) == (True, 49)
    assert len(port_cache) == 2


def test_default_cache_dir_is_the_ports_own():
    from repro.exp import cache as ref_cache_mod
    from repro_torch.exp import cache as cache_mod
    assert cache_mod.DEFAULT_CACHE_DIR != ref_cache_mod.DEFAULT_CACHE_DIR


def test_rows_equal_the_reference_format():
    spec = _spec(3)
    ref_spec = ref_exp.SweepSpec("sq", "repro.exp.smoke:square",
                                 axes={"x": [0, 1, 2]})
    res, _ = exp.run_sweep(spec, exp.EngineConfig(cache=None))
    ref_res, _ = ref_exp.run_sweep(ref_spec, ref_exp.EngineConfig(cache=None))
    assert exp.rows_from(res, "sq") == ref_exp.rows_from(ref_res, "sq")


def test_smoke_point_equals_the_reference():
    from repro.exp import smoke as ref_smoke
    from repro_torch.exp import smoke
    for w, cluster in ((12, 1), (16, 4)):
        assert smoke.eval_point(w, cluster) == ref_smoke.eval_point(w,
                                                                    cluster)


def test_exp_smoke_passes(tmp_path, capsys):
    from repro_torch.exp import smoke
    assert smoke.main(["--cache-dir", str(tmp_path), "--jobs", "2"]) == 0
    out = capsys.readouterr().out
    assert "exp smoke OK" in out and "0 executed" in out
