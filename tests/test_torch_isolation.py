"""The port stands alone: no JAX, nothing of ``repro``, no quiet CPU
fallback, and no compiler needed to import it.

* No module under ``src/repro_torch/`` imports ``jax``/``jaxlib``,
  ``msgpack`` or any module of ``repro`` — checked on every module's
  syntax tree, and by importing the whole package in a fresh interpreter
  and reading ``sys.modules``. Importing it loads no kernel either.
  The plan, checkpoint, fabric and router modules, the sweep engine,
  studies, examples and tools, the planner's search, its command
  line and ``plan_report``, and the training stack (optimizer, data
  stream, losses, trainer, ``examples.train_lm``) are also imported
  first, each in a fresh interpreter.
* Entry points default to CUDA: without a CUDA device and without an
  explicit ``device="cpu"`` they raise (the engine, ``init_params``,
  calibration, ``build_engine``, ``build_replicas`` and
  ``restore_checkpoint``), for every served family, and so do the
  studies and examples that compute with torch (``fig3_error``,
  ``quickstart``, ``serve_lm``), and the planner's ``search``, ``score``
  and ``smoke`` (its accuracy objective takes the device, with or
  without the probe) and ``plan_act_scales``, and the trainer CLI,
  ``examples.train_lm``, the data stream and ``materialize_batch``. Every architecture
  of the reference's zoo builds, and its parameter tree resolves to
  policy paths that its projection groups cover.
* Without ``nvcc`` the kernel loader raises a clear error; it never
  hands back a plain version.
* The fabric (transport, chaos, worker, controller, the smoke and chaos
  contracts and their command line), the fault-tolerant runtime, the
  scheduler and the MessagePack codec import, and the fabric's smoke and
  chaos contracts run on the CPU, with ``jax``, ``repro`` and
  ``msgpack`` blocked (``sys.modules[name] = None``); ``python -m
  repro_torch.fabric worker|smoke|chaos`` without CUDA and without
  ``--device cpu`` exits non-zero with ``resolve_device``'s error.
"""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import device as tdevice
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.configs import InputShape, get_config, reduced
from repro_torch.fabric import build_engine, save_engine_checkpoint
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.models import registry
from repro_torch.quant.calibrate import calibrate_act_scales
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.router import build_replicas

from _torch_parity import ARCHS

PKG = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"


FORBIDDEN = ("jax", "jaxlib", "repro", "msgpack")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_reference():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 20
    bad = [(str(f.relative_to(PKG)), name) for f in files
           for name in _imports(f) if _forbidden(name)]
    assert bad == []


def test_importing_the_package_loads_no_jax_no_reference_no_kernel():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "import repro_torch.kernels._build as b\n"
        "assert not b._LIBS, b._LIBS\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) > 20


NUMERICS_MODULES = ("repro_torch.core", "repro_torch.core.fp16",
                    "repro_torch.core.fixedpoint", "repro_torch.core.nibble",
                    "repro_torch.core.ehu", "repro_torch.core.ipu",
                    "repro_torch.core.error_bounds", "repro_torch.kernels.mpmm")


SERVING_SURFACE_MODULES = (
    "repro_torch.autotune", "repro_torch.autotune.plan",
    "repro_torch.autotune.objectives", "repro_torch.checkpoint",
    "repro_torch.checkpoint.checkpoint", "repro_torch.checkpoint._msgpack",
    "repro_torch.fabric", "repro_torch.fabric.checkpoint",
    "repro_torch.serving.router", "repro_torch.core.simulator",
    "repro_torch.core.area_power", "repro_torch.core.workloads")


def _imports_alone(modules):
    """Import ``modules`` first in a fresh interpreter: no JAX, no
    msgpack, nothing of ``repro``, no kernel library, no CUDA context."""
    for mod in modules:
        assert (PKG.parent / (mod.replace(".", "/") + ".py")).exists() or \
            (PKG.parent / mod.replace(".", "/") / "__init__.py").exists()
    code = (
        "import importlib, sys, torch\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(n for n in sys.modules\n"
        f"             if n.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "import repro_torch.kernels._build as b\n"
        "assert not b._LIBS, b._LIBS\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_paper_numerics_modules_stand_alone():
    """The paper-numerics modules and the mpmm wrapper, each imported
    first in a fresh interpreter: no JAX, nothing of ``repro``, no kernel
    library loaded, no CUDA context made."""
    _imports_alone(NUMERICS_MODULES)


def test_serving_surface_modules_stand_alone():
    """The plan, checkpoint, fabric, router and cost-model modules, each
    imported first in a fresh interpreter, as above."""
    _imports_alone(SERVING_SURFACE_MODULES)


FAMILY_MODULES = ("repro_torch.layers.rwkv6", "repro_torch.layers.rglru",
                  "repro_torch.models.vlm", "repro_torch.models.rwkv",
                  "repro_torch.models.griffin", "repro_torch.models.encdec",
                  "repro_torch.serving.smoke", "repro_torch.serving.__main__")


def test_family_modules_stand_alone():
    """The vlm, rwkv, griffin and encdec modules and the serving smoke
    and its command line, each imported first in a fresh interpreter, as
    above."""
    _imports_alone(FAMILY_MODULES)


STUDY_MODULES = (
    "repro_torch.exp", "repro_torch.exp.sweep", "repro_torch.exp.cache",
    "repro_torch.exp.runner", "repro_torch.exp.smoke",
    "repro_torch.studies", "repro_torch.studies.common",
    "repro_torch.studies.fig3_error", "repro_torch.studies.table1",
    "repro_torch.studies.fig7_breakdown", "repro_torch.studies.fig8_perf",
    "repro_torch.studies.fig9_expdiff", "repro_torch.studies.fig10_tradeoff",
    "repro_torch.studies.run", "repro_torch.core.exact_ref",
    "repro_torch.examples", "repro_torch.examples.quickstart",
    "repro_torch.examples.accelerator_study",
    "repro_torch.examples.serve_lm", "repro_torch.tools",
    "repro_torch.tools.calibrate_area", "repro_torch.tools.trace_report")


def test_study_example_and_tool_modules_stand_alone():
    """The sweep engine, the paper's studies, the examples and the tools,
    each imported first in a fresh interpreter, as above."""
    _imports_alone(STUDY_MODULES)


PLANNER_MODULES = (
    "repro_torch.autotune.candidates", "repro_torch.autotune.objectives",
    "repro_torch.autotune.search", "repro_torch.autotune.cli",
    "repro_torch.autotune.__main__", "repro_torch.tools.plan_report")


def test_planner_modules_stand_alone():
    """The planner's candidates, objectives, search and command line, and
    ``tools.plan_report``, each imported first in a fresh interpreter, as
    above."""
    _imports_alone(PLANNER_MODULES)


def test_loading_a_plan_imports_no_model():
    """``repro_torch.autotune`` resolves its names lazily: loading a plan
    through it pulls neither the model stack nor the search."""
    plan = PKG.parents[1] / "results" / "plans" / "qwen2_0_5b.json"
    prog = ("import sys\n"
            "from repro_torch.autotune import load_plan\n"
            f"load_plan({str(plan)!r})\n"
            "bad = sorted(n for n in sys.modules if n.startswith(\n"
            "    ('repro_torch.models', 'repro_torch.layers',\n"
            "     'repro_torch.autotune.search', 'jax', 'repro.')))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", prog], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _fig3_main(argv):
    from repro_torch.studies import fig3_error
    fig3_error.main(["--no-cache", "--quiet-progress", *argv])


def _quickstart_main(argv):
    from repro_torch.examples import quickstart
    quickstart.main(argv)


def _serve_lm_main(argv):
    from repro_torch.examples import serve_lm
    serve_lm.main(["--requests", "2", "--max-new", "2", *argv])


@pytest.mark.parametrize("main", (_fig3_main, _quickstart_main,
                                  _serve_lm_main),
                         ids=("fig3_error", "quickstart", "serve_lm"))
def test_study_and_example_entry_points_raise_without_cuda(
        no_cuda, main, monkeypatch, tmp_path, capsys):
    """``fig3_error``, ``quickstart`` and ``serve_lm`` compute with torch
    on ``--device`` (default cuda): without CUDA they raise unless given
    ``--device cpu``; none falls back to the CPU."""
    from repro_torch.studies import common
    monkeypatch.setattr(common, "RESULTS_DIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--device", "cuda"])
    assert capsys.readouterr().out == ""
    main(["--device", "cpu"])
    assert capsys.readouterr().out


def test_entry_points_raise_without_cuda_unless_asked_for_cpu(no_cuda):
    cfg = reduced("qwen2-0.5b")
    api = registry.build(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init_params(cfg)
    params = registry.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, api, params)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate_act_scales(cfg, api, params, prompts=[[1, 2, 3]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve_device("cuda")
    eng = ServingEngine(cfg, api, params, device="cpu")
    assert eng.device == torch.device("cpu")


def test_serving_surface_raises_without_cuda_unless_asked_for_cpu(
        no_cuda, tmp_path):
    cfg = reduced("qwen2-0.5b")
    params = registry.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_replicas(cfg, ["bf16"], params=params)
    (rep,) = build_replicas(cfg, ["bf16"], params=params, device="cpu")
    save_engine_checkpoint(rep.engine, str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_engine(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_checkpoint(str(tmp_path), 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        restore_checkpoint(str(tmp_path), 0, device="cuda")
    eng = build_engine(str(tmp_path), device="cpu")
    assert eng.device == torch.device("cpu")
    tree, _ = restore_checkpoint(str(tmp_path), 0, device="cpu")
    assert tree["embed"]["w"].device == torch.device("cpu")


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    for name in _build.SOURCES:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            _build.library(name)
    assert not (tmp_path / "build").exists()


def test_cpu_tensors_never_reach_the_loader(monkeypatch):
    def refuse(name):
        raise AssertionError(f"loader called for {name} on CPU tensors")
    monkeypatch.setattr(_build, "library", refuse)
    before = tops.launch_counts()
    a = torch.ones((3, 8), dtype=torch.int8)
    b = torch.ones((8, 5), dtype=torch.int8)
    assert int(tops.int8_matmul(a, b)[0, 0]) == 8
    # bytes 0x11 hold two nibbles of +1 each
    assert int(tops.int4_matmul_packed(a, tops.pack_int4(b))[0, 0]) == 8
    x = torch.ones((3, 8))
    sw = torch.ones((1, 5))
    y = tops.fused_quantized_matmul(x, b, sw, torch.tensor(0.5))
    assert float(y[0, 0]) == 8.0          # round(1 / 0.5) * 8 * 0.5
    y = tops.fused_dequant_matmul(x, b, sw, torch.tensor(0.5), act="qdq")
    assert float(y[0, 0]) == 8.0
    y = tops.mp_matmul(x.half(), b.half())
    assert float(y[0, 0]) == 8.0
    assert tops.launch_counts() == before


def test_build_flags_are_exact():
    """The exact kernels need IEEE division and rounding: never fast
    math, and always the sm_90a target."""
    flags = " ".join(_build.NVCC_FLAGS)
    assert "fast_math" not in flags and "fast-math" not in flags
    assert "arch=compute_90a,code=sm_90a" in flags
    for src in _build.SOURCES:
        text = (_build.CSRC / f"{src}.cu").read_text()
        assert "extern \"C\"" in text
        assert "torch/extension.h" not in text


@pytest.mark.parametrize("arch", ("internvl2-1b", "rwkv6-1.6b",
                                  "recurrentgemma-9b"))
def test_family_entry_points_raise_without_cuda_unless_asked_for_cpu(
        no_cuda, arch):
    cfg = reduced(arch)
    api = registry.build(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        api.init_cache(2, 8)
    params = registry.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, api, params)
    eng = ServingEngine(cfg, api, params, device="cpu")
    assert eng.device == torch.device("cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_every_arch_builds_and_resolves_its_projection_paths(arch):
    """``build`` takes the full config of every architecture, and every
    projection of the reduced model's parameter tree resolves to a
    policy path that one of the architecture's projection groups
    matches (a path no group matches would make a plan's rule dead)."""
    import re

    from repro_torch.quant.prepare import iter_projection_weights
    api = registry.build(get_config(arch))
    assert api.cfg.arch_id == arch and callable(api.prefill)
    cfg = reduced(arch)
    paths = registry.projection_paths(cfg)
    params = registry.init_params(cfg, device="cpu")
    resolved = {paths(p) for p, _ in iter_projection_weights(params, paths)}
    assert resolved and None not in resolved
    groups = registry.projection_groups(cfg)
    for path in resolved:
        assert any(re.search(g.pattern, path) for g in groups), path


def test_planner_raises_without_cuda_unless_asked_for_cpu(no_cuda, tmp_path,
                                                          capsys):
    """``python -m repro_torch.autotune search`` (with the probe or
    without), ``score`` and ``smoke`` score accuracy on ``--device``
    (default cuda): without CUDA they raise naming the flag, and write
    nothing; ``--device cpu`` searches on the CPU. The probe and
    ``plan_act_scales`` raise the same way unless given ``device="cpu"``."""
    from repro_torch.autotune import cli, objectives
    from repro_torch.autotune.plan import load_plan
    out = tmp_path / "plan.json"
    search = ["search", "--model", "qwen2-0.5b", "--shapes", "reduced",
              "--modes", "bf16", "int8", "fp16_ipu", "--widths", "12",
              "--cache-dir", str(tmp_path / "cache"), "--quiet-progress",
              "--out", str(out)]
    for argv in (search, search + ["--no-probe"],
                 search + ["--device", "cuda"],
                 ["smoke", "--cache-dir", str(tmp_path / "smoke")]):
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(argv)
    assert not out.exists() and not (tmp_path / "cache").exists()
    assert not (tmp_path / "smoke").exists()
    assert cli.main(search + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out
    plan = load_plan(str(out))
    assert plan.meta["probe"] is True
    score = ["score", *search[1:-2], "--plan", str(out)]
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(score)
    assert cli.main(score + ["--device", "cpu"]) == 0
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        objectives.accuracy_point("qwen2-0.5b", "ffn_in", "fp16_ipu", 12,
                                  28, device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        objectives.divergence_probe("qwen2-0.5b", "ffn_in", "int8", 16, 28)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.plan_act_scales(plan)
    assert cli.plan_act_scales(plan, device="cpu")


TRAINING_MODULES = (
    "repro_torch.optim", "repro_torch.optim.adamw",
    "repro_torch.optim.schedule", "repro_torch.optim.loss_scale",
    "repro_torch.optim.tree", "repro_torch.data",
    "repro_torch.data.pipeline", "repro_torch.models.losses",
    "repro_torch.launch", "repro_torch.launch.train",
    "repro_torch.launch.serve", "repro_torch.examples.train_lm")


def test_training_modules_stand_alone():
    """The optimizer, the data stream, the losses, the trainer and its
    example, each imported first in a fresh interpreter, as above."""
    _imports_alone(TRAINING_MODULES)


def test_training_entry_points_raise_without_cuda_unless_asked_for_cpu(
        no_cuda, tmp_path, capsys):
    """The trainer CLI, ``examples/train_lm`` and the data stream take
    their device like every entry point: CUDA by default, raising
    without it; ``--device cpu`` / ``device="cpu"`` runs on the CPU."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLMDataset
    from repro_torch.examples import train_lm
    from repro_torch.launch import train
    argv = ["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path / "t")]
    for fn, args in ((train.main, argv),
                     (train_lm.main, ["--steps", "1", "--ckpt-dir",
                                      str(tmp_path / "e")])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(args)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(args + ["--device", "cuda"])
    assert capsys.readouterr().out == ""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SyntheticLMDataset(DataConfig(vocab=16, seq_len=4, global_batch=2))
    cfg = reduced("qwen2-0.5b")
    shape = InputShape("t", 4, 2, "train")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.materialize_batch(cfg, shape)
    assert registry.materialize_batch(cfg, shape, device="cpu")[
        "tokens"].device == torch.device("cpu")
    train.main(argv + ["--device", "cpu"])
    assert capsys.readouterr().out.startswith("arch=qwen2-0.5b steps=1 ")


FABRIC_MODULES = (
    "repro_torch.fabric", "repro_torch.fabric.transport",
    "repro_torch.fabric.chaos", "repro_torch.fabric.worker",
    "repro_torch.fabric.controller", "repro_torch.fabric.smoke",
    "repro_torch.fabric.chaos_smoke", "repro_torch.fabric.__main__",
    "repro_torch.runtime", "repro_torch.runtime.fault_tolerance",
    "repro_torch.serving.scheduler", "repro_torch.checkpoint._msgpack")


def test_fabric_modules_stand_alone():
    """The fabric, the runtime, the scheduler and the codec, each
    imported first in a fresh interpreter, as above."""
    _imports_alone(FABRIC_MODULES)


def test_fabric_runs_with_jax_repro_and_msgpack_blocked():
    """With ``jax``, ``jaxlib``, ``repro`` and ``msgpack`` made
    unimportable, the fabric's modules import, a message crosses the wire
    and ``python -m repro_torch.fabric smoke|chaos --device cpu`` keep
    their contracts."""
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for name in {FABRIC_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from repro_torch.fabric import transport as tp\n"
        "msg = tp.Resume(name='w', progress={3: 5})\n"
        "assert tp.decode_message(tp.encode_message(msg)) == msg\n"
        "from repro_torch.fabric.__main__ import main\n"
        "assert main(['smoke', '--device', 'cpu']) == 0\n"
        "assert main(['chaos', '--device', 'cpu']) == 0\n"
        "print('ok')\n")
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr
    assert "fabric-smoke: PASS on cpu" in res.stdout
    assert "chaos-smoke: PASS on cpu" in res.stdout
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("argv", (
    ["worker", "--ckpt", "missing", "--connect", "127.0.0.1:9"],
    ["smoke"], ["chaos"]), ids=("worker", "smoke", "chaos"))
def test_fabric_cli_needs_cuda_unless_asked_for_cpu(argv):
    """Without a CUDA device (none visible) and without ``--device
    cpu``, each command exits non-zero on ``resolve_device``'s error
    before it serves or dials anything."""
    env = {"PYTHONPATH": str(PKG.parent), "PATH": "/usr/bin:/bin",
           "CUDA_VISIBLE_DEVICES": ""}
    res = subprocess.run([sys.executable, "-m", "repro_torch.fabric",
                          *argv], env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
    assert "PASS" not in res.stdout
