"""Shared helpers of the ``test_torch_*`` parity tests: move the JAX
reference's parameter trees into the torch port through numpy."""
import dataclasses
import importlib.util
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax

from repro.quant.prepare import PreparedWeight as JaxPrepared
from repro_torch.configs import ModelConfig, MoESpec
from repro_torch.convert import params_from_numpy, to_numpy

# every architecture of the reference's zoo (``repro/configs``)
ARCHS = ("qwen2-0.5b", "rwkv6-1.6b", "recurrentgemma-9b", "mixtral-8x7b",
         "internvl2-1b", "seamless-m4t-medium", "gemma2-9b", "glm4-9b",
         "stablelm-12b", "qwen3-moe-30b-a3b")


def jax_to_numpy(tree):
    """JAX tree -> numpy tree; a PreparedWeight becomes the
    ``{data, scale, kind, act_scale}`` record the converter reads."""
    def leaf(x):
        if isinstance(x, JaxPrepared):
            return {"data": np.asarray(x.data),
                    "scale": None if x.scale is None else np.asarray(x.scale),
                    "kind": x.kind,
                    "act_scale": (None if x.act_scale is None
                                  else np.asarray(x.act_scale))}
        return np.asarray(x)
    return jax.tree.map(leaf, tree,
                        is_leaf=lambda x: isinstance(x, JaxPrepared))


def port_config(ref_cfg) -> ModelConfig:
    """The port's ModelConfig with a reference config's fields (the port
    lists only the configs it serves; its cost model reads any)."""
    d = dataclasses.asdict(ref_cfg)
    if d["moe"] is not None:
        d["moe"] = MoESpec(**d["moe"])
    return ModelConfig(**d)


def to_torch(tree):
    """JAX tree -> the port's tensors on the CPU."""
    return params_from_numpy(jax_to_numpy(tree), device="cpu")


def f32(x):
    """Any JAX array or torch tensor (bf16 included) -> f32 numpy."""
    if hasattr(x, "detach"):
        return np.asarray(to_numpy(x), np.float32)
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Run a test module's torch ops on one intra-op thread (imported by
    the modules that use it). The suite runs several workers on shared
    cores; a thread pool of every core's size in each worker
    oversubscribes them, and the plain FP-IP matmul's many small ops then
    slow by more than an order of magnitude."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_REFERENCE = {}


def reference(task: str):
    """Outputs of ``tests/_jax_reference.py <task>``, computed once per
    process in a subprocess with XLA's excess precision off (see that
    file for why)."""
    if task not in _REFERENCE:
        here = os.path.dirname(os.path.abspath(__file__))
        src = os.path.join(os.path.dirname(here), "src")
        env = dict(os.environ)
        env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                            + " --xla_allow_excess_precision=false").strip()
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (src, env.get("PYTHONPATH")) if p)
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, f"{task}.pkl")
            subprocess.run([sys.executable,
                            os.path.join(here, "_jax_reference.py"), task,
                            out], env=env, check=True, timeout=600)
            with open(out, "rb") as f:
                _REFERENCE[task] = pickle.load(f)
    return _REFERENCE[task]


def load_fp_convert():
    """tools/fp_convert.py: the independent numpy codec oracle."""
    if "fp_convert" in sys.modules:
        return sys.modules["fp_convert"]
    spec = importlib.util.spec_from_file_location(
        "fp_convert", os.path.join(os.path.dirname(__file__), "..",
                                   "tools", "fp_convert.py"))
    fc = importlib.util.module_from_spec(spec)
    sys.modules["fp_convert"] = fc
    spec.loader.exec_module(fc)
    return fc
