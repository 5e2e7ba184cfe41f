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


def _reference_env():
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(os.path.dirname(here), "src")
    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_allow_excess_precision=false").strip()
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (src, env.get("PYTHONPATH")) if p)
    return here, env


def reference(task: str, arch=None):
    """Outputs of ``tests/_jax_reference.py <task> [<arch>]``, computed
    once per process in a subprocess with XLA's excess precision off
    (see that file for why)."""
    return references(task, [arch])[arch]


def references(task: str, archs):
    """``reference(task, arch)`` for every arch of ``archs``; the missing
    ones run side by side, one subprocess each."""
    todo = [a for a in archs if (task, a) not in _REFERENCE]
    for arch, out in run_references(task, todo).items():
        _REFERENCE[(task, arch)] = out
    return {a: _REFERENCE[(task, a)] for a in archs}


def run_references(task: str, archs, env_extra=None, timeout: float = 600):
    """{arch: outputs of ``_jax_reference.py <task> [<arch>]``}, one
    subprocess per arch, all started before any is waited for;
    ``env_extra`` adds to their environment. Nothing is cached."""
    here, env = _reference_env()
    env.update(env_extra or {})
    results = {}
    with tempfile.TemporaryDirectory() as d:
        procs = {}
        for i, arch in enumerate(archs):
            out = os.path.join(d, f"{task}-{i}.pkl")
            procs[arch] = (out, subprocess.Popen(
                [sys.executable, os.path.join(here, "_jax_reference.py"),
                 task, out] + ([arch] if arch else []), env=env))
        try:
            for arch, (out, proc) in procs.items():
                if proc.wait(timeout=timeout):
                    raise subprocess.CalledProcessError(proc.returncode,
                                                        proc.args)
                with open(out, "rb") as f:
                    results[arch] = pickle.load(f)
        finally:
            for _, proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return results


BF16_RTOL = 2.0 ** -7
# f32 recurrent states (the wkv ``s``, the RG-LRU ``h``): relative to
# each leaf's largest magnitude
F32_STATE_RTOL = 1e-5


def flat(tree, prefix=""):
    """{path: leaf} of dicts, lists and (named) tuples."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def assert_state(got, want, what):
    """Port decode state (torch) against the reference's (numpy): the
    same leaves, position tags exact, bf16 leaves within one bf16 ulp,
    f32 leaves within ``F32_STATE_RTOL`` of the leaf's largest
    magnitude."""
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys(), what
    for path, t in got.items():
        a = to_numpy(t)
        b = np.asarray(want[path])
        assert a.shape == b.shape, (what, path)
        if not np.issubdtype(b.dtype, np.floating) and b.dtype.name != \
                "bfloat16":
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {path}")
        elif t.dtype == torch.bfloat16:
            np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                       rtol=BF16_RTOL, atol=1e-6,
                                       err_msg=f"{what} {path}")
        else:
            scale = max(float(np.abs(b).max()), 1e-30)
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=F32_STATE_RTOL * scale,
                                       err_msg=f"{what} {path}")


def assert_caches(got, want, what, rtol=BF16_RTOL):
    """Port caches against the reference's: position tags equal, K and V
    (bf16) within ``rtol`` (one bf16 ulp by default)."""
    for name, c in want.items():
        k, v, pos = to_numpy(got[name])
        np.testing.assert_array_equal(pos, np.asarray(c[2]),
                                      err_msg=f"{what} {name} pos")
        for a, b, field in ((k, c[0], "k"), (v, c[1], "v")):
            np.testing.assert_allclose(a, np.asarray(b, np.float32),
                                       rtol=rtol, atol=0,
                                       err_msg=f"{what} {name} {field}")


def run_lm(api, prepared, variant):
    """The port's side of ``_jax_reference._lm_cases``: prefill logits
    and caches, and a chunked prefill into fresh caches (returned
    live)."""
    from repro_torch.layers.mplinear import executor_variant

    from _jax_reference import lm_inputs
    inp = lm_inputs()
    out = {}
    with executor_variant(variant), torch.no_grad():
        logits, caches = api.prefill(
            prepared, {"tokens": torch.from_numpy(inp["prefill_tokens"])},
            api.init_cache(2, 16, "cpu"))
        out["prefill_logits"], out["prefill_caches"] = logits, caches
        c2 = api.prefill_chunk(
            prepared, {"tokens": torch.from_numpy(inp["chunk_tokens"]),
                       "offsets": torch.from_numpy(inp["chunk_offsets"]),
                       "lengths": torch.from_numpy(inp["chunk_lengths"])},
            api.init_cache(3, 8, "cpu"))
        out["chunk_caches"] = {k: to_numpy(c) for k, c in c2.items()}
    return out, c2


def check_lm_case(api, prepared, variant, case, logit_atol,
                  cache_rtol=BF16_RTOL):
    """One ``_lm_cases`` case: prefill logits and caches, chunk caches,
    then three decode steps fed the reference's own argmax tokens."""
    from repro_torch.layers.mplinear import executor_variant

    from _jax_reference import lm_inputs
    got, c2 = run_lm(api, prepared, variant)
    np.testing.assert_allclose(got["prefill_logits"].numpy(),
                               case["prefill_logits"], rtol=0,
                               atol=logit_atol)
    assert_caches(got["prefill_caches"], case["prefill_caches"], "prefill",
                  cache_rtol)
    assert_caches(got["chunk_caches"], case["chunk_caches"], "chunk",
                  cache_rtol)
    inp = lm_inputs()
    tok = torch.from_numpy(inp["chunk_tokens"][:, :1].copy())
    pos = torch.from_numpy(inp["chunk_offsets"] + inp["chunk_lengths"])
    with executor_variant(variant), torch.no_grad():
        for want in case["decode_logits"]:
            logits, c2 = api.decode_step(prepared,
                                         {"token": tok, "pos": pos}, c2)
            np.testing.assert_allclose(logits.numpy(), want, rtol=0,
                                       atol=logit_atol)
            tok = torch.from_numpy(
                np.argmax(want, -1).astype(np.int32)[:, None])
            pos = pos + 1
    assert_caches(c2, case["decode_caches"], "decode", cache_rtol)


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
