"""The port's CUDA kernels on the card (``cuda`` marker).

Run on a machine with a CUDA device and ``nvcc``:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs where the JAX package is not
installed. Every test skips without a CUDA device (decided inside the
fixture, never at import). Tolerances: the exact kernels are
``torch.equal`` to their plain versions; ``fused_dequant_mm`` agrees
with its plain version within 2 gamma_K (|x| @ |w|) elementwise, the
most two f32 summation orders of the same products can differ by
(gamma_K = K u / (1 - K u), u = 2^-24); ``mp_matmul`` is bit-equal to
its plain version (compared on the output's bit patterns).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced
from repro_torch.core.ipu import IPUConfig
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qmm as tqmm
from repro_torch.kernels import ref as tref
from repro_torch.models import registry
from repro_torch.quant.quantize import (FP4_E2M1, FP8_E4M3, fp_quantize,
                                        quantize_symmetric)

INT_KINDS = ["int8", "int4", "int4_packed"]
U = 2.0 ** -24


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _stored(gen, k, n, kind, groups, device):
    w = torch.randn((k, n), generator=gen, device=device) / k ** 0.5
    wg = w.reshape(groups, k // groups, n)
    if kind in ("fp8", "fp4", "fp4_packed"):
        q, s = fp_quantize(wg, FP8_E4M3 if kind == "fp8" else FP4_E2M1,
                           axis=-2)
    else:
        q, s = quantize_symmetric(wg, 8 if kind == "int8" else 4, axis=-2)
    q = q.reshape(k, n)
    if kind == "int4_packed":
        q = tops.pack_int4(q)
    elif kind == "fp4_packed":
        q = tops.pack_u4(q)
    return q.contiguous(), s.reshape(groups, n).contiguous()


def _sum_bound(x, w, sw, sa, kind, act):
    xp = x
    if act != "none":
        xp = tref.quantize_act_ref(x, sa)
        if act == "qdq":
            xp = xp * sa
    wf = tref.decode_weight_ref(w, kind)
    k, n = wf.shape
    g = sw.shape[0]
    wf = (wf.reshape(g, k // g, n) * sw[:, None, :]).reshape(k, n)
    absdot = xp.abs().double() @ wf.abs().double()
    if act == "quant":
        absdot = absdot * sa.double()
    return 2 * (k * U / (1 - k * U)) * absdot


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("kind", tfused.KINDS)
def test_fused_dequant_matches_plain(cuda, kind, groups):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(31)
    for m, k, n in ((5, 128, 72), (8, 896, 130), (33, 256, 40)):
        w, sw = _stored(gen, k, n, kind, groups, cuda)
        x = torch.randn((m, k), generator=gen, device=cuda) * 2
        sa = (x.abs().amax() / 127).reshape(())
        for act in tfused.ACTS:
            got = tops.fused_dequant_matmul(x, w, sw, sa, kind=kind, act=act)
            want = tops.fused_dequant_matmul(x, w, sw, sa, kind=kind,
                                             act=act, backend="ref")
            diff = (got.double() - want.double()).abs()
            assert bool((diff <= _sum_bound(x, w, sw, sa, kind,
                                            act)).all()), (kind, act, m)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", INT_KINDS)
def test_exact_kernels_equal_plain(cuda, kind):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(32)
    for m, k, n in ((9, 192, 130), (1, 64, 7), (256, 896, 128)):
        w, sw = _stored(gen, k, n, kind, 1, cuda)
        x = torch.randn((m, k), generator=gen, device=cuda) * 2
        sa = torch.tensor(0.11, device=cuda)
        assert torch.equal(
            tops.fused_quantized_matmul(x, w, sw, sa, kind=kind),
            tops.fused_quantized_matmul(x, w, sw, sa, kind=kind,
                                        backend="ref"))
        a = tref.quantize_act_ref(x, sa).to(torch.int8)
        fn = tops.int4_matmul_packed if kind == "int4_packed" \
            else tops.int8_matmul
        assert torch.equal(fn(a, w), fn(a, w, backend="ref"))


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject_mixed_devices(cuda):
    a = torch.ones((4, 16), dtype=torch.int8, device=cuda)
    b = torch.ones((16, 8), dtype=torch.int8, device=cuda)
    before = tops.launch_counts()["qmm"]
    assert int(tops.int8_matmul(a, b)[0, 0]) == 16
    assert tops.launch_counts()["qmm"] == before + 1
    tops.int8_matmul(a, b, backend="ref")
    assert tops.launch_counts()["qmm"] == before + 1
    with pytest.raises(ValueError):
        tops.int8_matmul(a, b.cpu())


# ------------------------------------------------- qmm on the tensor cores

def _misaligned(t: torch.Tensor, offset: int) -> torch.Tensor:
    """A contiguous copy of ``t`` whose data pointer lies ``offset``
    bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def _int8(gen, shape, device):
    return torch.randint(-128, 128, shape, generator=gen, device=device,
                         dtype=torch.int8)


def _qmm(a, b, splits=None):
    """``qmm`` with the number of K ranges forced (None: the default
    plan)."""
    if splits is None:
        return tqmm.qmm(a, b)
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    (m, k), n = a.shape, b.shape[1]
    return tqmm.qmm(a, b, plan=tqmm.plan_qmm(m, n, k, sms, splits))


# edge shapes: ragged M, N, K; rows aligned to 8, 4, 2 and 1 bytes
QMM_EDGES = [(5, 200, 72), (33, 128, 130), (17, 100, 30), (1, 32, 7),
             (9, 192, 129), (8, 4864, 896), (256, 896, 128), (3, 7, 2),
             (16, 33, 64), (4, 0, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", QMM_EDGES, ids=str)
def test_qmm_equals_plain_at_edges(cuda, shape):
    m, k, n = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m * 7919 + k * 31 + n)
    a, b = _int8(gen, (m, k), cuda), _int8(gen, (k, n), cuda)
    want = tref.qmm_ref(a, b)
    assert torch.equal(_qmm(a, b), want)
    for splits in (1, 3, 7):
        assert torch.equal(_qmm(a, b, splits), want), splits


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 0), (0, 1), (4, 8), (3, 5)],
                         ids=str)
def test_qmm_equals_plain_at_misaligned_pointers(cuda, offsets):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(41)
    for m, k, n in ((8, 896, 128), (17, 256, 64), (5, 200, 72)):
        a0, b0 = _int8(gen, (m, k), cuda), _int8(gen, (k, n), cuda)
        a, b = _misaligned(a0, offsets[0]), _misaligned(b0, offsets[1])
        assert a.data_ptr() % 16 == offsets[0] % 16
        assert b.data_ptr() % 16 == offsets[1] % 16
        assert torch.equal(_qmm(a, b), tref.qmm_ref(a0, b0))
        assert torch.equal(_qmm(a, b, 1), tref.qmm_ref(a0, b0))


@pytest.mark.cuda
def test_qmm_extremes_at_full_depth(cuda):
    """All -128 operands at K = 4864: every product is 2^14, every sum
    4864 * 2^14, with the split forced to 1 and to several."""
    a = torch.full((8, 4864), -128, dtype=torch.int8, device=cuda)
    b = torch.full((4864, 896), -128, dtype=torch.int8, device=cuda)
    want = tref.qmm_ref(a, b)
    assert int(want[0, 0]) == 4864 * 2 ** 14
    for splits in (None, 1, 5, 38):
        assert torch.equal(_qmm(a, b, splits), want), splits


@pytest.mark.cuda
def test_qmm_refuses_a_plan_that_does_not_cover_k(cuda):
    a = torch.ones((8, 256), dtype=torch.int8, device=cuda)
    b = torch.ones((256, 64), dtype=torch.int8, device=cuda)
    before = tops.launch_counts()["qmm"]
    for plan in (tqmm.QmmPlan(1, 32, 1, 128), tqmm.QmmPlan(3, 32, 1, 256),
                 tqmm.QmmPlan(1, 48, 1, 256), tqmm.QmmPlan(1, 32, 9, 32)):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            tqmm.qmm(a, b, plan=plan)
    assert tops.launch_counts()["qmm"] == before
    assert int(tqmm.qmm(a, b, plan=tqmm.QmmPlan(1, 32, 8, 32))[0, 0]) == 256


@pytest.mark.cuda
def test_qmm_counts_one_launch_per_call_and_replays_in_a_graph(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(43)
    a, b = _int8(gen, (8, 4864), cuda), _int8(gen, (4864, 896), cuda)
    want = tref.qmm_ref(a, b)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert tqmm.plan_qmm(8, 896, 4864, sms).splits > 1  # a zeroed output
    before = tops.launch_counts()["qmm"]
    tops.int8_matmul(a, b)
    assert tops.launch_counts()["qmm"] == before + 1
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        tops.int8_matmul(a, b)                  # warm up off the default
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tops.int8_matmul(a, b)
    graph.replay()
    graph.replay()                    # zeroing is part of the graph
    torch.cuda.synchronize()
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_engine_fused_on_off_identical_on_the_card(cuda):
    """Reduced qwen2-0.5b under fidelity_int8 on the card: the fused
    (``fused_qmm``) and unfused (``qmm``) routes give the same greedy
    streams, and each route launched its kernels."""
    from repro_torch.serving import EngineConfig, Request
    from repro_torch.serving.engine import ServingEngine
    cfg = dataclasses.replace(reduced("qwen2-0.5b"),
                              precision_policy="fidelity_int8")
    api = registry.build(cfg)
    params = api.init(0, cuda)
    scales, streams = "auto", {}
    for mode in ("on", "off"):
        tops.reset_launch_counts()
        eng = ServingEngine(cfg, api, params, EngineConfig(
            batch_slots=3, cache_len=64, decode_block=4,
            act_calibration=scales, fused_executors=mode))
        scales = eng.act_scales
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, prompt=rng.integers(
                    0, cfg.vocab, int(rng.integers(3, 12)), dtype=np.int32),
                    max_new_tokens=6) for i in range(5)]
        for r in reqs:
            eng.submit(r)
        eng.run_until_drained()
        streams[mode] = [r.tokens for r in reqs]
        counts = tops.launch_counts()
        assert counts["fused_qmm" if mode == "on" else "qmm"] > 0, counts
    assert streams["on"] == streams["off"]


# ------------------------------------------------------------ mp_matmul

MP_CFGS = [IPUConfig(n=16, w=16, accum="fp32"),
           IPUConfig(n=16, w=28, accum="fp32"),
           IPUConfig(n=8, w=12, accum="fp16")]


def _f16_operands(gen, m, k, n, device):
    """'Wide' f16 operands (normal times 2^[-10, 12)) with zeros, -0,
    subnormals and an all-zero K-group, made on the card."""
    def wide(shape):
        x = torch.randn(shape, generator=gen, device=device)
        e = torch.randint(-10, 12, shape, generator=gen, device=device)
        return torch.ldexp(x, e).to(torch.float16).nan_to_num(0, 0, 0)
    a, b = wide((m, k)), wide((k, n))
    a[0] = 0
    a[1, ::3] = -0.0
    sub = torch.randint(-1023, 1024, (k,), generator=gen, device=device)
    a[2 % m] = (sub * 2.0 ** -24).to(torch.float16)
    b[:min(16, k), 0] = 0
    return a.contiguous(), b.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("cfg", MP_CFGS + [
    IPUConfig(n=16, w=16, accum="fp32", rounding="floor"),
    IPUConfig(n=16, w=16, accum="bf16", sw_precision=12)],
    ids=lambda c: f"n{c.n}w{c.w}{c.accum}{c.rounding[:2]}")
def test_mp_matmul_equals_plain(cuda, cfg, fused):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(33)
    for m, k, n in ((5, 200, 72), (8, 896, 130), (33, 64, 40), (3, 7, 2)):
        a, b = _f16_operands(gen, m, k, n, cuda)
        got = tops.mp_matmul(a, b, cfg, fused=fused)
        want = tops.mp_matmul(a, b, cfg, fused=fused, backend="ref")
        assert got.dtype == want.dtype and got.shape == (m, n)
        assert torch.equal(got.view(torch.int16 if got.element_size() == 2
                                    else torch.int32),
                           want.view(torch.int16 if want.element_size() == 2
                                     else torch.int32)), (m, k, n)


@pytest.mark.cuda
def test_mp_matmul_wrapper_counts_and_refuses(cuda):
    a = torch.ones((4, 32), dtype=torch.float16, device=cuda)
    b = torch.ones((32, 8), dtype=torch.float16, device=cuda)
    before = tops.launch_counts()["mp_matmul"]
    assert float(tops.mp_matmul(a, b)[0, 0]) == 32.0
    assert tops.launch_counts()["mp_matmul"] == before + 1
    tops.mp_matmul(a, b, backend="ref")
    assert tops.launch_counts()["mp_matmul"] == before + 1
    for cfg in (IPUConfig(multi_cycle=True), IPUConfig(operand="bf16")):
        with pytest.raises(NotImplementedError):
            tops.mp_matmul(a, b, cfg)
    with pytest.raises(ValueError):
        tops.mp_matmul(a, b.cpu())
    assert tops.launch_counts()["mp_matmul"] == before + 1
