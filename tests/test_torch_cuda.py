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
its plain version (compared on the output's bit patterns). The
training tests at the end launch no kernel: one train step of each
reduced family on the card against the CPU, and the trainer CLI killed
and resumed bit-equal (the step's accumulating backwards are
deterministic without torch's deterministic mode).
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.configs import reduced
from repro_torch.core.ipu import IPUConfig
from repro_torch.kernels import fused as tfused
from repro_torch.kernels import mpmm as tmpmm
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


def _fd_check(x, w, sw, sa, kind, act, plan=None):
    """``fused_dequant_mm`` (under ``plan``) within 2 gamma_K of its
    plain version; returns the kernel's output."""
    got = tfused.fused_dequant_mm(x, w, sw, sa, kind=kind, act=act,
                                  plan=plan)
    want = tref.fused_dequant_mm_ref(x, w, sw, sa, kind=kind, act=act)
    diff = (got.double() - want.double()).abs()
    assert bool((diff <= _sum_bound(x, w, sw, sa, kind, act)).all()), (
        kind, act, tuple(x.shape), tuple(w.shape), plan)
    return got


def _fd_plan(x, w, sw, kind, **kw):
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    m, k = x.shape
    return tfused.plan_fused_dequant(m, w.shape[1], k, sw.shape[0], kind,
                                     sms, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 7, 8, 9, 15, 16, 17, 33])
def test_fused_dequant_row_limit_edges(cuda, m):
    """Both sides of the 16 register rows a block holds: every kind and
    act, per-channel and G = 7 scales, the default plan, and K unsplit
    (one range, no cluster)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(50 + m)
    k, n = 896, 200
    x = torch.randn((m, k), generator=gen, device=cuda) * 2
    sa = (x.abs().amax() / 127).reshape(())
    for kind in tfused.KINDS:
        for groups in (1, 7):
            w, sw = _stored(gen, k, n, kind, groups, cuda)
            plan = _fd_plan(x, w, sw, kind)
            assert plan.rows == min(16, 1 << (m - 1).bit_length())
            for act in tfused.ACTS:
                _fd_check(x, w, sw, sa, kind, act)
            _fd_check(x, w, sw, sa, kind, "qdq",
                      _fd_plan(x, w, sw, kind, splits=1))


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 0, 0), (0, 1, 0), (0, 0, 1),
                                     (3, 5, 2), (0, 4, 0), (0, 8, 0)],
                         ids=str)
def test_fused_dequant_at_misaligned_pointers(cuda, offsets):
    """x, w and sw moved off their 16-byte boundaries (w by 1, 4 and 8
    bytes: the byte, 4-byte and again 4-byte copy widths), and N = 200,
    a row stride of 8 bytes mod 16; the result is the aligned one, bit
    for bit."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(60)
    for kind in ("int8", "int4_packed", "fp8", "fp4_packed"):
        for m, k, n in ((8, 896, 128), (5, 200, 72), (16, 4864, 200)):
            w0, sw0 = _stored(gen, k, n, kind, 1, cuda)
            x0 = torch.randn((m, k), generator=gen, device=cuda) * 2
            x = _misaligned(x0, offsets[0])
            w = _misaligned(w0, offsets[1])
            sw = _misaligned(sw0, offsets[2])
            sa = (x0.abs().amax() / 127).reshape(())
            for act in ("none", "qdq"):
                got = _fd_check(x, w, sw, sa, kind, act)
                # the copy width does not change the order of the sums
                assert torch.equal(got, tfused.fused_dequant_mm(
                    x0, w0, sw0, sa, kind=kind, act=act))


@pytest.mark.cuda
def test_fused_dequant_repeats_and_replays_bit_identical(cuda):
    """Split-K adds partials in split order: two launches give the same
    bits, and so do a CUDA-graph replay and a replay twice in a row,
    with one launch counted per call and none per replay."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(61)
    x = torch.randn((8, 4864), generator=gen, device=cuda) * 2
    w, sw = _stored(gen, 4864, 896, "int4_packed", 1, cuda)
    sa = (x.abs().amax() / 127).reshape(())
    assert _fd_plan(x, w, sw, "int4_packed").splits > 1

    def call():
        return tops.fused_dequant_matmul(x, w, sw, sa, kind="int4_packed",
                                         act="qdq")
    before = tops.launch_counts()["fused_dequant_mm"]
    first = _fd_check(x, w, sw, sa, "int4_packed", "qdq")
    assert torch.equal(call(), first)
    assert tops.launch_counts()["fused_dequant_mm"] == before + 2
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()                                  # warm up off the default
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [call() for _ in range(3)]       # one workspace, reused
    counted = tops.launch_counts()["fused_dequant_mm"]
    graph.replay()
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out, first)
    outs[0].zero_()
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    for out in outs:
        assert torch.equal(out, first)
    assert torch.equal(call(), first)           # eager after the replays
    assert tops.launch_counts()["fused_dequant_mm"] == counted + 1


@pytest.mark.cuda
def test_fused_dequant_forced_plans_and_refusals(cuda):
    """Every block width and several split counts agree with the plain
    version; a plan that does not cover K, takes more ranges than a
    cluster or whose slice does not fit is refused before any launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(62)
    x = torch.randn((8, 896), generator=gen, device=cuda) * 2
    w, sw = _stored(gen, 896, 300, "fp4_packed", 4, cuda)
    sa = (x.abs().amax() / 127).reshape(())
    for bn in tfused.DECODE_WIDTHS:
        for splits, kc in ((1, 896), (3, 320), (7, 128), (5, 192)):
            _fd_check(x, w, sw, sa, "fp4_packed", "quant",
                      tfused.FusedPlan(8, bn, splits, kc))
    before = tops.launch_counts()["fused_dequant_mm"]
    for plan in (tfused.FusedPlan(8, 32, 2, 320),    # does not cover K
                 tfused.FusedPlan(8, 32, 4, 320),    # an empty range
                 tfused.FusedPlan(3, 32, 1, 896),    # no such row count
                 tfused.FusedPlan(8, 32, 28, 32),    # more than a cluster
                 tfused.FusedPlan(8, 48, 1, 896),    # no such width
                 tfused.FusedPlan(8, 32, 1, 900),    # not a multiple of 32
                 tfused.FusedPlan(16, 32, 1, 2560)):  # slice too large
        with pytest.raises(RuntimeError, match="cudaError_t"):
            tfused.fused_dequant_mm(x, w, sw, sa, kind="fp4_packed",
                                    act="quant", plan=plan)
    assert tops.launch_counts()["fused_dequant_mm"] == before


@pytest.mark.cuda
def test_fused_dequant_largest_codes(cuda):
    """Every weight at its kind's largest code (int8 -128, int4 -8, both
    packed nibbles -8, e4m3 0x7F = 480, e2m1 0xF = -6, both packed
    nibbles 6) and acts at the ends of the int8 grid, at K = 4864."""
    m, k, n = 8, 4864, 136
    x = torch.full((m, k), 3.0, device=cuda)
    x[1::2] = -3.0
    sa = torch.tensor(3.0 / 127, device=cuda)
    codes = {"int8": (torch.int8, -128), "int4": (torch.int8, -8),
             "int4_packed": (torch.int8, -120),     # nibbles -8, -8
             "fp8": (torch.uint8, 0x7F), "fp4": (torch.uint8, 0xF),
             "fp4_packed": (torch.uint8, 0x77)}
    for kind, (dtype, code) in codes.items():
        rows = k // 2 if kind in tfused.PACKED_KINDS else k
        w = torch.full((rows, n), code, dtype=dtype, device=cuda)
        sw = torch.full((1, n), 0.5, device=cuda)
        for act in tfused.ACTS:
            _fd_check(x, w, sw, sa, kind, act)


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


# ------------------------------- fused_qmm and qmm_packed (int_tc_kernel)

# the kernel under test: (wrapper, weight kind)
INT_TC = [("fused_qmm", "int8"), ("fused_qmm", "int4"),
          ("fused_qmm", "int4_packed"), ("qmm_packed", "int4_packed")]
INT_TC_IDS = [f"{k}-{kind}" for k, kind in INT_TC]
# qwen2-0.5b's projection shapes, (K, N)
INT_TC_LAYER = [(896, 896), (896, 128), (896, 4864), (4864, 896)]


def _int_tc_operands(gen, kernel, kind, m, k, n, device):
    """(x, w, sw, sa): f32 acts, a stored weight, its scales and the act
    scale for ``fused_qmm``; int8 acts and random packed bytes (sw, sa
    None) for ``qmm_packed``."""
    if kernel == "qmm_packed":
        return _int8(gen, (m, k), device), _int8(gen, (k // 2, n), device), \
            None, None
    x = torch.randn((m, k), generator=gen, device=device) * 2
    if k == 0:
        return x, torch.zeros((0, n), dtype=torch.int8, device=device), \
            torch.ones((1, n), device=device), torch.tensor(0.1, device=device)
    w, sw = _stored(gen, k, n, kind, 1, device)
    return x, w, sw, (x.abs().amax() / 127).reshape(())


def _int_tc(kernel, kind, operands, plan=None):
    x, w, sw, sa = operands
    if kernel == "qmm_packed":
        return tqmm.qmm_packed(x, w, plan=plan)
    return tfused.fused_qmm(x, w, sw, sa, kind=kind, plan=plan)


def _int_tc_plain(kernel, kind, operands):
    x, w, sw, sa = operands
    if kernel == "qmm_packed":
        return tref.qmm_ref(x, tref.unpack_int4_ref(w))
    return tref.fused_qmm_ref(x, w, sw, sa, kind=kind)


def _int_tc_plan(kernel, kind, operands, splits=None, **kw):
    x, w = operands[:2]
    (m, k), n = x.shape, w.shape[1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return tqmm.plan_int_tc(m, n, k, kind == "int4_packed", sms, splits, **kw)


def _int_tc_count(kernel):
    return tops.launch_counts()[kernel]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 17, 256])
@pytest.mark.parametrize("kernel,kind", INT_TC, ids=INT_TC_IDS)
def test_int_tc_equals_plain_at_serving_shapes(cuda, kernel, kind, m):
    """Bit-equal to the plain version at qwen2-0.5b's projection shapes,
    default plans, one launch per call."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(50 + m)
    for k, n in INT_TC_LAYER:
        ops_ = _int_tc_operands(gen, kernel, kind, m, k, n, cuda)
        before = _int_tc_count(kernel)
        got = _int_tc(kernel, kind, ops_)
        assert _int_tc_count(kernel) == before + 1
        assert torch.equal(got, _int_tc_plain(kernel, kind, ops_)), (k, n)


# ragged M, N and K (K even: packed rows), rows aligned to 8, 4, 2 bytes
INT_TC_EDGES = [(5, 200, 72), (33, 128, 130), (17, 100, 30), (1, 32, 7),
                (9, 192, 129), (3, 8, 2), (16, 34, 64), (2, 66, 5),
                (4, 0, 8), (40, 4864, 36)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", INT_TC_EDGES, ids=str)
@pytest.mark.parametrize("kernel,kind", INT_TC, ids=INT_TC_IDS)
def test_int_tc_equals_plain_at_edges(cuda, kernel, kind, shape):
    m, k, n = shape
    gen = torch.Generator(device=cuda)
    gen.manual_seed(m * 7919 + k * 31 + n)
    ops_ = _int_tc_operands(gen, kernel, kind, m, k, n, cuda)
    want = _int_tc_plain(kernel, kind, ops_)
    assert torch.equal(_int_tc(kernel, kind, ops_), want)
    for splits in (1, 3, 8):
        plan = _int_tc_plan(kernel, kind, ops_, splits)
        assert torch.equal(_int_tc(kernel, kind, ops_, plan), want), plan


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(1, 0), (0, 1), (0, 4), (3, 5)],
                         ids=str)
@pytest.mark.parametrize("kernel,kind", INT_TC, ids=INT_TC_IDS)
def test_int_tc_equals_plain_at_misaligned_pointers(cuda, kernel, kind,
                                                    offsets):
    """x (or a) and w start ``offsets`` elements past a 16-byte boundary:
    the kernel takes 4-byte or byte copies, and gives the aligned
    result."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(51)
    for m, k, n in ((8, 896, 128), (17, 256, 64), (5, 200, 72)):
        x0, w0, sw, sa = _int_tc_operands(gen, kernel, kind, m, k, n, cuda)
        x, w = _misaligned(x0, offsets[0]), _misaligned(w0, offsets[1])
        want = _int_tc_plain(kernel, kind, (x0, w0, sw, sa))
        for splits in (None, 1, 5):
            plan = _int_tc_plan(kernel, kind, (x, w), splits)
            got = _int_tc(kernel, kind, (x, w, sw, sa), plan)
            assert torch.equal(got, want), (m, k, n, splits)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,kind", INT_TC, ids=INT_TC_IDS)
def test_int_tc_extremes(cuda, kernel, kind):
    """At K = 4864, N = 896: int8 -128 weights, packed nibbles 0x7 and
    0x8 in every pairing (bytes 0x77, 0x88, 0x78, 0x87), activations
    whose |x / sa| passes 127.5 (clamped) and ties x = (j + 1/2) sa at
    an exact (0.125) and an inexact (0.1) scale, all -128 int8
    activations; default and single-range plans."""
    m, k, n = 8, 4864, 896
    packed = kind == "int4_packed"
    ws = []
    if packed:
        for byte in (0x77, 0x88, 0x78, 0x87):
            ws.append(torch.full((k // 2, n), byte, dtype=torch.uint8,
                                 device=cuda).view(torch.int8))
    else:
        lo = -128 if kind == "int8" else -8
        ws.append(torch.full((k, n), lo, dtype=torch.int8, device=cuda))
        ws.append(torch.where(torch.arange(n, device=cuda) % 2 == 0, lo,
                              -lo - 1).to(torch.int8).expand(k, n)
                  .contiguous())
    sw = torch.linspace(0.01, 2.0, n, device=cuda).reshape(1, n)
    j = torch.arange(k, device=cuda, dtype=torch.float32) % 300 - 150
    acts = []
    for sa in (0.125, 0.1):
        sa_t = torch.tensor(sa, device=cuda)
        ties = ((j + 0.5) * sa).expand(m, k).contiguous()
        big = torch.full((m, k), 1e4, device=cuda)
        big[1::2] = -1e4
        acts += [(ties, sa_t), (big, sa_t)]
    for w in ws:
        if kernel == "qmm_packed":
            cases = [(torch.full((m, k), -128, dtype=torch.int8,
                                 device=cuda), None, None)]
            cases.append((tref.quantize_act_ref(acts[0][0], acts[0][1])
                          .to(torch.int8), None, None))
        else:
            cases = [(x, sw, sa) for x, sa in acts]
        for x, s, sa in cases:
            ops_ = (x, w, s, sa)
            want = _int_tc_plain(kernel, kind, ops_)
            for splits in (None, 1):
                plan = _int_tc_plan(kernel, kind, ops_, splits)
                assert torch.equal(_int_tc(kernel, kind, ops_, plan), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,kind", INT_TC, ids=INT_TC_IDS)
def test_int_tc_forced_and_refused_plans(cuda, kernel, kind):
    """Every forced number of K ranges and grid target gives the same
    bits; a plan that does not cover K, or that the kernel has no
    instance of, raises and counts no launch."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(52)
    ops_ = _int_tc_operands(gen, kernel, kind, 8, 4864, 896, cuda)
    want = _int_tc_plain(kernel, kind, ops_)
    for splits in range(1, tqmm.TC_MAX_SPLITS + 1):
        plan = _int_tc_plan(kernel, kind, ops_, splits)
        assert torch.equal(_int_tc(kernel, kind, ops_, plan), want), plan
    for per_sm in (1, 2, 4):
        plan = _int_tc_plan(kernel, kind, ops_, blocks_per_sm=per_sm)
        assert torch.equal(_int_tc(kernel, kind, ops_, plan), want), plan
    small = _int_tc_operands(gen, kernel, kind, 8, 256, 64, cuda)
    before = _int_tc_count(kernel)
    for plan in (tqmm.IntTcPlan(1, 1, 128), tqmm.IntTcPlan(3, 1, 256),
                 tqmm.IntTcPlan(1, 9, 32), tqmm.IntTcPlan(1, 2, 144),
                 tqmm.IntTcPlan(1, 2, 0), tqmm.IntTcPlan(1, 3, 128)):
        with pytest.raises(RuntimeError, match="cudaError_t"):
            _int_tc(kernel, kind, small, plan)
    assert _int_tc_count(kernel) == before
    got = _int_tc(kernel, kind, small, tqmm.IntTcPlan(1, 8, 32))
    assert torch.equal(got, _int_tc_plain(kernel, kind, small))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,kind", INT_TC, ids=INT_TC_IDS)
def test_int_tc_repeats_and_replays_bit_identical(cuda, kernel, kind):
    """Split plans (a cluster sum) give the same bits over repeated
    launches, a CUDA-graph replay and two replays in a row, one launch
    counted per call."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(53)
    for m, k, n in ((8, 4864, 896), (8, 896, 128), (256, 896, 896)):
        ops_ = _int_tc_operands(gen, kernel, kind, m, k, n, cuda)
        assert _int_tc_plan(kernel, kind, ops_).splits > 1
        want = _int_tc_plain(kernel, kind, ops_)
        before = _int_tc_count(kernel)
        outs = [_int_tc(kernel, kind, ops_) for _ in range(3)]
        assert _int_tc_count(kernel) == before + 3
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            _int_tc(kernel, kind, ops_)         # warm up off the default
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = _int_tc(kernel, kind, ops_)
        graph.replay()
        torch.cuda.synchronize()
        outs.append(out.clone())
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
        outs.append(out.clone())
        assert all(torch.equal(o, want) for o in outs), (m, k, n)


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


def _bits(y):
    return y.view(torch.int16 if y.element_size() == 2 else torch.int32)


def _mp_equal(a, b, cfg, fused=False, plan=None):
    got = tmpmm.mp_matmul(a, b, cfg, fused=fused, plan=plan)
    want = tref.mp_matmul_blocked_ref(a, b, cfg, fused=fused)
    assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want))
    return got


def _ordered(gen, m, k, n, g, step, device):
    """Group maxima that rise (step 1: every group a record up to the
    29th) or fall (step -1) one exponent a K-group."""
    e = (-14 if step > 0 else 15) + step * (torch.arange(k, device=device)
                                            // g)

    def unit(shape):
        sign = torch.randint(0, 2, shape, generator=gen, device=device)
        return (torch.rand(shape, generator=gen, device=device) * 0.5 + 1
                ) * (sign * 2 - 1)
    a = torch.ldexp(unit((m, k)), e.clamp(-14, 15).expand(m, k))
    return (a.to(torch.float16).contiguous(),
            unit((k, n)).to(torch.float16).contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1, -1])
@pytest.mark.parametrize("cfg", MP_CFGS[::2] + [
    IPUConfig(n=16, w=16, accum="fp32", rounding="floor")],
    ids=lambda c: f"n{c.n}w{c.w}{c.accum}{c.rounding[:2]}")
def test_mp_matmul_ordered_group_maxima(cuda, cfg, step):
    """Ascending maxima make every group a record: the fold truncates at
    every group; descending only at the first."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(34)
    for m, k, n in ((8, 29 * cfg.n, 300), (8, 4864, 96), (3, 300, 70)):
        a, b = _ordered(gen, m, k, n, cfg.n, step, cuda)
        for fused in (False, True):
            _mp_equal(a, b, cfg, fused)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [IPUConfig(n=3, w=16, accum="fp32"),
                                 IPUConfig(n=40, w=16, rounding="floor"),
                                 IPUConfig(n=64, w=20, accum="bf16",
                                           sw_precision=12)],
                         ids=lambda c: f"n{c.n}")
def test_mp_matmul_group_sizes(cuda, cfg):
    """Groups of 3, and of 40 and 64 (staged in two chunks a lane)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(35)
    for m, k, n in ((8, 896, 130), (5, 203, 72)):
        a, b = _f16_operands(gen, m, k, n, cuda)
        for fused in (False, True):
            _mp_equal(a, b, cfg, fused)


@pytest.mark.cuda
def test_mp_matmul_forced_plans_and_misaligned_pointers(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(36)
    cfg = MP_CFGS[0]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m, k, n in ((8, 4864, 200), (9, 896, 300), (5, 200, 72)):
        a, b = _f16_operands(gen, m, k, n, cuda)
        want = _mp_equal(a, b, cfg)
        for force in ({"splits": 1}, {"splits": tmpmm.MAX_SPLITS},
                      {"bn": 32}, {"bn": 256}, {"splits": 3, "bn": 64}):
            got = _mp_equal(a, b, cfg,
                            plan=tmpmm.plan_mpmm(m, n, k, 16, sms, **force))
            assert torch.equal(_bits(got), _bits(want))
        for oa, ob in ((1, 0), (0, 1), (0, 2), (3, 5)):
            def shifted(t, off):
                buf = torch.empty(t.numel() + off, dtype=t.dtype,
                                  device=cuda)
                out = buf[off:].view(t.shape)
                out.copy_(t)
                return out
            got = _mp_equal(shifted(a, oa), shifted(b, ob), cfg)
            assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_mp_matmul_repeats_and_replays_bit_identical(cuda):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(37)
    a, b = _f16_operands(gen, 8, 4864, 896, cuda)
    cfg = MP_CFGS[0]
    before = tmpmm.LAUNCHES["mp_matmul"]
    first = tmpmm.mp_matmul(a, b, cfg)
    assert tmpmm.LAUNCHES["mp_matmul"] == before + 1
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tmpmm.mp_matmul(a, b, cfg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tmpmm.mp_matmul(a, b, cfg)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(_bits(out), _bits(first))
    assert torch.equal(_bits(tmpmm.mp_matmul(a, b, cfg)), _bits(first))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["int8", "int4_packed", "fp4_packed"])
@pytest.mark.parametrize("groups", [1, 577])
def test_fused_dequant_deeper_k_than_one_launch(cuda, kind, groups):
    """K = 18464 at M = 16: one scale group past one launch's K, so the
    wrapper launches once per K slice and adds the partials."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(38)
    m, k, n = 16, 18464, 72
    assert len(tfused.k_slices(m, k, groups, kind)) == 2
    x = torch.randn((m, k), generator=gen, device=cuda) * 2
    sa = (x.abs().amax() / 127).reshape(())
    w, sw = _stored(gen, k, n, kind, groups, cuda)
    for act in tfused.ACTS:
        before = tfused.LAUNCHES["fused_dequant_mm"]
        _fd_check(x, w, sw, sa, kind, act)
        assert tfused.LAUNCHES["fused_dequant_mm"] == before + 2


# ------------------------------------------------ the engine's CUDA graphs

# (policy, fused_executors): fused_dequant_mm (int4_serving), the staged
# fake-quant path (int8_serving off), fused_qmm and qmm (fidelity_int8 on
# and off) and mp_matmul (fidelity_fp16_ipu)
GRAPH_ROUTES = [("int4_serving", "on"), ("int8_serving", "off"),
                ("fidelity_int8", "on"), ("fidelity_int8", "off"),
                ("fidelity_fp16_ipu", "auto")]
# the kernel each route launches (the staged path runs torch matmuls)
GRAPH_KERNEL = {("int4_serving", "on"): "fused_dequant_mm",
                ("int8_serving", "off"): None,
                ("fidelity_int8", "on"): "fused_qmm",
                ("fidelity_int8", "off"): "qmm",
                ("fidelity_fp16_ipu", "auto"): "mp_matmul"}
GRAPH_IDS = [f"{p}-{m}" for p, m in GRAPH_ROUTES]


def _graph_engine(device, policy, fused, decode_block=4, scales="auto"):
    from repro_torch.serving import EngineConfig
    from repro_torch.serving.engine import ServingEngine
    cfg = dataclasses.replace(reduced("qwen2-0.5b"), precision_policy=policy)
    api = registry.build(cfg)
    return ServingEngine(cfg, api, api.init(0, device), EngineConfig(
        batch_slots=3, cache_len=64, prefill_chunk=8,
        decode_block=decode_block, act_calibration=scales,
        fused_executors=fused))


def _graph_requests(cfg, sampled, seed=0):
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
                0, cfg.vocab, int(rng.integers(3, 14)), dtype=np.int32),
                max_new_tokens=int(rng.integers(4, 10)),
                sampling=SamplingParams(
                    temperature=0.8 if sampled and i % 2 == 0 else 0.0,
                    top_k=40, top_p=0.95))
            for i in range(5)]


def _serve_all(eng, reqs):
    for r in reqs:
        eng.submit(r)
    eng.run_until_drained()
    return {r.rid: list(r.tokens) for r in reqs}


@pytest.mark.cuda
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("policy,fused", GRAPH_ROUTES, ids=GRAPH_IDS)
def test_engine_programs_replay_bit_identical_to_eager(cuda, policy, fused,
                                                       sampled):
    """Each of the four programs (prefill wave, decode step, selection,
    decode block), replayed from its graph, gives outputs (tokens,
    carry, logits) and every cache and parameter tensor bit-identical to
    the same program run eagerly on cloned state."""
    eng = _graph_engine(cuda, policy, fused)
    _serve_all(eng, _graph_requests(eng.cfg, sampled))
    stats = eng.metrics()["graphs"]
    assert stats["captures"] == stats["signatures"] > 0
    assert stats["replays"] > 0
    checks = eng._check_replays(sampled)
    assert len(checks) == 4 and all(v == [] for v in checks.values()), checks


@pytest.mark.cuda
def test_interleaved_signatures_replay_bit_identical(cuda):
    """Block programs replayed in turns (n = 4, 2, 4, then sampled, then
    greedy) over one cache give what the same sequence gives eagerly."""
    from repro_torch.serving import graphs
    eng = _graph_engine(cuda, "int4_serving", "on")
    _serve_all(eng, _graph_requests(eng.cfg, False))
    b = eng.b

    def carry(n, sample, seed):
        rng = np.random.default_rng(seed)
        return registry.DecodeCarry(
            tok=rng.integers(0, eng.cfg.vocab, b, dtype=np.int32),
            pos=np.array([5, 9, 12], np.int32), rem=np.full(b, n, np.int32),
            taken=np.zeros(b, np.int32), stops=np.full((b, 4), -1, np.int32),
            temp=np.full(b, 0.8 if sample else 0.0, np.float32),
            top_k=np.full(b, 40, np.int32), top_p=np.full(b, 0.95, np.float32),
            keys=np.array([[11 + i, seed] for i in range(b)], np.int64))

    seq = [(4, False), (2, False), (4, False), (4, True), (4, False)]
    progs = {}
    for s in seq:
        fn = eng._block_decode(*s)
        progs[s] = getattr(fn, "__wrapped__", fn)
    for s, prog in progs.items():
        prog(eng.params, eng.caches, carry(*s, 99))       # capture each
    state = graphs.clone_tree(eng.caches)
    replays = sum(p.replays for p in progs.values())
    got = [graphs.clone_tree(progs[s](eng.params, eng.caches, carry(*s, i)))
           for i, s in enumerate(seq)]
    assert sum(p.replays for p in progs.values()) == replays + len(seq)
    want = [graphs.clone_tree(progs[s]._eager(eng.params, state,
                                              carry(*s, i)))
            for i, s in enumerate(seq)]
    for i, (g, w) in enumerate(zip(got, want)):
        for (path, x), (_, y) in zip(graphs.leaves(g), graphs.leaves(w)):
            assert graphs.same_bits(x, y), (i, seq[i], path)


@pytest.mark.cuda
@pytest.mark.parametrize("decode_block", [1, 4])
@pytest.mark.parametrize("policy,fused", GRAPH_ROUTES, ids=GRAPH_IDS)
def test_graphed_launch_counts_and_streams_equal_eager(cuda, policy, fused,
                                                       decode_block):
    """After a graphed run the wrappers' launch counts read what an eager
    run of the same requests counts (captures take theirs back, replays
    add theirs), and the streams are the same."""
    eng = _graph_engine(cuda, policy, fused, decode_block)
    eager = _graph_engine(cuda, policy, fused, decode_block,
                          scales=eng.act_scales)
    tops.reset_launch_counts()
    streams = _serve_all(eng, _graph_requests(eng.cfg, True, seed=1))
    graphed = tops.launch_counts()
    tops.reset_launch_counts()
    with eager._graphs._eager_calls():
        assert _serve_all(eager, _graph_requests(eng.cfg, True,
                                                 seed=1)) == streams
    assert tops.launch_counts() == graphed
    kernel = GRAPH_KERNEL[(policy, fused)]
    assert graphed[kernel] > 0 if kernel else sum(graphed.values()) == 0
    assert eng.metrics()["graphs"]["replays"] > 0
    assert eager.metrics()["graphs"]["signatures"] == 0


@pytest.mark.cuda
def test_engine_refuses_a_swapped_cache_tensor(cuda):
    from repro_torch.serving import Request
    eng = _graph_engine(cuda, "int8_serving", "on")
    _serve_all(eng, _graph_requests(eng.cfg, False))
    b0 = eng.caches["b0"]
    eng.caches["b0"] = b0._replace(k=b0.k.clone())
    eng.submit(Request(rid=99, prompt=np.arange(1, 6, dtype=np.int32),
                       max_new_tokens=3))
    with pytest.raises(RuntimeError, match="static argument 1/b0/k"):
        eng.run_until_drained()


# last in the file: a failed capture leaves nothing behind that a later
# test would notice (the stream is restored), but it runs after the rest
@pytest.mark.cuda
def test_a_failed_capture_raises_and_keeps_nothing(cuda):
    """A program that syncs the host runs eagerly at its first call and
    cannot be captured: the call raises, no signature is kept, the
    launch counts and the current stream are as before."""
    from repro_torch.serving import graphs
    programs = graphs.Programs(cuda)
    prog = programs.program(lambda x: x * float(x.sum()), 0, "syncs")
    counts, stream = tops.launch_counts(), torch.cuda.current_stream()
    with pytest.raises(RuntimeError):
        prog(np.ones(4, np.float32))
    assert prog._cache_size() == 0
    assert tops.launch_counts() == counts
    assert torch.cuda.current_stream() == stream
    torch.cuda.synchronize()


# ------------------------------------------ plan, checkpoint and router

PLAN = str(pathlib.Path(__file__).resolve().parents[1] / "results"
           / "plans" / "qwen2_0_5b.json")


@pytest.mark.cuda
def test_plan_engine_launches_fused_dequant_per_int8_projection(cuda):
    """Reduced qwen2-0.5b served from the committed plan on the card:
    one decode step launches ``fused_dequant_mm`` once per int8
    projection (six per layer; ``wo`` is bf16) and no other kernel, and
    a served wave replays its graphs with those launches."""
    import contextlib
    from repro_torch.serving import EngineConfig, Request
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.graphs import count_delta
    cfg = dataclasses.replace(reduced("qwen2-0.5b"),
                              precision_policy=f"plan:{PLAN}")
    eng = ServingEngine(cfg, registry.build(cfg), registry.init_params(
        cfg, 0, cuda), EngineConfig(batch_slots=3, cache_len=64,
                                    decode_block=4, act_calibration="auto"))
    assert eng.fused and eng.device.type == "cuda"
    before = tops.launch_counts()
    eng._trace_decode(contextlib.nullcontext)
    torch.cuda.synchronize()
    assert count_delta(before, tops.launch_counts()) \
        == {"fused_dequant_mm": 6 * cfg.n_layers}
    rng = np.random.default_rng(0)
    before = tops.launch_counts()
    for i in range(4):
        eng.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab, 9,
                                                      dtype=np.int32),
                           max_new_tokens=8))
    eng.run_until_drained()
    assert set(count_delta(before, tops.launch_counts())) \
        == {"fused_dequant_mm"}
    assert eng.metrics()["graphs"]["captures"] > 0


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_card_bit_equal(cuda, tmp_path):
    """An int4_serving engine on the card, saved and rebuilt with
    ``build_engine`` (default device): every leaf back on the card bit
    for bit, no weight quantization, and the same greedy streams."""
    from repro_torch.fabric import build_engine, save_engine_checkpoint
    from repro_torch.layers.mplinear import count_weight_quant
    from repro_torch.quant.prepare import tree_manifest
    from repro_torch.serving import EngineConfig, Request
    from repro_torch.serving.engine import ServingEngine
    from repro_torch.serving.graphs import same_bits
    cfg = dataclasses.replace(reduced("qwen2-0.5b"),
                              precision_policy="int4_serving")
    eng = ServingEngine(cfg, registry.build(cfg), registry.init_params(
        cfg, 0, cuda), EngineConfig(batch_slots=2, cache_len=64,
                                    decode_block=4, act_calibration="auto",
                                    fused_executors="on"))
    save_engine_checkpoint(eng, str(tmp_path))
    with count_weight_quant() as wq:
        again = build_engine(str(tmp_path))
    assert wq[0] == 0 and again.device.type == "cuda"
    mine, theirs = tree_manifest(eng.params)[1], tree_manifest(
        again.params)[1]
    assert len(mine) == len(theirs)
    assert all(b.is_cuda and same_bits(a, b) for a, b in zip(mine, theirs))

    def serve(e):
        rng = np.random.default_rng(3)
        reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, 7,
                                                   dtype=np.int32),
                        max_new_tokens=6) for i in range(3)]
        for r in reqs:
            e.submit(r)
        e.run_until_drained()
        return [r.tokens for r in reqs]
    assert serve(eng) == serve(again)


@pytest.mark.cuda
def test_router_over_two_graphed_engines(cuda):
    """A plan replica and a bf16 replica on the card behind the
    plan-aware router, stepped in turns: tagged requests on bf16, every
    stream equal to its replica serving it alone, and each engine
    captured into its own graphs."""
    from repro_torch.serving import (EngineConfig, Request, Router,
                                     build_replicas)
    cfg = reduced("qwen2-0.5b")
    reps = build_replicas(cfg, [f"plan:{PLAN}", "bf16"], config=EngineConfig(
        batch_slots=2, cache_len=64, decode_block=4, act_calibration="auto"))
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, 5 + i, dtype=np.int32)
               for i in range(6)]

    def requests():
        return [Request(rid=i, prompt=p, max_new_tokens=6,
                        tags=("accuracy",) if i % 2 else ())
                for i, p in enumerate(prompts)]
    router = Router(reps)
    reqs = requests()
    placed = {r.rid: router.submit(r).name for r in reqs}
    router.run_until_drained()
    assert all(placed[i] == "bf16" for i in range(1, 6, 2))
    for rep in reps:
        assert rep.engine.metrics()["graphs"]["captures"] > 0
        for r in requests():
            if placed[r.rid] == rep.name:
                rep.engine.submit(r)
                rep.engine.run_until_drained()
                assert r.tokens == reqs[r.rid].tokens, (rep.name, r.rid)


# ---------------------------------------------- the MoE layer, gemma2 shapes

def _moe_card_vs_cpu(mcfg, params, x, policy="int4_serving", prepare=True):
    """The MoE block on the card and on the CPU (a copy of the same
    parameters): identical routing; returns (card y, CPU y) in f64."""
    from repro_torch.convert import tree_to
    from repro_torch.core.policy import get_policy
    from repro_torch.layers import moe
    from repro_torch.quant.prepare import prepare_weight
    pol = get_policy(policy)
    if prepare:
        spec = pol.spec_for("block/moe/experts")
        params = {k: ({"w": prepare_weight(v["w"], spec)}
                      if k != "router" else v) for k, v in params.items()}
    out = []
    for tree, xx in ((params, x.cuda()), (tree_to(params, "cpu"), x.cpu())):
        with torch.no_grad():
            route = moe.route(tree, mcfg, xx)
            y, _ = moe.forward(tree, mcfg, xx, pol, "block/moe")
        out.append(([t.cpu() for t in route[1:5]], y.cpu().double()))
    (rc, yc), (rp, yp) = out
    for name, a, b in zip(("ids", "gates", "pos", "fits"), rc, rp):
        if name == "gates":
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(a, b), name
    return yc, yp


def _rel_rms(a, b):
    return float(torch.sqrt(((a - b) ** 2).mean() / (b ** 2).mean()))


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["einsum", "gather"])
def test_moe_block_on_the_card_matches_the_cpu_reduced(cuda, dispatch):
    """Reduced qwen3-moe's MoE block (raw bf16 experts and prepared
    int4), a chunk and a decode step: the same routing on the card and
    the CPU, outputs within 1% relative RMS (bf16 products summed in
    another order; phase 5's first-layer tolerance). f32 matmuls must
    not run on TF32 (a TF32 router moves expert selection)."""
    from repro_torch.layers import moe
    from repro_torch.models.lm import moe_cfg
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    mcfg = dataclasses.replace(moe_cfg(reduced("qwen3-moe-30b-a3b")),
                               dispatch=dispatch)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    params = moe.init(gen, mcfg, cuda)
    rng = np.random.default_rng(6)
    for shape in ((2, 32, mcfg.d_model), (8, 1, mcfg.d_model)):
        x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                             ).to(torch.bfloat16)
        for policy, prepare in (("bf16", False), ("int4_serving", True)):
            yc, yp = _moe_card_vs_cpu(mcfg, params, x, policy, prepare)
            assert _rel_rms(yc, yp) <= 1e-2, (shape, policy)


@pytest.mark.cuda
def test_moe_block_on_the_card_matches_the_cpu_full_width(cuda):
    """qwen3-moe-30b-a3b's MoE block at full width (128 experts, top-8,
    d_expert 768), prepared int4, one 32-token chunk whose last 24
    positions hold one hidden state (as a chunk's padded tail does):
    they all pick the same 8 experts, so assignments drop at capacity
    8, and routing is identical on the card and the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.layers import moe
    from repro_torch.models.lm import moe_cfg
    mcfg = moe_cfg(get_config("qwen3-moe-30b-a3b"))
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    params = moe.init(gen, mcfg, cuda)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (1, 32, mcfg.d_model), dtype=np.float32)).to(torch.bfloat16)
    x[:, 8:] = x[:, 8:9]
    _, _, _, _, fits, cap = moe.route(params, mcfg, x.cuda())
    assert cap == 8 and not bool(fits.all())
    yc, yp = _moe_card_vs_cpu(mcfg, params, x)
    assert _rel_rms(yc, yp) <= 1e-2


GEMMA2_SHAPES = [(3584, 4096), (3584, 2048), (4096, 3584), (3584, 14336),
                 (14336, 3584)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", GEMMA2_SHAPES, ids=str)
@pytest.mark.parametrize("kind", ["int4_packed", "int8"])
def test_fused_dequant_at_gemma2_shapes(cuda, kind, k, n):
    """``fused_dequant_mm`` at gemma2-9b's projection shapes (K and N up
    to 14336), M in {8, 256}, each act step: within 2 gamma_K of its
    plain version."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(9)
    w, sw = _stored(gen, k, n, kind, 1, cuda)
    for m in (8, 256):
        x = torch.randn((m, k), generator=gen, device=cuda) * 2
        sa = (x.abs().amax() / 127).reshape(())
        for act in tfused.ACTS:
            _fd_check(x, w, sw, sa, kind, act)


# the new families' projection shapes (K, N): rwkv6-1.6b's channel mix,
# recurrentgemma-9b's MLP and MQA wk/wv
FAMILY_SHAPES = [(2048, 7168), (7168, 2048), (4096, 12288), (12288, 4096),
                 (4096, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", FAMILY_SHAPES, ids=str)
@pytest.mark.parametrize("kind", ["int4_packed", "int8"])
def test_fused_dequant_at_family_shapes(cuda, kind, k, n):
    """``fused_dequant_mm`` at rwkv6-1.6b's and recurrentgemma-9b's new
    projection shapes, M in {8, 256}, each act step: within 2 gamma_K of
    its plain version."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(10)
    w, sw = _stored(gen, k, n, kind, 1, cuda)
    for m in (8, 256):
        x = torch.randn((m, k), generator=gen, device=cuda) * 2
        sa = (x.abs().amax() / 127).reshape(())
        for act in tfused.ACTS:
            _fd_check(x, w, sw, sa, kind, act)


FAMILY_ARCHS = ["internvl2-1b", "rwkv6-1.6b", "recurrentgemma-9b"]


def _family_engine(arch, device, params=None, scales="auto", **kw):
    from repro_torch.serving import EngineConfig
    from repro_torch.serving.engine import ServingEngine
    cfg = dataclasses.replace(reduced(arch), precision_policy="int4_serving")
    api = registry.build(cfg)
    if params is None:
        params = registry.init_params(cfg, seed=0, device=device)
    return ServingEngine(cfg, api, params, config=EngineConfig(
        batch_slots=2, cache_len=32, act_calibration=scales,
        fused_executors="on", **kw), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_state_updates_in_place_across_replays(cuda, arch):
    """The decode step's graph, replayed twice, writes the new state into
    the tensors it was captured with (the same addresses), bit-equal to
    the same steps run eagerly on a copy of the state."""
    from repro_torch.serving import graphs
    eng = _family_engine(arch, cuda)
    ptrs = [t.data_ptr() for _, t in graphs.leaves(eng.caches)]
    eager = graphs.clone_tree(eng.caches)
    pos = np.zeros(2, np.int32)
    for i, tok in enumerate(([[3], [5]], [[7], [11]], [[2], [9]])):
        tok = np.asarray(tok, np.int32)
        logits, eng.caches = eng._decode(eng.params, eng.caches, tok,
                                         pos + i)
        with eng._graphs._eager_calls():
            want, eager = eng._decode(eng.params, eager, tok, pos + i)
        assert graphs.same_bits(logits, want), i
        assert [t.data_ptr() for _, t in graphs.leaves(eng.caches)] == ptrs
        for (p, a), (_, b) in zip(graphs.leaves(eng.caches),
                                  graphs.leaves(eager)):
            assert graphs.same_bits(a, b), (i, p)
    assert eng.metrics()["graphs"]["replays"] == 2
    checks = eng._check_replays(False)
    assert all(v == [] for v in checks.values()), checks


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_engine_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced engine per family under ``int4_serving`` (calibrated on
    the CPU, fused), on the card and on the CPU from the same weights:
    the card's graphed and eager waves give the same streams and
    launches; its teacher-forced admission counts as the CPU's; and one
    decode step from the same state agrees with the CPU's logits within
    1e-2 relative RMS (phase 5's first-layer tolerance)."""
    from repro_torch.convert import tree_to
    from repro_torch.serving import Request, graphs
    cpu = _family_engine(arch, "cpu")
    params = tree_to(registry.init_params(cpu.cfg, seed=0, device="cpu"),
                     cuda)
    rng = np.random.default_rng(4)

    def reqs():
        return [Request(rid=i, prompt=rng.integers(0, 512, n,
                                                   dtype=np.int32),
                        max_new_tokens=4) for i, n in enumerate((5, 9, 3))]

    def serve(eng, eager=False):
        import contextlib
        before = tops.launch_counts()
        calls = eng._graphs._eager_calls() if eager \
            else contextlib.nullcontext()
        with calls:
            for r in reqs():
                eng.submit(r)
            eng.run_until_drained()
        torch.cuda.synchronize()
        launched = {k: v - before.get(k, 0)
                    for k, v in tops.launch_counts().items()}
        return ({r.rid: list(r.tokens) for r in eng.completed.values()},
                launched)

    rng = np.random.default_rng(4)
    card = _family_engine(arch, cuda, params, scales=cpu.act_scales)
    graphed, n_graphed = serve(card)
    rng = np.random.default_rng(4)
    eager, n_eager = serve(_family_engine(arch, cuda, params,
                                          scales=cpu.act_scales), True)
    assert graphed == eager and n_graphed == n_eager
    assert n_graphed["fused_dequant_mm"] > 0
    rng = np.random.default_rng(4)
    serve(cpu)
    assert card.counters["teacher_forced_tokens"] == \
        cpu.counters["teacher_forced_tokens"] == 4 + 8 + 2
    tok = np.asarray([[11], [13]], np.int32)
    pos = np.asarray([20, 21], np.int32)
    with card._graphs._eager_calls():
        lc, _ = card._decode(card.params,
                             tree_to(graphs.clone_tree(cpu.caches), cuda),
                             tok, pos)
    lp, _ = cpu._decode(cpu.params, cpu.caches, tok, pos)
    assert _rel_rms(lc.cpu(), lp) <= 1e-2


# ------------------------------------------------ encdec and the smoke

def _encdec_prepared(policy, device, cpu_params):
    """Reduced seamless-m4t-medium under ``policy``: calibrated on the
    CPU (random path, with frames), prepared, on ``device``."""
    from repro_torch.convert import tree_to
    from repro_torch.core.policy import get_policy
    from repro_torch.quant.calibrate import calibrate_act_scales
    cfg = dataclasses.replace(reduced("seamless-m4t-medium"),
                              precision_policy=policy)
    api = registry.build(cfg)
    scales = calibrate_act_scales(cfg, api, cpu_params, device="cpu")
    tree = api.prepare(cpu_params, get_policy(policy), act_scales=scales)
    return cfg, api, tree_to(tree, device)


def _encdec_batch(cfg, device):
    rng = np.random.default_rng(6)
    return {"tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab, (2, 12), dtype=np.int32)).to(device),
            "frames": torch.from_numpy(rng.standard_normal(
                (2, 8, cfg.frontend_dim), dtype=np.float32)).to(device)}


# card against CPU for a whole model (chip_smoke.py's phase 5 gates): the
# two sum in different orders, so an int8 act code at a rounding boundary
# can flip and move everything downstream by a step; a wrong kernel,
# scale or layout moves the logits by their whole range
WHOLE_MODEL_MAX_OF_RANGE = 0.10
WHOLE_MODEL_REL_RMS = 0.15


def _whole_model_close(a, b):
    a, b = a.double(), b.double()
    return (_rel_rms(a, b) <= WHOLE_MODEL_REL_RMS
            and float((a - b).abs().max())
            <= WHOLE_MODEL_MAX_OF_RANGE * float(b.max() - b.min()))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["int4_serving", "int8_serving"])
def test_encdec_on_the_card_matches_the_cpu_reduced(cuda, policy):
    """Reduced encdec, fused: one prefill launches ``fused_dequant_mm``
    once per projection (1 + 2 x 7 + 2 x 11 = 37) and a decode step once
    per decoder projection (2 x 11 = 22), nothing else. The first
    encoder block, from the same input, agrees with the CPU within 1e-2
    relative RMS (phase 5's first-layer tolerance); prefill logits, the
    encoder output and three decode steps fed the CPU's greedy tokens
    within the whole-model gates."""
    from repro_torch.convert import tree_to
    from repro_torch.core.policy import get_policy
    from repro_torch.layers.mplinear import executor_variant
    from repro_torch.models import encdec
    from repro_torch.models.lm import unstack
    from repro_torch.serving import graphs
    cpu_params = registry.init_params(reduced("seamless-m4t-medium"),
                                      seed=0, device="cpu")
    cfg, api, card = _encdec_prepared(policy, cuda, cpu_params)
    cpu = tree_to(card, "cpu")
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(3)).bfloat16()
    blocks = []
    for tree, dev in ((card, cuda), (cpu, "cpu")):
        with torch.no_grad(), executor_variant("fused"):
            blocks.append(encdec.encode_block(
                unstack(tree["enc_blocks"])[0], cfg, x.to(dev),
                torch.arange(8, device=dev)[None].expand(2, 8),
                get_policy(policy)).cpu())
    assert _rel_rms(*blocks) <= 1e-2
    out, tokens = {}, None
    for where, tree, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        batch = _encdec_batch(cfg, dev)
        before = tops.launch_counts()
        with torch.no_grad(), executor_variant("fused"):
            logits, state = api.prefill(tree, batch,
                                        api.init_cache(2, 16, dev))
            torch.cuda.synchronize()
            prefill = graphs.count_delta(before, tops.launch_counts())
            enc_out = state[1].cpu()
            pos = torch.full((2,), 12, dtype=torch.int32, device=dev)
            steps, launches = [], []
            for i in range(3):
                tok = (logits.argmax(-1) if tokens is None
                       else tokens[i].to(dev)).to(torch.int32)[:, None]
                before = tops.launch_counts()
                logits, state = api.decode_step(
                    tree, {"token": tok, "pos": pos}, state)
                torch.cuda.synchronize()
                launches.append(graphs.count_delta(before,
                                                   tops.launch_counts()))
                steps.append((tok.cpu()[:, 0], logits.cpu()))
                pos = pos + 1
        if tokens is None:
            tokens = [t for t, _ in steps]
        out[where] = (enc_out, steps, prefill, launches)
    (ec, dc, pc, nc), (ep, dp, pp, np_) = out["card"], out["cpu"]
    assert pc == {"fused_dequant_mm": 37}
    assert nc == [{"fused_dequant_mm": 22}] * 3
    assert pp == {} and np_ == [{}] * 3
    assert _whole_model_close(ec.float(), ep.float())
    real = slice(0, cfg.vocab)
    for (ta, a), (tb, b) in zip(dc, dp):
        assert torch.equal(ta, tb)
        assert _whole_model_close(a[:, real], b[:, real])


@pytest.mark.cuda
def test_encdec_decode_replays_bit_identical_to_eager(cuda):
    """A reduced encdec decode step through the program cache (captured
    once, then replayed) gives logits and a state bit-identical to the
    same steps run eagerly on a copy of the state, in the tensors it was
    captured with."""
    from repro_torch.layers.mplinear import executor_variant
    from repro_torch.serving import graphs
    cpu_params = registry.init_params(reduced("seamless-m4t-medium"),
                                      seed=0, device="cpu")
    cfg, api, tree = _encdec_prepared("int4_serving", cuda, cpu_params)
    with torch.no_grad(), executor_variant("fused"):
        _, state = api.prefill(tree, _encdec_batch(cfg, cuda),
                               api.init_cache(2, 16, cuda))
    eager = graphs.clone_tree(state)
    ptrs = [t.data_ptr() for _, t in graphs.leaves(state)]

    def step(t, st, tok, pos):
        with torch.no_grad(), executor_variant("fused"):
            return api.decode_step(t, {"token": tok, "pos": pos}, st)
    programs = graphs.Programs(cuda)
    program = programs.program(step, 2, "decode_step")
    pos = np.full(2, 12, np.int32)
    for i, tok in enumerate(([[3], [5]], [[7], [11]], [[2], [9]])):
        tok = np.asarray(tok, np.int32)
        got, _ = program(tree, state, tok, pos + i)
        want, eager = step(tree, eager, torch.from_numpy(tok).to(cuda),
                           torch.from_numpy(pos + i).to(cuda))
        assert graphs.same_bits(got, want), i
        assert [t.data_ptr() for _, t in graphs.leaves(state)] == ptrs
        for (p, a), (_, b) in zip(graphs.leaves(state),
                                  graphs.leaves(eager)):
            assert graphs.same_bits(a, b), (i, p)
    assert programs.stats()["captures"] == 1
    assert programs.stats()["replays"] == 2


@pytest.mark.cuda
def test_serving_smoke_on_the_card(cuda, tmp_path):
    """``python -m repro_torch.serving smoke --trace PATH`` on the card
    (its default device): exit 0, every contract held, a valid trace."""
    import json

    from repro_torch.obs import validate_chrome_trace
    from repro_torch.serving.__main__ import main
    path = str(tmp_path / "trace.json")
    assert main(["smoke", "--trace", path]) == 0
    with open(path) as f:
        assert validate_chrome_trace(json.load(f)) == []


@pytest.mark.cuda
@pytest.mark.parametrize("command", ["smoke", "chaos"])
def test_fabric_contracts_on_the_card(cuda, command, capsys):
    """``python -m repro_torch.fabric smoke`` and ``chaos`` on the card
    (their default device): exit 0, every contract of the reference's
    held, and the fabric's workers served through ``fused_dequant_mm``."""
    from repro_torch.fabric.__main__ import main
    before = tops.launch_counts()["fused_dequant_mm"]
    assert main([command]) == 0
    assert "PASS on cuda" in capsys.readouterr().out
    assert tops.launch_counts()["fused_dequant_mm"] > before


@pytest.mark.cuda
def test_fig3_rows_on_the_card_equal_the_cpus(cuda):
    """Fig. 3's whole grid through ``core.ipu`` on the card: every row
    equal to the CPU's."""
    import json

    from repro_torch import exp
    from repro_torch.studies import fig3_error
    rows = {}
    for dev in ("cuda", "cpu"):
        res, rep = exp.run_sweep(fig3_error.spec(), exp.EngineConfig(
            cache=None, device=dev))
        assert rep.n_executed == 48
        rows[dev] = json.dumps(exp.rows_from(res, "fig3_error"),
                               sort_keys=True)
    assert rows["cuda"] == rows["cpu"]


@pytest.mark.cuda
def test_fig3_raw_accumulators_on_the_card_equal_the_cpus(cuda):
    """Every Fig. 3 cell's raw accumulators (``hi``, ``lo``, exponent)
    through ``core.ipu`` on the card equal to the CPU's, integer for
    integer: the rows are medians and would hide a few that differ."""
    from repro_torch.core.ipu import fp16_inner_product_raw
    from repro_torch.studies import fig3_error
    for p in fig3_error.spec().points():
        kw = p.kwargs
        a, b = fig3_error.operands(kw["dist"])
        cfg = fig3_error.ipu_config(kw["accum"], kw["w"])
        got = {}
        for dev in (cuda, "cpu"):
            acc, e = fp16_inner_product_raw(torch.as_tensor(a, device=dev),
                                            torch.as_tensor(b, device=dev),
                                            cfg)
            got[dev] = [t.cpu() for t in (acc.hi, acc.lo, e)]
        for x, y in zip(got[cuda], got["cpu"]):
            assert torch.equal(x, y), p.label()


@pytest.mark.cuda
@pytest.mark.parametrize("accum,dist,w", (("fp16", "laplace", 8),
                                          ("fp16", "uniform", 16),
                                          ("fp32", "normal", 20),
                                          ("fp32", "laplace", 28)))
def test_mp_matmul_diagonal_is_the_fp_ip_on_fig3_operands(cuda, accum,
                                                          dist, w):
    """The kernel's products of Fig. 3's operands: the diagonal of
    ``mp_matmul(a, b.T)`` bit-equal to ``fp16_inner_product(a, b)``."""
    from repro_torch.core.ipu import fp16_inner_product
    from repro_torch.studies import fig3_error
    a, b = (torch.as_tensor(x, device=cuda)
            for x in fig3_error.operands(dist))
    cfg = fig3_error.ipu_config(accum, w)
    before = tops.launch_counts()["mp_matmul"]
    diag = torch.diagonal(tops.mp_matmul(a, b.T.contiguous(), cfg))
    assert tops.launch_counts()["mp_matmul"] == before + 1
    want = fp16_inner_product(a, b, cfg)
    bits = torch.int16 if want.element_size() == 2 else torch.int32
    assert torch.equal(diag.contiguous().view(bits), want.view(bits))


@pytest.mark.cuda
def test_quickstart_prints_the_same_text_on_the_card(cuda, capsys):
    from repro_torch.examples import quickstart
    quickstart.main(["--device", "cuda"])
    card = capsys.readouterr().out
    quickstart.main(["--device", "cpu"])
    assert card and card == capsys.readouterr().out


@pytest.mark.cuda
@pytest.mark.parametrize("group,mode,w", (("attn_qkv", "fp16_ipu", 12),
                                          ("ffn_in", "fp16_ipu", 16),
                                          ("ffn_out", "fp16_ipu", 20),
                                          ("attn_wo", "int8", 16),
                                          ("ffn_in", "fp8", 16),
                                          ("head", "int4", 16)))
def test_probe_on_the_card_matches_the_cpu(cuda, monkeypatch, group, mode,
                                           w):
    """The planner's accuracy point on the card and on the CPU: the same
    weights and tokens (numpy draws), the KL within the stated bound, the
    analytic bound equal; an exact fp16_ipu candidate launches
    ``mp_matmul`` once a projection of its group (2 layers), each call
    bit-equal to its plain version on the same operands (the KL alone
    cannot see the IPU's truncation), any other candidate none."""
    from repro_torch.autotune import objectives
    from repro_torch.autotune.objectives import PROBE_KL_ATOL, PROBE_KL_RTOL
    before = tops.launch_counts()
    calls = []
    real = tmpmm.mp_matmul

    def recording(a, b, cfg, **kwargs):
        out = real(a, b, cfg, **kwargs)
        calls.append((a.clone(), b.clone(), cfg, kwargs, out.clone()))
        return out

    monkeypatch.setattr(tmpmm, "mp_matmul", recording)
    card = objectives.accuracy_point("qwen2-0.5b", group, mode, w, 28,
                                     device="cuda")
    torch.cuda.synchronize()
    monkeypatch.undo()
    launched = {k: n - before[k] for k, n in tops.launch_counts().items()
                if n != before[k]}
    cpu = objectives.accuracy_point("qwen2-0.5b", group, mode, w, 28,
                                    device="cpu")
    assert card["bound_rel"] == cpu["bound_rel"]
    assert abs(card["divergence"] - cpu["divergence"]) \
        <= PROBE_KL_RTOL * cpu["divergence"] + PROBE_KL_ATOL, (card, cpu)
    per_layer = {"attn_qkv": 3, "attn_wo": 1, "ffn_in": 2, "ffn_out": 1}
    if mode == "fp16_ipu" and w < 28:
        assert launched == {"mp_matmul": 2 * per_layer[group]}
        assert len(calls) == 2 * per_layer[group]
        for a, b, cfg, kwargs, out in calls:
            assert cfg.w == w
            want = tref.mp_matmul_blocked_ref(a, b, cfg, **kwargs)
            bits = {2: torch.int16, 4: torch.int32}[out.element_size()]
            assert out.dtype == want.dtype and torch.equal(
                out.view(bits), want.view(bits)), \
                (tuple(a.shape), tuple(b.shape), cfg)
    else:
        assert launched == {} and calls == []


@pytest.mark.cuda
def test_autotune_smoke_on_the_card(cuda, tmp_path, capsys):
    """``python -m repro_torch.autotune smoke`` on the card (its default
    device): the reference's contract, and the cold run's probes of the
    exact fp16_ipu candidate launch ``mp_matmul``."""
    from repro_torch.autotune import cli
    before = tops.launch_counts()["mp_matmul"]
    assert cli.main(["smoke", "--cache-dir", str(tmp_path)]) == 0
    assert capsys.readouterr().out.startswith("autotune smoke OK")
    # 4 projection groups a probe: 2 x (3 + 1 + 2 + 1) projections
    assert tops.launch_counts()["mp_matmul"] - before == 14


# one train step, card against CPU: (loss relative, the worst gradient
# leaf's relative L2, the parameter tree after the step, relative L2),
# each a few times the reading beside it (an H100 at 700 W). qwen2 and
# seamless multiply only in f32 (``_dot_f32``) and agree to f32
# summation order; the others also multiply bf16 by bf16 (rwkv's
# token-shift mixing, griffin's recurrence gates, the experts' einsums,
# the vision projector), where the card and the CPU round differently
TRAIN_CARD_VS_CPU = {
    "qwen2-0.5b": (1e-6, 1e-5, 1e-7),            # 7.3e-8 1.5e-7 5.0e-9
    "mixtral-8x7b": (1e-6, 2e-2, 1e-3),          # 6.8e-8 4.3e-3 1.8e-4
    "rwkv6-1.6b": (1e-6, 2e-2, 1e-3),            # 0      2.1e-3 3.2e-5
    "recurrentgemma-9b": (1e-6, 2e-2, 1e-3),     # 0      5.4e-3 9.6e-5
    "internvl2-1b": (1e-6, 2e-2, 1e-3),          # 7.4e-8 3.4e-3 1.1e-4
    "seamless-m4t-medium": (1e-6, 1e-5, 1e-7),   # 6.7e-8 1.2e-7 3.4e-10
}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", list(TRAIN_CARD_VS_CPU))
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """One train step of the reduced family (numpy-drawn weights and
    batch) on the card and on the CPU, both under the trainer's
    numerics: the loss, each gradient leaf and the parameters after the
    step within ``TRAIN_CARD_VS_CPU``; no kernel launched."""
    from repro_torch.configs import InputShape
    from repro_torch.convert import tree_to
    from repro_torch.launch import train
    from repro_torch.optim.tree import tree_leaves
    cfg = reduced(arch)
    api = registry.build(cfg)
    tc = train.TrainConfig(adamw=train.AdamWConfig(lr=1e-3), warmup=1)
    batch = registry.materialize_batch(
        cfg, InputShape("train", 16, 2, "train"), seed=3, device="cpu")
    params = api.init(0, "cpu", draws="numpy")
    before = tops.launch_counts()
    got = {}
    for dev in ("cuda", "cpu"):
        st = train.init_state(api, tree_to(params, dev))
        st = st._replace(step=st.step + 1)
        b = {k: v.to(dev) for k, v in batch.items()}
        with train.train_numerics():
            grads, loss, metrics = train.grad_step(api, tc, st, b)
            new, _ = train.apply_updates(api, tc, st, grads, loss,
                                         metrics)
        got[dev] = (float(loss), [g.double().cpu() for g in
                                  tree_leaves(grads)],
                    torch.cat([p.double().cpu().ravel()
                               for p in tree_leaves(new.params)]))
    assert tops.launch_counts() == before
    (lc, gc, pc), (lp, gp, pp) = got["cuda"], got["cpu"]
    loss_tol, grad_tol, param_tol = TRAIN_CARD_VS_CPU[arch]
    assert lc == pytest.approx(lp, rel=loss_tol)

    def rel(a, b):
        return float((a - b).norm() / max(float(b.norm()), 1e-30))
    assert max(rel(a, b) for a, b in zip(gc, gp)) <= grad_tol
    assert rel(pc, pp) <= param_tol


@pytest.mark.cuda
def test_trainer_cli_on_the_card_resumes_bit_equal(cuda, tmp_path):
    """The trainer CLI on the card (its default device), reduced
    qwen2-0.5b: killed by ``fail_at_step`` and resumed, the losses and
    final state equal an uninterrupted run's bit for bit, with torch's
    deterministic mode off (the step leaves it as it found it)."""
    from repro_torch.launch import train
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.runtime.fault_tolerance import (WorkerFailure,
                                                     fail_at_step)

    def args(name):
        return train.parse_args(["--reduced", "--steps", "8",
                                 "--ckpt-every", "3",
                                 "--ckpt-dir", str(tmp_path / name)])

    whole = train.run(args("whole"))
    with pytest.raises(WorkerFailure):
        train.run(args("killed"), failure_hook=fail_at_step(5))
    resumed = train.run(args("killed"))
    assert resumed.losses == whole.losses[3:]
    for a, b in zip(tree_leaves(resumed.state), tree_leaves(whole.state)):
        assert a.device.type == "cuda" and torch.equal(a, b)
    assert not torch.are_deterministic_algorithms_enabled()
